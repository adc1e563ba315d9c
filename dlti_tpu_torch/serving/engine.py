"""Continuous-batching inference engine: the port of
``dlti_tpu/serving/engine.py``'s paged-KV path with multi-step decode.

* **Two programs.** Prefill runs the admitted prompts padded to a length
  bucket, several admissions per call, eagerly (its shapes vary). Decode
  runs every slot one token per iteration, inactive slots at position 0
  against the trash block, ``k`` iterations a window with one host sync a
  window (``EngineConfig.steps_per_sync``; the reference's
  ``_build_multi_decode_fn``): each iteration runs the model, samples on
  the device and feeds the sampled token back. ``k`` comes from the
  reference's halving ladder (:meth:`InferenceEngine._window_steps`).
* **One CUDA graph.** On the card :class:`EngineExecutor` captures one
  decode iteration as a CUDA graph (:meth:`InferenceEngine.
  warmup_decode_ladder` before traffic, or at the first dispatch) and
  replays it ``k`` times a window, so one graph serves every ladder length
  where the reference compiles a program per length. On the CPU the same
  iteration runs eagerly, and that is the card's oracle.
* **Paged KV.** One physical pool per layer on the device
  (``ops.kv_cache``, updated in place); :class:`BlockManager` hands out
  blocks.
* **Device-resident decode state** (``serving.decode_state``, on by
  default: ``EngineConfig.decode_state_cache``): block tables, seeds,
  generated counts and sampling parameters live on the device, and only
  rows a scheduling event dirtied are uploaded, through pinned memory; a
  clean step uploads nothing but the window's ids and positions.
* **Continuous batching.** Each :meth:`InferenceEngine.step` dispatches the
  decode window, admits waiting requests into free slots (prefill), then
  completes the window — the reference's order. Nothing in the dispatch
  waits on the card, so admission overlaps the window. Block tables grow
  to cover the window; when the pool runs out the youngest sequence is
  preempted back to the queue and recomputed on readmission, and a
  multi-step window that cannot reserve its blocks falls back to one step.
* **Sampling** is per-slot data (``serving.sampling``). A request's draws
  are a hash of (its seed, tokens generated so far), so a seeded stream
  does not depend on batch company, preemption or ``steps_per_sync``.
* **What the server needs**: a request's ``cancel_requested`` flag (set
  from any thread; a queued request finishes without a slot, a running one
  at its next token), the ``finished`` deque the server drains,
  ``abort_all`` after a faulted step, and the request-latency histograms
  (``telemetry.lifecycle``).
* **KV pool dtypes**: ``cache_dtype`` ``"bfloat16"``, ``"float32"`` or
  ``"int8"`` (per-row scales; decode through the paged kernel's int8 mode).

Not ported yet (ROADMAP.md): speculative decode, prefix caching and tiers,
chunked and ragged prefill, the multi-LoRA pool, int8 weights, float16 KV
pools, tensor parallelism, the memory ledger, tracer spans and
critical-path attribution.
"""

from __future__ import annotations

import collections
import itertools
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dlti_tpu_torch.config import LoRAConfig, ModelConfig
from dlti_tpu_torch.models.interop import load_model
from dlti_tpu_torch.ops.kv_cache import init_paged_cache
from dlti_tpu_torch.ops.launches import GraphLaunches
from dlti_tpu_torch.serving.block_manager import BlockManager
from dlti_tpu_torch.serving.decode_state import DecodeStateCache
from dlti_tpu_torch.serving.sampling import SamplingParams, sample_tokens
from dlti_tpu_torch.telemetry.lifecycle import RequestTelemetry
from dlti_tpu_torch.utils.device import (
    resolve_device, resolve_dtype, to_host, upload,
)

@dataclass
class EngineConfig:
    """Engine sizing (the reference's fields of the same names)."""

    max_seqs: int = 8              # decode batch slots
    block_size: int = 16           # tokens per KV block
    num_blocks: int = 256          # physical pool size (per layer)
    max_model_len: int = 512       # max prompt+generation length per request
    prefill_buckets: Sequence[int] = ()  # default: powers of 2 up to max_model_len
    cache_dtype: str = "bfloat16"  # "bfloat16" | "float32" | "int8"
    eos_token_id: int = 2          # Llama-2 </s>
    # Multi-step decode: run this many decode iterations (forward -> sample
    # -> feed back) per host sync. Amortizes per-step host work and round
    # trips; the trade-off is up to steps_per_sync-1 discarded tokens after
    # an EOS and coarser admission cadence.
    steps_per_sync: int = 1
    # Device-resident decode state (serving.decode_state): per-slot tables,
    # seeds, counts and sampling parameters stay on the device and only
    # dirtied rows upload. False re-uploads every row every dispatch;
    # outputs are identical either way.
    decode_state_cache: bool = True
    # Raise NumericFault before appending any token of a round whose
    # logprobs are not finite (NaN/inf logits).
    guard_nonfinite: bool = True

    def buckets(self) -> List[int]:
        if self.prefill_buckets:
            return sorted(self.prefill_buckets)
        out, b = [], self.block_size
        while b < self.max_model_len:
            out.append(b)
            b *= 2
        out.append(self.max_model_len)
        return out

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_model_len // self.block_size)


class NumericFault(RuntimeError):
    """A round produced nonfinite logprobs; raised before any of its tokens
    is appended."""


@dataclass
class Request:
    """One generation request (token level)."""

    request_id: str
    prompt_token_ids: List[int]
    params: SamplingParams = field(default_factory=SamplingParams)
    arrival_time: float = field(default_factory=time.monotonic)
    # Filled by the engine:
    output_token_ids: List[int] = field(default_factory=list)
    output_logprobs: List[float] = field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    finish_reason: Optional[str] = None
    num_preemptions: int = 0
    # When the request was first admitted into a slot (None while queued);
    # kept across preemption so the queue-time histogram sees the first wait.
    admitted_time: Optional[float] = None
    # Early cancel (stop string, client disconnect, timeout): set from any
    # thread, consumed by the engine at admission or at the next token.
    cancel_requested: bool = False

    @property
    def done(self) -> bool:
        return self.finish_reason is not None


@dataclass
class GenerationResult:
    request_id: str
    prompt_token_ids: List[int]
    output_token_ids: List[int]
    output_logprobs: List[float]
    finish_reason: str
    ttft_s: float
    latency_s: float


class _Slot:
    """Host state for one decode slot."""

    def __init__(self, slot_id: int):
        self.slot_id = slot_id
        self.request: Optional[Request] = None
        self.blocks: List[int] = []
        self.seq_len = 0  # tokens written to the KV cache
        self.last_token = 0

    @property
    def free(self) -> bool:
        return self.request is None


def decode_mirrors(ec: EngineConfig) -> Dict[str, np.ndarray]:
    """Fresh host mirrors of the per-slot decode state, in
    ``serving.decode_state.FIELDS`` order; a free slot's row holds these
    values."""
    S = ec.max_seqs
    return {"block_tables": np.zeros((S, ec.max_blocks_per_seq), np.int32),
            "slot_seeds": np.zeros((S,), np.int64),
            "gen_counts": np.zeros((S,), np.int32),
            "temperature": np.ones((S,), np.float32),
            "top_k": np.zeros((S,), np.int32),
            "top_p": np.ones((S,), np.float32)}


class EngineExecutor:
    """The device half: the model, the KV pools, the resident decode state
    and the prefill and decode calls. Holds no scheduling state.

    A decode window reads static buffers: ``ids`` and ``pos`` ``(S, 1)``,
    the resident state (``self.state``) and the KV pools, and writes step
    j's tokens and logprobs into row j of ``(steps_per_sync, S)`` outputs.
    On a CUDA device the iteration is captured once as a CUDA graph and
    replayed; ``cuda_graphs=False`` runs it eagerly on the card instead (for
    tests and ``chip_smoke.py`` only). A capture that fails raises.
    """

    def __init__(self, model_cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 lora_cfg: Optional[LoRAConfig] = None, device=None, *,
                 cuda_graphs: bool = True):
        self.device = dev = resolve_device(device)
        self.cfg = ec = engine_cfg
        self.model_cfg = model_cfg
        self.model = load_model(model_cfg, params, dev, lora_cfg)
        cache_dtype = ("int8" if ec.cache_dtype == "int8"
                       else resolve_dtype(ec.cache_dtype))
        self.cache = init_paged_cache(
            model_cfg.num_layers, ec.num_blocks, ec.block_size,
            model_cfg.num_kv_heads, model_cfg.resolved_head_dim, cache_dtype,
            device=dev)
        self.state = DecodeStateCache(decode_mirrors(ec), dev)
        S, K = ec.max_seqs, max(1, ec.steps_per_sync)
        # ids, positions, this window's counts, step index, outputs.
        self._bufs = (torch.zeros((S, 1), dtype=torch.long, device=dev),
                      torch.zeros((S, 1), dtype=torch.int32, device=dev),
                      torch.zeros((S,), dtype=torch.int32, device=dev),
                      torch.zeros((1,), dtype=torch.long, device=dev),
                      torch.zeros((K, S), dtype=torch.long, device=dev),
                      torch.zeros((K, S), dtype=torch.float32, device=dev))
        self.cuda_graphs = cuda_graphs and dev.type == "cuda"
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches = GraphLaunches()

    def _decode_iteration(self, bufs, state) -> None:
        """One decode iteration over every slot, in place: forward, sample,
        write row ``step`` of the outputs, then ids <- token, pos += 1,
        counts += 1, step += 1 (every row, like the reference's scan;
        inactive rows have all-zero tables and keep writing the trash
        block)."""
        ids, pos, cnt, step, out_tok, out_lp = bufs
        tables, seeds, _, temperature, top_k, top_p = state
        logits = self.model(ids, positions=pos, cache=self.cache,
                            block_tables=tables)
        tok, lp = sample_tokens(logits[:, 0], seeds, cnt, temperature, top_k,
                                top_p)
        out_tok.index_copy_(0, step, tok[None])
        out_lp.index_copy_(0, step, lp[None])
        ids.copy_(tok[:, None])
        pos.add_(1)
        cnt.add_(1)
        step.add_(1)

    @torch.no_grad()
    def capture(self) -> None:
        """Capture the decode iteration as a CUDA graph (once; later calls
        return at once). An eager warm-up iteration first builds what the
        first call builds lazily (the kernel library, RoPE tables, cuBLAS
        state) on a side stream, on zeroed copies of the buffers and block
        table, so it writes nothing but the trash block. The capture
        itself launches nothing: the launch counters it moved are put back
        and credited to each replay instead."""
        if not self.cuda_graphs or self.graph is not None:
            return
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                state = list(self.state.tensors)
                state[0] = torch.zeros_like(state[0])
                self._decode_iteration([torch.zeros_like(b) for b in self._bufs],
                                       state)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with self.launches.capturing(), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                self._decode_iteration(self._bufs, self.state.tensors)
        self.graph = graph

    @torch.no_grad()
    def decode_window(self, k: int, input_ids: np.ndarray,
                      positions: np.ndarray):
        """``k`` decode iterations from ``input_ids``/``positions`` ``(S,
        1)`` over the resident state, as it stands on the device. Returns
        device tensors (tokens, logprobs) of shape ``(k, S)``: views of the
        static outputs, valid until the next window. Waits on nothing."""
        ids, pos, cnt, step, out_tok, out_lp = self._bufs
        if k > out_tok.shape[0]:
            raise ValueError(f"a window of {k} steps exceeds steps_per_sync="
                             f"{out_tok.shape[0]}")
        upload(input_ids, self.device, out=ids)
        upload(positions, self.device, out=pos)
        cnt.copy_(self.state.gen_counts)
        step.zero_()
        if self.cuda_graphs:
            self.capture()
            with torch.cuda.device(self.device):
                for _ in range(k):
                    self.graph.replay()
            self.launches.credit(k)
        else:
            for _ in range(k):
                self._decode_iteration(self._bufs, self.state.tensors)
        return out_tok[:k], out_lp[:k]

    @torch.no_grad()
    def prefill(self, input_ids: np.ndarray, positions: np.ndarray,
                block_table: np.ndarray, last_idx: np.ndarray) -> torch.Tensor:
        """Prefill rows ``(B, bucket)`` (padding at position -1, whose KV
        writes go to the trash block); returns each row's logits at
        ``last_idx``. Waits on nothing."""
        dev = self.device
        logits = self.model(upload(input_ids, dev),
                            positions=upload(positions, dev), cache=self.cache,
                            block_tables=upload(block_table, dev))
        rows = torch.arange(logits.shape[0], device=dev)
        return logits[rows, upload(last_idx, dev).long()]

    @torch.no_grad()
    def sample(self, logits: torch.Tensor, seeds: np.ndarray, counts: np.ndarray,
               temperature: np.ndarray, top_k: np.ndarray, top_p: np.ndarray):
        dev = self.device
        return sample_tokens(logits, upload(seeds, dev), upload(counts, dev),
                             upload(temperature, dev), upload(top_k, dev),
                             upload(top_p, dev))


class InferenceEngine:
    """Synchronous engine core: :meth:`submit` requests, :meth:`step` in a
    loop; :meth:`generate` is the offline batch entry point."""

    def __init__(self, model_cfg: ModelConfig, params,
                 engine_cfg: EngineConfig = EngineConfig(),
                 lora_cfg: Optional[LoRAConfig] = None, device=None,
                 executor: Optional[EngineExecutor] = None):
        """``executor``: a prebuilt :class:`EngineExecutor` for this model
        and ``engine_cfg`` (how a caller runs the card eagerly:
        ``EngineExecutor(..., cuda_graphs=False)``); built here by default,
        and then ``params`` is loaded into it."""
        if engine_cfg.steps_per_sync < 1:
            raise ValueError(f"steps_per_sync must be >= 1, got "
                             f"{engine_cfg.steps_per_sync}")
        if engine_cfg.max_blocks_per_seq > engine_cfg.num_blocks - 1:
            # Block 0 is the trash block; a max-length sequence that can
            # never fit would block the FCFS queue head forever.
            raise ValueError(
                f"max_model_len={engine_cfg.max_model_len} needs "
                f"{engine_cfg.max_blocks_per_seq} KV blocks but the pool has "
                f"only {engine_cfg.num_blocks - 1} allocatable "
                f"(num_blocks={engine_cfg.num_blocks} minus the reserved "
                f"trash block); raise num_blocks or lower max_model_len")
        self.cfg = ec = engine_cfg
        self.model_cfg = model_cfg
        if executor is None:
            executor = EngineExecutor(model_cfg, params, engine_cfg, lora_cfg,
                                      device)
        elif executor.cfg != engine_cfg or executor.model_cfg != model_cfg:
            raise ValueError("the executor was built for another configuration")
        self.executor = executor
        self.block_manager = BlockManager(ec.num_blocks, ec.block_size)
        self.slots = [_Slot(i) for i in range(ec.max_seqs)]
        self.waiting: collections.deque = collections.deque()
        # Recently finished requests, for the server to drain their last events.
        self.finished: collections.deque = collections.deque(maxlen=256)
        self.telemetry = RequestTelemetry()
        self._rng = random.Random(0)  # seeds of requests that name none
        self._req_counter = itertools.count()

        # Host mirrors of the per-slot device state (serving.decode_state).
        self._mirrors = decode_mirrors(ec)
        self._block_tables = self._mirrors["block_tables"]
        self._slot_seeds = self._mirrors["slot_seeds"]
        self._gen_counts = self._mirrors["gen_counts"]
        self._temperature = self._mirrors["temperature"]
        self._top_k = self._mirrors["top_k"]
        self._top_p = self._mirrors["top_p"]
        # The resident state's counters (decode_state_uploads, _rows,
        # _clean_syncs) live in the same dict; they stay 0 with the cache
        # off, as in the reference.
        self._state_cache = self.executor.state
        self.stats = self._state_cache.stats
        self.stats.update({
            "requests": 0, "generated_tokens": 0, "prefill_tokens": 0,
            "preemptions": 0,
            # Device decode steps: k per window of k.
            "decode_steps": 0,
            # slot x step units consumed; / (max_seqs * decode_steps) is the
            # mean slot occupancy (a slot that finishes mid-window stops
            # counting there).
            "decode_slot_steps": 0, "prefill_batches": 0,
            "numeric_faults": 0,
            # Multi-step windows shrunk to one step because the pool could
            # not reserve their blocks.
            "hbm_growth_deferrals": 0})

    @property
    def device(self) -> torch.device:
        return self.executor.device

    @property
    def model(self):
        return self.executor.model

    @property
    def cache(self) -> list:
        return self.executor.cache

    @property
    def num_active(self) -> int:
        return sum(not s.free for s in self.slots)

    @property
    def num_free_blocks(self) -> int:
        return self.block_manager.num_free

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or self.num_active > 0

    def warmup_decode_ladder(self) -> None:
        """Make the decode path ready before traffic, so no window's first
        use stalls the live loop: bring the resident state up to date and,
        on the card, capture the decode iteration's CUDA graph. One graph
        serves every ladder length (k is a replay count). Idempotent: a
        re-warm keeps the graph it has."""
        self._sync_state()
        self.executor.capture()

    def _window_steps(self, active: list) -> int:
        """Budget-clamped multi-step window (the reference's ladder).

        Never run a window past the smallest predictable retirement among
        active slots (max_tokens budget, or model-length room: a length stop
        fires when prompt + output reaches max_model_len): round that up to
        the halving ladder steps_per_sync, /2, ..., 1, then down under the
        hard KV room, which a window must never pass."""
        ec = self.cfg
        min_rem = min(
            min(s.request.params.max_tokens - len(s.request.output_token_ids),
                ec.max_model_len - len(s.request.prompt_token_ids)
                - len(s.request.output_token_ids))
            for s in active)
        k = ec.steps_per_sync
        while k > 1 and k // 2 >= min_rem:
            k //= 2
        min_room = min(ec.max_model_len - s.seq_len for s in active)
        while k > 1 and k > min_room:
            k //= 2
        return k

    def _mark_state_dirty(self, slot_id: int) -> None:
        """A scheduling event changed ``slot_id``'s mirrors (admission,
        release, block growth, prefill completion): the next dispatch
        uploads that row."""
        self._state_cache.mark_dirty(slot_id)

    def _sync_state(self) -> None:
        """Bring the resident state up to the mirrors: the dirty rows with
        the cache on, every row with it off."""
        if self.cfg.decode_state_cache:
            self._state_cache.sync(self._mirrors)
        else:
            self._state_cache.reupload(self._mirrors)

    def _bucket_for(self, n: int) -> int:
        for b in self.cfg.buckets():
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds max_model_len={self.cfg.max_model_len}")

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def submit(self, prompt_token_ids: Sequence[int],
               params: Optional[SamplingParams] = None,
               request_id: Optional[str] = None) -> Request:
        """Enqueue a request; tokens arrive through :meth:`step`."""
        if not prompt_token_ids:
            raise ValueError("prompt must contain at least one token")
        if len(prompt_token_ids) >= self.cfg.max_model_len:
            raise ValueError(
                f"prompt ({len(prompt_token_ids)} tokens) must be shorter than "
                f"max_model_len={self.cfg.max_model_len}")
        req = Request(request_id=request_id or f"req-{next(self._req_counter)}",
                      prompt_token_ids=list(prompt_token_ids),
                      params=params or SamplingParams())
        self.waiting.append(req)
        self.stats["requests"] += 1
        return req

    def generate(self, prompts: Sequence[Sequence[int]],
                 params: Optional[SamplingParams] = None,
                 ) -> List[GenerationResult]:
        """Offline batch generation: submit all, step until drained."""
        reqs = [self.submit(p, params) for p in prompts]
        while self.has_work:
            self.step()
        return [self._result(r) for r in reqs]

    def step(self) -> List[Request]:
        """One scheduler iteration: dispatch the decode round, admit waiting
        requests (prefill), complete the decode round. Returns the requests
        the decode round finished.

        Slots admitted here were free when the decode round was set up, so
        its block tables point their rows at the trash block; they join the
        next round."""
        pending = None
        if any(not s.free for s in self.slots):
            pending = self._decode_dispatch()
        self._admit()
        if pending is None:
            return []
        return self._decode_complete(pending)

    # ------------------------------------------------------------------
    # Scheduling
    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Admit waiting requests into free slots (FCFS), then prefill them
        in batched calls grouped by length bucket."""
        admissions = []
        for slot in self.slots:
            # Cancelled while queued: finish without taking a slot.
            while self.waiting and self.waiting[0].cancel_requested:
                req = self.waiting.popleft()
                req.finish_reason = "stop"
                req.finish_time = time.monotonic()
                self.finished.append(req)
                self.telemetry.on_finished(req)
            if not self.waiting or not slot.free:
                continue
            req = self.waiting[0]
            tokens = req.prompt_token_ids + req.output_token_ids
            blocks = self.block_manager.allocate(
                self.block_manager.blocks_needed(len(tokens) + 1))
            if blocks is None:
                break  # head-of-line blocking: FCFS, no starvation
            self.waiting.popleft()
            admissions.append((slot, req, blocks))

        by_bucket: dict = {}
        for adm in admissions:
            req = adm[1]
            n = len(req.prompt_token_ids) + len(req.output_token_ids)
            by_bucket.setdefault(self._bucket_for(n), []).append(adm)
        for bucket, group in by_bucket.items():
            # Past ~8 rows a wider call's padded work outgrows its gain.
            for i in range(0, len(group), 8):
                self._prefill_group(bucket, group[i:i + 8])

    def _register_slot(self, slot: _Slot, req: Request, blocks: List[int]) -> None:
        """Host bookkeeping for an admitted request."""
        self.telemetry.on_admitted(req)
        slot.request = req
        slot.blocks = blocks
        slot.seq_len = len(req.prompt_token_ids) + len(req.output_token_ids)
        sid = slot.slot_id
        self._block_tables[sid] = 0
        self._block_tables[sid, :len(blocks)] = blocks
        self._temperature[sid] = req.params.temperature
        self._top_k[sid] = req.params.top_k
        self._top_p[sid] = req.params.top_p
        self._slot_seeds[sid] = (req.params.seed & (2 ** 63 - 1)
                                 if req.params.seed is not None
                                 else self._rng.getrandbits(63))
        # Nonzero on readmission after preemption: the seeded stream
        # continues where it left off.
        self._gen_counts[sid] = len(req.output_token_ids)
        self._mark_state_dirty(sid)

    def _prefill_group(self, bucket: int, group: List[tuple]) -> None:
        """Register the group's slots and prefill their whole context
        (prompt plus any tokens generated before a preemption)."""
        chunks = []
        for slot, req, blocks in group:
            self._register_slot(slot, req, blocks)
            chunks.append((slot, req.prompt_token_ids + req.output_token_ids))
        self._run_prefill_batch(bucket, chunks)

    def _run_prefill_batch(self, bucket: int, chunks: List[tuple]) -> None:
        """One prefill call over rows ``(slot, tokens)``, padded to a power
        of two rows; each row's first token is sampled from its last real
        logit."""
        ec = self.cfg
        B = 1
        while B < len(chunks):
            B *= 2
        nblk_needed = max(self.block_manager.blocks_needed(len(t))
                          for _, t in chunks)
        nblk_bucket = 1
        while nblk_bucket < nblk_needed:
            nblk_bucket *= 2
        nblk_bucket = min(nblk_bucket, ec.max_blocks_per_seq)

        self.stats["prefill_batches"] += 1
        ids = np.zeros((B, bucket), np.int32)
        pos = np.full((B, bucket), -1, np.int32)  # -1: written to the trash block
        bt = np.zeros((B, nblk_bucket), np.int32)
        last_idx = np.zeros((B,), np.int32)
        seeds = np.zeros((B,), np.int64)
        counts = np.zeros((B,), np.int32)
        temps = np.ones((B,), np.float32)
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        for r, (slot, tokens) in enumerate(chunks):
            sid, req = slot.slot_id, slot.request
            ids[r, :len(tokens)] = tokens
            pos[r, :len(tokens)] = np.arange(len(tokens))
            bt[r, :min(len(slot.blocks), nblk_bucket)] = slot.blocks[:nblk_bucket]
            last_idx[r] = len(tokens) - 1
            seeds[r] = self._slot_seeds[sid]
            counts[r] = self._gen_counts[sid]
            temps[r] = req.params.temperature
            top_k[r] = req.params.top_k
            top_p[r] = req.params.top_p
            self.stats["prefill_tokens"] += len(tokens)

        ex = self.executor
        last_logits = ex.prefill(ids, pos, bt, last_idx)
        toks, lps = to_host(*ex.sample(last_logits, seeds, counts, temps, top_k,
                                       top_p))
        if self.cfg.guard_nonfinite:
            bad = [slot.slot_id for r, (slot, _) in enumerate(chunks)
                   if not np.isfinite(lps[r])]
            if bad:
                self.stats["numeric_faults"] += 1
                raise NumericFault(f"nonfinite prefill output on slot(s) {bad}: "
                                   "the model is producing NaN/inf logits")
        for r, (slot, _) in enumerate(chunks):
            self._append_token(slot, int(toks[r]), float(lps[r]))
            # The first token moved the slot's count: upload its row before
            # it joins a decode window.
            self._mark_state_dirty(slot.slot_id)

    def _decode_dispatch(self):
        """Pick this round's window, grow block tables to cover it
        (preempting the youngest when the pool is exhausted; a multi-step
        window that cannot reserve its blocks shrinks to one step), bring
        the resident state up to date and launch the window. Waits on
        nothing. Returns the pending window for :meth:`_decode_complete`."""
        ec = self.cfg
        active0 = [s for s in self.slots if not s.free]
        k_steps = (self._window_steps(active0)
                   if ec.steps_per_sync > 1 and active0 else 1)

        def grow_tables(window: int) -> bool:
            for slot in sorted((s for s in self.slots if not s.free),
                               key=lambda s: s.request.arrival_time):
                if slot.free:  # preempted by an earlier iteration
                    continue
                need = self.block_manager.blocks_needed(slot.seq_len + window)
                while need > len(slot.blocks):
                    got = self.block_manager.allocate(1)
                    if got is None:
                        if not self._preempt_youngest(exclude=slot):
                            return False
                        continue
                    slot.blocks.extend(got)
                    self._block_tables[slot.slot_id, len(slot.blocks) - 1] = got[0]
                    self._mark_state_dirty(slot.slot_id)
            return True

        if not grow_tables(k_steps):
            if k_steps > 1:
                # Defer, don't fault: blocks already granted stay with their
                # slots, and table rows past one step are never read.
                self.stats["hbm_growth_deferrals"] += 1
                k_steps = 1
            if not grow_tables(k_steps):
                raise RuntimeError("KV pool exhausted and nothing to preempt; "
                                   "increase num_blocks or lower max_seqs")

        active = [s for s in self.slots if not s.free]
        if not active:
            return None
        t_prep = time.perf_counter()
        ids = np.zeros((ec.max_seqs, 1), np.int64)
        pos = np.zeros((ec.max_seqs, 1), np.int32)  # inactive -> trash block
        for s in active:
            ids[s.slot_id, 0] = s.last_token
            pos[s.slot_id, 0] = s.seq_len  # position of the new token
        self._sync_state()
        self.telemetry.host_prep.observe(time.perf_counter() - t_prep)
        tokens, logprobs = self.executor.decode_window(k_steps, ids, pos)
        if ec.decode_state_cache:
            # Every surviving slot's count advances by k; a slot that
            # finishes inside the window is released, which marks it dirty.
            self._state_cache.bump_gen_counts(k_steps)
        return active, k_steps, tokens, logprobs

    def _decode_complete(self, pending) -> List[Request]:
        """Bring the window's results to the host (its one sync) and walk
        each slot's k tokens, stopping at EOS, a stop token or a length
        limit; the rest of that slot's window is discarded. The whole window
        is checked for nonfinite logprobs before any token is appended."""
        active, k_steps, tokens, logprobs = pending
        tokens, logprobs = to_host(tokens, logprobs)  # (k, S)
        self.stats["decode_steps"] += k_steps
        if self.cfg.guard_nonfinite:
            bad = [s.slot_id for s in active
                   if not np.isfinite(logprobs[:, s.slot_id]).all()]
            if bad:
                self.stats["numeric_faults"] += 1
                raise NumericFault(f"nonfinite decode output on slot(s) {bad} "
                                   f"(window of {k_steps} step(s)): the model "
                                   "is producing NaN/inf logits")
        finished = []
        for s in active:
            req = s.request
            for j in range(k_steps):
                self.stats["decode_slot_steps"] += 1
                s.seq_len += 1  # the input token is now in the cache
                if self._append_token(s, int(tokens[j, s.slot_id]),
                                      float(logprobs[j, s.slot_id])):
                    # Its later window tokens sit past seq_len in blocks
                    # just freed: never registered, never read.
                    finished.append(req)
                    break
        return finished

    def _append_token(self, slot: _Slot, token: int, logprob: float) -> bool:
        """Record a generated token; retire the slot when finished."""
        req = slot.request
        now = time.monotonic()
        if req.first_token_time is None:
            req.first_token_time = now
            self.telemetry.on_first_token(req)
        req.output_token_ids.append(token)
        req.output_logprobs.append(logprob)
        slot.last_token = token
        self._gen_counts[slot.slot_id] = len(req.output_token_ids)
        self.stats["generated_tokens"] += 1

        reason = None
        if req.cancel_requested:
            # Server-side early cancel: finish as a normal stop.
            reason = "stop"
        elif token == self.cfg.eos_token_id or token in req.params.stop_token_ids:
            reason = "stop"
        elif len(req.output_token_ids) >= req.params.max_tokens:
            reason = "length"
        elif len(req.prompt_token_ids) + len(req.output_token_ids) >= self.cfg.max_model_len:
            reason = "length"
        if reason is None:
            return False
        req.finish_reason = reason
        req.finish_time = now
        self.finished.append(req)
        self.telemetry.on_finished(req)
        self._release(slot)
        return True

    def _release(self, slot: _Slot) -> None:
        self.block_manager.free(slot.blocks)
        slot.request = None
        slot.blocks = []
        slot.seq_len = 0
        sid = slot.slot_id
        self._block_tables[sid] = 0
        self._temperature[sid] = 1.0
        self._top_k[sid] = 0
        self._top_p[sid] = 1.0
        self._slot_seeds[sid] = 0
        self._gen_counts[sid] = 0
        self._mark_state_dirty(sid)

    def abort_all(self, reason: str = "abort") -> List[Request]:
        """Finish every running and queued request with ``reason`` and free
        their slots: the server's recovery after a faulted :meth:`step`,
        whose consumers are gone. Returns the aborted requests."""
        aborted: List[Request] = []
        for slot in self.slots:
            if slot.request is not None:
                req = slot.request
                req.finish_reason = reason
                req.finish_time = time.monotonic()
                aborted.append(req)
                self._release(slot)
        while self.waiting:
            req = self.waiting.popleft()
            req.finish_reason = reason
            req.finish_time = time.monotonic()
            aborted.append(req)
        for req in aborted:
            self.telemetry.on_finished(req)
        return aborted

    def _preempt_youngest(self, exclude: _Slot) -> bool:
        """Evict the most recently arrived sequence back to the queue head."""
        candidates = [s for s in self.slots if not s.free and s is not exclude]
        if not candidates:
            return False
        victim = max(candidates, key=lambda s: s.request.arrival_time)
        req = victim.request
        req.num_preemptions += 1
        self.stats["preemptions"] += 1
        self.waiting.appendleft(req)
        self._release(victim)
        return True

    def _result(self, req: Request) -> GenerationResult:
        return GenerationResult(
            request_id=req.request_id,
            prompt_token_ids=req.prompt_token_ids,
            output_token_ids=req.output_token_ids,
            output_logprobs=req.output_logprobs,
            finish_reason=req.finish_reason or "abort",
            ttft_s=(req.first_token_time or req.arrival_time) - req.arrival_time,
            latency_s=(req.finish_time or time.monotonic()) - req.arrival_time,
        )
