"""Continuous-batching inference engine: the port of
``dlti_tpu/serving/engine.py``'s single-step paged-KV path.

* **Two programs.** Prefill runs the admitted prompts padded to a length
  bucket, several admissions per call; decode runs every slot one token
  per step, inactive slots at position 0 against the trash block.
* **Paged KV.** One physical pool per layer on the device
  (``ops.kv_cache``, updated in place); :class:`BlockManager` hands out
  blocks; block tables are small int32 arrays copied to the device each
  call.
* **Continuous batching.** Each :meth:`InferenceEngine.step` dispatches the
  decode round, admits waiting requests into free slots (prefill), then
  completes the decode round — the reference's order. Block tables grow as
  sequences cross block boundaries; when the pool runs out the youngest
  sequence is preempted back to the queue and recomputed on readmission.
* **Sampling** is per-slot data (``serving.sampling``). A request's draws
  come from generators seeded by (its seed, tokens generated so far), so a
  seeded stream does not depend on batch company or preemption.
* **What the server needs**: a request's ``cancel_requested`` flag (set
  from any thread; a queued request finishes without a slot, a running one
  at its next token), the ``finished`` deque the server drains,
  ``abort_all`` after a faulted step, and the request-latency histograms
  (``telemetry.lifecycle``).
* **KV pool dtypes**: ``cache_dtype`` ``"bfloat16"``, ``"float32"`` or
  ``"int8"`` (per-row scales; decode through the paged kernel's int8 mode).

Not ported yet (ROADMAP.md): multi-step and speculative decode, prefix
caching and tiers, chunked and ragged prefill, the decode-state cache, the
multi-LoRA pool, int8 weights, float16 KV pools, tensor parallelism, the
memory ledger, tracer spans and critical-path attribution.
"""

from __future__ import annotations

import collections
import itertools
import random
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from dlti_tpu_torch.config import LoRAConfig, ModelConfig
from dlti_tpu_torch.models.interop import load_model
from dlti_tpu_torch.ops.kv_cache import init_paged_cache
from dlti_tpu_torch.serving.block_manager import BlockManager
from dlti_tpu_torch.serving.sampling import SamplingParams, sample_tokens
from dlti_tpu_torch.telemetry.lifecycle import RequestTelemetry
from dlti_tpu_torch.utils.device import resolve_device, resolve_dtype

_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, count: int) -> int:
    """The seed of a slot's ``count``-th draw (splitmix64 of the pair), the
    role ``jax.random.fold_in(key, count)`` plays in the reference."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(count) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1  # < 2**63


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


class EngineExecutor:
    """The device half: the model, the KV pools, and the prefill and decode
    calls. Holds no scheduling state."""

    def __init__(self, model_cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 lora_cfg: Optional[LoRAConfig] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = engine_cfg
        self.model_cfg = model_cfg
        self.model = load_model(model_cfg, params, self.device, lora_cfg)
        cache_dtype = ("int8" if engine_cfg.cache_dtype == "int8"
                       else resolve_dtype(engine_cfg.cache_dtype))
        self.cache = init_paged_cache(
            model_cfg.num_layers, engine_cfg.num_blocks, engine_cfg.block_size,
            model_cfg.num_kv_heads, model_cfg.resolved_head_dim, cache_dtype,
            device=self.device)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    @torch.no_grad()
    def prefill(self, input_ids: np.ndarray, positions: np.ndarray,
                block_table: np.ndarray, last_idx: np.ndarray) -> torch.Tensor:
        """Prefill rows ``(B, bucket)`` (padding at position -1, whose KV
        writes are dropped); returns each row's logits at ``last_idx``."""
        logits = self.model(self._t(input_ids), positions=self._t(positions),
                            cache=self.cache, block_tables=self._t(block_table))
        rows = torch.arange(logits.shape[0], device=self.device)
        return logits[rows, self._t(last_idx).long()]

    @torch.no_grad()
    def decode(self, input_ids: np.ndarray, positions: np.ndarray,
               block_tables: np.ndarray, seeds: Sequence[int],
               temperature: np.ndarray, top_k: np.ndarray, top_p: np.ndarray):
        """One decode step for every slot plus sampling; returns device
        tensors (tokens, logprobs) of shape (max_seqs,)."""
        logits = self.model(self._t(input_ids), positions=self._t(positions),
                            cache=self.cache, block_tables=self._t(block_tables))
        return self.sample(logits[:, 0], seeds, temperature, top_k, top_p)

    @torch.no_grad()
    def sample(self, logits: torch.Tensor, seeds: Sequence[int],
               temperature: np.ndarray, top_k: np.ndarray, top_p: np.ndarray):
        return sample_tokens(logits, seeds, self._t(temperature),
                             self._t(top_k), self._t(top_p))


class InferenceEngine:
    """Synchronous engine core: :meth:`submit` requests, :meth:`step` in a
    loop; :meth:`generate` is the offline batch entry point."""

    def __init__(self, model_cfg: ModelConfig, params,
                 engine_cfg: EngineConfig = EngineConfig(),
                 lora_cfg: Optional[LoRAConfig] = None, device=None):
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
        self.executor = EngineExecutor(model_cfg, params, engine_cfg, lora_cfg,
                                       device)
        self.block_manager = BlockManager(ec.num_blocks, ec.block_size)
        self.slots = [_Slot(i) for i in range(ec.max_seqs)]
        self.waiting: collections.deque = collections.deque()
        # Recently finished requests, for the server to drain their last events.
        self.finished: collections.deque = collections.deque(maxlen=256)
        self.telemetry = RequestTelemetry()
        self._rng = random.Random(0)  # seeds of requests that name none
        self._req_counter = itertools.count()

        # Host mirrors of the per-slot device inputs.
        S, MB = ec.max_seqs, ec.max_blocks_per_seq
        self._block_tables = np.zeros((S, MB), np.int32)
        self._temperature = np.ones((S,), np.float32)
        self._top_k = np.zeros((S,), np.int32)
        self._top_p = np.ones((S,), np.float32)
        self._slot_seeds = [0] * S
        self._gen_counts = np.zeros((S,), np.int32)
        self.stats = {"requests": 0, "generated_tokens": 0, "prefill_tokens": 0,
                      "preemptions": 0, "decode_steps": 0,
                      # slot x step units consumed; / (max_seqs * decode_steps)
                      # is the mean slot occupancy.
                      "decode_slot_steps": 0, "prefill_batches": 0,
                      "numeric_faults": 0}

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
        self._slot_seeds[sid] = (req.params.seed if req.params.seed is not None
                                 else self._rng.getrandbits(63))
        # Nonzero on readmission after preemption: the seeded stream
        # continues where it left off.
        self._gen_counts[sid] = len(req.output_token_ids)

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
        pos = np.full((B, bucket), -1, np.int32)  # -1: write dropped
        bt = np.zeros((B, nblk_bucket), np.int32)
        last_idx = np.zeros((B,), np.int32)
        seeds = [0] * B
        temps = np.ones((B,), np.float32)
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        for r, (slot, tokens) in enumerate(chunks):
            sid, req = slot.slot_id, slot.request
            ids[r, :len(tokens)] = tokens
            pos[r, :len(tokens)] = np.arange(len(tokens))
            bt[r, :min(len(slot.blocks), nblk_bucket)] = slot.blocks[:nblk_bucket]
            last_idx[r] = len(tokens) - 1
            seeds[r] = fold_seed(self._slot_seeds[sid], self._gen_counts[sid])
            temps[r] = req.params.temperature
            top_k[r] = req.params.top_k
            top_p[r] = req.params.top_p
            self.stats["prefill_tokens"] += len(tokens)

        ex = self.executor
        last_logits = ex.prefill(ids, pos, bt, last_idx)
        toks, lps = ex.sample(last_logits, seeds, temps, top_k, top_p)
        toks, lps = toks.cpu().numpy(), lps.cpu().numpy()
        if self.cfg.guard_nonfinite:
            bad = [slot.slot_id for r, (slot, _) in enumerate(chunks)
                   if not np.isfinite(lps[r])]
            if bad:
                self.stats["numeric_faults"] += 1
                raise NumericFault(f"nonfinite prefill output on slot(s) {bad}: "
                                   "the model is producing NaN/inf logits")
        for r, (slot, _) in enumerate(chunks):
            self._append_token(slot, int(toks[r]), float(lps[r]))

    def _decode_dispatch(self):
        """Grow block tables for this round (preempting the youngest when
        the pool is exhausted), snapshot the host mirrors and run the decode
        call. Returns the pending round for :meth:`_decode_complete`."""
        ec = self.cfg
        for slot in sorted((s for s in self.slots if not s.free),
                           key=lambda s: s.request.arrival_time):
            if slot.free:  # preempted by an earlier iteration
                continue
            need = self.block_manager.blocks_needed(slot.seq_len + 1)
            while need > len(slot.blocks):
                got = self.block_manager.allocate(1)
                if got is None:
                    if not self._preempt_youngest(exclude=slot):
                        raise RuntimeError(
                            "KV pool exhausted and nothing to preempt; "
                            "increase num_blocks or lower max_seqs")
                    continue
                slot.blocks.extend(got)
                self._block_tables[slot.slot_id, len(slot.blocks) - 1] = got[0]

        active = [s for s in self.slots if not s.free]
        if not active:
            return None
        t_prep = time.perf_counter()
        ids = np.zeros((ec.max_seqs, 1), np.int32)
        pos = np.zeros((ec.max_seqs, 1), np.int32)  # inactive -> trash block
        for s in active:
            ids[s.slot_id, 0] = s.last_token
            pos[s.slot_id, 0] = s.seq_len  # position of the new token
        seeds = [fold_seed(self._slot_seeds[i], self._gen_counts[i])
                 for i in range(ec.max_seqs)]
        self.telemetry.host_prep.observe(time.perf_counter() - t_prep)
        tokens, logprobs = self.executor.decode(
            ids, pos, self._block_tables, seeds, self._temperature,
            self._top_k, self._top_p)
        return active, tokens, logprobs

    def _decode_complete(self, pending) -> List[Request]:
        """Bring the round's results to the host and append them."""
        active, tokens, logprobs = pending
        tokens = tokens.cpu().numpy()
        logprobs = logprobs.cpu().numpy()
        self.stats["decode_steps"] += 1
        if self.cfg.guard_nonfinite:
            bad = [s.slot_id for s in active if not np.isfinite(logprobs[s.slot_id])]
            if bad:
                self.stats["numeric_faults"] += 1
                raise NumericFault(f"nonfinite decode output on slot(s) {bad}: "
                                   "the model is producing NaN/inf logits")
        finished = []
        for s in active:
            self.stats["decode_slot_steps"] += 1
            s.seq_len += 1  # the input token is now in the cache
            req = s.request
            if self._append_token(s, int(tokens[s.slot_id]),
                                  float(logprobs[s.slot_id])):
                finished.append(req)
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
