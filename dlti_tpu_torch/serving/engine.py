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
* **int8 weights** (``EngineConfig.quantization="int8"``): the embedding,
  the head and the projection kernels are quantized leaf by leaf as they
  reach the device (``models.quantization``: int8 with per-channel float32
  scales), and each is expanded to the compute dtype at its use, one layer
  at a time; in the decode graph each layer's expanded weights are freed
  after its use.
* **KV pool dtypes**: ``cache_dtype`` ``"bfloat16"``, ``"float16"``,
  ``"float32"`` or ``"int8"`` (per-row scales; decode through the paged
  kernel's int8 mode), whatever the model's dtype: the decode kernel takes
  a float32, bfloat16 or float16 query on any of them.

* **Chunked prefill** (``max_prefill_tokens_per_step``): admitted prompts
  are prefilled at most that many tokens a step, each chunk at its own
  offset (positions ``start...``, block table sized from ``start + len``);
  a slot is ``prefilling`` (masked to the trash block in decode) until its
  last chunk samples its first token. **Ragged prefill**
  (``ragged_prefill``) packs chunks of mixed lengths into shared calls.
* **Prefix caching** (``enable_prefix_caching``, ``serving.prefix_cache``):
  full blocks of retired sequences are kept content-addressed and reused
  at admission; with ``prefix_host_blocks``/``prefix_disk_blocks``
  (``serving.prefix_tiers``) evicted blocks demote to host RAM and disk and
  restore with a scatter instead of a re-prefill
  (:meth:`EngineExecutor.fetch_block_kv` / :meth:`EngineExecutor.
  restore_block`, on the stepper thread, never inside a decode dispatch).
* **N-gram speculative decode** (``speculative="ngram"``): each round
  proposes up to ``k`` draft tokens per slot by prompt lookup in the
  device-resident token history, verifies them in one ``(S, k+1)``
  forward (the gather path: the paged kernel is single-token, as in the
  reference) and scatters the accepted prefix plus a bonus token back into
  the history; ``steps_per_sync`` rounds run a host sync, one CUDA graph
  per draft length of the ladder and table width (the blocks the window
  can touch, rounded up to a power of two as the reference cuts its
  tables) replayed round by round. A per-slot gate
  pauses slots whose drafts keep failing (:meth:`InferenceEngine.
  _spec_note_slot`).
* **Multi-LoRA serving** (``adapter_slots`` > 0, ``serving.adapters``): the
  executor owns an :class:`~dlti_tpu_torch.serving.adapters.AdapterPool`
  and every forward (prefill, the decode graph, the spec graphs) applies
  each row's adapter by its pool row, a resident decode-state field
  (``adapter_ids``). A request names its adapter (``submit(...,
  adapter=)``); admission resolves the row before it takes blocks, defers
  the request while every row is pinned and fails that request alone for
  an unknown or corrupt adapter. Rows are released at finish, preemption
  and cancel, and prefix-cache keys are namespaced by the adapter. With
  ``adapter_slots = 0`` no program changes.

* **Tensor parallelism** (``mesh=`` with a tensor group,
  ``parallel.mesh.build_mesh``): every rank of the tensor group builds the
  engine, as the reference's single-process TP engine places its weights
  and pools on a ``tensor`` mesh. Each rank's executor holds its part of
  the weights (``models.interop.shard_params``: int8 weights quantized
  whole, then sliced) and a KV pool of its ``num_kv_heads / tp`` heads, on
  which the paged decode kernel runs unchanged. Rank 0 alone schedules:
  its executor mirrors each call that touches the device (prefill, the
  decode window, sampling, the resident state's writes, the graph capture)
  to the other ranks (``parallel.tensor.HostMirror``), which run
  :meth:`InferenceEngine.follow` until rank 0 calls
  :meth:`InferenceEngine.stop_followers`. Every rank samples from the same
  assembled float32 logits with the same seeds, so the resident state
  stays equal everywhere. The adapter pool, speculative decode and the
  prefix cache's host/disk tiers are refused under it (ROADMAP.md);
  plain prefix reuse, chunked and ragged prefill, int8 pools and int8
  weights run. A CUDA graph needs NCCL: under gloo (``launcher
  --one-device``) the executor must run eagerly.

* **Paged-KV handoff** (:meth:`InferenceEngine.export_handoff` /
  :meth:`InferenceEngine.adopt_handoff`): a decoding slot's written blocks
  travel device -> host -> device (the prefix tiers' transport) with what
  its next decode step needs to sample the token the origin would have,
  so a replica fleet (``serving.replicas``) migrates live decodes off a
  draining replica without a re-prefill. :meth:`InferenceEngine.resubmit`
  re-enqueues a failed-over request with its tokens so far.

Not ported yet (ROADMAP.md): the native block allocator, the
disaggregation controller, the memory ledger and headroom-aware admission,
the token-storm guard, tracer spans and critical-path attribution.
"""

from __future__ import annotations

import collections
import itertools
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dlti_tpu_torch.config import LoRAConfig, ModelConfig
from dlti_tpu_torch.models.interop import load_model, shard_params
from dlti_tpu_torch.models.quantization import quantize_params_int8
from dlti_tpu_torch.ops.kv_cache import init_paged_cache
from dlti_tpu_torch.ops.launches import GraphLaunches
from dlti_tpu_torch.parallel.tensor import HostMirror, mirrored
from dlti_tpu_torch.serving.adapters import AdapterError, AdapterPool
from dlti_tpu_torch.serving.block_manager import BlockManager
from dlti_tpu_torch.serving.decode_state import FIELDS, DecodeStateCache
from dlti_tpu_torch.serving.prefix_cache import PrefixCachingAllocator
from dlti_tpu_torch.serving.prefix_tiers import TieredBlockStore
from dlti_tpu_torch.serving.sampling import SamplingParams, sample_tokens
from dlti_tpu_torch.telemetry.lifecycle import RequestTelemetry
from dlti_tpu_torch.utils.device import (
    resolve_device, resolve_dtype, to_host, upload,
)

logger = logging.getLogger("dlti_tpu_torch.serving")

# The speculative-decode /metrics names (the reference's; the server's spec
# scalar source renders them from the engine's stats dict).
SPEC_METRIC_NAMES = (
    "dlti_spec_proposed_total",
    "dlti_spec_accepted_total",
    "dlti_spec_paused_rounds_total",
    "dlti_spec_acceptance_rate",
    "dlti_spec_draft_len",
)

@dataclass
class EngineConfig:
    """Engine sizing (the reference's fields of the same names)."""

    max_seqs: int = 8              # decode batch slots
    block_size: int = 16           # tokens per KV block
    num_blocks: int = 256          # physical pool size (per layer)
    max_model_len: int = 512       # max prompt+generation length per request
    prefill_buckets: Sequence[int] = ()  # default: powers of 2 up to max_model_len
    cache_dtype: str = "bfloat16"  # "bfloat16" | "float16" | "float32" | "int8"
    eos_token_id: int = 2          # Llama-2 </s>
    # Automatic prefix caching (serving.prefix_cache): retired sequences'
    # full KV blocks are kept content-addressed and reused by later
    # requests sharing a prompt prefix; unreferenced blocks are evicted LRU
    # under pool pressure.
    enable_prefix_caching: bool = False
    # Prefix-cache tiers (serving.prefix_tiers): with a host and/or disk
    # budget (and prefix caching on), evicted blocks demote device -> host
    # RAM -> disk instead of being discarded, and a prefix match that runs
    # past the device blocks restores lower-tier blocks with a scatter.
    # Budgets in blocks; 0 = that tier off.
    prefix_host_blocks: int = 0
    prefix_disk_dir: str = ""
    prefix_disk_blocks: int = 0
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
    # Weight-only quantization: "int8" stores the matmul weights as int8 +
    # per-channel scales, expanded at use; "none" keeps param_dtype.
    quantization: str = "none"
    # Speculative decoding: "ngram" proposes draft tokens by prompt lookup
    # (match the trailing n-gram against earlier context, copy what
    # followed) and verifies them in a (k+1)-position forward, greedy-exact
    # up to the numerics of a wider forward. steps_per_sync such rounds run
    # per host sync. Sampling slots in the batch take their position-0
    # draw from the same (seed, count) stream as plain decode.
    speculative: str = "none"          # "none" | "ngram"
    num_draft_tokens: int = 4
    ngram_size: int = 2
    # Per-slot gate: a slot's probe window closes after spec_probe_window
    # rounds; if its drafts found lookup hits in that window and their mean
    # accepted tokens per hit round is below spec_min_acceptance, the slot
    # stops proposing for spec_cooldown engine rounds. 0.0 disables the
    # gate (always speculate).
    spec_min_acceptance: float = 0.25
    spec_probe_window: int = 64
    spec_cooldown: int = 32
    # Draft-length ladder: pick each round's k from num_draft_tokens, /2,
    # ..., 1 by the participants' smoothed acceptance. False pins
    # k = num_draft_tokens.
    spec_adaptive: bool = True
    # Ragged multi-admission prefill: pack chunks of mixed lengths FCFS into
    # shared calls bounded by padded total tokens instead of one call per
    # length bucket. Outputs are identical either way; calls are fewer.
    ragged_prefill: bool = False
    # Chunked prefill: cap prompt tokens prefilled per engine step, so
    # admission never stalls running decodes for a whole prompt length.
    # 0 = unbounded (whole prompts in one batched call per bucket).
    max_prefill_tokens_per_step: int = 0
    # Multi-LoRA serving (serving.adapters): with adapter_slots > 0 the
    # executor holds a stacked adapter pool ((slots+1, in, r) and (slots+1,
    # r, out) per targeted projection, row 0 the all-zero base) and every
    # forward gathers each row's factors by its pool row. adapter_rank is
    # the pool-wide maximum (smaller adapters zero-pad, exactly);
    # adapter_targets name the projections the pool covers. 0 slots leave
    # every program as it is without a pool.
    adapter_slots: int = 0
    adapter_rank: int = 16
    adapter_targets: Sequence[str] = ("q_proj", "k_proj", "v_proj", "o_proj")

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
    # Multi-LoRA serving: the registered adapter this request generates
    # under ("" = the base model), and its resolved pool row (-1 =
    # unresolved). The row is acquired at admission and released with the
    # slot, so a preempted request acquires again (its row may have been
    # evicted meanwhile).
    adapter: str = ""
    _adapter_slot: int = -1
    # Replica fleets (serving.replicas): the replica that owns the request,
    # failover resubmissions it consumed, and live migrations it survived.
    replica: int = 0
    num_retries: int = 0
    num_migrations: int = 0

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
        # Chunked prefill, as positions into the request's (prompt +
        # output) tokens: next_pos = where the next chunk starts,
        # prefill_end = one past the last prompt token. A slot with
        # next_pos < prefill_end is admitted but not yet decodable.
        self.next_pos = 0
        self.prefill_end = 0

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def prefilling(self) -> bool:
        return self.request is not None and self.next_pos < self.prefill_end


class BlockPayload(dict):
    """A fetched block: ``{"l00000": {"k": rows, "v": rows, ...}, ...}`` of
    host tensors. On the card their device -> host copies may still be in
    flight; :meth:`wait` blocks until they have landed."""

    event = None

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def spec_hist_width(ec: EngineConfig) -> int:
    """Token-history row width: positions 0..max_model_len-1, one slack cell
    for the in-flight input token, and the last cell a scratch cell that
    absorbs masked scatter writes."""
    return ec.max_model_len + ec.num_draft_tokens + 2


def decode_mirrors(ec: EngineConfig) -> Dict[str, np.ndarray]:
    """Fresh host mirrors of the per-slot decode state, in
    ``serving.decode_state.FIELDS`` order (plus ``adapter_ids``, each slot's
    adapter-pool row, with a pool, and ``spec_hist``, each slot's tokens at
    their context positions, with speculation on); a free slot's row holds
    these values."""
    S = ec.max_seqs
    m = {"block_tables": np.zeros((S, ec.max_blocks_per_seq), np.int32),
         "slot_seeds": np.zeros((S,), np.int64),
         "gen_counts": np.zeros((S,), np.int32),
         "temperature": np.ones((S,), np.float32),
         "top_k": np.zeros((S,), np.int32),
         "top_p": np.ones((S,), np.float32)}
    if ec.adapter_slots > 0:
        m["adapter_ids"] = np.zeros((S,), np.int64)
    if ec.speculative == "ngram":
        m["spec_hist"] = np.zeros((S, spec_hist_width(ec)), np.int64)
    return m


def spec_ladder(kmax: int) -> List[int]:
    """The draft lengths a spec round may take: kmax, kmax//2, ..., 1."""
    out, k = [], kmax
    while k >= 1:
        out.append(k)
        k //= 2
    return out


def spec_widths(max_blocks: int) -> List[int]:
    """The block-table widths a spec round may attend through: the powers
    of two below ``max_blocks``, and ``max_blocks``."""
    out, w = [], 1
    while w < max_blocks:
        out.append(w)
        w *= 2
    return out + [max_blocks]


def propose_drafts(hist: torch.Tensor, seq_len: torch.Tensor, k: int,
                   n: int) -> torch.Tensor:
    """Prompt-lookup drafts ``(S, k)`` (-1 = none): match each row's
    trailing ``n``-gram (ending at its input token, ``hist[seq_len]``)
    against every earlier ``n``-gram wholly inside its context and copy the
    ``k`` tokens that followed the most recent hit, cut at ``seq_len``. The
    reference's ``propose``, in fixed-shape tensor ops."""
    S, W = hist.shape
    rows = torch.arange(S, device=hist.device)
    ar_n = torch.arange(n, device=hist.device)
    start = (seq_len + 1 - n).clamp(0, W - n)
    tails = hist[rows[:, None], start[:, None] + ar_n[None, :]]        # (S, n)
    eq = torch.ones((S, W - n + 1), dtype=torch.bool, device=hist.device)
    for j in range(n):
        eq &= hist[:, j:W - n + 1 + j] == tails[:, j:j + 1]
    ii = torch.arange(W - n + 1, device=hist.device)[None, :]
    valid = eq & (ii <= (seq_len - n)[:, None]) & (seq_len >= n)[:, None]
    found = valid.any(dim=1)
    best = torch.where(valid, ii, -1).amax(dim=1)
    j = torch.arange(k, device=hist.device)[None, :]
    first = (best + n).clamp(0, W - k)
    drafts = hist[rows[:, None], first[:, None] + j]
    ok = found[:, None] & ((best + n)[:, None] + j <= seq_len[:, None])
    return torch.where(ok, drafts, -1)


class EngineExecutor:
    """The device half: the model, the KV pools, the resident decode state
    and the prefill, decode and speculative calls, and the block transport
    of the prefix tiers. Holds no scheduling state.

    A decode window reads static buffers: ``ids`` and ``pos`` ``(S, 1)``,
    the resident state (``self.state``) and the KV pools, and writes step
    j's tokens and logprobs into row j of ``(steps_per_sync, S)`` outputs.
    A spec window reads ``t_in``, ``seq_len`` and the proposal mask ``(S,)``
    and the resident token history, and writes round r's tokens, logprobs
    ``(S, k+1)`` and emitted, proposed and accepted counts ``(S,)`` into
    row r of its outputs. On a CUDA device one decode iteration and one
    spec round per (ladder length, table width) are captured as CUDA
    graphs (sharing one memory pool) and replayed; ``cuda_graphs=False`` runs them eagerly on
    the card instead (for tests and ``chip_smoke.py`` only). A capture that
    fails raises.

    ``mesh`` with a tensor group: this rank's part of the model and the
    pools (see the module docstring); ``params`` whole or already this
    rank's part (``init_params(..., mesh=)``).
    """

    def __init__(self, model_cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 lora_cfg: Optional[LoRAConfig] = None, device=None, *,
                 cuda_graphs: bool = True, donate_params: bool = False, mesh=None):
        self.device = dev = resolve_device(device)
        self.cfg = ec = engine_cfg
        self.model_cfg = model_cfg
        if ec.quantization not in ("none", "int8"):
            raise ValueError(f"unknown quantization {ec.quantization!r}")
        if ec.speculative not in ("none", "ngram"):
            raise ValueError(f"unknown speculative mode {ec.speculative!r}")
        tensor = mesh if mesh is not None and mesh.tensor_parallel else None
        self.mesh = tensor
        self.mirror: Optional[HostMirror] = None
        if tensor is not None:
            check_tensor_engine(ec, tensor, cuda_graphs and dev.type == "cuda")
            # Leaf by leaf: int8 weights quantized whole, then sliced.
            params = shard_params(params if donate_params else dict(params), tensor,
                                  model_cfg, lora_cfg, device=dev,
                                  quantize=ec.quantization == "int8", donate=True)
            if tensor.tp > 1:
                self.mirror = HostMirror(tensor)
        elif ec.quantization == "int8":
            # Leaf by leaf onto the device; with donate_params each source
            # leaf is let go (popped from the caller's dict) as it is done.
            params = quantize_params_int8(params if donate_params else dict(params),
                                          device=dev, donate=True)
        self.model = load_model(model_cfg, params, dev, lora_cfg, mesh=tensor)
        del params
        # The multi-LoRA pool, sized from the model's final (possibly int8)
        # projection shapes, on the engine's device.
        self.adapter_pool: Optional[AdapterPool] = None
        if ec.adapter_slots > 0:
            self.adapter_pool = AdapterPool(
                dict(self.model.named_parameters()), ec.adapter_slots,
                ec.adapter_rank, ec.adapter_targets, device=dev)
        cache_dtype = ("int8" if ec.cache_dtype == "int8"
                       else resolve_dtype(ec.cache_dtype))
        # This rank's KV heads: all of them without tensor parallelism.
        kv_heads = model_cfg.num_kv_heads // (1 if tensor is None else tensor.tp)
        self.cache = init_paged_cache(
            model_cfg.num_layers, ec.num_blocks, ec.block_size,
            kv_heads, model_cfg.resolved_head_dim, cache_dtype, device=dev)
        self.state = DecodeStateCache(decode_mirrors(ec), dev)
        self.state.mirror = self.mirror
        S, K = ec.max_seqs, max(1, ec.steps_per_sync)
        # ids, positions, this window's counts, step index, outputs.
        self._bufs = (torch.zeros((S, 1), dtype=torch.long, device=dev),
                      torch.zeros((S, 1), dtype=torch.int32, device=dev),
                      torch.zeros((S,), dtype=torch.int32, device=dev),
                      torch.zeros((1,), dtype=torch.long, device=dev),
                      torch.zeros((K, S), dtype=torch.long, device=dev),
                      torch.zeros((K, S), dtype=torch.float32, device=dev))
        self.spec_on = ec.speculative == "ngram"
        # Spec rounds: t_in, seq_len, counts, proposal mask, round index;
        # outputs per ladder length k.
        self._spec_bufs = (torch.zeros((S,), dtype=torch.long, device=dev),
                           torch.zeros((S,), dtype=torch.long, device=dev),
                           torch.zeros((S,), dtype=torch.int32, device=dev),
                           torch.zeros((S,), dtype=torch.bool, device=dev),
                           torch.zeros((1,), dtype=torch.long, device=dev))
        self._spec_out: Dict[int, tuple] = {}
        self.cuda_graphs = cuda_graphs and dev.type == "cuda"
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches = GraphLaunches()
        # By (draft length, table width).
        self.spec_graphs: Dict[tuple, torch.cuda.CUDAGraph] = {}
        self.spec_launches: Dict[tuple, GraphLaunches] = {}
        # One memory pool for every captured graph (they never run at
        # once); its size is what the captures added to the reserved bytes
        # (the verify forward's gathered windows are most of it).
        self._pool = None
        self._capture_stream = None
        self.graph_pool_bytes = 0
        # Block fetches for the prefix tiers that failed (each such block
        # was discarded instead of demoted).
        self.fetch_failures = 0

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    def _decode_iteration(self, bufs, state) -> None:
        """One decode iteration over every slot, in place: forward, sample,
        write row ``step`` of the outputs, then ids <- token, pos += 1,
        counts += 1, step += 1 (every row, like the reference's scan;
        inactive rows have all-zero tables and keep writing the trash
        block). With speculation on, the token also lands in the resident
        history at its context position."""
        ids, pos, cnt, step, out_tok, out_lp = bufs
        tables, seeds, _, temperature, top_k, top_p = state[:len(FIELDS)]
        logits = self.model(ids, positions=pos, cache=self.cache,
                            block_tables=tables, **self._adapter_args(state))
        tok, lp = sample_tokens(logits[:, 0], seeds, cnt, temperature, top_k,
                                top_p)
        hist = self.state.field("spec_hist", state)
        if hist is not None:
            # Rows of free and prefilling slots write garbage here; their
            # rows upload whole before they decode.
            rows = torch.arange(hist.shape[0], device=hist.device)
            hist.index_put_((rows, pos[:, 0].long() + 1), tok)
        out_tok.index_copy_(0, step, tok[None])
        out_lp.index_copy_(0, step, lp[None])
        ids.copy_(tok[:, None])
        pos.add_(1)
        cnt.add_(1)
        step.add_(1)

    def _adapter_args(self, state=None, adapter_ids=None) -> dict:
        """The model's multi-LoRA arguments: each row's pool row (the
        resident ``adapter_ids`` of ``state``, or ``adapter_ids``) and the
        pool's per-layer tensors; nothing without a pool."""
        if self.adapter_pool is None:
            return {}
        if adapter_ids is None:
            adapter_ids = self.state.field("adapter_ids", state)
        return {"adapter_ids": adapter_ids, "adapters": self.adapter_pool.layers}

    def _capture(self, run, launches: GraphLaunches, static_args: list
                 ) -> torch.cuda.CUDAGraph:
        """Capture ``run(*static_args, state)`` as a CUDA graph
        in the shared pool. An eager warm-up first builds what the first
        call builds lazily (the kernel library, RoPE tables, cuBLAS state)
        on a side stream, on zeroed copies of the buffers and a zeroed block
        table, so it writes nothing but the trash block, whose rows a
        mixture of experts then puts back: it routes padding rows that
        attend over it, so a graphed engine must hold the eager one's.
        The capture itself launches nothing: the launch counters it moved
        are put back and credited to each replay instead."""
        with torch.cuda.device(self.device):
            trash = [{name: t[0].clone() for name, t in layer.items()}
                     for layer in self.cache] if self.model_cfg.num_experts > 0 else []
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run(*[torch.zeros_like(a) for a in static_args],
                    [torch.zeros_like(t) for t in self.state.tensors])
            torch.cuda.current_stream().wait_stream(side)
            for layer, saved in zip(self.cache, trash):
                for name, t in saved.items():
                    layer[name][0].copy_(t)
            del trash
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            # torch.cuda.graph empties the allocator's cache on entry: empty
            # it first, so the reserved bytes grow by the capture's pool alone.
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            if self._capture_stream is None:
                # A capture stream of this device: torch.cuda.graph's own is
                # one per process, made on the device of its first capture,
                # and an engine on another card (a replica fleet's) would
                # launch off it and invalidate the capture.
                self._capture_stream = torch.cuda.Stream(self.device)
            with launches.capturing(), torch.cuda.graph(
                    graph, pool=self._pool, stream=self._capture_stream,
                    capture_error_mode="thread_local"):
                run(*static_args, self.state.tensors)
            self.graph_pool_bytes += torch.cuda.memory_reserved(self.device) - before
        return graph

    @torch.no_grad()
    @mirrored()
    def capture(self) -> None:
        """Capture the decode iteration as a CUDA graph (once; later calls
        return at once)."""
        if not self.cuda_graphs or self.graph is not None:
            return
        self.graph = self._capture(
            lambda *a: self._decode_iteration(a[:-1], a[-1]),
            self.launches, list(self._bufs))

    @torch.no_grad()
    @mirrored()
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

    # ------------------------------------------------------------------
    # Speculative decode
    # ------------------------------------------------------------------
    def _spec_outputs(self, k: int) -> tuple:
        out = self._spec_out.get(k)
        if out is None:
            R, S, dev = max(1, self.cfg.steps_per_sync), self.cfg.max_seqs, self.device
            out = self._spec_out[k] = (
                torch.zeros((R, S, k + 1), dtype=torch.long, device=dev),
                torch.zeros((R, S, k + 1), dtype=torch.float32, device=dev),
                torch.zeros((R, S), dtype=torch.long, device=dev),
                torch.zeros((R, S), dtype=torch.long, device=dev),
                torch.zeros((R, S), dtype=torch.long, device=dev))
        return out

    def _spec_round(self, k: int, width: int, bufs, out, state) -> None:
        """One propose -> verify -> accept round over every slot, in place
        (the reference's ``_build_spec_decode_fn`` body), attending through
        the first ``width`` blocks of each table:

        1. place each slot's input token in its history at ``seq_len`` and
           propose up to ``k`` drafts by prompt lookup; masked slots
           (sampling, paused, inactive) get none;
        2. one forward over ``(S, k+1)`` positions ``seq_len...`` (the
           gather path); its KV writes past a slot's accepted prefix are
           garbage at positions the next round or decode step overwrites
           before any query attends to them;
        3. greedy slots emit the longest draft prefix that matches the
           argmax plus one bonus token; every slot's first token is the
           plain decode draw for its (seed, count), so sampling slots
           advance one token exactly as in plain decode;
        4. scatter the emitted tokens into the history (the rest of the
           lanes into the scratch cell), write row ``step`` of the outputs
           and advance ``t_in``, ``seq_len``, the counts and ``step``.
        """
        t_in, seq_len, cnt, mask, step = bufs
        toks_o, lps_o, emit_o, prop_o, acc_o = out
        tables, seeds, _, temperature, top_k, top_p = state[:len(FIELDS)]
        hist = self.state.field("spec_hist", state)
        tables = tables[:, :width]
        S, W = hist.shape
        dev = hist.device
        rows = torch.arange(S, device=dev)
        ar = torch.arange(k + 1, device=dev)
        hist.index_put_((rows, seq_len), t_in)
        drafts = propose_drafts(hist, seq_len, k, self.cfg.ngram_size)
        drafts = torch.where(mask[:, None], drafts, -1)
        ids = torch.cat([t_in[:, None], drafts.clamp(min=0)], dim=1)
        pos = (seq_len[:, None] + ar[None, :]).to(torch.int32)
        logits = self.model(ids, positions=pos, cache=self.cache, block_tables=tables,
                            **self._adapter_args(state))         # (S, k+1, V)
        g = logits.argmax(dim=-1)
        g_lp = (torch.gather(logits, 2, g[..., None])[..., 0]
                - torch.logsumexp(logits, dim=-1))
        s_tok, s_lp = sample_tokens(logits[:, 0], seeds, cnt, temperature,
                                    top_k, top_p)
        eq = (drafts == g[:, :k]) & (drafts >= 0)
        m = torch.cumprod(eq.long(), dim=1).sum(dim=1)
        emit = torch.where(temperature == 0.0, m + 1, 1)
        toks = torch.cat([s_tok[:, None], g[:, 1:]], dim=1)
        lps = torch.cat([s_lp[:, None], g_lp[:, 1:]], dim=1)
        cols = torch.where(ar[None, :] < emit[:, None],
                           seq_len[:, None] + 1 + ar[None, :], W - 1)
        hist.index_put_((rows[:, None].expand(S, k + 1), cols), toks)
        t_next = torch.gather(toks, 1, (emit - 1)[:, None])[:, 0]
        toks_o.index_copy_(0, step, toks[None])
        lps_o.index_copy_(0, step, lps[None])
        emit_o.index_copy_(0, step, emit[None])
        prop_o.index_copy_(0, step, (drafts >= 0).sum(dim=1)[None])
        acc_o.index_copy_(0, step, m[None])
        t_in.copy_(t_next)
        seq_len.add_(emit)
        cnt.add_(emit.to(cnt.dtype))
        step.add_(1)

    @torch.no_grad()
    def capture_spec(self, k: int, width: int) -> None:
        """Capture one spec round at draft length ``k`` through ``width``
        table blocks as a CUDA graph (once per pair)."""
        if not self.cuda_graphs or (k, width) in self.spec_graphs:
            return
        launches = self.spec_launches[k, width] = GraphLaunches()
        self.spec_graphs[k, width] = self._capture(
            lambda *a: self._spec_round(k, width, a[0:5], a[5:10], a[-1]), launches,
            [*self._spec_bufs, *self._spec_outputs(k)])

    @torch.no_grad()
    def spec_window(self, k: int, width: int, rounds: int, t_in: np.ndarray,
                    seq_len: np.ndarray, mask: np.ndarray):
        """``rounds`` spec rounds at draft length ``k``, attending through
        the first ``width`` blocks of each table, from the host's
        ``t_in``/``seq_len``/``mask`` ``(S,)`` over the resident state.
        Leaves the resident generated counts advanced by what each slot
        emitted. Returns device tensors (tokens, logprobs ``(R, S, k+1)``,
        emitted, proposed, accepted ``(R, S)``), valid until the next
        window. Waits on nothing."""
        bt_in, bseq, cnt, bmask, step = self._spec_bufs
        out = self._spec_outputs(k)
        if rounds > out[0].shape[0]:
            raise ValueError(f"{rounds} rounds exceed steps_per_sync="
                             f"{out[0].shape[0]}")
        upload(t_in, self.device, out=bt_in)
        upload(seq_len, self.device, out=bseq)
        upload(mask, self.device, out=bmask)
        cnt.copy_(self.state.gen_counts)
        step.zero_()
        if self.cuda_graphs:
            self.capture_spec(k, width)
            with torch.cuda.device(self.device):
                for _ in range(rounds):
                    self.spec_graphs[k, width].replay()
            self.spec_launches[k, width].credit(rounds)
        else:
            for _ in range(rounds):
                self._spec_round(k, width, self._spec_bufs, out, self.state.tensors)
        self.state.gen_counts.copy_(cnt)
        return tuple(o[:rounds] for o in out)

    # ------------------------------------------------------------------
    # Prefill and sampling
    # ------------------------------------------------------------------
    @torch.no_grad()
    @mirrored()
    def prefill(self, input_ids: np.ndarray, positions: np.ndarray,
                block_table: np.ndarray, last_idx: np.ndarray,
                adapter_ids: Optional[np.ndarray] = None) -> torch.Tensor:
        """Prefill rows ``(B, bucket)`` at their own positions (padding at
        position -1, whose KV writes go to the trash block); returns each
        row's logits at ``last_idx``. ``adapter_ids`` ``(B,)``: each row's
        adapter-pool row (needed with a pool). Waits on nothing."""
        dev = self.device
        extra = (self._adapter_args(adapter_ids=upload(adapter_ids, dev))
                 if self.adapter_pool is not None else {})
        logits = self.model(upload(input_ids, dev),
                            positions=upload(positions, dev), cache=self.cache,
                            block_tables=upload(block_table, dev), **extra)
        rows = torch.arange(logits.shape[0], device=dev)
        return logits[rows, upload(last_idx, dev).long()]

    @torch.no_grad()
    @mirrored()
    def sample(self, logits: torch.Tensor, seeds: np.ndarray, counts: np.ndarray,
               temperature: np.ndarray, top_k: np.ndarray, top_p: np.ndarray):
        dev = self.device
        return sample_tokens(logits, upload(seeds, dev), upload(counts, dev),
                             upload(temperature, dev), upload(top_k, dev),
                             upload(top_p, dev))

    # ------------------------------------------------------------------
    # Tensor parallelism: the followers
    # ------------------------------------------------------------------
    def follow(self) -> None:
        """A follower's loop (a tensor rank above 0): make each device call
        the leader mirrors, in its order, until the leader stops. A mirrored
        ``sample`` reads the logits of the last mirrored ``prefill``."""
        if self.mirror is None or self.mirror.leads:
            raise RuntimeError("follow() runs on a tensor rank above 0 only")
        last = None
        while True:
            op, args = self.mirror.receive()
            if op == "stop":
                return
            owner, _, name = op.rpartition(".")
            if name == "sample":
                args[0] = last
            out = getattr(self.state if owner == "state" else self, name)(*args)
            if name == "prefill":
                last = out

    def stop_followers(self) -> None:
        """Release the followers from :meth:`follow` (the leader; once)."""
        m = self.mirror
        if m is not None and m.leads and not m.stopped:
            m.stopped = True
            m.send("stop", ())

    def release(self) -> None:
        """Drop the model, the KV pools, the adapter pool and the captured
        graphs, so their device memory is free before a replacement engine
        is built (a replica fleet's rebuild). The executor runs no call
        afterwards."""
        self.model = None
        self.cache = []
        self.adapter_pool = None
        self.graph = None
        self.spec_graphs = {}
        self._spec_out = {}
        self._pool = None
        self._capture_stream = None

    # ------------------------------------------------------------------
    # Block transport (prefix-tier demotion and restore)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def fetch_block_kv(self, block: int) -> Optional["BlockPayload"]:
        """One physical block's KV rows from every layer pool, copied
        device -> host into pinned buffers, queued on the compute stream
        without waiting: the copies read the block before any later call
        can overwrite it, and a host reader of the bytes calls
        :meth:`BlockPayload.wait` first (the disk tier does; the host tier
        and a restore need not). Runs on the stepper thread. The payload
        keys are the reference's disk format (``"l00000": {"k", "v"}``,
        plus ``k_scale``/``v_scale`` for an int8 pool). A failure is
        logged and counted and returns None: the block is discarded
        instead of demoted."""
        try:
            cuda = self.device.type == "cuda"
            out = BlockPayload()
            for i, layer in enumerate(self.cache):
                rows = {}
                for name, t in layer.items():
                    if cuda:
                        h = torch.empty(t.shape[1:], dtype=t.dtype, pin_memory=True)
                        h.copy_(t[block], non_blocking=True)
                    else:
                        h = t[block].clone()
                    rows[name] = h
                out[f"l{i:05d}"] = rows
            if cuda:
                out.event = torch.cuda.Event()
                out.event.record(torch.cuda.current_stream(self.device))
        except Exception as e:  # noqa: BLE001 - a demotion is best effort
            self.fetch_failures += 1
            logger.warning("block KV fetch failed (%s: %s); block discarded",
                           type(e).__name__, e)
            return None
        return out

    @torch.no_grad()
    def restore_block(self, block: int, payload: dict) -> None:
        """Scatter a fetched payload into physical ``block`` of every layer
        pool, on the compute stream without blocking (host rows are staged
        in pinned memory), so the next prefill or decode call sees it."""
        cuda = self.device.type == "cuda"
        for i, layer in enumerate(self.cache):
            rows = payload[f"l{i:05d}"]
            for name, t in layer.items():
                src = rows[name]
                if not isinstance(src, torch.Tensor):
                    src = torch.from_numpy(np.ascontiguousarray(src))
                src = src.to(t.dtype)
                if cuda and not src.is_pinned():
                    src = src.pin_memory()
                t[block].copy_(src, non_blocking=True)


def check_tensor_engine(ec: EngineConfig, mesh, cuda_graphs: bool) -> None:
    """Raise for what a tensor-parallel engine does not run (``mesh``: a
    mesh with a tensor group)."""
    refused = [what for what, on in (
        ("the adapter pool (adapter_slots)", ec.adapter_slots > 0),
        ("n-gram speculative decode", ec.speculative != "none"),
        ("the prefix cache's host/disk tiers",
         ec.prefix_host_blocks > 0 or ec.prefix_disk_blocks > 0)) if on]
    if refused:
        raise NotImplementedError(f"tensor={mesh.tp}: {', '.join(refused)} under tensor "
                                  "parallelism is not ported yet (see ROADMAP.md)")
    if mesh.parallel.data * mesh.parallel.fsdp * mesh.ep > 1:
        raise ValueError("a serving mesh may only extend the tensor axis (batch-level "
                         "scaling is a replica concern)")
    if cuda_graphs and dist.get_backend(mesh.tensor_group) != "nccl":
        raise ValueError(f"the decode graph captures the tensor group's collectives, "
                         f"which needs NCCL; the group runs "
                         f"{dist.get_backend(mesh.tensor_group)}: pass cuda_graphs=False "
                         "(EngineExecutor) to decode eagerly")


class InferenceEngine:
    """Synchronous engine core: :meth:`submit` requests, :meth:`step` in a
    loop; :meth:`generate` is the offline batch entry point."""

    def __init__(self, model_cfg: ModelConfig, params,
                 engine_cfg: EngineConfig = EngineConfig(),
                 lora_cfg: Optional[LoRAConfig] = None, device=None,
                 executor: Optional[EngineExecutor] = None,
                 donate_params: bool = False, mesh=None,
                 telemetry: Optional[RequestTelemetry] = None):
        """``executor``: a prebuilt :class:`EngineExecutor` for this model
        and ``engine_cfg`` (how a caller runs the card eagerly:
        ``EngineExecutor(..., cuda_graphs=False)``); built here by default,
        and then ``params`` is loaded into it. ``donate_params``: under
        ``quantization="int8"`` or a tensor group each leaf of ``params``
        (a dict) is popped as it is placed, so its source is freed unless
        the caller holds it elsewhere. ``mesh``: a mesh with a tensor group
        (every rank of it builds the engine; see the module docstring).
        ``telemetry``: request histograms shared with other engines (a
        replica fleet's); a fresh set by default."""
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
                                      device, donate_params=donate_params, mesh=mesh)
        elif executor.cfg != engine_cfg or executor.model_cfg != model_cfg:
            raise ValueError("the executor was built for another configuration")
        self.executor = executor
        self.block_manager = BlockManager(ec.num_blocks, ec.block_size)
        self.prefix_cache = None
        if ec.enable_prefix_caching:
            tier_store = None
            if ec.prefix_host_blocks > 0 or ec.prefix_disk_blocks > 0:
                tier_store = TieredBlockStore(
                    host_blocks=ec.prefix_host_blocks,
                    disk_dir=ec.prefix_disk_dir,
                    disk_blocks=ec.prefix_disk_blocks)
            self.prefix_cache = PrefixCachingAllocator(
                self.block_manager, tier_store=tier_store,
                kv_fetch=executor.fetch_block_kv if tier_store is not None
                else None)
        self.slots = [_Slot(i) for i in range(ec.max_seqs)]
        self.waiting: collections.deque = collections.deque()
        # Recently finished requests, for the server to drain their last events.
        self.finished: collections.deque = collections.deque(maxlen=256)
        self.telemetry = telemetry if telemetry is not None else RequestTelemetry()
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
        # Each slot's adapter-pool row (0, the base, for free slots and base
        # requests); with no pool, a host array the device never reads.
        self._adapter_ids = self._mirrors.get("adapter_ids",
                                              np.zeros((ec.max_seqs,), np.int64))
        # Each slot's tokens at their context positions: the spec rounds'
        # proposal input, kept incrementally at admission and append. Cells
        # past a slot's length are never read, so stale tails need no
        # zeroing.
        self._spec_hist = self._mirrors.get("spec_hist")
        # The per-slot gate (see _spec_note_slot): rounds in the open probe
        # window, the rounds among them whose lookup found a draft, the
        # draft tokens accepted in them, cooldown rounds left, and the
        # smoothed accepted-drafts-per-round estimate behind the draft
        # length (seeded at full k, so a fresh slot probes the widest).
        S = ec.max_seqs
        self._spec_slot_prop = np.zeros((S,), np.int64)
        self._spec_slot_hits = np.zeros((S,), np.int64)
        self._spec_slot_acc = np.zeros((S,), np.int64)
        self._spec_slot_pause = np.zeros((S,), np.int32)
        self._spec_slot_ewma = np.full((S,), float(ec.num_draft_tokens), np.float64)
        # Draft length of the last dispatched round (0: plain decode).
        self._spec_last_k = 0
        # The resident state's counters (decode_state_uploads, _rows,
        # _clean_syncs) live in the same dict; they stay 0 with the cache
        # off, as in the reference.
        self._state_cache = self.executor.state
        self.stats = self._state_cache.stats
        self.stats.update({
            "requests": 0, "generated_tokens": 0, "prefill_tokens": 0,
            "preemptions": 0,
            # Device decode steps: k per window of k (a spec window of R
            # rounds counts R).
            "decode_steps": 0,
            # slot x step units consumed; / (max_seqs * decode_steps) is the
            # mean slot occupancy (a slot that finishes mid-window stops
            # counting there).
            "decode_slot_steps": 0,
            # Prompt tokens whose KV came from the prefix cache's device
            # blocks, and from its host or disk tiers by a restore.
            "prefix_cached_tokens": 0, "prefix_restored_tokens": 0,
            # Prefill calls (ragged packing exists to shrink this).
            "prefill_batches": 0,
            "spec_proposed": 0, "spec_accepted": 0, "spec_paused_rounds": 0,
            "numeric_faults": 0,
            # Multi-step windows shrunk to one step because the pool could
            # not reserve their blocks.
            "hbm_growth_deferrals": 0})

    @property
    def device(self) -> torch.device:
        return self.executor.device

    @property
    def follower(self) -> bool:
        """A tensor rank above 0: it runs :meth:`follow`, never :meth:`step`."""
        return self.executor.mirror is not None and not self.executor.mirror.leads

    def follow(self) -> None:
        """Make the device calls the tensor group's rank 0 mirrors, until it
        calls :meth:`stop_followers` (every tensor rank above 0)."""
        self.executor.follow()

    def stop_followers(self) -> None:
        """Release the followers (rank 0, once its serving ends)."""
        self.executor.stop_followers()

    @property
    def model(self):
        return self.executor.model

    @property
    def adapter_pool(self) -> Optional[AdapterPool]:
        return self.executor.adapter_pool

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

    @property
    def spec_draft_len(self) -> int:
        """Draft length of the last dispatched decode round (0: it ran
        plain decode): the dlti_spec_draft_len gauge."""
        return self._spec_last_k

    def warmup_decode_ladder(self) -> None:
        """Make the decode path ready before traffic, so no window's first
        use stalls the live loop: bring the resident state up to date and,
        on the card, capture the decode iteration's CUDA graph and, with
        speculation on, one spec round's graph per draft length of the
        ladder and table width. A graph serves every window length (a
        replay count). Idempotent: a re-warm keeps the graphs it has."""
        self._sync_state()
        self.executor.capture()
        if self.executor.spec_on:
            for k in spec_ladder(self.cfg.num_draft_tokens):
                for width in spec_widths(self.cfg.max_blocks_per_seq):
                    self.executor.capture_spec(k, width)

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
        the cache on, every row with it off. Prefilling slots' block tables
        upload as the trash block, so no decode call writes KV they hold."""
        masked = [s.slot_id for s in self.slots if s.prefilling]
        if self.cfg.decode_state_cache:
            self._state_cache.sync(self._mirrors, masked)
        else:
            self._state_cache.reupload(self._mirrors, masked)

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
               request_id: Optional[str] = None, adapter: str = "") -> Request:
        """Enqueue a request; tokens arrive through :meth:`step`. Touches no
        engine state but the queue and its own counter, so handler threads
        may call it while the stepper thread steps. ``adapter`` names a
        registered LoRA adapter ("" = the base model); an unknown one fails
        this request at admission."""
        if not prompt_token_ids:
            raise ValueError("prompt must contain at least one token")
        if len(prompt_token_ids) >= self.cfg.max_model_len:
            raise ValueError(
                f"prompt ({len(prompt_token_ids)} tokens) must be shorter than "
                f"max_model_len={self.cfg.max_model_len}")
        req = Request(request_id=request_id or f"req-{next(self._req_counter)}",
                      prompt_token_ids=list(prompt_token_ids),
                      params=params or SamplingParams(), adapter=adapter)
        return self.enqueue(req)

    def enqueue(self, req: Request) -> Request:
        """Queue a new request built elsewhere (a replica fleet builds one
        before it picks the replica); the thread contract of :meth:`submit`."""
        self.waiting.append(req)
        self.stats["requests"] += 1
        return req

    def resubmit(self, req: Request) -> None:
        """Re-enqueue an existing request (replica failover): it keeps its
        id, parameters, arrival time and tokens so far, and admission
        recomputes prompt plus output as after a preemption. Same thread
        contract as :meth:`submit`; ``stats["requests"]`` does not count it
        again. Its adapter pin did not survive (the dead replica's pool is
        gone), so admission resolves ``req.adapter`` on this engine."""
        req._adapter_slot = -1
        self.waiting.append(req)

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
        requests (prefill), spend the chunked-prefill budget, complete the
        decode round. Returns the requests the decode round finished.

        Slots admitted here were free when the decode round was set up, so
        its block tables point their rows at the trash block; they join the
        next round."""
        return self.step_finish(self.step_launch())

    def step_launch(self):
        """:meth:`step`'s first half: launch the decode round (None when no
        slot decodes). Waits on nothing, so a fleet launches every
        replica's round before it waits on any."""
        if any(not s.free and not s.prefilling for s in self.slots):
            return self._decode_dispatch()
        return None

    def step_finish(self, pending) -> List[Request]:
        """:meth:`step`'s second half: admit and prefill, then complete the
        round :meth:`step_launch` returned (its one sync)."""
        self._admit()
        if self.cfg.max_prefill_tokens_per_step > 0:
            self._prefill_work()
        if pending is None:
            return []
        return self._decode_complete(pending)

    # ------------------------------------------------------------------
    # Admission and prefill
    # ------------------------------------------------------------------
    def _alloc(self, n: int) -> Optional[List[int]]:
        """Allocate blocks, evicting cached prefixes LRU under pressure."""
        if self.prefix_cache is not None:
            return self.prefix_cache.allocate(n)
        return self.block_manager.allocate(n)

    def _admit(self) -> None:
        """Admit waiting requests into free slots (FCFS), reusing cached
        prefix blocks and restoring lower-tier ones, then prefill the rest
        in batched calls (by length bucket, packed ragged, or in chunks
        from :meth:`_prefill_work`)."""
        admissions = []
        for slot in self.slots:
            # Cancelled while queued: finish without taking a slot.
            while self.waiting and self.waiting[0].cancel_requested:
                req = self.waiting.popleft()
                # It may hold a pool row from a pass that then ran out of blocks.
                self._release_adapter(req)
                req.finish_reason = "stop"
                req.finish_time = time.monotonic()
                self.finished.append(req)
                self.telemetry.on_finished(req)
            if not self.waiting or not slot.free:
                continue
            req = self.waiting[0]
            # Resolve the adapter's pool row before any block work: a full
            # pool of pinned rows leaves the request queued (FCFS, as KV
            # exhaustion does), a bad adapter fails this request alone, and
            # the row stays pinned across passes until the slot releases.
            if req._adapter_slot < 0:
                if not req.adapter:
                    req._adapter_slot = 0
                elif self.adapter_pool is None:
                    self.waiting.popleft()
                    self._fail_waiting(req, f"request names adapter {req.adapter!r} "
                                            "but the engine has no adapter pool "
                                            "(adapter_slots=0)")
                    continue
                else:
                    try:
                        row, _ = self.adapter_pool.acquire(req.adapter)
                    except AdapterError as e:
                        self.waiting.popleft()
                        self._fail_waiting(req, str(e))
                        continue
                    if row < 0:
                        break  # every row pinned: retry next step
                    req._adapter_slot = row
            ns = req.adapter or None
            tokens = req.prompt_token_ids + req.output_token_ids
            cached_blocks: List[int] = []
            n_cached = 0
            tier_keys: List[tuple] = []
            if self.prefix_cache is not None:
                # Keys are namespaced by the adapter: the same prompt under
                # two adapters writes different KV.
                cached_blocks, n_cached = self.prefix_cache.match_prefix(tokens, ns=ns)
                # Pin the matched blocks BEFORE allocating the suffix, or
                # the allocation's own eviction could reclaim them.
                self.prefix_cache.acquire(cached_blocks)
                # The chain continues into the host/disk tiers: these keys'
                # payloads restore into blocks allocated below.
                tier_keys = self.prefix_cache.match_tiers(tokens, len(cached_blocks),
                                                          ns=ns)
            need = (self.block_manager.blocks_needed(len(tokens) + 1)
                    - len(cached_blocks))
            blocks = self._alloc(need)
            if blocks is None:
                if cached_blocks:
                    self.prefix_cache.release(cached_blocks)
                break  # head-of-line blocking: FCFS, no starvation
            restored_by_tier: Dict[str, int] = {}
            n_restored = 0
            for j, key in enumerate(tier_keys):
                # A fetch misses if the allocation's evictions cascaded the
                # key off the bounded disk tier, or fails verification:
                # either way the chain stops and the rest prefills.
                payload, tier = self.prefix_cache.fetch_restore(key)
                if payload is None:
                    break
                self.executor.restore_block(blocks[j], payload)
                self.prefix_cache.register_restored(key, blocks[j])
                restored_by_tier[tier] = restored_by_tier.get(tier, 0) + 1
                n_restored += 1
            if self.prefix_cache is not None:
                self.stats["prefix_cached_tokens"] += n_cached
                self.stats["prefix_restored_tokens"] += n_restored * self.cfg.block_size
                self.prefix_cache.record_admission(cached_blocks, restored_by_tier)
            self.waiting.popleft()
            n_prefix = n_cached + n_restored * self.cfg.block_size
            admissions.append((slot, req, cached_blocks + blocks, n_prefix))

        if self.cfg.max_prefill_tokens_per_step > 0:
            # Chunked: register now, prefill in bounded chunks from
            # _prefill_work; decode slots never stall for a prompt length.
            for slot, req, blocks, n_prefix in admissions:
                n = len(req.prompt_token_ids) + len(req.output_token_ids)
                self._register_slot(slot, req, blocks, n)
                slot.next_pos = n_prefix
            return

        suffix_lens = [len(req.prompt_token_ids) + len(req.output_token_ids) - n_prefix
                       for _slot, req, _blocks, n_prefix in admissions]
        if self.cfg.ragged_prefill:
            for width, group in self._ragged_groups(admissions, suffix_lens):
                self._prefill_group(width, group)
            return
        by_bucket: dict = {}
        for adm, n in zip(admissions, suffix_lens):
            by_bucket.setdefault(self._bucket_for(n), []).append(adm)
        for bucket, group in by_bucket.items():
            # Past ~8 rows a wider call's padded work outgrows its gain.
            for i in range(0, len(group), 8):
                self._prefill_group(bucket, group[i:i + 8])

    def _prefill_work(self) -> None:
        """Chunked prefill: spend up to ``max_prefill_tokens_per_step``
        prompt tokens on partially prefilled slots (FCFS by arrival), in
        batched calls. A slot whose last chunk lands samples its first
        token and joins the next decode step."""
        budget = self.cfg.max_prefill_tokens_per_step
        chunks: List[tuple] = []  # (slot, tokens, start_pos, is_last)
        for slot in sorted((s for s in self.slots if s.prefilling),
                           key=lambda s: s.request.arrival_time):
            if budget <= 0:
                break
            req = slot.request
            remaining = slot.prefill_end - slot.next_pos
            take = min(remaining, budget)
            tokens = req.prompt_token_ids + req.output_token_ids
            chunks.append((slot, tokens[slot.next_pos:slot.next_pos + take],
                           slot.next_pos, take == remaining))
            slot.next_pos += take
            budget -= take
        if self.cfg.ragged_prefill:
            for width, group in self._ragged_groups(chunks, [len(c[1]) for c in chunks]):
                self._run_prefill_batch(width, group)
            return
        by_bucket: dict = {}
        for ch in chunks:
            by_bucket.setdefault(self._bucket_for(len(ch[1])), []).append(ch)
        for bucket, group in by_bucket.items():
            for i in range(0, len(group), 8):
                self._run_prefill_batch(bucket, group[i:i + 8])

    def _ragged_groups(self, items: List, lengths: List[int]) -> List[tuple]:
        """FCFS ragged packing: ``(width, members)`` groups whose width is
        the widest member's bucket. A group closes at 8 rows, or when its
        padded footprint (rows rounded up to a power of two, times width)
        would pass twice the members' own bucketed work. Rows keep their
        own positions, tables and last-token indices, so the grouping never
        changes a row's output."""
        groups: List[tuple] = []
        cur: List = []
        wid = real = 0
        for it, ln in zip(items, lengths):
            w = self._bucket_for(ln)
            nwid = max(wid, w)
            nreal = real + w
            rows_pow2 = 1
            while rows_pow2 < len(cur) + 1:
                rows_pow2 *= 2
            if cur and (len(cur) >= 8 or rows_pow2 * nwid > 2 * nreal):
                groups.append((wid, cur))
                cur = []
                nwid, nreal = w, w
            cur.append(it)
            wid, real = nwid, nreal
        if cur:
            groups.append((wid, cur))
        return groups

    def _register_slot(self, slot: _Slot, req: Request, blocks: List[int],
                       n: int) -> None:
        """Host bookkeeping for an admitted request whose context is ``n``
        tokens (fully prefilled unless the chunked path rewinds
        ``next_pos``)."""
        self.telemetry.on_admitted(req)
        slot.request = req
        slot.blocks = blocks
        slot.seq_len = n
        slot.next_pos = n
        slot.prefill_end = n
        sid = slot.slot_id
        self._block_tables[sid] = 0
        self._block_tables[sid, :len(blocks)] = blocks
        self._temperature[sid] = req.params.temperature
        self._top_k[sid] = req.params.top_k
        self._top_p[sid] = req.params.top_p
        # A request without a resolved row decodes under row 0, the base.
        self._adapter_ids[sid] = max(req._adapter_slot, 0)
        self._slot_seeds[sid] = (req.params.seed & (2 ** 63 - 1)
                                 if req.params.seed is not None
                                 else self._rng.getrandbits(63))
        # Nonzero on readmission after preemption: the seeded stream
        # continues where it left off.
        self._gen_counts[sid] = len(req.output_token_ids)
        if self._spec_hist is not None:
            ctx = req.prompt_token_ids + req.output_token_ids
            self._spec_hist[sid, :len(ctx)] = ctx
        self._mark_state_dirty(sid)

    def _prefill_group(self, bucket: int, group: List[tuple]) -> None:
        """Register the group's slots and prefill each context (prompt plus
        any tokens generated before a preemption) past its cached prefix."""
        chunks = []
        for slot, req, blocks, n_prefix in group:
            tokens = req.prompt_token_ids + req.output_token_ids
            self._register_slot(slot, req, blocks, len(tokens))
            chunks.append((slot, tokens[n_prefix:], n_prefix, True))
        self._run_prefill_batch(bucket, chunks)

    def _run_prefill_batch(self, bucket: int, chunks: List[tuple]) -> None:
        """One prefill call over rows ``(slot, tokens, start_pos, is_last)``,
        padded to a power of two rows. Each row writes positions ``start,
        start + 1, ...`` and attends through its whole block table, so a
        chunk or a prefix-hit suffix sees every key before it. The table
        is always ``max_blocks_per_seq`` wide (the reference cuts it to the
        group's widest row, rounded up to a power of two): the attention's
        sums then run over the same window whatever rows share the call,
        so a row's output does not depend on how admissions are grouped
        (ragged on and off give the same bytes). A mixture of experts takes
        the reference's cut instead: its padding rows attend uniformly over
        the window and are routed, taking expert capacity, so the window's
        width decides which real tokens an expert drops. Final chunks
        sample their first token from their last real logit; the others
        write KV only."""
        ec = self.cfg
        B = 1
        while B < len(chunks):
            B *= 2
        self.stats["prefill_batches"] += 1
        width = ec.max_blocks_per_seq
        if self.model_cfg.num_experts > 0:
            need = max(self.block_manager.blocks_needed(start + len(tokens))
                       for _, tokens, start, _ in chunks)
            width = min(1 << max(need - 1, 0).bit_length(), width)
        ids = np.zeros((B, bucket), np.int32)
        pos = np.full((B, bucket), -1, np.int32)  # -1: written to the trash block
        bt = np.zeros((B, width), np.int32)
        last_idx = np.zeros((B,), np.int32)
        seeds = np.zeros((B,), np.int64)
        counts = np.zeros((B,), np.int32)
        temps = np.ones((B,), np.float32)
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        adapter_ids = np.zeros((B,), np.int64)
        for r, (slot, tokens, start, _) in enumerate(chunks):
            sid, req = slot.slot_id, slot.request
            adapter_ids[r] = self._adapter_ids[sid]
            ids[r, :len(tokens)] = tokens
            pos[r, :len(tokens)] = np.arange(start, start + len(tokens))
            bt[r, :min(len(slot.blocks), width)] = slot.blocks[:width]
            last_idx[r] = len(tokens) - 1
            seeds[r] = self._slot_seeds[sid]
            counts[r] = self._gen_counts[sid]
            temps[r] = req.params.temperature
            top_k[r] = req.params.top_k
            top_p[r] = req.params.top_p
            self.stats["prefill_tokens"] += len(tokens)

        ex = self.executor
        last_logits = ex.prefill(ids, pos, bt, last_idx, adapter_ids)
        if not any(is_last for *_, is_last in chunks):
            return  # mid-prompt chunks: KV writes only, nothing to sample
        toks, lps = to_host(*ex.sample(last_logits, seeds, counts, temps, top_k,
                                       top_p))
        if self.cfg.guard_nonfinite:
            bad = [slot.slot_id for r, (slot, *_, is_last) in enumerate(chunks)
                   if is_last and not np.isfinite(lps[r])]
            if bad:
                self.stats["numeric_faults"] += 1
                raise NumericFault(f"nonfinite prefill output on slot(s) {bad}: "
                                   "the model is producing NaN/inf logits")
        for r, (slot, *_, is_last) in enumerate(chunks):
            if is_last:
                self._append_token(slot, int(toks[r]), float(lps[r]))
                # The first token moved the slot's count, and a chunked
                # slot's table row sheds its trash-block mask: upload its
                # row before it joins a decode window.
                self._mark_state_dirty(slot.slot_id)

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    def _decode_dispatch(self):
        """Pick this round's work (a spec window when a greedy slot may
        propose and every decoding slot has room, else a plain window),
        grow block tables to cover it (preempting the youngest when the
        pool is exhausted; a window that cannot reserve its blocks shrinks
        to one plain step), bring the resident state up to date and launch
        it. Waits on nothing. Returns the pending window for
        :meth:`_decode_complete`."""
        ec = self.cfg
        active0 = [s for s in self.slots if not s.free and not s.prefilling]
        spec_parts: list = []
        spec_k = 0
        if self.executor.spec_on and active0:
            spec_parts = self._spec_round_gate(active0)
        if spec_parts:
            spec_k = self._spec_pick_k(spec_parts)
        R = ec.steps_per_sync
        use_spec = bool(spec_parts) and all(
            s.seq_len + R * (spec_k + 1) <= ec.max_model_len for s in active0)
        self._spec_last_k = spec_k if use_spec else 0
        if use_spec:
            k_steps = R * (spec_k + 1)  # block-growth window
        elif ec.steps_per_sync > 1 and active0:
            k_steps = self._window_steps(active0)
        else:
            k_steps = 1

        def grow_tables(window: int, spec: bool) -> bool:
            for slot in sorted((s for s in self.slots
                                if not s.free and not s.prefilling),
                               key=lambda s: s.request.arrival_time):
                if slot.free:  # preempted by an earlier iteration
                    continue
                # A sampling slot advances one token a spec round; its
                # draft-lane writes past that land on the trash block.
                win = (R if spec and slot.request.params.temperature != 0.0
                       else window)
                need = self.block_manager.blocks_needed(slot.seq_len + win)
                while need > len(slot.blocks):
                    got = self._alloc(1)
                    if got is None:
                        if not self._preempt_youngest(exclude=slot):
                            return False
                        continue
                    slot.blocks.extend(got)
                    self._block_tables[slot.slot_id, len(slot.blocks) - 1] = got[0]
                    self._mark_state_dirty(slot.slot_id)
            return True

        if not grow_tables(k_steps, use_spec):
            if k_steps > 1:
                # Defer, don't fault: blocks already granted stay with their
                # slots, and table rows past one step are never read.
                self.stats["hbm_growth_deferrals"] += 1
                use_spec = False
                self._spec_last_k = 0
                k_steps = 1
            if not grow_tables(k_steps, use_spec):
                raise RuntimeError("KV pool exhausted and nothing to preempt; "
                                   "increase num_blocks or lower max_seqs")

        active = [s for s in self.slots if not s.free and not s.prefilling]
        if not active:
            return None
        if use_spec:
            return self._spec_dispatch(active, spec_parts, spec_k)
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
        if pending[0] == "spec":
            return self._spec_complete(pending)
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

    # ------------------------------------------------------------------
    # Speculative decode
    # ------------------------------------------------------------------
    def _spec_round_gate(self, active: List[_Slot]) -> List[_Slot]:
        """Tick each paused greedy slot's cooldown and return the greedy
        slots that may propose this round. A slot in cooldown rides the
        spec window masked to single-step (or the plain path, when every
        greedy slot is paused at once); ``spec_paused_rounds`` counts
        paused slot-rounds."""
        gate_on = self.cfg.spec_min_acceptance > 0.0
        out = []
        for s in active:
            if s.request.params.temperature != 0.0:
                continue
            sid = s.slot_id
            if gate_on and self._spec_slot_pause[sid] > 0:
                self._spec_slot_pause[sid] -= 1
                self.stats["spec_paused_rounds"] += 1
            else:
                out.append(s)
        return out

    def _spec_pick_k(self, parts: List[_Slot]) -> int:
        """This round's draft length from the ladder: the smallest member
        with one token of probe slack over the most optimistic
        participant's smoothed acceptance (the slack lets the estimate
        climb back up). ``spec_adaptive=False`` pins the full draft."""
        kmax = self.cfg.num_draft_tokens
        if not self.cfg.spec_adaptive:
            return kmax
        est = max(self._spec_slot_ewma[s.slot_id] for s in parts)
        want = min(kmax, int(np.ceil(est)) + 1)
        for kk in reversed(spec_ladder(kmax)):
            if kk >= want:
                return kk
        return kmax

    def _spec_note_slot(self, sid: int) -> None:
        """Close a slot's probe window once it holds ``spec_probe_window``
        rounds. Rounds whose lookup found no draft cost the slot nothing and
        say nothing about its drafts, so the verdict reads only the rounds
        that proposed: if there were any and their mean accepted tokens per
        round is below ``spec_min_acceptance``, THAT slot pauses for
        ``spec_cooldown`` rounds. (The reference counts a no-hit round as a
        failed one, which pauses a slot that has not yet reached its
        repetitive stretch; the port holds the contract of
        ``tests/test_spec_production.py::test_zero_hit_slot_pauses_alone``
        instead: the slot whose drafts fail pauses, the one whose drafts
        land never does.)"""
        ec = self.cfg
        if ec.spec_min_acceptance > 0.0 and self._spec_slot_prop[sid] >= ec.spec_probe_window:
            hits = self._spec_slot_hits[sid]
            if hits and self._spec_slot_acc[sid] / hits < ec.spec_min_acceptance:
                self._spec_slot_pause[sid] = ec.spec_cooldown
            self._spec_slot_prop[sid] = 0
            self._spec_slot_hits[sid] = 0
            self._spec_slot_acc[sid] = 0

    def _spec_reset_slot(self, sid: int) -> None:
        self._spec_slot_prop[sid] = 0
        self._spec_slot_hits[sid] = 0
        self._spec_slot_acc[sid] = 0
        self._spec_slot_pause[sid] = 0
        self._spec_slot_ewma[sid] = float(self.cfg.num_draft_tokens)

    def _spec_dispatch(self, active: List[_Slot], parts: List[_Slot], k: int):
        """Launch ``steps_per_sync`` spec rounds at draft length ``k``
        (no sync). ``parts`` may propose; everyone else (sampling slots,
        greedy slots in cooldown) runs single-step inside the rounds. The
        resident state, token history included, uploads only its dirty
        rows."""
        ec = self.cfg
        t_prep = time.perf_counter()
        t_in = np.zeros((ec.max_seqs,), np.int64)
        seq_len = np.zeros((ec.max_seqs,), np.int64)
        mask = np.zeros((ec.max_seqs,), np.bool_)
        for s in active:
            t_in[s.slot_id] = s.last_token
            seq_len[s.slot_id] = s.seq_len
        for s in parts:
            mask[s.slot_id] = True
        # The verify attends through the blocks the whole window can touch,
        # rounded up to a power of two as the reference cuts its tables.
        need = max(self.block_manager.blocks_needed(s.seq_len + ec.steps_per_sync * (k + 1))
                   for s in active)
        width = next(w for w in spec_widths(ec.max_blocks_per_seq) if w >= need)
        self._sync_state()
        self.telemetry.host_prep.observe(time.perf_counter() - t_prep)
        out = self.executor.spec_window(k, width, ec.steps_per_sync, t_in, seq_len, mask)
        return ("spec", active, mask, *out)

    def _spec_complete(self, pending) -> List[Request]:
        """Bring a spec window to the host (its one sync) and walk its
        emissions: per slot per round the device says how many tokens it
        emitted (greedy: accepted prefix + bonus; sampling: one). A slot
        stops at EOS or a limit and the rest of its window is discarded,
        as in plain multi-step decode."""
        _, active, mask, toks, lps, emit, prop, acc = pending
        toks, lps, emit, prop, acc = to_host(toks, lps, emit, prop, acc)
        R = emit.shape[0]
        self.stats["decode_steps"] += R
        if self.cfg.guard_nonfinite:
            bad = [s.slot_id for s in active
                   if any(not np.isfinite(lps[r, s.slot_id, :emit[r, s.slot_id]]).all()
                          for r in range(R))]
            if bad:
                self.stats["numeric_faults"] += 1
                raise NumericFault(f"nonfinite speculative-decode output on "
                                   f"slot(s) {bad}: the model is producing "
                                   "NaN/inf logits")
        finished = []
        for s in active:
            sid = s.slot_id
            proposing = bool(mask[sid])
            done = False
            for r in range(R):
                self.stats["decode_slot_steps"] += 1
                if proposing:
                    self._spec_slot_prop[sid] += 1
                    self._spec_slot_hits[sid] += int(prop[r, sid] > 0)
                    self._spec_slot_acc[sid] += int(emit[r, sid]) - 1
                    self._spec_slot_ewma[sid] += 0.2 * (
                        int(acc[r, sid]) - self._spec_slot_ewma[sid])
                    self.stats["spec_proposed"] += int(prop[r, sid])
                    self.stats["spec_accepted"] += int(acc[r, sid])
                for j in range(int(emit[r, sid])):
                    s.seq_len += 1
                    done = self._append_token(s, int(toks[r, sid, j]),
                                              float(lps[r, sid, j]))
                    if done:
                        finished.append(s.request)
                        break
                if done:
                    break
            if proposing and not done:
                self._spec_note_slot(sid)
        return finished

    # ------------------------------------------------------------------
    # Retirement
    # ------------------------------------------------------------------
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
        if self._spec_hist is not None:
            self._spec_hist[slot.slot_id, len(req.prompt_token_ids)
                            + len(req.output_token_ids) - 1] = token
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

    def _release(self, slot: _Slot, register: bool = True) -> None:
        """Free a slot. With prefix caching its written full blocks are
        registered for reuse (shared ones drop a reference; the partial
        tail goes back to the pool); a mid-prefill slot has written only
        ``next_pos`` tokens. ``register=False`` (abort after a faulted
        step, whose KV may never have been written) registers nothing."""
        if self.prefix_cache is not None and slot.request is not None:
            req = slot.request
            n_written = slot.next_pos if slot.prefilling else slot.seq_len
            written = ((req.prompt_token_ids + req.output_token_ids)[:n_written]
                       if register else [])
            self.prefix_cache.release_sequence(written, slot.blocks,
                                               ns=req.adapter or None)
        else:
            self.block_manager.free(slot.blocks)
        if slot.request is not None:
            self._release_adapter(slot.request)
        slot.request = None
        slot.blocks = []
        slot.seq_len = 0
        slot.next_pos = 0
        slot.prefill_end = 0
        sid = slot.slot_id
        self._block_tables[sid] = 0
        self._temperature[sid] = 1.0
        self._top_k[sid] = 0
        self._top_p[sid] = 1.0
        self._slot_seeds[sid] = 0
        self._gen_counts[sid] = 0
        self._adapter_ids[sid] = 0
        self._spec_reset_slot(sid)
        self._mark_state_dirty(sid)

    def _release_adapter(self, req: Request) -> None:
        """Drop the request's pool-row pin and mark it unresolved
        (idempotent): a preempted request acquires again at readmission."""
        if self.adapter_pool is not None and req._adapter_slot > 0:
            self.adapter_pool.release(req._adapter_slot)
        req._adapter_slot = -1

    def _fail_waiting(self, req: Request, msg: str) -> None:
        """Finish a request that was never admitted as an error (an unknown
        or corrupt adapter): the engine, its slots and the rest of the
        queue are untouched."""
        logger.warning("request %s failed at admission: %s", req.request_id, msg)
        self._release_adapter(req)
        req.finish_reason = "error"
        req.finish_time = time.monotonic()
        self.finished.append(req)
        self.telemetry.on_finished(req)

    # ------------------------------------------------------------------
    # Paged-KV handoff (live migration between replicas)
    # ------------------------------------------------------------------
    def export_handoff(self, slot: _Slot) -> Optional[dict]:
        """Snapshot what another engine needs to continue ``slot``'s request
        token for token, then release the slot here. Only the blocks that
        cover written positions (``0..seq_len-1``) travel, device -> host
        through :meth:`EngineExecutor.fetch_block_kv`. The snapshot carries
        the slot's seed and draw count (a seed the request did not name
        came from this engine's own stream, so it is carried, never drawn
        again), its last token, the adaptive-spec gate's state and, on the
        request, the adapter name. Returns None, with the slot untouched,
        if a block fetch fails."""
        req = slot.request
        sid = slot.slot_id
        n_blocks = self.block_manager.blocks_needed(slot.seq_len)
        payloads = []
        for b in slot.blocks[:n_blocks]:
            p = self.executor.fetch_block_kv(b)
            if p is None:
                return None
            payloads.append(p)
        snap = {
            "request": req,
            "payloads": payloads,
            "seq_len": slot.seq_len,
            "last_token": slot.last_token,
            "seed": int(self._slot_seeds[sid]),
            "gen_count": int(self._gen_counts[sid]),
            "spec": {"prop": int(self._spec_slot_prop[sid]),
                     "hits": int(self._spec_slot_hits[sid]),
                     "acc": int(self._spec_slot_acc[sid]),
                     "pause": int(self._spec_slot_pause[sid]),
                     "ewma": float(self._spec_slot_ewma[sid])},
        }
        self._release(slot)
        return snap

    def adopt_handoff(self, snap: dict) -> bool:
        """Admit a request whose KV arrives as host payloads (the
        :meth:`export_handoff` counterpart): take a free slot, allocate a
        block chain, restore the payloads into it on this engine's device
        and stream, and seed the slot so its next decode step samples the
        token the origin engine would have. Returns False, consuming
        nothing, when no slot, adapter row or blocks are free."""
        slot = next((s for s in self.slots if s.free), None)
        if slot is None:
            return False
        req = snap["request"]
        # Re-pin the adapter on this engine's pool first: the origin's pin
        # went with the origin's slot.
        pinned = False
        if req.adapter and req._adapter_slot < 0:
            if self.adapter_pool is None:
                return False
            try:
                row, _ = self.adapter_pool.acquire(req.adapter)
            except AdapterError:
                return False
            if row < 0:
                return False
            req._adapter_slot = row
            pinned = True
        seq_len = snap["seq_len"]
        # + 1: the first decode step writes position seq_len.
        blocks = self._alloc(self.block_manager.blocks_needed(seq_len + 1))
        if blocks is None:
            if pinned:
                # The row is this pool's: the next survivor pins its own.
                self._release_adapter(req)
            return False
        self.telemetry.on_admitted(req)
        slot.request = req
        slot.blocks = blocks
        slot.seq_len = seq_len
        slot.next_pos = seq_len
        slot.prefill_end = seq_len
        slot.last_token = snap["last_token"]
        sid = slot.slot_id
        self._block_tables[sid] = 0
        self._block_tables[sid, :len(blocks)] = blocks
        self._temperature[sid] = req.params.temperature
        self._top_k[sid] = req.params.top_k
        self._top_p[sid] = req.params.top_p
        self._slot_seeds[sid] = snap["seed"]
        self._gen_counts[sid] = snap["gen_count"]
        self._adapter_ids[sid] = max(req._adapter_slot, 0)
        if self._spec_hist is not None:
            ctx = req.prompt_token_ids + req.output_token_ids
            self._spec_hist[sid, :len(ctx)] = ctx
        spec = snap.get("spec")
        if spec:
            self._spec_slot_prop[sid] = spec["prop"]
            self._spec_slot_hits[sid] = spec["hits"]
            self._spec_slot_acc[sid] = spec["acc"]
            self._spec_slot_pause[sid] = spec["pause"]
            self._spec_slot_ewma[sid] = spec["ewma"]
        self._mark_state_dirty(sid)
        for b, payload in zip(blocks, snap["payloads"]):
            # The origin's device -> host copies may still be in flight on
            # another device's stream: wait for them before the host rows
            # are read.
            if isinstance(payload, BlockPayload):
                payload.wait()
            self.executor.restore_block(b, payload)
        return True

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
                self._release(slot, register=False)
        while self.waiting:
            req = self.waiting.popleft()
            self._release_adapter(req)
            req.finish_reason = reason
            req.finish_time = time.monotonic()
            aborted.append(req)
        for req in aborted:
            self.telemetry.on_finished(req)
        return aborted

    def _preempt_youngest(self, exclude: _Slot) -> bool:
        """Evict the most recently arrived sequence back to the queue head
        (recomputed on readmission; with prefix caching its written blocks
        stay cached)."""
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
