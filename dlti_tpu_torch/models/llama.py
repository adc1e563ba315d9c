"""Llama-family transformer for serving and training: the port of
``dlti_tpu/models/llama.py``.

RMSNorm, RoPE, GQA attention, gated MLP, float32 logits with a tied or
untied head. Parameter names and layouts are the reference's
(``model.layers.{i}.attn.q_proj.kernel`` is ``(in, out)``), so
``models.interop.params_from_jax`` is a rename.

Attention branches ported here: the paged cache, float or int8 (several
positions a row, a prefill chunk or a speculative verify, through
``ops.attention.paged_window_attention``, the reference's ``paged_gather``
+ ``reference_attention``; one-token decode through the paged decode
kernel, given an int8 pool's scales) and the no-cache (training) path through
``multi_head_attention`` with ``cfg.attention_impl`` (flash attention's CUDA
kernels on the card). In training each block runs under
``torch.utils.checkpoint`` when ``cfg.remat`` (policy ``nothing_saveable``,
honouring ``remat_stride``), and LoRA dropout draws its masks from a seed
the caller passes (``dropout_seed``): each layer's projections get a key
derived from it on the device (:func:`dropout_keys`), hashed once per
forward, so the recomputation draws the same masks and a CUDA graph can
take the seed from a buffer. Under ZeRO-3 or ``offload_params`` a
``parallel.sharding.ParamFetcher`` on the model brings each block's leaves
whole onto the device for the block (all-gathered, or copied from pinned
host memory a block ahead), inside a remat recompute again; a data-parallel
rank numbers its dropout rows from ``dropout_row_offset``. With
``cfg.remat`` off (``remat_policy`` ``none`` on the CLIs) every block keeps
its activations. Weights may be int8 (``models.quantization``: the
embedding, the head and the projection kernels as ``QuantizedWeight``
pairs), each expanded at its use, as the reference's ``maybe_dequantize``.
The dense fixed-capacity cache and the other remat policies are not
ported.

Sequence parallelism (:meth:`LlamaForCausalLM.set_sequence_axis`): the
model takes a rank's contiguous chunk of every row, at its global
positions, and every layer's attention runs the ring over the sequence
group (``parallel.ring_attention``, one ``RingContext`` a forward).
Pipeline parallelism (``stage=(k, P)``): the module holds stage ``k``'s
``num_layers / P`` layers as its ``layers.0 ..`` (their dropout keys the
global layers'), and ``parallel.pipeline`` drives its parts
(:meth:`LlamaModel.embed`, :meth:`LlamaModel.run_layers`,
:meth:`LlamaModel.norm`, :meth:`LlamaForCausalLM.logits`) through the
GPipe schedule.

Tensor parallelism (:meth:`LlamaForCausalLM.set_tensor_axis`, after the
leaves were split by ``parallel.sharding.strategy_axes``): each rank holds
``num_heads / tp`` query heads and ``num_kv_heads / tp`` KV heads (its
paged pools too), ``intermediate_size / tp`` MLP hidden units (a mixture
of experts: of every expert) and ``vocab_size / tp`` rows of the embedding
and columns of the head. The block's input reaches q/k/v and gate/up
through the tensor group's copy, o and down all-reduce their partial
products, the embedding is looked up rank by rank and summed, and the
float32 logits of every rank's columns are assembled whole on every rank
(``parallel.tensor``), so the loss, sampling and everything held whole run
as on one device. Attention runs unchanged on the local heads, in training
(flash attention's kernels) and in serving (the paged decode kernel).

Multi-LoRA serving passes ``adapter_ids`` ``(B,)`` (each row's pool row)
and ``adapters``, the pool's per-layer ``{projection: (a, b, s)}``
(``serving.adapters.AdapterPool.layers``); every projection the pool
targets adds its rows' deltas (``models.lora.adapter_delta``), in the
eager prefill, the decode iteration, the multi-position window and the
speculative verify alike. Without them no branch is built.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dlti_tpu_torch.config import LoRAConfig, ModelConfig
from dlti_tpu_torch.models.lora import LoRADense, dropout_hashes
from dlti_tpu_torch.models.moe import MoEMLP, check_lora_targets, collect_aux_loss
from dlti_tpu_torch.models.quantization import QuantizedWeight, weight_of
from dlti_tpu_torch.ops.attention import multi_head_attention, paged_window_attention
from dlti_tpu_torch.ops.kv_cache import paged_update, slot_mapping
from dlti_tpu_torch.ops.paged_attention import paged_decode_attention
from dlti_tpu_torch.ops.rope import (
    apply_rope, assert_rope_table_covers, rope_frequencies,
)
from dlti_tpu_torch.parallel.ring_attention import ring_attention_local
from dlti_tpu_torch.parallel.tensor import (
    COLUMN_PARALLEL, ROW_PARALLEL, check_divides, copy_in, gather_vocab, vocab_embedding,
)
from dlti_tpu_torch.utils.device import resolve_dtype
from dlti_tpu_torch.utils.hashing import MASK32, mix32

PAGED_ATTENTION_IMPLS = ("auto", "kernel", "gather")
REMAT_POLICIES = ("nothing_saveable",)
# The projections of a block that can carry LoRA dropout, in key order.
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
               "down_proj")


def dropout_keys(seed, num_layers: int, device) -> torch.Tensor:
    """The LoRA dropout key of every (layer, projection) under ``seed``:
    a ``(num_layers, len(PROJECTIONS))`` int64 tensor of 32-bit keys on
    ``device``. ``seed`` is a 32-bit key: a Python int (its low 32 bits) or
    a 0-d int64 tensor on ``device``, which may change between replays of a
    CUDA graph that captured this call."""
    if not isinstance(seed, torch.Tensor):
        seed = torch.full((), seed & MASK32, dtype=torch.int64, device=device)
    sites = mix32(torch.arange(num_layers * len(PROJECTIONS), device=device) ^ 0x68E31DA4)
    return mix32(seed ^ sites).reshape(num_layers, len(PROJECTIONS))


def _hashes(hashes: Optional[tuple], projection: str) -> Optional[tuple]:
    """One projection's (row, column) dropout hashes from its layer's."""
    if hashes is None:
        return None
    j = PROJECTIONS.index(projection)
    return hashes[0][j], hashes[1][j]


def _adapter(rows: Optional[tuple], projection: str) -> Optional[tuple]:
    """One projection's per-row adapter arguments ``(ids, a, b, s)`` from
    its layer's ``(ids, {projection: (a, b, s)})``; None where the pool
    does not target it."""
    if rows is None or projection not in rows[1]:
        return None
    return (rows[0], *rows[1][projection])


class RMSNorm(nn.Module):
    """Llama RMSNorm with float32 statistics; ``offset`` is Gemma's
    ``(1 + weight)`` form (weights stored zero-centred)."""

    def __init__(self, hidden_size: int, eps: float = 1e-5, offset: bool = False,
                 device=None):
        super().__init__()
        self.eps = eps
        self.offset = offset
        init = torch.zeros if offset else torch.ones
        self.scale = nn.Parameter(init(hidden_size, dtype=torch.float32,
                                       device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + self.eps)
        s = self.scale.float()
        if self.offset:
            s = 1.0 + s
        return (normed * s).to(x.dtype)


def _proj(cfg: ModelConfig, lora: Optional[LoRAConfig], name: str,
          in_features: int, features: int, use_bias: bool, device) -> LoRADense:
    kw = {}
    if lora is not None and lora.enabled and name in lora.target_modules:
        kw = dict(lora_r=lora.r, lora_alpha=lora.alpha, lora_dropout=lora.dropout)
    return LoRADense(in_features, features, use_bias=use_bias,
                     dtype=resolve_dtype(cfg.dtype),
                     param_dtype=resolve_dtype(cfg.param_dtype), device=device,
                     **kw)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: ModelConfig, lora: Optional[LoRAConfig] = None,
                 device=None):
        super().__init__()
        if cfg.paged_attention_impl not in PAGED_ATTENTION_IMPLS:
            raise ValueError(f"paged_attention_impl must be one of "
                             f"{PAGED_ATTENTION_IMPLS}, got "
                             f"{cfg.paged_attention_impl!r}")
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.resolved_head_dim
        bias = cfg.attention_bias  # Qwen2: q/k/v only, never o
        self.q_proj = _proj(cfg, lora, "q_proj", h, cfg.num_heads * hd, bias, device)
        self.k_proj = _proj(cfg, lora, "k_proj", h, cfg.num_kv_heads * hd, bias, device)
        self.v_proj = _proj(cfg, lora, "v_proj", h, cfg.num_kv_heads * hd, bias, device)
        self.o_proj = _proj(cfg, lora, "o_proj", cfg.num_heads * hd, h, False, device)
        # This rank's heads (all of them without tensor parallelism).
        self.num_heads, self.num_kv_heads = cfg.num_heads, cfg.num_kv_heads
        self.tp = None
        # This layer's index in its model (the ring keeps what it received
        # under it for the remat recompute).
        self.layer_index = None

    def _effective_window(self, segment_ids) -> Optional[int]:
        """Sliding window combined with the packed-document length bound
        (exact under segment masking)."""
        cfg = self.cfg
        window = cfg.sliding_window
        if segment_ids is not None and cfg.packed_attention_window:
            window = (min(window, cfg.packed_attention_window)
                      if window else cfg.packed_attention_window)
        return window

    def forward(self, x, cos, sin, positions, segment_ids=None,
                cache: Optional[dict] = None,
                block_tables: Optional[torch.Tensor] = None,
                hashes: Optional[tuple] = None,
                paged: Optional[tuple] = None,
                adapter_rows: Optional[tuple] = None,
                ring=None) -> torch.Tensor:
        """``paged``: ``(slots, seq_lens, drop)`` of a paged-cache call, computed
        once per forward by :class:`LlamaModel`; ``hashes``: this layer's
        dropout hashes, ``(row, column)`` by projection (None: no
        dropout); ``adapter_rows``: ``(ids, {projection: (a, b, s)})`` of
        this layer's adapter pool (None: no per-row adapters); ``ring``: the
        forward's ``parallel.ring_attention.RingContext`` under sequence
        parallelism (the rows are this rank's chunk)."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        nh, nkv = self.num_heads, self.num_kv_heads
        rows = adapter_rows
        if self.tp is not None:  # q/k/v are column-parallel
            x = copy_in(x, self.tp)
        q = self.q_proj(x, _hashes(hashes, "q_proj"),
                        _adapter(rows, "q_proj")).reshape(b, s, nh, hd)
        k = self.k_proj(x, _hashes(hashes, "k_proj"),
                        _adapter(rows, "k_proj")).reshape(b, s, nkv, hd)
        v = self.v_proj(x, _hashes(hashes, "v_proj"),
                        _adapter(rows, "v_proj")).reshape(b, s, nkv, hd)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)

        if cache is not None:
            # Paged cache: write this step's K/V into the pool in place, then
            # attend over the sequence's pages. Unwritten rows sit at logical
            # positions past the query, so the position mask hides them.
            slots, seq_lens, drop = paged
            paged_update(cache, k, v, slots, drop)
            if s == 1 and cfg.paged_attention_impl != "gather":
                out = paged_decode_attention(
                    q, cache["k"], cache["v"], block_tables, seq_lens,
                    k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                    window=cfg.sliding_window,
                ).to(q.dtype)
            else:
                out = paged_window_attention(q, cache, block_tables, positions,
                                             window=cfg.sliding_window)
        elif ring is not None:
            # The ring masks by the positions RoPE used; the packed bound is
            # not a window here (per-document positions never reach it), as
            # in the reference.
            out = ring_attention_local(q, k, v, ring=ring, layer=self.layer_index)
        else:
            out = multi_head_attention(q, k, v, causal=True,
                                       segment_ids=segment_ids,
                                       impl=cfg.attention_impl,
                                       window=self._effective_window(segment_ids))
        return self.o_proj(out.reshape(b, s, nh * hd),
                           _hashes(hashes, "o_proj"), _adapter(rows, "o_proj"))


_MLP_ACTIVATIONS = {
    "silu": F.silu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
}


class LlamaMLP(nn.Module):
    """Gated MLP: down(act(gate(x)) * up(x))."""

    def __init__(self, cfg: ModelConfig, lora: Optional[LoRAConfig] = None,
                 device=None):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.act = _MLP_ACTIVATIONS[cfg.mlp_activation]
        self.gate_proj = _proj(cfg, lora, "gate_proj", h, m, False, device)
        self.up_proj = _proj(cfg, lora, "up_proj", h, m, False, device)
        self.down_proj = _proj(cfg, lora, "down_proj", m, h, False, device)
        self.tp = None

    def forward(self, x: torch.Tensor, hashes: Optional[tuple] = None,
                adapter_rows: Optional[tuple] = None) -> torch.Tensor:
        rows = adapter_rows
        if self.tp is not None:  # gate/up are column-parallel
            x = copy_in(x, self.tp)
        gate = self.gate_proj(x, _hashes(hashes, "gate_proj"), _adapter(rows, "gate_proj"))
        up = self.up_proj(x, _hashes(hashes, "up_proj"), _adapter(rows, "up_proj"))
        return self.down_proj(self.act(gate) * up, _hashes(hashes, "down_proj"),
                              _adapter(rows, "down_proj"))


class LlamaBlock(nn.Module):
    """Attention and MLP with pre-norms. With ``cfg.num_experts`` > 0 the MLP
    is a ``models.moe.MoEMLP``: ``token_mask`` keeps padding out of its
    routing, and ``want_aux`` makes the block return ``(x, aux)``, its
    load-balance loss beside the output (a dense block returns ``x``)."""

    def __init__(self, cfg: ModelConfig, lora: Optional[LoRAConfig] = None,
                 device=None):
        super().__init__()
        eps, off = cfg.rms_norm_eps, cfg.rmsnorm_offset
        self.input_norm = RMSNorm(cfg.hidden_size, eps, off, device)
        self.attn = LlamaAttention(cfg, lora, device)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, eps, off, device)
        self.moe = cfg.num_experts > 0
        if self.moe:
            check_lora_targets(lora)
            self.mlp = MoEMLP(cfg, device)
        else:
            self.mlp = LlamaMLP(cfg, lora, device)

    def forward(self, x, cos, sin, positions, segment_ids=None, cache=None,
                block_tables=None, hashes=None, paged=None, adapter_rows=None,
                token_mask=None, want_aux=False, ring=None):
        x = x + self.attn(self.input_norm(x), cos, sin, positions, segment_ids,
                          cache, block_tables, hashes, paged, adapter_rows, ring)
        if self.moe:
            y, aux = self.mlp(self.post_attn_norm(x), token_mask, want_aux)
            return (x + y, aux) if want_aux else x + y
        return x + self.mlp(self.post_attn_norm(x), hashes, adapter_rows)


class LlamaModel(nn.Module):
    """Transformer body: embeddings, blocks, final norm. ``stage`` ``(k, P)``:
    a pipeline stage's body, holding layers ``k * L/P .. (k+1) * L/P - 1``
    of ``cfg.num_layers`` as its ``layers.0 ..`` (``parallel.pipeline``
    runs it)."""

    def __init__(self, cfg: ModelConfig, lora: Optional[LoRAConfig] = None,
                 device=None, stage: Tuple[int, int] = (0, 1)):
        super().__init__()
        if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported yet; the port "
                f"has {REMAT_POLICIES} (see ROADMAP.md)")
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.hidden_size, dtype=resolve_dtype(cfg.param_dtype),
            device=device), requires_grad=False)
        index, count = stage
        if cfg.num_layers % count:
            raise ValueError(f"num_layers={cfg.num_layers} must divide into "
                             f"pipe={count} stages")
        per_stage = cfg.num_layers // count
        # The global index of this module's first layer (dropout keys), and
        # the number of pipeline stages the layers are split into.
        self.layer_offset = index * per_stage
        self.num_stages = count
        self.layers = nn.ModuleList(LlamaBlock(cfg, lora, device)
                                    for _ in range(per_stage))
        for i, layer in enumerate(self.layers):
            layer.attn.layer_index = i
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                  cfg.rmsnorm_offset, device)
        # RoPE tables by (length, device); computed, not learned.
        self._rope: Dict[Tuple[int, torch.device], tuple] = {}
        # ZeRO-3 and offload_params: fetches the leaves this rank does not
        # hold whole on its device (parallel.sharding.ParamFetcher).
        self.fetcher = None
        # The tensor group's mesh view under tensor parallelism.
        self.tp = None
        # The sequence group's mesh view under sequence parallelism.
        self.sp = None

    def _rope_tables(self, table_len: int, device) -> tuple:
        key = (table_len, device)
        if key not in self._rope:
            self._rope[key] = rope_frequencies(self.cfg.resolved_head_dim,
                                               table_len, self.cfg.rope_theta,
                                               device=device)
        return self._rope[key]

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The embedding of ``input_ids`` in the compute dtype (fetched,
        vocabulary-split or int8 as the module holds it)."""
        cfg = self.cfg
        dtype = resolve_dtype(cfg.dtype)
        fetcher = self.fetcher
        emb = self.embed_tokens
        scale = None
        if isinstance(emb, QuantizedWeight):
            table, scale = ((emb.q, emb.scale) if fetcher is None
                            else (fetcher.leaf("model.embed_tokens.q"),
                                  fetcher.leaf("model.embed_tokens.scale")))
        else:
            table = emb if fetcher is None else fetcher.leaf("model.embed_tokens")
        if self.tp is not None:
            x = vocab_embedding(input_ids, table, self.tp, scale, dtype)
        elif scale is not None:
            # int8: gather the rows, then scale them in the compute dtype,
            # as the reference does.
            x = table[input_ids].to(dtype) * scale.to(dtype)
        else:
            x = table[input_ids].to(dtype)
        if cfg.embedding_scale:  # Gemma: scaled by sqrt(hidden) in the compute dtype
            # A CPU scalar: no host-to-device copy, which a CUDA graph refuses.
            x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=dtype)
        return x

    def layer_hashes(self, dropout_seed, rows: int, device, row_offset: int = 0,
                     row_ids: Optional[torch.Tensor] = None) -> Optional[tuple]:
        """This module's layers' dropout hashes under ``dropout_seed`` (None:
        no dropout): every (layer, projection)'s row and column hashes at
        once, keyed by the global layer index, for ``rows`` rows numbered
        from ``row_offset`` (or by ``row_ids``)."""
        if dropout_seed is None:
            return None
        cfg = self.cfg
        cols = max(cfg.hidden_size, cfg.num_heads * cfg.resolved_head_dim,
                   cfg.intermediate_size)
        keys = dropout_keys(dropout_seed, cfg.num_layers, device)
        keys = keys[self.layer_offset:self.layer_offset + len(self.layers)]
        return dropout_hashes(keys, rows, cols, row_offset=row_offset, row_ids=row_ids)

    def run_layers(self, x, cos, sin, positions, segment_ids=None, hashes=None,
                   token_mask=None, want_aux: bool = False):
        """The blocks of the no-cache (training) path: ``(x, [aux])``, each
        block under ``torch.utils.checkpoint`` when ``cfg.remat`` (every
        ``remat_stride``-th keeping its activations), its leaves fetched
        when the model has a fetcher; under sequence parallelism the
        attention runs the ring over ``positions``."""
        cfg = self.cfg
        fetcher = self.fetcher
        ring = None
        if self.sp is not None:
            from dlti_tpu_torch.parallel.ring_attention import RingContext

            ring = RingContext(self.sp, positions, segment_ids, causal=True,
                               window=cfg.sliding_window)
        remat = cfg.remat and torch.is_grad_enabled()
        n = len(self.layers)
        # Selective remat: every remat_stride-th block keeps its
        # activations instead of recomputing them in the backward.
        recomputed = [i for i in range(n)
                      if remat and not (cfg.remat_stride > 1 and i % cfg.remat_stride == 0)]
        if fetcher is not None:
            fetcher.begin(recomputed)
        auxes = []
        for i, layer in enumerate(self.layers):
            layer_hashes = None if hashes is None else (hashes[0][i], hashes[1][i])
            run = layer if fetcher is None else functools.partial(fetcher.run_block, i, layer)
            args = (x, cos, sin, positions, segment_ids, None, None, layer_hashes, None,
                    None, token_mask, want_aux, ring)
            if i in recomputed:
                # The block's (x, aux) outputs are what the backward differentiates;
                # the recompute rebuilds the block's insides only, so its aux
                # is counted once.
                out = checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                out = run(*args)
            if want_aux:
                x, aux = out
                auxes.append(aux)
            else:
                x = out
        return x, auxes

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm (its scale fetched when the model fetches it)."""
        fetcher = self.fetcher
        if fetcher is not None and fetcher.fetches("model.final_norm.scale"):
            return torch.func.functional_call(
                self.final_norm, {"scale": fetcher.leaf("model.final_norm.scale")}, (x,))
        return self.final_norm(x)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[List[dict]] = None,
                block_tables: Optional[torch.Tensor] = None,
                dropout_seed=None, dropout_row_offset: int = 0,
                adapter_ids: Optional[torch.Tensor] = None,
                adapters: Optional[list] = None,
                token_mask: Optional[torch.Tensor] = None,
                return_aux: bool = False,
                dropout_rows: Optional[torch.Tensor] = None):
        """The final norm's output ``(b, s, h)``; with ``return_aux`` (a
        mixture of experts) the pair of it and the sum of the layers'
        load-balance losses. ``token_mask`` (default: ``segment_ids != 0``
        for packed rows) keeps padding out of the experts' routing.
        ``dropout_rows``: each token's global row number for the dropout
        masks, in place of ``dropout_row_offset``."""
        cfg = self.cfg
        b, s = input_ids.shape
        x = self.embed(input_ids)
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)

        paged = None
        if cache is None:
            # Cover the whole sequence even past the preset's design length
            # (under sequence parallelism the positions are global).
            table_len = max(cfg.max_seq_len, s * (self.sp.world if self.sp else 1))
            assert_rope_table_covers(table_len, s, "no-cache path")
        else:
            if block_tables is None:
                raise ValueError("a paged cache needs block_tables")
            # Capacity of the logical window: positions stay below it.
            block_size = cache[0]["k"].shape[1]
            table_len = block_tables.shape[1] * block_size
            block_tables = block_tables.to(torch.int32).contiguous()
            # Where this call's K/V rows go, (for one-token decode) each
            # row's length, and for a mixture of experts, which routes rows
            # that read the trash block back, which rows are padding, whose
            # writes are dropped (none in decode): the same in every layer.
            drop = None
            if cfg.num_experts > 0:
                drop = positions < 0 if s > 1 else torch.zeros_like(positions, dtype=torch.bool)
            paged = (slot_mapping(block_tables, positions, block_size),
                     (positions[:, 0] + 1).to(torch.int32), drop)
        cos, sin = self._rope_tables(table_len, x.device)

        # Every (layer, projection)'s row and column hashes at once: a mask
        # then costs three elementwise ops.
        hashes = self.layer_hashes(dropout_seed, b * s, x.device, dropout_row_offset,
                                   dropout_rows)
        want_aux = return_aux and cfg.num_experts > 0
        if token_mask is None and segment_ids is not None and cfg.num_experts > 0:
            token_mask = (segment_ids != 0).to(torch.int32)  # packed: 0 = pad
        if cache is None:
            x, auxes = self.run_layers(x, cos, sin, positions, segment_ids, hashes,
                                       token_mask, want_aux)
        else:
            auxes = []
            if self.fetcher is not None:
                self.fetcher.begin([])
            for i, layer in enumerate(self.layers):
                layer_hashes = None if hashes is None else (hashes[0][i], hashes[1][i])
                run = (layer if self.fetcher is None
                       else functools.partial(self.fetcher.run_block, i, layer))
                out = run(x, cos, sin, positions, segment_ids, cache[i], block_tables,
                            layer_hashes, paged,
                            None if adapters is None else (adapter_ids, adapters[i]),
                            token_mask, want_aux)
                if want_aux:
                    x, aux = out
                    auxes.append(aux)
                else:
                    x = out
        x = self.norm(x)
        if return_aux:
            return x, (collect_aux_loss(auxes) if auxes
                       else torch.zeros((), dtype=torch.float32, device=x.device))
        return x


class LlamaForCausalLM(nn.Module):
    """Body plus LM head; returns float32 logits.

    With a paged ``cache`` (a list of per-layer ``{"k", "v"}`` pools from
    ``ops.kv_cache.init_paged_cache``) and ``block_tables``, the forward
    writes this call's K/V into the pools in place. ``dropout_seed`` (see
    :func:`dropout_keys`) turns LoRA dropout on (training); without it the
    forward is deterministic. ``return_hidden`` returns the final norm's
    output instead of the logits, for a loss that applies
    :meth:`head_matrix` itself (``training.step.chunked_causal_lm_loss``).
    ``adapter_ids`` and ``adapters`` apply a multi-LoRA pool per row (see
    the module docstring). A mixture of experts takes ``token_mask`` (1 for
    real tokens) and with ``return_aux`` returns ``(logits or hidden, aux)``,
    ``aux`` the sum of its layers' load-balance losses (0 for a dense model).
    """

    def __init__(self, cfg: ModelConfig, lora: Optional[LoRAConfig] = None,
                 device=None, stage: Tuple[int, int] = (0, 1)):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg, lora, device, stage)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                cfg.hidden_size, cfg.vocab_size,
                dtype=resolve_dtype(cfg.param_dtype), device=device),
                requires_grad=False)
        # Every leaf's whole shape, whatever part of it a parallel layout
        # later leaves this module (parallel.sharding.plan_layout reads it).
        self.whole_shapes: Dict[str, Tuple[int, ...]] = {
            n: tuple(p.shape) for n, p in self.named_parameters()}

    def forward(self, input_ids, positions=None, segment_ids=None, cache=None,
                block_tables=None, dropout_seed=None, dropout_row_offset: int = 0,
                return_hidden: bool = False, adapter_ids=None,
                adapters: Optional[list] = None, token_mask=None,
                return_aux: bool = False, dropout_rows=None):
        if (adapters is None) != (adapter_ids is None):
            raise ValueError("adapter_ids and adapters go together")
        out = self.model(input_ids, positions, segment_ids, cache, block_tables,
                         dropout_seed, dropout_row_offset, adapter_ids, adapters,
                         token_mask, return_aux, dropout_rows)
        x, aux = out if return_aux else (out, None)
        if not return_hidden:
            x = self.logits(x)
        return (x, aux) if return_aux else x

    def set_tensor_axis(self, axis) -> None:
        """Run on this rank's part of every tensor-split leaf (the leaves
        hold it already, or are ``meta`` slots of the local shapes) and
        issue the tensor group's collectives (``axis``: ``Mesh.tensor``)."""
        cfg = self.cfg
        check_divides(cfg, axis.world)
        self.model.tp = axis
        for name, mod in self.named_modules():
            if isinstance(mod, (LlamaAttention, LlamaMLP, MoEMLP, LoRADense)):
                mod.tp = axis
            if isinstance(mod, LlamaAttention):
                mod.num_heads = cfg.num_heads // axis.world
                mod.num_kv_heads = cfg.num_kv_heads // axis.world
            elif isinstance(mod, LoRADense):
                leaf = name.rpartition(".")[2]
                mod.tp_mode = ("column" if leaf in COLUMN_PARALLEL
                               else "row" if leaf in ROW_PARALLEL else None)

    def set_sequence_axis(self, axis) -> None:
        """Take this rank's chunk of every row and run attention as the ring
        over the sequence group (``axis``: ``Mesh.sequence``)."""
        if self.cfg.num_experts > 0:
            raise NotImplementedError(
                "sequence parallelism with a mixture of experts (capacity and the "
                "aux loss over the global token order) is not ported yet (see "
                "ROADMAP.md)")
        self.model.sp = axis

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Float32 logits of the final hidden state ``x`` (every rank's
        vocabulary columns under tensor parallelism)."""
        tp = self.model.tp
        if tp is None:
            return lm_head_logits(x, self.head_matrix())
        # this rank's vocabulary columns, then every rank's
        return gather_vocab(lm_head_logits(copy_in(x, tp), self.head_matrix()), tp)

    def head_matrix(self) -> torch.Tensor:
        """The (hidden, vocab) matrix the forward multiplies the final
        hidden state by (through :func:`lm_head_logits`), fetched whole when
        this rank does not hold it so. An int8 head is expanded to the
        compute dtype, an int8 tied embedding to float32, as the reference
        expands them."""
        fetcher = self.model.fetcher
        if self.cfg.tie_embeddings:
            return weight_of(self.model.embed_tokens, "model.embed_tokens", fetcher,
                             torch.float32).T
        return weight_of(self.lm_head, "lm_head", fetcher, resolve_dtype(self.cfg.dtype))


def lm_head_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Float32 logits ``x @ head``: the reference's ``jnp.dot(x,
    head.astype(x.dtype), preferred_element_type=float32)``.

    On the card a bf16/fp16 ``x`` multiplies the head cast to its dtype on
    the tensor cores, accumulating and writing float32
    (:class:`_HalfHeadMatmul`). Everywhere else (the CPU has no such GEMM,
    and float32 models need none) it is the float32 product of the two,
    which is the same function up to summation order: the products of two
    bf16 values are exact in float32. Logits stay float32 either way; a
    bf16 rounding would flip greedy near-ties against the JAX engine.
    """
    if x.device.type == "cuda" and x.dtype in (torch.bfloat16, torch.float16):
        return _HalfHeadMatmul.apply(x, head.to(x.dtype))
    return x.float() @ head.float()


class _HalfHeadMatmul(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=torch.float32)`` (``aten::mm.dtype``,
    which has no derivative) with the float32 head's gradients: dx as the
    float32 product ``g @ w.T`` rounded to x's dtype, dw likewise."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g2 @ w.float().T).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = (x.reshape(-1, x.shape[-1]).float().T @ g2).to(w.dtype)
        return dx, dw
