"""Llama-family transformer for serving and training: the port of
``dlti_tpu/models/llama.py``.

RMSNorm, RoPE, GQA attention, gated MLP, float32 logits with a tied or
untied head. Parameter names and layouts are the reference's
(``model.layers.{i}.attn.q_proj.kernel`` is ``(in, out)``), so
``models.interop.params_from_jax`` is a rename.

Attention branches ported here: the paged cache, float or int8 (prefill
through ``paged_gather`` + ``reference_attention``; one-token decode
through the paged decode kernel, given an int8 pool's scales) and the no-cache (training) path through
``multi_head_attention`` with ``cfg.attention_impl`` (flash attention's CUDA
kernels on the card). In training each block runs under
``torch.utils.checkpoint`` when ``cfg.remat`` (policy ``nothing_saveable``,
honouring ``remat_stride``), and LoRA dropout draws its masks from a seed
the caller passes (``dropout_seed``): each layer's projections get a key
derived from it on the device (:func:`dropout_keys`), hashed once per
forward, so the recomputation draws the same masks and a CUDA graph can
take the seed from a buffer. The
dense fixed-capacity cache, ring attention, the other remat policies and
quantized leaves are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dlti_tpu_torch.config import LoRAConfig, ModelConfig
from dlti_tpu_torch.models.lora import LoRADense, dropout_hashes
from dlti_tpu_torch.ops.attention import multi_head_attention, reference_attention
from dlti_tpu_torch.ops.kv_cache import paged_gather, paged_update, slot_mapping
from dlti_tpu_torch.ops.paged_attention import paged_decode_attention
from dlti_tpu_torch.ops.rope import (
    apply_rope, assert_rope_table_covers, rope_frequencies,
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
                paged: Optional[tuple] = None) -> torch.Tensor:
        """``paged``: ``(slots, seq_lens)`` of a paged-cache call, computed
        once per forward by :class:`LlamaModel`; ``hashes``: this layer's
        dropout hashes, ``(row, column)`` by projection (None: no
        dropout)."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        q = self.q_proj(x, _hashes(hashes, "q_proj")).reshape(b, s, cfg.num_heads, hd)
        k = self.k_proj(x, _hashes(hashes, "k_proj")).reshape(b, s, cfg.num_kv_heads, hd)
        v = self.v_proj(x, _hashes(hashes, "v_proj")).reshape(b, s, cfg.num_kv_heads, hd)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)

        if cache is not None:
            # Paged cache: write this step's K/V into the pool in place, then
            # attend over the sequence's pages. Unwritten rows sit at logical
            # positions past the query, so the position mask hides them.
            slots, seq_lens = paged
            paged_update(cache, k, v, slots)
            if s == 1 and cfg.paged_attention_impl != "gather":
                out = paged_decode_attention(
                    q, cache["k"], cache["v"], block_tables, seq_lens,
                    k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                    window=cfg.sliding_window,
                ).to(q.dtype)
            else:
                ck, cv = paged_gather(cache, block_tables)
                out = reference_attention(
                    q, ck.to(q.dtype), cv.to(q.dtype), causal=True,
                    q_positions=positions, window=cfg.sliding_window)
        else:
            out = multi_head_attention(q, k, v, causal=True,
                                       segment_ids=segment_ids,
                                       impl=cfg.attention_impl,
                                       window=self._effective_window(segment_ids))
        return self.o_proj(out.reshape(b, s, cfg.num_heads * hd),
                           _hashes(hashes, "o_proj"))


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

    def forward(self, x: torch.Tensor, hashes: Optional[tuple] = None) -> torch.Tensor:
        gate = self.gate_proj(x, _hashes(hashes, "gate_proj"))
        up = self.up_proj(x, _hashes(hashes, "up_proj"))
        return self.down_proj(self.act(gate) * up, _hashes(hashes, "down_proj"))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, lora: Optional[LoRAConfig] = None,
                 device=None):
        super().__init__()
        if cfg.num_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts blocks are not ported yet (see ROADMAP.md)")
        eps, off = cfg.rms_norm_eps, cfg.rmsnorm_offset
        self.input_norm = RMSNorm(cfg.hidden_size, eps, off, device)
        self.attn = LlamaAttention(cfg, lora, device)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, eps, off, device)
        self.mlp = LlamaMLP(cfg, lora, device)

    def forward(self, x, cos, sin, positions, segment_ids=None, cache=None,
                block_tables=None, hashes=None, paged=None):
        x = x + self.attn(self.input_norm(x), cos, sin, positions, segment_ids,
                          cache, block_tables, hashes, paged)
        return x + self.mlp(self.post_attn_norm(x), hashes)


class LlamaModel(nn.Module):
    """Transformer body: embeddings, blocks, final norm."""

    def __init__(self, cfg: ModelConfig, lora: Optional[LoRAConfig] = None,
                 device=None):
        super().__init__()
        if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported yet; the port "
                f"has {REMAT_POLICIES} (see ROADMAP.md)")
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.hidden_size, dtype=resolve_dtype(cfg.param_dtype),
            device=device), requires_grad=False)
        self.layers = nn.ModuleList(LlamaBlock(cfg, lora, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                  cfg.rmsnorm_offset, device)
        # RoPE tables by (length, device); computed, not learned.
        self._rope: Dict[Tuple[int, torch.device], tuple] = {}

    def _rope_tables(self, table_len: int, device) -> tuple:
        key = (table_len, device)
        if key not in self._rope:
            self._rope[key] = rope_frequencies(self.cfg.resolved_head_dim,
                                               table_len, self.cfg.rope_theta,
                                               device=device)
        return self._rope[key]

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[List[dict]] = None,
                block_tables: Optional[torch.Tensor] = None,
                dropout_seed=None) -> torch.Tensor:
        cfg = self.cfg
        dtype = resolve_dtype(cfg.dtype)
        b, s = input_ids.shape
        x = self.embed_tokens[input_ids].to(dtype)
        if cfg.embedding_scale:  # Gemma: scaled by sqrt(hidden) in the compute dtype
            # A CPU scalar: no host-to-device copy, which a CUDA graph refuses.
            x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=dtype)
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)

        paged = None
        if cache is None:
            # Cover the whole sequence even past the preset's design length.
            table_len = max(cfg.max_seq_len, s)
            assert_rope_table_covers(table_len, s, "no-cache path")
        else:
            if block_tables is None:
                raise ValueError("a paged cache needs block_tables")
            # Capacity of the logical window: positions stay below it.
            block_size = cache[0]["k"].shape[1]
            table_len = block_tables.shape[1] * block_size
            block_tables = block_tables.to(torch.int32).contiguous()
            # Where this call's K/V rows go, and (for one-token decode) each
            # row's length: the same in every layer.
            paged = (slot_mapping(block_tables, positions, block_size),
                     (positions[:, 0] + 1).to(torch.int32))
        cos, sin = self._rope_tables(table_len, x.device)

        hashes = None
        if dropout_seed is not None:
            # Every (layer, projection)'s row and column hashes at once: a
            # mask then costs three elementwise ops.
            cols = max(cfg.hidden_size, cfg.num_heads * cfg.resolved_head_dim,
                       cfg.intermediate_size)
            hashes = dropout_hashes(dropout_keys(dropout_seed, cfg.num_layers, x.device),
                                    b * s, cols)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            layer_hashes = None if hashes is None else (hashes[0][i], hashes[1][i])
            # Selective remat: every remat_stride-th block keeps its
            # activations instead of recomputing them in the backward.
            if remat and not (cfg.remat_stride > 1 and i % cfg.remat_stride == 0):
                x = checkpoint(layer, x, cos, sin, positions, segment_ids, None,
                               None, layer_hashes, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, cos, sin, positions, segment_ids,
                          cache[i] if cache is not None else None, block_tables,
                          layer_hashes, paged)
        return self.final_norm(x)


class LlamaForCausalLM(nn.Module):
    """Body plus LM head; returns float32 logits.

    With a paged ``cache`` (a list of per-layer ``{"k", "v"}`` pools from
    ``ops.kv_cache.init_paged_cache``) and ``block_tables``, the forward
    writes this call's K/V into the pools in place. ``dropout_seed`` (see
    :func:`dropout_keys`) turns LoRA dropout on (training); without it the
    forward is deterministic. ``return_hidden`` returns the final norm's
    output instead of the logits, for a loss that applies
    :meth:`head_matrix` itself (``training.step.chunked_causal_lm_loss``).
    """

    def __init__(self, cfg: ModelConfig, lora: Optional[LoRAConfig] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg, lora, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                cfg.hidden_size, cfg.vocab_size,
                dtype=resolve_dtype(cfg.param_dtype), device=device),
                requires_grad=False)

    def forward(self, input_ids, positions=None, segment_ids=None, cache=None,
                block_tables=None, dropout_seed=None,
                return_hidden: bool = False) -> torch.Tensor:
        x = self.model(input_ids, positions, segment_ids, cache, block_tables,
                       dropout_seed)
        if return_hidden:
            return x
        return lm_head_logits(x, self.head_matrix())

    def head_matrix(self) -> torch.Tensor:
        """The (hidden, vocab) matrix the forward multiplies the final
        hidden state by (through :func:`lm_head_logits`)."""
        return self.model.embed_tokens.T if self.cfg.tie_embeddings else self.lm_head


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
