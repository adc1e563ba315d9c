"""Attention ops: the port of ``dlti_tpu/ops/attention.py``
(``repeat_kv``, ``make_causal_mask``, ``reference_attention`` and the
``multi_head_attention`` dispatch between it and flash attention), and
``paged_window_attention``: several query positions a row over the paged KV
cache (a prefill chunk, a prefix-hit suffix, the speculative verify), the
reference's ``paged_gather`` + ``reference_attention``.

Scores and softmax are float32 whatever the input dtype, as in the
reference's ``preferred_element_type=float32`` einsums.
"""

from __future__ import annotations

from typing import Optional

import torch

from dlti_tpu_torch.ops.flash_attention import flash_attention
from dlti_tpu_torch.ops.kv_cache import paged_gather


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(b, s, kv_heads, d) -> (b, s, kv_heads * n_rep, d) for GQA."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def make_causal_mask(q_len: int, kv_len: int, dtype=torch.float32,
                     window: Optional[int] = None, device=None) -> torch.Tensor:
    """Additive causal mask of shape (1, 1, q_len, kv_len).

    Query i attends to kv positions <= kv_len - q_len + i; ``window`` keeps
    only the last ``window`` positions (query included) visible.
    """
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    allowed = kv_pos <= q_pos
    if window is not None:
        allowed &= kv_pos > q_pos - window
    neg = torch.finfo(dtype).min
    return torch.where(allowed, 0.0, neg)[None, None].to(dtype)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain attention. q: (b, sq, h, d); k/v: (b, skv, h_kv, d).

    ``segment_ids`` (id 0 = padding) keeps tokens inside their own packed
    segment; ``q_positions``/``kv_positions`` (b, s) give explicit token
    positions for the causal mask (paged decode, where the gathered window
    is longer than what was written); ``window`` is Mistral-style sliding
    locality. Softmax in float32; output in q's dtype.
    """
    b, sq, num_heads, head_dim = q.shape
    num_kv = k.shape[2]
    k = repeat_kv(k, num_heads // num_kv)
    v = repeat_kv(v, num_heads // num_kv)
    f32 = torch.float32
    neg = torch.finfo(f32).min

    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)) * head_dim ** -0.5

    skv = k.shape[1]
    if causal:
        if q_positions is not None:
            kv_pos = (kv_positions if kv_positions is not None
                      else torch.arange(skv, device=q.device)[None, :].expand(b, skv))
            allowed = kv_pos[:, None, :] <= q_positions[:, :, None]
            if window is not None:
                allowed &= kv_pos[:, None, :] > q_positions[:, :, None] - window
            scores = scores + torch.where(allowed, 0.0, neg)[:, None, :, :]
        else:
            scores = scores + make_causal_mask(sq, skv, f32, window=window,
                                               device=q.device)
    if segment_ids is not None:
        kv_seg = kv_segment_ids if kv_segment_ids is not None else segment_ids
        same = (segment_ids[:, :, None] == kv_seg[:, None, :]) & (kv_seg[:, None, :] != 0)
        scores = torch.where(same[:, None, :, :], scores, neg)

    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).to(f32), v.to(f32))
    return out.to(q.dtype)


ATTENTION_IMPLS = ("auto", "reference", "flash")


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    impl: str = "auto",
    window: Optional[int] = None,
) -> torch.Tensor:
    """Dispatching attention entry point used by the model.

    ``impl``: "reference" runs :func:`reference_attention`; "flash" runs
    ``ops.flash_attention.flash_attention`` (its plain version on a CPU
    tensor, the CUDA kernels on the card); "auto" takes flash on every CUDA
    tensor and the reference path on a CPU one. The JAX package's rule for
    "auto" (lengths and head_dim multiples of 128) follows the TPU tile; the
    CUDA kernels mask ragged tails by bounds and need no such alignment, and
    they raise on what they were not built for (head_dim outside 64/128/256,
    more than 64 query heads per kv head). The one exception is causal
    attention with ``sq != skv``: the flash mask is top-left aligned and
    the reference's bottom-right, a different function, so "auto" keeps the
    reference there as the JAX package does.
    """
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention impl must be one of {ATTENTION_IMPLS}, "
                         f"got {impl!r}")
    use_flash = impl == "flash"
    if impl == "auto":
        use_flash = q.device.type == "cuda" and (q.shape[1] == k.shape[1] or not causal)
    if use_flash:
        return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                               window=window)
    return reference_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                               window=window)


def paged_window_attention(q: torch.Tensor, layer_cache: dict,
                           block_tables: torch.Tensor, q_positions: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """Attention of ``s`` query positions a row (``q`` (b, s, h, d), at
    ``q_positions`` (b, s)) over the row's whole paged window, causal by
    position: the reference's ``paged_gather`` + ``reference_attention``
    (``dlti_tpu/models/llama.py:157-187``), which it is everywhere but for a
    bfloat16 or float16 ``q`` on a CUDA device. There the reference's
    float32 copies of the window are the cost (a 2048-token window of 28
    slots is ~0.9 GB a layer in bf16), so :func:`_half_window_attention`
    gathers the window once into q's dtype and runs both products as
    half-precision GEMMs with float32 output: the reference's function up to
    rounding. The products of two half-precision values are exact in
    float32, so only the summation order differs (as in the LM head's GEMM);
    an int8 window's row scales multiply the float32 scores and
    probabilities instead of each payload element, which skips the
    reference's rounding of ``payload * scale`` to q's dtype."""
    if q.device.type == "cuda" and q.dtype in (torch.bfloat16, torch.float16):
        return _half_window_attention(
            q, layer_cache, block_tables, q_positions, window,
            lambda a, b: torch.bmm(a, b, out_dtype=torch.float32))
    k, v = paged_gather(layer_cache, block_tables)
    return reference_attention(q, k.to(q.dtype), v.to(q.dtype), causal=True,
                               q_positions=q_positions, window=window)


def _half_window_attention(q, layer_cache, block_tables, q_positions, window, bmm):
    """The card's form of :func:`paged_window_attention` in q's (half)
    dtype; ``bmm(a, b)`` is a batched product with float32 output. GQA
    groups each kv head's query heads into one product instead of repeating
    the window."""
    b, s, h, d = q.shape
    _, bs, kvh, _ = layer_cache["k"].shape
    rep = h // kvh
    idx = block_tables.long()
    t = idx.shape[1] * bs

    def window_of(name: str) -> torch.Tensor:
        """(b * kvh, t, d): the rows in q's dtype (int8 payloads cast
        exactly, without their scales)."""
        out = torch.empty((b, kvh, t, d), dtype=q.dtype, device=q.device)
        out.view(b, kvh, -1, bs, d).permute(0, 2, 3, 1, 4).copy_(layer_cache[name][idx])
        return out.view(b * kvh, t, d)

    def scales_of(name: str) -> Optional[torch.Tensor]:
        """(b, kvh, 1, 1, t): an int8 window's float32 row scales."""
        scale = layer_cache.get(name + "_scale")
        if scale is None:
            return None
        return scale[idx].reshape(b, t, kvh).permute(0, 2, 1)[:, :, None, None, :]

    qg = q.view(b, s, kvh, rep, d).permute(0, 2, 3, 1, 4).reshape(b * kvh, rep * s, d)
    scores = bmm(qg, window_of("k").transpose(1, 2)).view(b, kvh, rep, s, t)
    k_scale = scales_of("k")
    if k_scale is not None:
        scores = scores * k_scale
    scores = scores * d ** -0.5
    kv_pos = torch.arange(t, device=q.device)
    allowed = kv_pos[None, None, :] <= q_positions[:, :, None]
    if window is not None:
        allowed &= kv_pos[None, None, :] > q_positions[:, :, None] - window
    mask = torch.where(allowed, 0.0, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores + mask[:, None, None], dim=-1)
    v_scale = scales_of("v")
    if v_scale is not None:
        probs = probs * v_scale
    out = bmm(probs.to(q.dtype).view(b * kvh, rep * s, t), window_of("v"))
    return out.view(b, kvh, rep, s, d).permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
