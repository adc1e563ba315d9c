"""Attention ops: the port of ``dlti_tpu/ops/attention.py``
(``repeat_kv``, ``make_causal_mask``, ``reference_attention`` and the
``multi_head_attention`` dispatch between it and flash attention).

Scores and softmax are float32 whatever the input dtype, as in the
reference's ``preferred_element_type=float32`` einsums.
"""

from __future__ import annotations

from typing import Optional

import torch

from dlti_tpu_torch.ops.flash_attention import flash_attention


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
