"""Rotary position embeddings (RoPE), Llama-style: the port of
``dlti_tpu/ops/rope.py``.

Split-half rotation (HF Llama's convention), computed in float32 and cast
back to the input dtype; positions are explicit so one op serves prefill
and paged decode.
"""

from __future__ import annotations

import torch


def assert_rope_table_covers(table_len: int, needed_len: int,
                             context: str = "") -> None:
    """Guard the table-sizing invariant: :func:`apply_rope` clamps
    positions into the table, so an under-sized table would silently clamp
    rotary angles instead of failing."""
    if table_len < needed_len:
        raise ValueError(
            f"RoPE table of length {table_len} cannot cover positions up "
            f"to {needed_len - 1}{' (' + context + ')' if context else ''}; "
            "apply_rope clamps positions into the table and would silently "
            "clamp rotary angles — size the table to >= max position + 1")


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                     device=None) -> tuple:
    """cos/sin tables of shape ``(max_seq_len, head_dim // 2)``, float32."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` of shape (batch, seq, heads, head_dim) by position.

    ``positions`` is (batch, seq); out-of-table positions (the -1 of padding
    tokens) are clamped into the table, as the reference's clip gather.
    """
    orig_dtype = x.dtype
    half = x.shape[-1] // 2
    idx = positions.long().clamp(0, cos.shape[0] - 1)
    cos_p = cos[idx][:, :, None, :].float()
    sin_p = sin[idx][:, :, None, :].float()
    x = x.float()
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos_p - x2 * sin_p, x2 * cos_p + x1 * sin_p],
                        dim=-1)
    return rotated.to(orig_dtype)
