"""Dense projection with an optional LoRA branch, and the LoRA parameter
helpers: the port of ``dlti_tpu/models/lora.py`` (``LoRADense``,
``lora_param_mask``, ``merge_lora_params``, ``count_params``).

    y = x @ kernel (+ bias)  +  (alpha / r) * (dropout(x) @ lora_a) @ lora_b

``kernel`` is stored ``(in, out)`` as in the reference, so weights move
between the packages by name without a transpose. The base kernel is frozen;
``lora_a``/``lora_b`` are float32 master weights, the only leaves a LoRA run
trains (``load_model(..., trainable_lora=True)`` sets their
``requires_grad``).

Dropout is applied to the adapter input only in training, and only when
the caller passes ``dropout_hashes``: the row and column hashes of one
32-bit key (:func:`dropout_hashes`), on the input's device. The keep mask
is a function of (the key, the element's index) computed on the device
(:func:`keep_mask_from`): a recomputation under activation checkpointing
draws the same mask as the forward did, nothing is read back to the host,
and a CUDA graph that is replayed with a new key in the same buffer draws
new masks. Without hashes the branch is deterministic, as in serving.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from dlti_tpu_torch.utils.hashing import mix32

LORA_LEAVES = ("lora_a", "lora_b")


class LoRADense(nn.Module):
    """Dense layer with an optional LoRA adapter branch."""

    def __init__(self, in_features: int, features: int, *, use_bias: bool = False,
                 lora_r: int = 0, lora_alpha: int = 32, lora_dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.bfloat16,
                 lora_param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.lora_r = lora_r
        self.lora_alpha = lora_alpha
        self.lora_dropout = lora_dropout
        self.kernel = nn.Parameter(torch.empty(in_features, features,
                                               dtype=param_dtype, device=device),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                              device=device), requires_grad=False)
                     if use_bias else None)
        if lora_r > 0:
            self.lora_a = nn.Parameter(torch.empty(
                in_features, lora_r, dtype=lora_param_dtype, device=device),
                requires_grad=False)
            self.lora_b = nn.Parameter(torch.zeros(
                lora_r, features, dtype=lora_param_dtype, device=device),
                requires_grad=False)

    def forward(self, x: torch.Tensor,
                dropout_hashes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        dt = self.dtype
        y = x.to(dt) @ self.kernel.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        if self.lora_r > 0:
            h = x
            if dropout_hashes is not None and self.lora_dropout > 0.0:
                h = dropout(h, self.lora_dropout, *dropout_hashes)
            delta = (h.to(dt) @ self.lora_a.to(dt)) @ self.lora_b.to(dt)
            y = y + (self.lora_alpha / self.lora_r) * delta
        return y


def dropout(x: torch.Tensor, rate: float, row_hash: torch.Tensor,
            col_hash: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep each element with probability
    ``1 - rate`` and scale kept ones by ``1 / (1 - rate)``; the mask is
    :func:`keep_mask_from` of one key's hashes."""
    keep_prob = 1.0 - rate
    keep = keep_mask_from(row_hash, col_hash, x.shape[-1], keep_prob)
    return torch.where(keep.reshape(x.shape), x / keep_prob, 0.0)


def dropout_hashes(keys: torch.Tensor, rows: int, cols: int) -> tuple:
    """For each of ``keys`` (int64 tensor of 32-bit keys, any shape ``K``):
    a 32-bit hash of (key, row) for ``rows`` rows and of (key, column) for
    ``cols`` columns, as int32 tensors shaped ``K + (rows,)`` and
    ``K + (cols,)``. One call hashes every key of a forward at once, so each
    dropout mask costs three elementwise ops on its full shape."""
    k = keys[..., None]
    r = mix32(mix32(torch.arange(rows, device=keys.device) ^ k) ^ 0x5BD1E995)
    c = mix32(torch.arange(cols, device=keys.device) ^ mix32(k ^ 0x27D4EB2F))
    # [0, 2**32) -> int32 exactly, by moving the range down 2**31.
    return (r - 2 ** 31).to(torch.int32), (c - 2 ** 31).to(torch.int32)


# Odd multiplier of the per-element step below (a bijection of int32).
_KEEP_MUL = 0x2C1B3C6D


def keep_mask_from(row_hash: torch.Tensor, col_hash: torch.Tensor, cols: int,
                   keep_prob: float) -> torch.Tensor:
    """The ``(rows, cols)`` bool keep mask of one key from its hashes
    (:func:`dropout_hashes`; ``col_hash`` may be longer than ``cols``):
    element (i, j) is (row hash i XOR column hash j) times an odd constant
    in wrapping int32 arithmetic, uniform over int32 since both hashes are,
    and it is kept when below ``keep_prob`` of the way up the int32 range
    (resolution 2**-32). A function of (key, i, j) alone."""
    h = (row_hash[:, None] ^ col_hash[None, :cols]) * _KEEP_MUL
    threshold = min(round(keep_prob * 2 ** 32), 2 ** 32 - 1) - 2 ** 31
    return h < threshold


# ----------------------------------------------------------------------
# Parameter helpers over ``{name: tensor}`` state dicts
# ----------------------------------------------------------------------

def is_lora_name(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in LORA_LEAVES


def lora_param_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True for trainable (LoRA) leaves, False for frozen ones; everything
    is trainable when no adapter is grafted (a full fine-tune)."""
    if not any(is_lora_name(n) for n in params):
        return {n: True for n in params}
    return {n: is_lora_name(n) for n in params}


def merge_lora_params(params: Mapping[str, torch.Tensor],
                      scaling: Optional[float] = None,
                      alpha: int = 32) -> Dict[str, torch.Tensor]:
    """Fold each LoRA pair into its base kernel, W' = W + scaling * A @ B in
    float32 and cast back to W's dtype; the returned dict has no
    ``lora_a``/``lora_b`` leaves."""
    out = {}
    for name, t in params.items():
        if is_lora_name(name):
            continue
        prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        a = params.get(f"{prefix}.lora_a")
        b = params.get(f"{prefix}.lora_b")
        if leaf == "kernel" and a is not None and b is not None:
            s = scaling if scaling is not None else alpha / a.shape[-1]
            t = (t.float() + s * (a.float() @ b.float())).to(t.dtype)
        out[name] = t
    return out


def count_params(params: Mapping[str, torch.Tensor]) -> Tuple[int, int]:
    """(trainable, total) parameter counts."""
    mask = lora_param_mask(params)
    total = sum(t.numel() for t in params.values())
    trainable = sum(t.numel() for n, t in params.items() if mask[n])
    return trainable, total
