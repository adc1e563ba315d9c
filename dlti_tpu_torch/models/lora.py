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
the caller passes a ``dropout_seed``: the keep mask is drawn from a
``torch.Generator`` seeded with it, so a recomputation under activation
checkpointing draws the same mask as the forward did (checkpointing restores
the default generators' state, never an explicit one's). Without a seed the
branch is deterministic, as in serving.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

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
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        dt = self.dtype
        y = x.to(dt) @ self.kernel.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        if self.lora_r > 0:
            h = x
            if dropout_seed is not None and self.lora_dropout > 0.0:
                h = dropout(h, self.lora_dropout, dropout_seed)
            delta = (h.to(dt) @ self.lora_a.to(dt)) @ self.lora_b.to(dt)
            y = y + (self.lora_alpha / self.lora_r) * delta
        return y


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep each element with probability
    ``1 - rate`` and scale kept ones by ``1 / (1 - rate)``; the mask comes
    from a generator seeded with ``seed`` on x's device."""
    keep_prob = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


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
