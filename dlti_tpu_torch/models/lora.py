"""Dense projection with an optional LoRA branch: the port of
``dlti_tpu/models/lora.py``'s ``LoRADense`` (serving side).

    y = x @ kernel (+ bias)  +  (alpha / r) * (x @ lora_a) @ lora_b

``kernel`` is stored ``(in, out)`` as in the reference, so weights move
between the packages by name without a transpose. The adapter branch is the
deterministic one (no dropout): this slice serves, it does not train.
"""

from __future__ import annotations

import torch
from torch import nn


class LoRADense(nn.Module):
    """Dense layer with an optional LoRA adapter branch."""

    def __init__(self, in_features: int, features: int, *, use_bias: bool = False,
                 lora_r: int = 0, lora_alpha: int = 32,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.bfloat16,
                 lora_param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.lora_r = lora_r
        self.lora_alpha = lora_alpha
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        y = x @ self.kernel.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        if self.lora_r > 0:
            delta = (x @ self.lora_a.to(dt)) @ self.lora_b.to(dt)
            y = y + (self.lora_alpha / self.lora_r) * delta
        return y
