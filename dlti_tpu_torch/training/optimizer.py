"""Optimizer and learning-rate schedule: the port of
``dlti_tpu/training/optimizer.py`` (``build_schedule``, ``build_optimizer``).

``build_optimizer`` is optax's ``chain(clip_by_global_norm, adamw)`` written
out on tensors, with optax's arithmetic:

* clip: ``g * max_norm / norm`` (as ``(g / norm) * max_norm``) when
  ``norm >= max_norm``, nothing added to the norm (unlike
  ``torch.nn.utils.clip_grad_norm_``);
* Adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, both
  bias-corrected by the incremented count, ``u = mu_hat / (sqrt(nu_hat) +
  eps)``, plus ``weight_decay * p``;
* the step size is ``schedule(count)`` read at the count *before* the
  update, so the first update of a warmup schedule has lr 0.

The count lives in the optimizer state, as optax's does, so a skipped
update (which restores the whole state) also holds the schedule. Moments are
float32 whatever the parameter dtype (the reference's ``_fp32_state``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch

from dlti_tpu_torch.config import OptimizerConfig


def build_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """Learning rate as a function of the optimizer's update count."""
    lr = cfg.learning_rate
    if cfg.schedule == "warmup_constant":
        if cfg.warmup_steps <= 0:
            return lambda count: lr
        warmup = max(cfg.warmup_steps, 1)
        # optax.linear_schedule(0, lr, warmup), then constant lr.
        return lambda count: ((0.0 - lr) * (1 - min(max(count, 0), warmup) / warmup) + lr
                              if count < warmup else lr)
    if cfg.schedule == "warmup_cosine":
        warmup = max(cfg.warmup_steps, 1)
        decay_steps = max(cfg.total_steps, cfg.warmup_steps + 1) - warmup

        def cosine(count: int) -> float:
            if count < warmup:
                return (0.0 - lr) * (1 - min(max(count, 0), warmup) / warmup) + lr
            c = min(count - warmup, decay_steps)
            return lr * (0.5 * (1 + math.cos(math.pi * c / decay_steps)))
        return cosine
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


@dataclass
class AdamWState:
    """optax's state for the chain: the update count (shared by Adam's bias
    correction and the schedule) and the float32 moments by parameter name."""

    count: int = 0
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)


def global_norm(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors.values()))


class ClipAdamW:
    """Global-norm clip, then AdamW with a schedule, over a dict of
    parameters; ``update`` writes the new parameters in place."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = build_schedule(cfg)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor]) -> AdamWState:
        cfg = self.cfg
        b1, b2 = cfg.betas
        norm = global_norm(grads)
        clip = norm >= cfg.grad_clip
        count_inc = state.count + 1
        bc1, bc2 = 1 - b1 ** count_inc, 1 - b2 ** count_inc
        step_size = -self.schedule(state.count)
        mu_new, nu_new = {}, {}
        for n, p in params.items():
            g = grads[n].float()
            g = torch.where(clip, (g / norm) * cfg.grad_clip, g)
            mu = (1 - b1) * g + b1 * state.mu[n]
            nu = (1 - b2) * (g * g) + b2 * state.nu[n]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            if cfg.weight_decay:
                u = u + cfg.weight_decay * p.float()
            p.copy_((p.float() + step_size * u).to(p.dtype))
            mu_new[n], nu_new[n] = mu, nu
        return AdamWState(count=count_inc, mu=mu_new, nu=nu_new)


def build_optimizer(cfg: OptimizerConfig) -> ClipAdamW:
    """Global-norm clip -> AdamW(schedule), applied to the trainable
    parameters only."""
    return ClipAdamW(cfg)
