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
update (which keeps the whole state) also holds the schedule. It is a 0-d
int32 tensor on the parameters' device, and the schedule and Adam's bias
corrections are computed from it with tensor ops in float32 (optax's
arithmetic), so an update reads nothing back to the host. ``update`` writes
the parameters, the moments and the count in place, into the tensors the
state already holds, so a CUDA graph that captured it reads on each replay
what the last one wrote. Moments are float32 whatever the parameter dtype
(the reference's ``_fp32_state``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Union

import torch

from dlti_tpu_torch.config import OptimizerConfig


def build_schedule(cfg: OptimizerConfig
                   ) -> Callable[[Union[int, torch.Tensor]], torch.Tensor]:
    """Learning rate as a function of the optimizer's update count (an int
    or an int tensor): a float32 tensor on the count's device, as optax's
    ``join_schedules(linear warmup, constant or cosine decay)``."""
    lr = cfg.learning_rate
    if cfg.schedule not in ("warmup_constant", "warmup_cosine"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    warmup = max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps, cfg.warmup_steps + 1) - warmup

    def schedule(count: Union[int, torch.Tensor]) -> torch.Tensor:
        c = torch.as_tensor(count).float()
        if cfg.schedule == "warmup_constant" and cfg.warmup_steps <= 0:
            return torch.full_like(c, lr)
        # optax.linear_schedule(0, lr, warmup) ...
        warm = (0.0 - lr) * (1 - c.clamp(0, warmup) / warmup) + lr
        if cfg.schedule == "warmup_constant":
            after = torch.full_like(c, lr)
        else:  # ... then optax.cosine_decay_schedule(lr, decay_steps)
            after = lr * (0.5 * (1 + torch.cos(math.pi * (c - warmup).clamp(max=decay_steps)
                                               / decay_steps)))
        return torch.where(c < warmup, warm, after)
    return schedule


@dataclass
class AdamWState:
    """optax's state for the chain: the update count (shared by Adam's bias
    correction and the schedule; a 0-d int32 tensor) and the float32
    moments by parameter name."""

    count: torch.Tensor = field(default_factory=lambda: torch.zeros((), dtype=torch.int32))
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)


def global_norm(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors.values()))


class ClipAdamW:
    """Global-norm clip, then AdamW with a schedule, over a dict of
    parameters; ``update`` writes the new parameters and state in place."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = build_schedule(cfg)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        device = next(iter(params.values())).device if params else None
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            nu={n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor], apply: torch.Tensor) -> AdamWState:
        """One update of ``params`` and ``state`` in place. ``apply``: a 0-d
        bool tensor; where it is False the parameters, the moments and the
        count keep their values (the update is computed and dropped)."""
        cfg = self.cfg
        b1, b2 = cfg.betas
        norm = global_norm(grads)
        clip = norm >= cfg.grad_clip
        count_inc = state.count + 1
        bc1, bc2 = 1 - b1 ** count_inc.float(), 1 - b2 ** count_inc.float()
        step_size = -self.schedule(state.count)

        def keep(new, old):  # in place: old <- new where apply
            torch.where(apply, new, old, out=old)

        for n, p in params.items():
            g = grads[n].float()
            g = torch.where(clip, (g / norm) * cfg.grad_clip, g)
            mu = (1 - b1) * g + b1 * state.mu[n]
            nu = (1 - b2) * (g * g) + b2 * state.nu[n]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            if cfg.weight_decay:
                u = u + cfg.weight_decay * p.float()
            keep((p.float() + step_size * u).to(p.dtype), p)
            keep(mu, state.mu[n])
            keep(nu, state.nu[n])
        keep(count_inc, state.count)
        return state


def build_optimizer(cfg: OptimizerConfig) -> ClipAdamW:
    """Global-norm clip -> AdamW(schedule), applied to the trainable
    parameters only."""
    return ClipAdamW(cfg)
