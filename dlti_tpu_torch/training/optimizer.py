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

``init`` and ``update`` follow the state's ``parallel.sharding.Layout``
(on one device, every leaf whole). Under a ZeRO strategy the moments of a
trainable leaf hold only this rank's part (``Layout.moment_axes``), the
gradient ``update`` takes is the one this rank owns (that part, or the whole
leaf), and the update runs on the part of the parameter: a leaf the
placement rule splits is its part already, a leaf it leaves whole is updated
on its shard over the moments' axis (``data`` under ZeRO-1/2, ``fsdp`` under
ZeRO-3) and its new whole value all-gathered after it. The clip reads
the norm of the whole gradient (``sharded_sq_norm``). With
``offload_optimizer`` on the card the moments rest in pinned host memory and
cross to the card for the update and back, with the same arithmetic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Union

import torch

from dlti_tpu_torch.config import OptimizerConfig
from dlti_tpu_torch.parallel.sharding import (
    Layout, all_gather_dim, shard_of, sharded_sq_norm,
)


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


class ClipAdamW:
    """Global-norm clip, then AdamW with a schedule, over a dict of
    parameters; ``update`` writes the new parameters and state in place."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = build_schedule(cfg)

    def init(self, params: Dict[str, torch.Tensor], layout: Layout) -> AdamWState:
        """Zero moments shaped like the part of each leaf this rank updates
        (its shard under a ZeRO ``layout``), in pinned host memory under
        ``offload_optimizer`` on the card."""
        device = next(iter(params.values())).device if params else None
        host = (layout.offload_optimizer and device is not None
                and device.type == "cuda")

        def zeros(n: str, p: torch.Tensor) -> torch.Tensor:
            if layout.gathers_update(n):
                p = shard_of(p, layout.leaves[n].opt_dim, layout.opt_view(n))
            if host:
                return torch.zeros(p.shape, dtype=torch.float32, pin_memory=True)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={n: zeros(n, p) for n, p in params.items()},
            nu={n: zeros(n, p) for n, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor], apply: torch.Tensor,
               layout: Layout, norm: Optional[torch.Tensor] = None) -> AdamWState:
        """One update of ``params`` and ``state`` in place. ``apply``: a 0-d
        bool tensor; where it is False the parameters, the moments and the
        count keep their values (the update is computed and dropped).
        ``layout``: the state's placement (``grads`` are the gradients this
        rank owns); ``norm``: the whole gradient's norm when the caller has
        it already."""
        cfg = self.cfg
        b1, b2 = cfg.betas
        if norm is None:
            norm = torch.sqrt(sharded_sq_norm(grads, layout))
        clip = norm >= cfg.grad_clip
        count_inc = state.count + 1
        bc1, bc2 = 1 - b1 ** count_inc.float(), 1 - b2 ** count_inc.float()
        step_size = -self.schedule(state.count)

        def keep(new, old):  # in place: old <- new where apply
            torch.where(apply, new, old, out=old)

        for n, whole in params.items():
            gathered = layout.gathers_update(n)
            p = shard_of(whole, layout.leaves[n].opt_dim, layout.opt_view(n)) if gathered else whole
            mu_old, nu_old = state.mu[n], state.nu[n]
            if mu_old.device != p.device:  # offloaded moments: onto the card
                mu_old = mu_old.to(p.device, non_blocking=True)
                nu_old = nu_old.to(p.device, non_blocking=True)
            g = grads[n].float()
            g = torch.where(clip, (g / norm) * cfg.grad_clip, g)
            mu = (1 - b1) * g + b1 * mu_old
            nu = (1 - b2) * (g * g) + b2 * nu_old
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            if cfg.weight_decay:
                u = u + cfg.weight_decay * p.float()
            keep((p.float() + step_size * u).to(p.dtype), p)
            keep(mu, mu_old)
            keep(nu, nu_old)
            if mu_old is not state.mu[n]:  # ... and back to pinned host memory
                state.mu[n].copy_(mu_old, non_blocking=True)
                state.nu[n].copy_(nu_old, non_blocking=True)
            if gathered:
                whole.copy_(all_gather_dim(p, layout.leaves[n].opt_dim, layout.opt_view(n)))
        keep(count_inc, state.count)
        return state


def build_optimizer(cfg: OptimizerConfig) -> ClipAdamW:
    """Global-norm clip -> AdamW(schedule), applied to the trainable
    parameters only."""
    return ClipAdamW(cfg)
