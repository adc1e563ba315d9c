"""The train step: the port of ``dlti_tpu/training/step.py``'s bf16 path
(``causal_lm_loss``, ``guard_nonfinite_update``, ``make_train_step``).

One optimizer step: forward and backward over each microbatch of the
leading ``accum`` axis with float32 gradient accumulation, the token-mean
loss (gradients divided by the total token count), the optimizer (clip +
AdamW), and the metrics ``loss``, ``grad_norm`` (before clipping),
``num_tokens``, ``nonfinite`` and ``skipped_update``. A step whose loss or
gradient norm is not finite leaves the parameters and the optimizer state
(its count, and with it the schedule) as they were; the step count still
advances. The fp16 loss scaler and ``loss_chunk`` are not ported
(``Trainer`` refuses a config that asks for them); the MoE aux loss is not
ported either, and a MoE model raises here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from dlti_tpu_torch.models.llama import derive_seed
from dlti_tpu_torch.training.optimizer import global_norm
from dlti_tpu_torch.training.state import TrainState


def causal_lm_loss(logits: torch.Tensor, input_ids: torch.Tensor,
                   loss_mask: Optional[torch.Tensor] = None) -> tuple:
    """Next-token cross-entropy: returns (sum of token losses, token count),
    labels being the inputs shifted left, masked by ``loss_mask[:, 1:]``."""
    targets = input_ids[:, 1:].long()
    logits = logits[:, :-1, :].float()
    if loss_mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=logits.device)
    else:
        mask = loss_mask[:, 1:].float()
    token_loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 targets.reshape(-1), reduction="none")
    return (token_loss.reshape(targets.shape) * mask).sum(), mask.sum()


def guard_nonfinite_update(grad_norm: torch.Tensor, loss: torch.Tensor) -> tuple:
    """Whether the update may be applied (loss and grad norm finite), and
    the ``nonfinite``/``skipped_update`` metrics. Reads the two scalars on
    the host: one synchronisation per step."""
    finite = bool(torch.isfinite(grad_norm).item() and torch.isfinite(loss).item())
    bad = 0.0 if finite else 1.0
    return finite, {"nonfinite": bad, "skipped_update": bad}


def make_train_step(model, *, accum_steps: int = 1) -> Callable:
    """Build ``train_step(state, batch, step_seed) -> metrics``, updating
    ``state`` in place. ``batch`` holds tensors on the model's device shaped
    (accum, micro_bs, seq): ``input_ids`` and optionally ``loss_mask``,
    ``positions``, ``segment_ids``. ``step_seed`` seeds the LoRA dropout
    masks (one seed per microbatch is derived from it); None runs without
    dropout."""
    if model.cfg.num_experts > 0:
        raise NotImplementedError("MoE training is not ported yet (see ROADMAP.md)")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   step_seed: Optional[int]) -> dict:
        trainable = state.trainable()
        names = list(trainable)
        leaves = [trainable[n] for n in names]
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        dev = leaves[0].device
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        n_tok = torch.zeros((), dtype=torch.float32, device=dev)
        for a in range(accum_steps):
            ids = batch["input_ids"][a]
            mask = batch.get("loss_mask")
            logits = state.model(
                ids, positions=_micro(batch, "positions", a),
                segment_ids=_micro(batch, "segment_ids", a),
                dropout_seed=derive_seed(step_seed, a))
            ls, nt = causal_lm_loss(logits, ids, None if mask is None else mask[a])
            del logits
            for acc, g in zip(grads, torch.autograd.grad(ls, leaves)):
                acc += g.float()
            loss_sum += ls.detach()
            n_tok += nt
        # Token-mean loss over the whole step (HF Trainer's semantics under
        # grad accumulation).
        n_tok = torch.clamp(n_tok, min=1.0)
        grads = {n: g / n_tok for n, g in zip(names, grads)}
        loss = loss_sum / n_tok
        grad_norm = global_norm(grads)
        finite, extra = guard_nonfinite_update(grad_norm, loss)
        if finite:
            state.opt_state = state.tx.update(grads, state.opt_state, trainable)
        state.step += 1
        return {"loss": float(loss), "grad_norm": float(grad_norm),
                "num_tokens": float(n_tok), **extra}

    return train_step


def _micro(batch: dict, key: str, a: int):
    t = batch.get(key)
    return None if t is None else t[a]
