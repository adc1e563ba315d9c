"""Train state: the port of ``dlti_tpu/training/state.py``
(``partition_params``, ``create_train_state``).

The state holds the step count, the model (whose frozen base and trainable
LoRA leaves are its parameters) and the optimizer state over the trainable
subset only.

:func:`state_leaves` names the state as the JAX ``TrainState``'s pytree
leaves, in JAX's flatten order, for the checkpoint store; for
``chain(clip_by_global_norm, adamw(schedule))``::

    .step                                       int32 []
    .params['lm_head'], .params['model'][...]   sorted keys
    .opt_state[1][0].count                      int32 [] (Adam's count)
    .opt_state[1][0].mu[('model', 'layers_0', ...)]   sorted key tuples
    .opt_state[1][0].nu[(...)]                  every mu before every nu
    .opt_state[1][2].count                      int32 [] (the schedule's)

The port's one ``AdamWState.count`` (a 0-d int32 tensor on the
parameters' device) is both counts, so the snapshot copies it with the
other device leaves; :func:`load_state_leaves` reads both back and checks
that they agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import torch
from torch import nn

from dlti_tpu_torch.models.interop import jax_path
from dlti_tpu_torch.models.lora import is_lora_name
from dlti_tpu_torch.training.optimizer import AdamWState, ClipAdamW

_ADAM = ".opt_state[1][0]"
_SCHEDULE_COUNT = ".opt_state[1][2].count"


def _is_trainable(name: str, lora_enabled: bool) -> bool:
    return not lora_enabled or is_lora_name(name)


def partition_params(params: Mapping[str, torch.Tensor], lora_enabled: bool
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Split ``{name: tensor}`` into (trainable, frozen): the LoRA leaves
    under LoRA, everything in a full fine-tune."""
    trainable = {n: t for n, t in params.items() if _is_trainable(n, lora_enabled)}
    frozen = {n: t for n, t in params.items() if not _is_trainable(n, lora_enabled)}
    return trainable, frozen


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: AdamWState
    tx: ClipAdamW
    lora_enabled: bool = True

    def trainable(self) -> Dict[str, torch.Tensor]:
        return partition_params(dict(self.model.named_parameters()),
                                self.lora_enabled)[0]


def create_train_state(model: nn.Module, tx: ClipAdamW,
                       lora_enabled: bool = True) -> TrainState:
    """Step 0, the model with its trainable leaves requiring grad (and only
    those), and the optimizer state over them."""
    trainable, _ = partition_params(dict(model.named_parameters()), lora_enabled)
    if not trainable:
        raise ValueError("no trainable params found (LoRA enabled but no "
                         "adapters grafted)")
    for name, p in model.named_parameters():
        p.requires_grad_(name in trainable)
    return TrainState(step=0, model=model, opt_state=tx.init(trainable), tx=tx,
                      lora_enabled=lora_enabled)


def params_key(name: str) -> str:
    """A parameter's leaf name in the JAX ``TrainState``:
    ``.params['model']['layers_0']['attn']['q_proj']['kernel']``."""
    return ".params" + "".join(f"[{k!r}]" for k in jax_path(name))


def frozen_param_keys(state: TrainState) -> List[str]:
    """The leaf names of the parameters no step changes (the base under
    LoRA; none in a full fine-tune)."""
    trainable = state.trainable()
    return [params_key(n) for n, _ in state.model.named_parameters()
            if n not in trainable]


def state_leaves(state: TrainState) -> List[Tuple[str, torch.Tensor]]:
    """The state as ``[(jax leaf name, tensor)]`` in the JAX flatten order
    (see the module docstring). Tensors are the live ones (parameters,
    moments and the count, on their device); the step is a new CPU int32
    scalar."""
    params = sorted(state.model.named_parameters(), key=lambda kv: jax_path(kv[0]))
    moments = sorted(state.opt_state.mu, key=jax_path)
    count = state.opt_state.count
    return ([(".step", torch.tensor(state.step, dtype=torch.int32))]
            + [(params_key(n), p) for n, p in params]
            + [(f"{_ADAM}.count", count)]
            + [(f"{_ADAM}.mu[{jax_path(n)!r}]", state.opt_state.mu[n]) for n in moments]
            + [(f"{_ADAM}.nu[{jax_path(n)!r}]", state.opt_state.nu[n]) for n in moments]
            + [(_SCHEDULE_COUNT, count)])


@torch.no_grad()
def load_state_leaves(state: TrainState,
                      leaves: Sequence[Tuple[str, torch.Tensor]]) -> None:
    """Load ``leaves`` (named as :func:`state_leaves` names them, e.g. from
    ``restore_train_state``) into ``state``, in place: parameters, moments
    and the count keep their tensors (and devices), so a CUDA graph that
    captured them stays valid; the step becomes an int. Reads the counts
    back to the host once."""
    got = dict(leaves)
    want = [name for name, _ in state_leaves(state)]
    if sorted(got) != sorted(want):
        missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        raise ValueError(f"leaves do not match the state: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    adam_count, schedule_count = int(got[f"{_ADAM}.count"]), int(got[_SCHEDULE_COUNT])
    if adam_count != schedule_count:
        raise ValueError(f"Adam's count {adam_count} and the schedule's count "
                         f"{schedule_count} disagree")
    for n, p in state.model.named_parameters():
        p.copy_(got[params_key(n)])
    opt = state.opt_state
    for n in state.trainable():
        opt.mu[n].copy_(got[f"{_ADAM}.mu[{jax_path(n)!r}]"])
        opt.nu[n].copy_(got[f"{_ADAM}.nu[{jax_path(n)!r}]"])
    opt.count.fill_(adam_count)
    state.step = int(got[".step"])
