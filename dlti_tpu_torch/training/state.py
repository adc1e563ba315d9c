"""Train state: the port of ``dlti_tpu/training/state.py``
(``partition_params``, ``create_train_state``).

The state holds the step count, the model (whose frozen base and trainable
LoRA leaves are its parameters) and the optimizer state over the trainable
subset only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from dlti_tpu_torch.models.lora import is_lora_name
from dlti_tpu_torch.training.optimizer import AdamWState, ClipAdamW


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
