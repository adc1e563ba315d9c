"""Weights in and out of the port's Llama modules.

* :func:`params_from_jax` — the JAX package's params tree (a nested dict of
  numpy arrays, as ``jax.device_get(model.init(...)["params"])`` gives) to
  this package's state dict. Layouts agree, so it is a rename:
  ``model/layers_{i}/attn/q_proj/kernel`` becomes
  ``model.layers.{i}.attn.q_proj.kernel``. LoRA factors (``lora_a``,
  ``lora_b``) cross like any other leaf, so both packages start from the
  same adapter.
* :func:`init_params` — a full-width random model filled directly on the
  device from a seeded ``torch.Generator``: embed and head normal(0.02),
  projection kernels lecun-normal (the reference's ``LoRADense`` default),
  norm scales ones (zeros under ``rmsnorm_offset``), biases zeros.

Both return ``{name: tensor}``; ``load_model`` builds a module around them
without copying.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from dlti_tpu_torch.config import LoRAConfig, ModelConfig
from dlti_tpu_torch.models.llama import LlamaForCausalLM
from dlti_tpu_torch.models.lora import is_lora_name
from dlti_tpu_torch.utils.device import resolve_device

# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so the truncated distribution has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: same bits as torch.bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten a JAX params tree into this package's state-dict names."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [str(k)])
            return
        name = ".".join(path)
        out[re.sub(r"layers_(\d+)", r"layers.\1", name)] = _to_tensor(node)

    walk(tree, [])
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                lora: Optional[LoRAConfig] = None) -> Dict[str, torch.Tensor]:
    """Random weights for ``cfg`` at full width, made on ``device`` (the card
    unless named) from ``torch.Generator(device).manual_seed(seed)``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = LlamaForCausalLM(cfg, lora, device="meta").state_dict()
    params = {}
    for name, meta in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            fill = 0.0 if cfg.rmsnorm_offset else 1.0
            t = torch.full(meta.shape, fill, dtype=meta.dtype, device=device)
        elif leaf in ("bias", "lora_b"):
            t = torch.zeros(meta.shape, dtype=meta.dtype, device=device)
        else:
            w = torch.empty(meta.shape, dtype=torch.float32, device=device)
            if leaf in ("embed_tokens", "lm_head"):
                w.normal_(0.0, 0.02, generator=gen)
            elif leaf == "kernel":
                std = math.sqrt(1.0 / meta.shape[0]) / _TRUNC_STD
                torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                            generator=gen)
            else:  # lora_a: PEFT's kaiming-uniform, variance 1 / (3 fan_in)
                bound = math.sqrt(1.0 / meta.shape[0])
                w.uniform_(-bound, bound, generator=gen)
            t = w.to(meta.dtype)
        params[name] = t
    return params


def load_model(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
               device=None, lora: Optional[LoRAConfig] = None,
               trainable_lora: bool = False) -> LlamaForCausalLM:
    """A ``LlamaForCausalLM`` on ``device`` whose parameters are ``params``
    (moved there if they are elsewhere; not copied if they are already).

    Every parameter is frozen and the module is in eval mode, unless
    ``trainable_lora``: then the ``lora_a``/``lora_b`` leaves require grad
    (the base stays frozen) and the module is in train mode."""
    device = resolve_device(device)
    model = LlamaForCausalLM(cfg, lora, device="meta")
    state = {k: v.to(device) for k, v in params.items()}
    model.load_state_dict(state, assign=True, strict=True)
    for name, p in model.named_parameters():
        p.requires_grad_(trainable_lora and is_lora_name(name))
    return model.train(trainable_lora)
