"""Weights in and out of the port's Llama modules.

* :func:`params_from_jax` — the JAX package's params tree (a nested dict of
  numpy arrays, as ``jax.device_get(model.init(...)["params"])`` gives, or
  of tensors) to this package's state dict. Layouts agree, so it is a
  rename: ``model/layers_{i}/attn/q_proj/kernel`` becomes
  ``model.layers.{i}.attn.q_proj.kernel``. LoRA factors (``lora_a``,
  ``lora_b``) cross like any other leaf, so both packages start from the
  same adapter. :func:`params_to_jax` is its inverse.
* :func:`tensor_to_numpy` / :func:`numpy_to_tensor` — the numpy codec the
  checkpoint store writes with: a tensor's bytes and the numpy dtype name
  the JAX package records. ``bfloat16`` travels as its bits (``uint16``)
  under the name ``"bfloat16"``, since numpy knows that dtype only once
  ``ml_dtypes`` is imported, and the port never imports it.
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
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from dlti_tpu_torch.config import LoRAConfig, ModelConfig
from dlti_tpu_torch.models.llama import LlamaForCausalLM
from dlti_tpu_torch.models.lora import is_lora_name
from dlti_tpu_torch.models.quantization import install_quantized, quant_bases
from dlti_tpu_torch.utils.device import resolve_device

# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so the truncated distribution has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


_BITS = {"bfloat16": (torch.bfloat16, np.uint16)}


def tensor_to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A CPU tensor's numpy view (no copy) and the dtype name the JAX
    package writes for it; ``bfloat16`` comes back as its ``uint16`` bits."""
    name = str(t.dtype).removeprefix("torch.")
    if name in _BITS:
        return t.view(torch.int16).numpy().view(_BITS[name][1]), name
    return t.numpy(), np.dtype(name).name


def numpy_to_tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The inverse of :func:`tensor_to_numpy`, sharing ``a``'s memory:
    ``a`` holds the values, or for ``bfloat16`` their bits (any 2-byte
    dtype)."""
    if dtype_name in _BITS:
        return torch.from_numpy(a.view(np.int16)).view(_BITS[dtype_name][0])
    if a.dtype.name != dtype_name:
        raise ValueError(f"array of {a.dtype.name} where {dtype_name} was expected")
    return torch.from_numpy(a)


def _to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: same bits as torch.bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def jax_path(name: str) -> Tuple[str, ...]:
    """This package's parameter name as the JAX params tree's key path:
    ``model.layers.3.attn.q_proj.kernel`` is
    ``('model', 'layers_3', 'attn', 'q_proj', 'kernel')``."""
    return tuple(re.sub(r"layers\.(\d+)", r"layers_\1", name).split("."))


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


def params_to_jax(params: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`params_from_jax`: ``{name: tensor}`` as the JAX
    package's nested params dict (leaves stay tensors)."""
    out: dict = {}
    for name, t in params.items():
        *parents, leaf = jax_path(name)
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t
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
    A weight ``params`` holds quantized (``{name}.q`` and ``{name}.scale``,
    ``models.quantization``) becomes a ``QuantizedWeight`` of the module.

    Every parameter is frozen and the module is in eval mode, unless
    ``trainable_lora``: then the ``lora_a``/``lora_b`` leaves require grad
    (the base stays frozen) and the module is in train mode."""
    device = resolve_device(device)
    model = LlamaForCausalLM(cfg, lora, device="meta")
    install_quantized(model, quant_bases(params))
    state = {k: v.to(device) for k, v in params.items()}
    model.load_state_dict(state, assign=True, strict=True)
    for name, p in model.named_parameters():
        p.requires_grad_(trainable_lora and is_lora_name(name))
    return model.train(trainable_lora)
