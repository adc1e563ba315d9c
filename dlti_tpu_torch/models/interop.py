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
  projection kernels, a mixture of experts' router and stacked experts
  lecun-normal (the reference's ``LoRADense`` and ``MoEMLP`` defaults, fan
  in every dim but the last, as flax's ``variance_scaling`` counts it: the
  contraction dim -2 of a kernel, ``E * h`` of an ``(E, h, m)`` stack of
  experts), norm scales ones (zeros under
  ``rmsnorm_offset``), biases zeros. :func:`init_params_int8` is the same
  model quantized leaf by leaf as it is drawn (the tree at full precision
  never exists: Mixtral-8x7B's 93 GB of bf16 would not fit one card).

Both return ``{name: tensor}``; ``load_model`` builds a module around them
without copying.

* :func:`shard_params` — a rank's part of a whole tree (from
  :func:`init_params`, :func:`params_from_jax` or
  ``load_hf_checkpoint``) under tensor parallelism
  (``parallel.tensor.tensor_shard_dim``), int8 weights quantized whole and
  then sliced; :func:`gather_params` gives the writer whole leaves again.
  :func:`init_params` and :func:`init_params_int8` take the mesh too and
  slice each leaf as it is drawn (whole from the shared generator, so
  every rank draws the same model). ``load_model(..., tensor=)`` builds the
  module at the rank's local widths around such a tree.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from dlti_tpu_torch.config import LoRAConfig, ModelConfig
from dlti_tpu_torch.models.llama import LlamaForCausalLM
from dlti_tpu_torch.models.lora import is_lora_name
from dlti_tpu_torch.models.quantization import (
    install_quantized, quant_bases, quantize_int8, quantize_params_int8, should_quantize,
)
from dlti_tpu_torch.parallel.tensor import quant_normalized_name, tensor_shard_dim
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


# Leaves drawn lecun-normal, fan in every dim but the last (flax's
# variance_scaling with in_axis -2 and out_axis -1 multiplies the in axis by
# the receptive field, every other axis but out).
_LECUN = ("kernel", "router", "w1", "w2", "w3")


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                lora: Optional[LoRAConfig] = None, mesh=None) -> Dict[str, torch.Tensor]:
    """Random weights for ``cfg`` at full width, made on ``device`` (the card
    unless named) from ``torch.Generator(device).manual_seed(seed)``.
    ``mesh``: keep this rank's part of each tensor-split leaf, sliced as it
    is drawn (:func:`shard_params`)."""
    if mesh is None or not mesh.tensor_parallel:
        return dict(_draw_params(cfg, seed, device, lora))
    out: Dict[str, torch.Tensor] = {}
    for name, t in _draw_params(cfg, seed, device, lora):
        out.update(_place(name, t, tuple(t.shape), mesh.tensor, quantize=False))
        del t
    return out


def init_params_int8(cfg: ModelConfig, seed: int = 0, device=None,
                     lora: Optional[LoRAConfig] = None, mesh=None
                     ) -> Dict[str, torch.Tensor]:
    """``quantize_params_int8(init_params(cfg, seed, device, lora))``, leaf
    for leaf the same values, made one leaf at a time: each weight is drawn
    and quantized before the next is drawn, so the device holds the int8
    tree and one leaf at full precision at most. ``mesh``: each leaf is
    quantized whole, then this rank keeps its part (:func:`shard_params`)."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in _draw_params(cfg, seed, device, lora):
        if mesh is not None and mesh.tensor_parallel:
            out.update(_place(name, t, tuple(t.shape), mesh.tensor, quantize=True))
        else:
            out.update(quantize_params_int8({name: t}, donate=True))
        del t
    return out


def _whole_shapes(cfg: ModelConfig, lora: Optional[LoRAConfig]) -> Dict[str, tuple]:
    """Every leaf's whole shape, by the name a full-precision tree gives it."""
    return {n: tuple(t.shape)
            for n, t in LlamaForCausalLM(cfg, lora, device="meta").state_dict().items()}


def _leaf_shape(name: str, whole: Mapping[str, tuple]) -> tuple:
    """Leaf ``name``'s whole shape from the full-precision shapes, an int8
    pair's leaves included (``scale`` reduced over the contraction dim)."""
    base = quant_normalized_name(name)
    if base == name:
        return whole[name]
    w = whole[base]
    return w if name.endswith(".q") else w[:-2] + (1, w[-1])


def _part(t: torch.Tensor, d: Optional[int], axis) -> torch.Tensor:
    """Rank ``axis.rank``'s part of the whole ``t`` along ``d`` (a copy),
    or ``t``."""
    if d is None or axis.world == 1:
        return t
    n = t.shape[d] // axis.world
    return t.narrow(d, axis.rank * n, n).clone()


def _place(name: str, t: torch.Tensor, whole: tuple, axis, quantize: bool
           ) -> Dict[str, torch.Tensor]:
    """Leaf ``name`` (whole shape ``whole``) as this tensor rank holds it:
    its part along the rule's dim when ``t`` is whole, ``t`` itself when it
    is already the part; with ``quantize``, a weight
    :func:`~dlti_tpu_torch.models.quantization.should_quantize` selects is
    quantized whole first, and both leaves of the pair are sliced."""
    d = tensor_shard_dim(name, whole, axis.world)
    local = list(whole)
    if d is not None:
        local[d] //= axis.world
    shape = tuple(t.shape)
    if shape not in (whole, tuple(local)):
        raise ValueError(f"{name}: shape {shape} is neither the whole leaf's {whole} "
                         f"nor a tensor rank's part {tuple(local)}")
    is_whole = shape == whole or d is None
    if quantize and should_quantize(name, t):
        if not is_whole:
            raise ValueError(f"{name}: an int8 weight is quantized whole, then sliced "
                             "(a part's scales would span part of its contraction dim); "
                             "pass whole weights or init_params_int8(mesh=)")
        q, scale = quantize_int8(t)
        return {f"{name}.q": _part(q, tensor_shard_dim(f"{name}.q", q.shape, axis.world), axis),
                f"{name}.scale": _part(scale, tensor_shard_dim(f"{name}.scale", scale.shape,
                                                               axis.world), axis)}
    return {name: _part(t, d, axis) if is_whole else t}


def shard_params(params, mesh, cfg: ModelConfig, lora: Optional[LoRAConfig] = None, *,
                 device=None, quantize: bool = False, donate: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """This tensor rank's tree of ``params`` under ``mesh`` (a leaf already
    at the rank's part passes as it is), each leaf moved to ``device``
    (default: where it lies) first. ``quantize``: the weights
    ``quantize_params_int8`` selects become int8 pairs, each quantized
    whole and then sliced (a column-parallel weight's scales split with its
    output channels, a row-parallel one's held whole, as the reference's
    ``_quant_normalized_path`` places them). ``donate``: each source leaf
    is popped as it is placed. Without a tensor group, ``params`` as they
    are."""
    if not mesh.tensor_parallel:
        return dict(params)
    whole = _whole_shapes(cfg, lora)
    done = quant_bases(params)
    out: Dict[str, torch.Tensor] = {}
    for name in list(params):
        t = params.pop(name) if donate else params[name]
        if device is not None:
            t = t.to(device)
        out.update(_place(name, t, _leaf_shape(name, whole), mesh.tensor,
                          quantize and name.rpartition(".")[0] not in done
                          and quant_normalized_name(name) == name))
        del t
    return out


def gather_params(params: Mapping[str, torch.Tensor], mesh, cfg: ModelConfig,
                  lora: Optional[LoRAConfig] = None) -> Dict[str, torch.Tensor]:
    """The whole tree from every tensor rank's :func:`shard_params` parts
    (a collective over the tensor group; every rank gets it, in host
    memory, leaf after leaf), for an export or a checkpoint."""
    if not mesh.tensor_parallel:
        return dict(params)
    from dlti_tpu_torch.parallel.sharding import gather_whole

    whole = _whole_shapes(cfg, lora)
    axis = mesh.tensor
    return {name: gather_whole(t, tensor_shard_dim(name, _leaf_shape(name, whole), axis.world),
                               axis)
            for name, t in params.items()}


def _draw_params(cfg: ModelConfig, seed: int, device, lora: Optional[LoRAConfig]
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of every leaf in the state-dict order, drawn from
    one generator."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = LlamaForCausalLM(cfg, lora, device="meta").state_dict()
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
            elif leaf in _LECUN:
                std = math.sqrt(1.0 / math.prod(meta.shape[:-1])) / _TRUNC_STD
                torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                            generator=gen)
            else:  # lora_a: PEFT's kaiming-uniform, variance 1 / (3 fan_in)
                bound = math.sqrt(1.0 / meta.shape[0])
                w.uniform_(-bound, bound, generator=gen)
            t = w.to(meta.dtype)
            del w
        yield name, t
        del t  # the caller's reference alone keeps the leaf


def load_model(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
               device=None, lora: Optional[LoRAConfig] = None,
               trainable_lora: bool = False, tensor=None) -> LlamaForCausalLM:
    """A ``LlamaForCausalLM`` on ``device`` whose parameters are ``params``
    (moved there if they are elsewhere; not copied if they are already).
    A weight ``params`` holds quantized (``{name}.q`` and ``{name}.scale``,
    ``models.quantization``) becomes a ``QuantizedWeight`` of the module.
    ``tensor`` (``Mesh.tensor``): ``params`` is a tensor rank's tree
    (:func:`shard_params`), and the module runs at its local widths.

    Every parameter is frozen and the module is in eval mode, unless
    ``trainable_lora``: then the ``lora_a``/``lora_b`` leaves require grad
    (the base stays frozen) and the module is in train mode."""
    device = resolve_device(device)
    model = LlamaForCausalLM(cfg, lora, device="meta")
    install_quantized(model, quant_bases(params))
    if tensor is not None:
        for name, p in list(model.named_parameters()):
            d = tensor_shard_dim(name, p.shape, tensor.world)
            if d is not None:
                prefix, _, leaf = name.rpartition(".")
                owner = model.get_submodule(prefix) if prefix else model
                setattr(owner, leaf, torch.nn.Parameter(
                    p.narrow(d, 0, p.shape[d] // tensor.world), requires_grad=False))
        model.set_tensor_axis(tensor)
    state = {k: v.to(device) for k, v in params.items()}
    model.load_state_dict(state, assign=True, strict=True)
    for name, p in model.named_parameters():
        p.requires_grad_(trainable_lora and is_lora_name(name))
    return model.train(trainable_lora)
