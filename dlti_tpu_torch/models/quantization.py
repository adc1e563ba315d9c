"""Weight-only int8 quantization: the port of
``dlti_tpu/models/quantization.py`` (``quantize_params_int8``,
``maybe_dequantize`` as :func:`dequantize`, ``dequantize_params``,
``quantization_error``; ``is_quant_node`` as :func:`quant_bases` over flat
names), with the reference's leaf selection and arithmetic bit for bit.

A quantized weight is a pair of leaves in place of the weight: ``q``, int8,
the weight's shape, and ``scale``, float32, the weight's shape with the
contraction dim (-2) reduced to 1: symmetric absmax per output channel.
Flat names append ``.q`` and ``.scale`` to the weight's name
(``model.layers.0.attn.q_proj.kernel.q``), which is the JAX tree's
``{"q", "scale"}`` node at the kernel's path, so checkpoints and exports
cross between the packages by name. In a module the pair is a
:class:`QuantizedWeight` submodule under the weight's attribute name.

The consumers (``models.lora.LoRADense``, the embedding and the head in
``models.llama``) expand a weight at its use, one layer at a time, as
ordinary PyTorch: ``torch.mul(q, scale, out=<dtype tensor>)`` reads the
int8 payload and writes the compute-dtype weight in one elementwise pass,
computing ``float32(q) * scale`` and rounding once, which is the
reference's ``(q.astype(float32) * scale).astype(dtype)`` bit for bit. The
frozen product :func:`int8_matmul` keeps only ``q`` and ``scale`` for the
backward and expands the weight again there, so a run without remat never
holds an expanded base between its forward and its backward.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, MutableMapping, Optional, Tuple

import torch
from torch import nn

# Leaves worth quantizing: big 2-D+ matmul weights. Tiny/1-D leaves (norm
# scales, biases, LoRA factors) keep their dtype.
_MIN_QUANT_SIZE = 1 << 14
# LoRA factors are tiny; the MoE router stays float32 in the reference.
_NEVER_QUANTIZED = ("lora_a", "lora_b", "router")


def should_quantize(name: str, t: torch.Tensor) -> bool:
    """The reference's ``_should_quantize`` for the leaf ``name``."""
    if t.dim() < 2 or t.numel() < _MIN_QUANT_SIZE:
        return False
    return name.rsplit(".", 1)[-1] not in _NEVER_QUANTIZED


def quantize_int8(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` of one weight, where it lies: absmax over dim -2 (kept
    as size 1), ``scale = absmax / 127`` where it is above 0 else 1,
    ``q = clip(round_half_even(t / scale), -127, 127)``, all in float32."""
    v32 = t.float()
    absmax = v32.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(v32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(float32(q) * scale).to(dtype)`` in one elementwise pass: the
    product is formed in float32 and rounded once to ``dtype`` as it is
    written."""
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    return torch.mul(q, scale, out=out)


class QuantizedWeight(nn.Module):
    """A frozen weight held as int8 ``q`` and float32 ``scale`` parameters
    (no gradient), in place of the weight's parameter."""

    def __init__(self, shape, device=None):
        super().__init__()
        shape = tuple(shape)
        self.q = nn.Parameter(torch.empty(shape, dtype=torch.int8, device=device),
                              requires_grad=False)
        self.scale = nn.Parameter(torch.empty(shape[:-2] + (1, shape[-1]),
                                              dtype=torch.float32, device=device),
                                  requires_grad=False)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def weight(self, dtype: torch.dtype) -> torch.Tensor:
        return dequantize(self.q, self.scale, dtype)


class _Int8Matmul(torch.autograd.Function):
    """``x @ dequantize(q, scale)`` for a frozen weight: saves ``q`` and
    ``scale`` (not the expanded weight) and expands again for dx."""

    @staticmethod
    def forward(ctx, x, q, scale):
        ctx.save_for_backward(q, scale)
        ctx.dtype = x.dtype
        return x @ dequantize(q, scale, x.dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        q, scale = ctx.saved_tensors
        return g @ dequantize(q, scale, ctx.dtype).T, None, None


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequantize(q, scale, x.dtype)``, differentiable in ``x`` only."""
    return _Int8Matmul.apply(x, q, scale)


def quant_bases(names: Iterable[str]) -> Dict[str, None]:
    """The weight names that a flat dict holds quantized (``{base}.q`` and
    ``{base}.scale`` both present), in order: over flat names, the
    reference's ``is_quant_node``."""
    names = list(names)
    present = set(names)
    return {n[:-2]: None for n in names
            if n.endswith(".q") and f"{n[:-2]}.scale" in present}


def quantize_params_int8(params: MutableMapping[str, torch.Tensor], device=None,
                         donate: bool = False) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` with every weight :func:`should_quantize` selects
    replaced by ``{name}.q`` and ``{name}.scale``, in the input's order.
    Each leaf is moved to ``device`` (default: where it lies) before it is
    quantized, so a host tree becomes a device tree one leaf at a time.
    ``donate=True`` pops each source from ``params`` as its pair is made,
    so the bf16 source and the int8 tree never coexist whole (the caller's
    dict is emptied). A weight the tree holds quantized already (its
    ``.q``/``.scale`` pair, e.g. from ``models.interop.init_params_int8``)
    is moved as it is."""
    out: Dict[str, torch.Tensor] = {}
    done = quant_bases(params)
    for name in list(params):
        t = params.pop(name) if donate else params[name]
        dev = t.device if device is None else device
        if should_quantize(name, t) and name.rpartition(".")[0] not in done:
            q, scale = quantize_int8(t.to(dev))
            out[f"{name}.q"], out[f"{name}.scale"] = q, scale
        else:
            out[name] = t.to(dev)
        del t
    return out


def dequantize_params(params: Mapping[str, torch.Tensor],
                      dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The whole tree expanded (tests and exports): each ``{name}.q`` /
    ``{name}.scale`` pair back to ``{name}`` in ``dtype``."""
    bases = quant_bases(params)
    out: Dict[str, torch.Tensor] = {}
    for name, t in params.items():
        base = name.rpartition(".")[0]
        if base in bases:
            if name.endswith(".q"):
                out[base] = dequantize(t, params[f"{base}.scale"], dtype)
            continue
        out[name] = t
    return out


def quantization_error(params: Mapping[str, torch.Tensor],
                       qparams: Mapping[str, torch.Tensor]) -> float:
    """Worst relative per-leaf RMS error of ``qparams`` against ``params``."""
    deq = dequantize_params(qparams, torch.float32)
    worst = 0.0
    for name, a in params.items():
        a32, b = a.float(), deq[name].float()
        rms = float(torch.sqrt(torch.mean((a32 - b) ** 2)))
        denom = float(torch.sqrt(torch.mean(a32 ** 2))) or 1.0
        worst = max(worst, rms / denom)
    return worst


def install_quantized(model: nn.Module, bases: Iterable[str]) -> None:
    """Replace each weight parameter named in ``bases`` by a
    :class:`QuantizedWeight` of its shape on its device (a ``meta`` model's
    slots, before ``load_state_dict``)."""
    whole = getattr(model, "whole_shapes", None)
    for base in bases:
        prefix, _, leaf = base.rpartition(".")
        owner = model.get_submodule(prefix) if prefix else model
        old = getattr(owner, leaf)
        delattr(owner, leaf)
        new = QuantizedWeight(old.shape, device=old.device)
        setattr(owner, leaf, new)
        if whole is not None:
            del whole[base]
            whole.update({f"{base}.{n}": tuple(p.shape) for n, p in new.named_parameters()})


def weight_of(attr, name: str, fetcher, dtype: Optional[torch.dtype]):
    """A module's weight ``attr`` (a parameter or a :class:`QuantizedWeight`)
    named ``name``, through ``fetcher`` when one is given (ZeRO-3 or
    offload, ``parallel.sharding.ParamFetcher``): the tensor, expanded to
    ``dtype`` when it is quantized."""
    if isinstance(attr, QuantizedWeight):
        if fetcher is None:
            return attr.weight(dtype)
        return dequantize(fetcher.leaf(f"{name}.q"), fetcher.leaf(f"{name}.scale"), dtype)
    return attr if fetcher is None else fetcher.leaf(name)
