"""Dense projection with an optional LoRA branch, and the LoRA parameter
helpers: the port of ``dlti_tpu/models/lora.py`` (``LoRADense``,
``lora_param_mask``, ``merge_lora_params``, ``count_params``).

    y = x @ kernel (+ bias)  +  (alpha / r) * (dropout(x) @ lora_a) @ lora_b

``kernel`` is stored ``(in, out)`` as in the reference, so weights move
between the packages by name without a transpose. The base kernel is frozen;
``lora_a``/``lora_b`` are float32 master weights, the only leaves a LoRA run
trains (``load_model(..., trainable_lora=True)`` sets their
``requires_grad``).

The base kernel may be quantized: a ``models.quantization.QuantizedWeight``
(int8 ``q`` and float32 ``scale``) in place of the ``kernel`` parameter,
expanded at use by the frozen product ``int8_matmul``, as the reference's
``maybe_dequantize`` at the consumer.

Dropout is applied to the adapter input only in training, and only when
the caller passes ``dropout_hashes``: the row and column hashes of one
32-bit key (:func:`dropout_hashes`), on the input's device. The keep mask
is a function of (the key, the element's index) computed on the device
(:func:`keep_mask_from`): a recomputation under activation checkpointing
draws the same mask as the forward did, nothing is read back to the host,
and a CUDA graph that is replayed with a new key in the same buffer draws
new masks. Without hashes the branch is deterministic, as in serving.

Under tensor parallelism (``tp_mode``, set by
``LlamaForCausalLM.set_tensor_axis``) the layer holds its rank's part: a
``"column"`` projection its output features (``kernel``, ``lora_b``, a
bias), a ``"row"`` one its input features (``kernel``, ``lora_a``). A
column projection reads its input through the tensor group's copy (made
once for the projections that share the input, ``x`` then being that
copy), both products; its ``lora_a``, which every rank holds whole, enters
through the copy too, so its gradient, each rank's through its own part of
``lora_b``, is summed over the group. A row projection all-reduces its
base product and ``x_part @ lora_a_part`` (then multiplied by the whole
``lora_b``), and draws its dropout mask from the columns it holds,
numbered from its first global input column, so every rank draws the
single-device mask. Each sum thus runs where one device sums, and a
tensor group of one gives one device's bits.

Multi-LoRA serving (``serving.adapters``) adds a per-row branch, the
counterpart of the reference's ``adapters`` variable collection: the caller
passes ``adapter=(ids, a, b, s)``, the row ids ``(B,)`` and this
projection's stacked pool ``a (P, in, r)``, ``b (P, r, out)``, ``s (P,)``;
each batch row gathers its adapter's factors, casts them to the compute
dtype and adds ``s * (x @ a) @ b`` through two batched products. Pool row 0
is all zero, so a base row adds exactly +0.0. Without ``adapter`` the
branch is not built, so training and adapter-off serving run the forward
they ran before.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from dlti_tpu_torch.models.quantization import (
    QuantizedWeight, dequantize, int8_matmul, quant_bases,
)
from dlti_tpu_torch.parallel.tensor import copy_in, reduce_out
from dlti_tpu_torch.utils.hashing import mix32

LORA_LEAVES = ("lora_a", "lora_b")


class LoRADense(nn.Module):
    """Dense layer with an optional LoRA adapter branch."""

    def __init__(self, in_features: int, features: int, *, use_bias: bool = False,
                 lora_r: int = 0, lora_alpha: int = 32, lora_dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.bfloat16,
                 lora_param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.lora_r = lora_r
        self.lora_alpha = lora_alpha
        self.lora_dropout = lora_dropout
        self.kernel = nn.Parameter(torch.empty(in_features, features,
                                               dtype=param_dtype, device=device),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                              device=device), requires_grad=False)
                     if use_bias else None)
        if lora_r > 0:
            self.lora_a = nn.Parameter(torch.empty(
                in_features, lora_r, dtype=lora_param_dtype, device=device),
                requires_grad=False)
            self.lora_b = nn.Parameter(torch.zeros(
                lora_r, features, dtype=lora_param_dtype, device=device),
                requires_grad=False)
        # Tensor parallelism: None, "column" or "row", and the tensor
        # group's mesh view (set_tensor_axis).
        self.tp_mode: Optional[str] = None
        self.tp = None

    def forward(self, x: torch.Tensor,
                dropout_hashes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                adapter: Optional[tuple] = None) -> torch.Tensor:
        """A column-parallel projection's ``x`` is its input after the tensor
        group's copy (``parallel.tensor.copy_in``)."""
        dt = self.dtype
        tp, mode = self.tp, self.tp_mode
        if isinstance(self.kernel, QuantizedWeight):
            y = int8_matmul(x.to(dt), self.kernel.q, self.kernel.scale)
        else:
            y = x.to(dt) @ self.kernel.to(dt)
        if mode == "row":
            y = reduce_out(y, tp)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        if self.lora_r > 0:
            h = x
            if dropout_hashes is not None and self.lora_dropout > 0.0:
                rows, cols = dropout_hashes
                if mode == "row":  # this rank's input columns
                    cols = cols[tp.rank * x.shape[-1]:]
                h = dropout(h, self.lora_dropout, rows, cols)
            a = self.lora_a if mode != "column" else copy_in(self.lora_a, tp)
            ha = h.to(dt) @ a.to(dt)
            if mode == "row":
                ha = reduce_out(ha, tp)
            delta = ha @ self.lora_b.to(dt)
            y = y + (self.lora_alpha / self.lora_r) * delta
        if adapter is not None:
            y = y + adapter_delta(x.to(dt), *adapter)
        return y


def adapter_delta(x: torch.Tensor, ids: torch.Tensor, pool_a: torch.Tensor,
                  pool_b: torch.Tensor, pool_s: torch.Tensor) -> torch.Tensor:
    """Each row's adapter delta ``s[id] * (x @ a[id]) @ b[id]`` for ``x``
    ``(B, s, in)`` in the compute dtype and row ids ``(B,)`` into the
    stacked pool: the reference's gather and two ``einsum``s
    (``dlti_tpu/models/lora.py:98-105``)."""
    dt = x.dtype
    a = pool_a[ids].to(dt)
    b = pool_b[ids].to(dt)
    s = pool_s[ids].to(dt)
    return s[:, None, None] * torch.bmm(torch.bmm(x, a), b)


def dropout(x: torch.Tensor, rate: float, row_hash: torch.Tensor,
            col_hash: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep each element with probability
    ``1 - rate`` and divide kept ones by ``1 - rate``; the mask is
    :func:`keep_mask_from` of one key's hashes. flax divides by a weakly
    typed Python float, which takes ``x``'s dtype: in bf16 and float16 by
    ``1 - rate`` rounded to that type (0.95 is 0.9502 in float16), so the
    divisor is rounded here too (a CPU scalar, which a CUDA graph takes)."""
    keep_prob = 1.0 - rate
    keep = keep_mask_from(row_hash, col_hash, x.shape[-1], keep_prob)
    return torch.where(keep.reshape(x.shape), x / torch.tensor(keep_prob, dtype=x.dtype),
                       0.0)


def dropout_hashes(keys: torch.Tensor, rows: int, cols: int,
                   row_offset: int = 0, row_ids: Optional[torch.Tensor] = None) -> tuple:
    """For each of ``keys`` (int64 tensor of 32-bit keys, any shape ``K``):
    a 32-bit hash of (key, row) for rows ``row_offset`` ..
    ``row_offset + rows - 1`` and of (key, column) for ``cols`` columns, as
    int32 tensors shaped ``K + (rows,)`` and ``K + (cols,)``. One call
    hashes every key of a forward at once, so each dropout mask costs three
    elementwise ops on its full shape. Rows are numbered across the whole
    microbatch: a data-parallel rank holding a slice of it passes the
    slice's first global row, so every rank draws the masks a single device
    draws for the same rows. ``row_ids`` (``(rows,)`` int64 on the keys'
    device) numbers the rows instead, when a rank's rows are not one run of
    the microbatch's (a sequence rank's chunk of every row)."""
    k = keys[..., None]
    rows_i = (torch.arange(row_offset, row_offset + rows, device=keys.device)
              if row_ids is None else row_ids)
    r = mix32(mix32(rows_i ^ k) ^ 0x5BD1E995)
    c = mix32(torch.arange(cols, device=keys.device) ^ mix32(k ^ 0x27D4EB2F))
    # [0, 2**32) -> int32 exactly, by moving the range down 2**31.
    return (r - 2 ** 31).to(torch.int32), (c - 2 ** 31).to(torch.int32)


# Odd multiplier of the per-element step below (a bijection of int32).
_KEEP_MUL = 0x2C1B3C6D


def keep_mask_from(row_hash: torch.Tensor, col_hash: torch.Tensor, cols: int,
                   keep_prob: float) -> torch.Tensor:
    """The ``(rows, cols)`` bool keep mask of one key from its hashes
    (:func:`dropout_hashes`; ``col_hash`` may be longer than ``cols``):
    element (i, j) is (row hash i XOR column hash j) times an odd constant
    in wrapping int32 arithmetic, uniform over int32 since both hashes are,
    and it is kept when below ``keep_prob`` of the way up the int32 range
    (resolution 2**-32). A function of (key, i, j) alone."""
    h = (row_hash[:, None] ^ col_hash[None, :cols]) * _KEEP_MUL
    threshold = min(round(keep_prob * 2 ** 32), 2 ** 32 - 1) - 2 ** 31
    return h < threshold


# ----------------------------------------------------------------------
# Parameter helpers over ``{name: tensor}`` state dicts
# ----------------------------------------------------------------------

def is_lora_name(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in LORA_LEAVES


def lora_param_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True for trainable (LoRA) leaves, False for frozen ones; everything
    is trainable when no adapter is grafted (a full fine-tune)."""
    if not any(is_lora_name(n) for n in params):
        return {n: True for n in params}
    return {n: is_lora_name(n) for n in params}


def merge_lora_params(params: Mapping[str, torch.Tensor],
                      scaling: Optional[float] = None,
                      alpha: int = 32) -> Dict[str, torch.Tensor]:
    """Fold each LoRA pair into its base kernel, W' = W + scaling * A @ B in
    float32 and cast back to W's dtype, on W's device (A @ B is formed
    where the factors are); the returned dict has no ``lora_a``/``lora_b``
    leaves. A quantized weight (``{name}.q``, ``{name}.scale``) is expanded
    to bf16 first, merged or not, as the reference's merge does: the export
    is a compute-dtype tree."""
    bases = quant_bases(params)
    out = {}
    for name, t in params.items():
        if is_lora_name(name):
            continue
        prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if prefix in bases:
            if leaf == "scale":
                continue
            t = dequantize(t, params[f"{prefix}.scale"], torch.bfloat16)
            name = prefix
            prefix, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        a = params.get(f"{prefix}.lora_a")
        b = params.get(f"{prefix}.lora_b")
        if leaf == "kernel" and a is not None and b is not None:
            s = scaling if scaling is not None else alpha / a.shape[-1]
            t = (t.float() + s * (a.float() @ b.float()).to(t.device)).to(t.dtype)
        out[name] = t
    return out


def count_params(params: Mapping[str, torch.Tensor]) -> Tuple[int, int]:
    """(trainable, total) parameter counts."""
    mask = lora_param_mask(params)
    total = sum(t.numel() for t in params.values())
    trainable = sum(t.numel() for n, t in params.items() if mask[n])
    return trainable, total
