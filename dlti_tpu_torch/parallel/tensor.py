"""Tensor parallelism: the placement rule and the collectives that GSPMD
inserts in the reference (``dlti_tpu/parallel/sharding.py:40-56``,
``:80``, ``:100-116``), written out as Megatron-style
``torch.autograd.Function`` pairs on the tensor group
(``parallel.mesh.Mesh.tensor``).

* **The rule** (:func:`tensor_shard_dim`, the reference's ``_TP_RULES``
  over the port's flat names): q/k/v and gate/up kernels, their
  ``lora_b`` and a q/k/v bias are column-parallel (split on their output
  features); o/down kernels and their ``lora_a`` row-parallel (split on
  their input features); ``embed_tokens`` is split over vocabulary rows and
  ``lm_head`` over vocabulary columns; a mixture of experts' ``w1``/``w3``
  on their hidden dim 2 and ``w2`` on dim 1. Everything else (norms, the
  router, the replicated LoRA factors) is held whole by every tensor rank.
  An int8 pair (``{w}.q``/``{w}.scale``) follows its weight's rule
  (``_quant_normalized_path``): ``q`` keeps the weight's split and
  ``scale``, size 1 on the contraction dim, is split with the output
  channels of a column-parallel weight and held whole for a row-parallel
  one. A dim the extent does not divide is held whole.
* **The collectives.** :class:`CopyIn` (identity forward, all-reduce
  backward) brings a tensor every rank holds into a column-parallel
  product; :class:`ReduceOut` (all-reduce forward, identity backward) sums
  a row-parallel product's partial results. :func:`vocab_embedding` looks
  up the rank's vocabulary rows (others read 0) and sums over the group;
  :func:`gather_vocab` assembles every rank's logit columns (a
  zero-padded all-reduce, exact: every column comes from one rank). Every
  leaf a rank holds whole then gets the same gradient on every rank, with
  no all-reduce of its own.

The collectives run whenever the mesh has a tensor group, a group of one
included (``build_mesh(..., tensor_group=True)``), as ZeRO's run at a
world of 1, on the current stream: a CUDA graph over NCCL captures them.
Every one is an all-reduce, which gloo carries for CUDA tensors too (two
ranks on one card, ``launcher --one-device``).
"""

from __future__ import annotations

import functools
import re
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

# name pattern -> the dim split over 'tensor' (kernels are (in, out)).
_TP_RULES = [
    (r".*(q_proj|k_proj|v_proj)\.kernel$", 1),   # column-parallel (heads)
    (r".*(q_proj|k_proj|v_proj)\.lora_b$", 1),   # lora_b's out dim follows the base
    (r".*(q_proj|k_proj|v_proj)\.bias$", 0),
    (r".*o_proj\.kernel$", 0),                    # row-parallel
    (r".*o_proj\.lora_a$", 0),                    # lora_a's in dim follows the base
    (r".*(gate_proj|up_proj)\.kernel$", 1),       # column-parallel (mlp hidden)
    (r".*(gate_proj|up_proj)\.lora_b$", 1),
    (r".*down_proj\.kernel$", 0),                 # row-parallel
    (r".*down_proj\.lora_a$", 0),
    (r".*embed_tokens$", 0),                      # vocabulary rows
    (r".*lm_head$", 1),                           # vocabulary columns
    (r".*mlp\.(w1|w3)$", 2),                      # expert hidden (E, h, m)
    (r".*mlp\.w2$", 1),                           # (E, m, h) row-parallel
]
_RULES = [(re.compile(p), d) for p, d in _TP_RULES]
# The weights an int8 pair's scale can belong to (an RMSNorm's ``scale`` is
# a leaf of its own).
_QUANT_OWNERS = ("kernel", "embed_tokens", "lm_head", "w1", "w2", "w3")

COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
ROW_PARALLEL = ("o_proj", "down_proj")


def quant_normalized_name(name: str) -> str:
    """An int8 pair's leaf (``{w}.q`` or ``{w}.scale``) as its weight's name,
    so the rules match quantized trees (the reference's
    ``_quant_normalized_path``); any other name as it is."""
    base, _, leaf = name.rpartition(".")
    if leaf == "q" or (leaf == "scale" and base.rpartition(".")[2] in _QUANT_OWNERS):
        return base
    return name


def _rule_dim(name: str) -> Optional[int]:
    path = quant_normalized_name(name)
    return next((d for pattern, d in _RULES if pattern.match(path)), None)


def tensor_shard_dim(name: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The dim of leaf ``name`` (whole ``shape``) split over a tensor axis
    of extent ``tp``, or None when every tensor rank holds it whole."""
    d = _rule_dim(name)
    return d if d is not None and d < len(shape) and shape[d] % tp == 0 else None


def whole_shapes(parts: Mapping[str, Sequence[int]], tp: int) -> Dict[str, tuple]:
    """Each leaf's whole shape from a tensor rank's parts (``parts``: name
    to the part's shape, of a model whose widths ``check_divides`` passed):
    the rule's dim times ``tp``; an int8 pair's ``scale`` from its weight's
    whole shape (size 1 on the contraction dim)."""
    out: Dict[str, tuple] = {}
    for name, shape in parts.items():
        shape = list(shape)
        if quant_normalized_name(name) != name and name.endswith(".scale"):
            continue
        d = _rule_dim(name)
        if d is not None and d < len(shape):
            shape[d] *= tp
        out[name] = tuple(shape)
    for name in parts:
        if name not in out:
            q = out[name[:-len("scale")] + "q"]
            out[name] = q[:-2] + (1, q[-1])
    return {name: out[name] for name in parts}


def all_reduce_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``mesh``'s group, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


class CopyIn(torch.autograd.Function):
    """A tensor every rank of the group holds, into a computation each rank
    sees only part of: identity forward, the gradient summed over the group
    backward."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh), None


class ReduceOut(torch.autograd.Function):
    """The sum over the group of each rank's partial result; the gradient,
    whole on every rank, passes through."""

    @staticmethod
    def forward(ctx, t, mesh):
        return all_reduce_(t.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(t: torch.Tensor, mesh) -> torch.Tensor:
    return CopyIn.apply(t, mesh)


def reduce_out(t: torch.Tensor, mesh) -> torch.Tensor:
    return ReduceOut.apply(t, mesh)


def vocab_embedding(ids: torch.Tensor, rows: torch.Tensor, mesh,
                    scale: Optional[torch.Tensor] = None,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The embedding of ``ids`` from this rank's vocabulary ``rows`` (``(V /
    tp, h)``, rank ``r`` holding ids ``r * V/tp ...``): each rank looks up
    the ids it holds, writes 0 for the others, and the group sums, which
    is exact. An int8 table passes its whole per-column ``scale`` and the
    compute ``dtype`` (the rows are scaled in it, as on one device)."""
    n = rows.shape[0]
    local = ids - mesh.rank * n
    inside = (local >= 0) & (local < n)
    x = rows[local.clamp(0, n - 1)].to(dtype or rows.dtype)
    if scale is not None:
        x = x * scale.to(dtype)
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return reduce_out(x, mesh)


class _GatherVocab(torch.autograd.Function):
    """Every rank's columns of the last dim, assembled: this rank's block
    in a zero tensor of the whole width, summed over the group (every
    column has one rank's value, so the sum is exact); backward, this
    rank's block of the gradient."""

    @staticmethod
    def forward(ctx, t, mesh):
        n = t.shape[-1]
        ctx.mesh, ctx.n = mesh, n
        out = t.new_zeros(*t.shape[:-1], n * mesh.world)
        out[..., mesh.rank * n:(mesh.rank + 1) * n] = t
        return all_reduce_(out, mesh)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.mesh.rank, ctx.n
        return g[..., r * n:(r + 1) * n], None


def gather_vocab(t: torch.Tensor, mesh) -> torch.Tensor:
    return _GatherVocab.apply(t, mesh)


def check_divides(cfg, tp: int) -> None:
    """Raise unless ``tp`` divides every dim the tensor axis splits: the
    heads and KV heads (the reference engine's check,
    ``dlti_tpu/serving/engine.py:391-396``), the MLP hidden size and the
    vocabulary."""
    dims = {"num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
            "intermediate_size": cfg.intermediate_size, "vocab_size": cfg.vocab_size}
    bad = {k: v for k, v in dims.items() if v % tp}
    if bad:
        raise ValueError(f"tensor={tp} must evenly divide {', '.join(f'{k}={v}' for k, v in dims.items())} "
                         f"(it does not divide {', '.join(bad)})")


class HostMirror:
    """The host half of a tensor-parallel engine: the tensor group's rank 0
    (the leader) schedules, and before each call that touches the device
    it sends the call's name and host arguments to the other ranks (one
    ``broadcast_object_list`` over the gloo control group), which make the
    same call (``serving.engine.EngineExecutor.follow``), so every rank
    issues the same collectives in the same order and no host decision is
    taken twice. A call made inside a mirrored call is not sent again."""

    def __init__(self, mesh):
        self.group = mesh.control_group
        self.src = dist.get_global_rank(self.group, 0)
        self.leads = mesh.tensor.rank == 0
        self.busy = False
        self.stopped = False

    def send(self, op: str, args: Sequence) -> None:
        dist.broadcast_object_list([(op, list(args))], src=self.src, group=self.group)

    def receive(self) -> tuple:
        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]


def mirrored(prefix: str = ""):
    """Decorate a device call of an object with a ``mirror`` attribute (a
    :class:`HostMirror` or None): on the leader the call is sent to the
    followers as ``prefix + name`` with its positional arguments, tensors
    replaced by None (a follower passes its own, see
    ``EngineExecutor.follow``), then made."""
    def wrap(fn):
        op = prefix + fn.__name__

        @functools.wraps(fn)
        def call(self, *args):
            m = self.mirror
            if m is None or not m.leads or m.busy:
                return fn(self, *args)
            m.send(op, [None if isinstance(a, torch.Tensor) else a for a in args])
            m.busy = True
            try:
                return fn(self, *args)
            finally:
                m.busy = False
        return call
    return wrap
