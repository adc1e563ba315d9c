"""The placement rule, ZeRO, expert parallelism and their collectives: the
port of ``dlti_tpu/parallel/sharding.py``.

The reference expresses DeepSpeed's ZeRO stages as shardings over a mesh
and lets GSPMD insert the collectives. The port places each leaf by the
same rule and runs plain ``torch.distributed`` collectives on per-leaf
shards, on the current stream, so that one CUDA graph captures a whole
step with them.

**One rule places every leaf** (:func:`strategy_axes`, the reference's
function of that name): a mixture of experts' stacked expert leaf splits
its expert dim over ``expert`` (when ``expert`` divides it), the tensor
rule's dim goes over ``tensor`` (``parallel.tensor``), and under ZeRO-3
the largest dim of the *whole* shape that ``fsdp`` divides, leaving out
those two (the first of equals, at least :data:`_MIN_FSDP_DIM`), goes over
``fsdp``. So ``q_proj``'s (4096, 4096) kernel splits dim 1 over ``tensor``
and dim 0 over ``fsdp``, and an int8 pair's (1, n) ``scale`` stays whole
over ``fsdp``. The flat layout (:func:`leaf_axes`, the reference's
``param_pspec``) and the stacked pipeline layout
(``parallel.pipeline.pipeline_param_placement``, ``dim_shift=1``,
``taken=(0,)``) both call it. A leaf's part is contiguous along each split
dim, rank ``r`` of the axis holding run ``r``: the tensor part, then this
rank's experts of it, then its ``fsdp`` shard of that
(``models.interop.shard_params`` cuts a whole tree so; :func:`shard_model`
cuts a model that holds tensor parts).

* **baseline** (``ZeROStage.NONE``): every leaf replicated over the batch
  axes; gradients all-reduced over them.
* **ZeRO-1**: the optimizer moments of a trainable leaf held whole by the
  tensor and expert ranks keep only this rank's shard over ``data`` (its
  largest dim ``data`` divides, any size); gradients are all-reduced, the
  update runs on the shard, and the new parameter is all-gathered.
* **ZeRO-2**: as ZeRO-1, but the gradient is reduce-scattered to the shard.
* **ZeRO-3**: a leaf the rule splits over ``fsdp`` is stored as this
  rank's shard and gathered at use (:class:`GatherAtUse`: all-gather over
  ``fsdp`` forward, reduce-scatter of a trainable leaf's gradient
  backward); its moments are its shard's, and its gradient is then summed
  over ``data``. A trainable leaf the rule leaves whole behaves as under
  ZeRO-2 over ``fsdp`` (the reference's ``opt_state_shardings``), its
  gradient summed over ``data`` too. At ``fsdp`` 1 nothing is sharded.

A leaf's moments and owned gradient are its part's whenever the rule
splits it (over any axis), never split further. At a world of 1 (a group
of one) the ZeRO-1/2 moments are one shard, the whole leaf, and their
collectives still run (copies), so a group of one exercises the same path
as a larger world.

Host offload (``ds_config_zero3.json:19-27`` parity): ``offload_optimizer``
keeps the moments, ``offload_params`` the frozen base (every leaf no step
changes: under LoRA the kernels, norms, embedding and head), in pinned host
memory. The update copies the moments to the card and back inside the
step; :class:`ParamFetcher` streams the base into the step one block ahead
on a side stream, and gathers the next block's ``fsdp`` shards while this
one runs. On the CPU host and device memory are one, so offload moves
nothing there.

Tensor parallelism (a tensor group, ``parallel.tensor``): the model runs at
this rank's parts (``load_model(mesh=)``; its modules issue the tensor
group's collectives). Every leaf a tensor rank holds whole gets the same
gradient on every tensor rank through those collectives, so gradients are
reduced over the batch axes alone.

Expert parallelism (``expert`` above 1, the reference's ``_EP_PATTERN``
rule): each MoE layer gets a :class:`MoEGroups`: every rank routes every
token and runs its own experts on them; :class:`ExpertIn` (identity
forward, all-reduce backward) brings the tokens and their routing weights
in, :class:`ExpertOut` (all-reduce forward, identity backward) sums the
partial combines, so every leaf held whole gets the same gradient on every
expert rank. Under data parallelism too (any ``expert``), :class:`MoEGroups`
makes capacity and the load-balance loss the global microbatch's over the
batch axes (``data`` times ``fsdp``): it all-gathers each batch rank's
per-(slot, expert) counts and sums the loss's statistics (:class:`BatchSum`,
all-reduce forward and backward).

Sequence parallelism (``sequence`` above 1): :func:`shard_model` puts the
model on the ring (its chunk of each row), and the step sums each gradient
(a shard's too: sequence peers hold the same shards) over the sequence group
before the batch axes' reduction. Pipeline parallelism (``pipe`` above 1): a
stage holds its layers' leaves (``LeafPlacement.stage``, the local names
``model.layers.0 ..`` standing for its global layers), each placed by the
rule, and every stage the embedding, the final norm and the head; gradients
are reduced over the batch axes alone (``parallel.pipeline``).

The gradient norm (:func:`sharded_sq_norm`) sums each leaf's squares over
every axis that splits it (``fsdp``, ``tensor``, ``expert``, the ZeRO-1/2/3
moments' axis, ``pipe`` for a stage's layer), so each element counts once.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from dlti_tpu_torch.config import ZeROStage
from dlti_tpu_torch.models.lora import is_lora_name
from dlti_tpu_torch.models.moe import MoEMLP
from dlti_tpu_torch.parallel.mesh import Mesh, axis_sum_
from dlti_tpu_torch.parallel.tensor import (
    CopyIn, ReduceOut, all_reduce_, quant_normalized_name, tensor_shard_dim)

# Expert-parallel rule: stacked expert weights (an int8 pair by its
# weight's name) split their expert dim over 'expert'.
_EP_PATTERN = re.compile(r".*\.mlp\.(w1|w2|w3)$")

# Don't ZeRO-3-shard leaves with no dim this long (norm scales, LoRA
# factors with every dim < 1024): the all-gather latency outweighs the
# memory saved. Shared by the flat and the stacked layout; tests lower it
# to place shards on tiny models.
_MIN_FSDP_DIM = 1024

# The order a leaf's parts are gathered in (the reverse of the cut: the
# tensor part, then its experts, then the fsdp shard of that).
_GATHER_ORDER = ("fsdp", "expert", "tensor")


def _largest_divisible_dim(shape: Sequence[int], size: int, taken=()) -> Optional[int]:
    """The largest dim divisible by ``size`` (the first of equals),
    leaving out the dims in ``taken``."""
    best, best_len = None, 0
    for d, n in enumerate(shape):
        if d in taken:
            continue
        if n % size == 0 and n > best_len:
            best, best_len = d, n
    return best


def strategy_axes(name: str, shape: Sequence[int], *, ep: int = 1, tp: int = 1,
                  fsdp: int = 1, dim_shift: int = 0, taken: tuple = ()) -> Dict[int, str]:
    """THE expert/tensor/fsdp placement rule for one leaf (``name`` in this
    package's names, an int8 pair's leaf by its weight's rule; ``shape``
    whole): ``{dim: axis}``. ``dim_shift`` moves the flat rules for the
    stacked pipeline layout (a leading layer dim shifts every flat dim by
    one); ``taken`` marks dims already claimed (the stacked layout's
    ``pipe`` dim 0) that ``fsdp`` must not take."""
    path = quant_normalized_name(name)
    out: Dict[int, str] = {}
    ep_d = tp_d = None
    if (ep > 1 and _EP_PATTERN.match(path) and dim_shift < len(shape)
            and shape[dim_shift] % ep == 0):
        ep_d = dim_shift
        out[ep_d] = "expert"
    if tp > 1:
        d = tensor_shard_dim(name, tuple(shape[dim_shift:]), tp)
        if d is not None and d + dim_shift != ep_d:
            tp_d = d + dim_shift
            out[tp_d] = "tensor"
    if fsdp > 1:
        d = _largest_divisible_dim(shape, fsdp, taken=tuple(taken) + (tp_d, ep_d))
        if d is not None and shape[d] >= _MIN_FSDP_DIM:
            out[d] = "fsdp"
    return out


def leaf_axes(name: str, shape: Sequence[int], mesh: Mesh) -> Dict[int, str]:
    """:func:`strategy_axes` of a flat leaf (or one layer of a stage) under
    ``mesh``'s extents: ``fsdp`` counts under ZeRO-3 only (the reference's
    ``param_pspec``)."""
    if not shape:
        return {}
    return strategy_axes(name, shape, ep=mesh.ep, tp=mesh.tp, fsdp=mesh.fsdp_extent)


def axis_view(mesh: Mesh, axis: str) -> Mesh:
    """``mesh``'s view of axis ``axis`` (a mesh axis name)."""
    return mesh.experts if axis == "expert" else getattr(mesh, axis)


def local_shape(shape: Sequence[int], axes: Mapping[int, str], mesh: Mesh) -> tuple:
    """The shape of this rank's part of a leaf of whole ``shape`` split
    over ``axes``."""
    out = list(shape)
    for d, axis in axes.items():
        out[d] //= axis_view(mesh, axis).world
    return tuple(out)


def shard_of(t: torch.Tensor, d: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the whole ``t`` along ``d`` (a view) over the
    ranks of ``mesh`` (an axis view), or ``t``."""
    if d is None:
        return t
    n = t.shape[d] // mesh.world
    return t.narrow(d, mesh.rank * n, n)


def part_of(t: torch.Tensor, axes: Mapping[int, str], mesh: Mesh,
            skip: Sequence[str] = ()) -> torch.Tensor:
    """This rank's part (a copy) of ``t`` along every split of ``axes``
    but those over the axes in ``skip`` (``t`` itself when nothing is
    cut)."""
    out = t
    for d, axis in axes.items():
        if axis not in skip:
            out = shard_of(out, d, axis_view(mesh, axis))
    return t if out is t else out.clone()


def cut_to_part(name: str, t: torch.Tensor, shape: Sequence[int], mesh: Mesh) -> torch.Tensor:
    """Leaf ``name`` (whole ``shape``) as this rank holds it under ``mesh``,
    by the rule's splits (:func:`leaf_axes`): ``t`` itself when it is this
    rank's part already, else this rank's part (a copy) of ``t``, the whole
    leaf or its tensor part (the tensor part, its experts, then the
    ``fsdp`` shard of that)."""
    axes = leaf_axes(name, tuple(shape), mesh)
    local = local_shape(shape, axes, mesh)
    tensor_part = local_shape(shape, {d: a for d, a in axes.items() if a == "tensor"}, mesh)
    got = tuple(t.shape)
    if got == local:
        return t
    if got == tuple(shape):
        return part_of(t, axes, mesh)
    if got == tensor_part:
        return part_of(t, axes, mesh, skip=("tensor",))
    raise ValueError(f"{name}: shape {got} is neither the whole leaf {tuple(shape)}, its "
                     f"tensor part {tensor_part} nor this rank's part {local}")


def ordered_axes(split: Mapping[int, str], mesh: Mesh) -> List[Tuple[int, Mesh]]:
    """``[(dim, axis view)]`` of a leaf's ``split``, in gather order."""
    return [(d, axis_view(mesh, a)) for a in _GATHER_ORDER for d, b in split.items() if b == a]


def all_gather_dim(shard: torch.Tensor, d: int, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's shard along ``d``."""
    out, work = _gather_start(shard, mesh, async_op=False)
    return _gather_finish(out, work, d, mesh)


@torch.no_grad()
def _gather_start(shard: torch.Tensor, mesh: Mesh, async_op: bool) -> tuple:
    """Issue the all-gather of ``shard`` over ``mesh``: ``(out, work)``,
    every rank's shard concatenated along dim 0 (the layout every backend
    takes) once ``work`` is waited on. ``async_op`` is taken over NCCL
    only, which writes ``out`` in place on its stream; elsewhere (gloo,
    whose host threads copy the result back) the gather completes here and
    ``work`` is None."""
    s = shard.contiguous()
    out = torch.empty((mesh.world * s.shape[0],) + tuple(s.shape[1:]), dtype=s.dtype,
                      device=s.device)
    async_op = async_op and dist.get_backend(mesh.group) == "nccl"
    work = dist.all_gather_into_tensor(out, s, group=mesh.group, async_op=async_op)
    return out, work if async_op else None


def _gather_finish(out: torch.Tensor, work, d: int, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from :func:`_gather_start`'s result, split along ``d``."""
    if work is not None:
        work.wait()
    if d == 0:
        return out
    w = mesh.world
    shape = list(out.shape)
    shape[0] //= w
    whole = list(shape)
    whole[d] *= w
    return out.unflatten(0, (w, shape[0])).movedim(0, d).reshape(whole)


def reduce_scatter_dim(full: torch.Tensor, d: int, mesh: Mesh) -> torch.Tensor:
    """This rank's shard along ``d`` of the sum of every rank's ``full``."""
    w = mesh.world
    inp = full.unflatten(d, (w, full.shape[d] // w)).movedim(d, 0).contiguous()
    out = torch.empty(inp.shape[1:], dtype=full.dtype, device=full.device)
    # Every rank's part concatenated along dim 0 (the layout every backend takes).
    dist.reduce_scatter_tensor(out, inp.flatten(0, 1), op=dist.ReduceOp.SUM,
                               group=mesh.group)
    return out


# A tensor every expert rank holds, into a computation whose gradient each
# rank sees only through its own experts (identity forward, the gradient
# summed over the expert group backward); and the sum over the expert group
# of each rank's share of the combine (the gradient passes through): the
# tensor group's pair, on the expert group.
ExpertIn, ExpertOut = CopyIn, ReduceOut


class BatchSum(torch.autograd.Function):
    """The sum over the batch axes of each rank's statistics, feeding a
    value every batch rank then uses: all-reduce forward and backward."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_(t.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh), None


class MoEGroups:
    """A MoE layer's collectives under ``mesh`` (``models.moe.MoEMLP.groups``):
    the batch axes' counts and sums, and (``split``: the layer holds its
    expert rank's experts) the expert group's way in and out."""

    def __init__(self, mesh: Mesh, split: bool):
        self.batch_mesh = mesh.batch
        self.expert_mesh = mesh.experts
        self.batch_world, self.batch_rank = self.batch_mesh.world, self.batch_mesh.rank
        self.expert_rank = self.expert_mesh.rank
        self.split = split and mesh.ep > 1

    def gather_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """Every batch rank's ``counts`` stacked by batch rank."""
        return all_gather_dim(counts[None], 0, self.batch_mesh)

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        return BatchSum.apply(t, self.batch_mesh)

    def expert_in(self, t: torch.Tensor) -> torch.Tensor:
        return ExpertIn.apply(t, self.expert_mesh)

    def expert_out(self, t: torch.Tensor) -> torch.Tensor:
        return ExpertOut.apply(t, self.expert_mesh)


class GatherAtUse(torch.autograd.Function):
    """A leaf's ``fsdp`` shard, whole over ``fsdp`` (its tensor part or its
    experts, or the whole leaf), for the computation that uses it: the
    forward all-gathers the shards (or takes ``ready``, a gather of them
    :class:`ParamFetcher` issued ahead: ``[(out, work)]``); the backward
    reduce-scatters the gradient to this rank's shard (autograd calls it
    only for a trainable leaf)."""

    @staticmethod
    def forward(ctx, shard, d, mesh, ready=None):
        ctx.d, ctx.mesh = d, mesh
        if ready:
            return _gather_finish(*ready.pop(), d, mesh)
        return all_gather_dim(shard, d, mesh)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.d, ctx.mesh), None, None, None


@dataclass(frozen=True)
class LeafPlacement:
    """Where one parameter leaf lives: ``shape`` (the whole leaf's; a
    stage's layer leaf: one layer's), ``axes`` (the rule's splits,
    ``(dim, axis)`` pairs: this rank holds its part along each), ``opt_dim``
    and ``opt_axis`` (a trainable leaf the rule leaves whole: its moments
    and owned gradient sharded along ``opt_dim`` over ``opt_axis``, ``data``
    under ZeRO-1/2, ``fsdp`` under ZeRO-3), ``host`` (kept in pinned host
    memory: an offloaded frozen leaf), ``stage`` (a layer leaf of this
    pipeline stage, which the other stages do not hold)."""

    shape: Tuple[int, ...]
    trainable: bool
    axes: Tuple[Tuple[int, str], ...] = ()
    opt_dim: Optional[int] = None
    opt_axis: str = "data"
    host: bool = False
    stage: bool = False

    @property
    def split(self) -> Dict[int, str]:
        """The rule's ``{dim: axis}``."""
        return dict(self.axes)

    def dim(self, axis: str) -> Optional[int]:
        """The dim split over ``axis``, or None."""
        return next((d for d, a in self.axes if a == axis), None)

    @property
    def fsdp_dim(self) -> Optional[int]:
        return self.dim("fsdp")

    @property
    def expert_dim(self) -> Optional[int]:
        return self.dim("expert")


@dataclass
class Layout:
    """The placement of every parameter leaf of a model under a mesh,
    built once by :func:`shard_model`."""

    mesh: Mesh
    leaves: Dict[str, LeafPlacement] = field(default_factory=dict)

    @property
    def offload_optimizer(self) -> bool:
        return self.mesh.parallel.offload_optimizer

    def param_axes(self, name: str) -> List[Tuple[int, Mesh]]:
        """``[(dim, axis view)]``: each dim along which this rank holds a
        part of the parameter ``name`` and the view of the ranks holding the
        others, in gather order (empty for a leaf held whole)."""
        return ordered_axes(self.leaves[name].split, self.mesh)

    def moment_split(self, name: str) -> Dict[int, str]:
        """``name``'s moments' ``{dim: axis}``: the leaf's own splits, else
        its ``opt_dim`` over ``opt_axis`` (empty for moments held whole)."""
        pl = self.leaves[name]
        if pl.axes or pl.opt_dim is None:
            return pl.split
        return {pl.opt_dim: pl.opt_axis}

    def moment_axes(self, name: str) -> List[Tuple[int, Mesh]]:
        """As :meth:`param_axes`, for ``name``'s moments."""
        return ordered_axes(self.moment_split(name), self.mesh)

    def opt_view(self, name: str) -> Mesh:
        """The view of the axis ``name``'s moments are sharded over."""
        return axis_view(self.mesh, self.leaves[name].opt_axis)

    def gathers_update(self, name: str) -> bool:
        """Whether the update of ``name`` runs on a shard of a parameter
        held whole, which is all-gathered after it (ZeRO-1/2/3 leaves the
        rule leaves whole)."""
        pl = self.leaves[name]
        return not pl.axes and pl.opt_dim is not None


def plan_layout(model: nn.Module, mesh: Mesh, lora_enabled: bool) -> Layout:
    """Every leaf's :class:`LeafPlacement` under ``mesh``, from the whole
    shapes the model records (``LlamaForCausalLM.whole_shapes``), whatever
    part of each leaf it holds."""
    offload = mesh.parallel.offload_params and mesh.device.type == "cuda"
    layout = Layout(mesh)
    stage = mesh.zero_stage
    opt_axis = "fsdp" if stage == ZeROStage.ZERO3 else "data"
    opt_view = axis_view(mesh, opt_axis)
    for name, _ in model.named_parameters():
        shape = tuple(model.whole_shapes[name])
        trainable = not lora_enabled or is_lora_name(name)
        axes = leaf_axes(name, shape, mesh)
        opt_dim = None
        if trainable and not axes and stage != ZeROStage.NONE and opt_view.group is not None:
            opt_dim = _largest_divisible_dim(shape, opt_view.world)
        layout.leaves[name] = LeafPlacement(
            shape=shape, trainable=trainable, axes=tuple(sorted(axes.items())),
            opt_dim=opt_dim, opt_axis=opt_axis, host=offload and not trainable,
            stage=mesh.pp > 1 and name.startswith("model.layers."))
    return layout


def _param_owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    prefix, _, leaf = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), leaf


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh, lora_enabled: bool) -> Layout:
    """Place ``model``'s parameters by :func:`plan_layout`, in place: a leaf
    that holds its tensor part (the whole leaf without a tensor split)
    keeps only this rank's experts and ``fsdp`` shard of it (a new
    ``nn.Parameter`` with the old one's ``requires_grad``; a leaf already at
    this rank's part, ``models.interop.shard_params``, stays), an offloaded
    leaf moves to pinned host memory. Installs a :class:`ParamFetcher` on
    the model when any leaf must be fetched at use, gives each MoE layer
    its :class:`MoEGroups` under data or expert parallelism, and returns
    the layout."""
    layout = plan_layout(model, mesh, lora_enabled)
    fetched = False
    for name, pl in layout.leaves.items():
        owner, leaf = _param_owner(model, name)
        old = getattr(owner, leaf)
        fetched = fetched or pl.host or pl.fsdp_dim is not None
        held = old.detach()
        t = cut_to_part(name, held, pl.shape, mesh)
        if pl.host:
            t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        if t is not held:
            setattr(owner, leaf, nn.Parameter(t, requires_grad=old.requires_grad))
        del old, held, t
    if fetched:
        model.model.fetcher = ParamFetcher(model, layout)
    if mesh.sp > 1:
        model.set_sequence_axis(mesh.sequence)
    if mesh.distributed and (mesh.batch.world > 1 or mesh.ep > 1):
        for name, mod in model.named_modules():
            if isinstance(mod, MoEMLP):
                w1 = next(n for n in layout.leaves if n.startswith(f"{name}.w1"))
                mod.groups = MoEGroups(mesh, split=layout.leaves[w1].expert_dim is not None)
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    return layout


class ParamFetcher:
    """Brings the leaves a model does not hold whole on its device (over
    ``fsdp``: its tensor part or its experts stay parts) to the computation
    that uses them: an offloaded leaf is copied from pinned host memory
    (``copy_(non_blocking=True)`` on a side stream), a ZeRO-3 shard is
    all-gathered over ``fsdp`` (:class:`GatherAtUse`). Both start one block
    ahead: while block ``i`` runs, the next planned block's copies run on
    the side stream and its gathers are in flight (``async_op``), waited on
    at its first use (the forward's last block starts nothing: the loss, or
    a pipeline stage's other ticks, come before the first recompute). The model calls :meth:`begin` at each forward with
    the blocks its backward will recompute, :meth:`run_block` for each
    block, and :meth:`leaf` for the embedding, the final norm and the head.
    Fetched tensors are ordinary intermediates: under remat the recompute
    in the backward fetches again, and a block's tensors are freed after
    its last use. The plan is the same on every ``fsdp`` rank (they share
    every other coordinate, and nothing in it reads the rows), so every
    rank issues its gathers in one order.

    Each prefetch buffer is allocated on the computing stream, which the
    side stream waits for before it writes, and the computing stream waits
    for the copy before its first use: no tensor changes streams, so the
    allocator frees buffers in stream order, within a CUDA graph's capture
    as outside it. An offloaded leaf that is also an ``fsdp`` shard is
    gathered at its use, after its copy."""

    def __init__(self, model: nn.Module, layout: Layout):
        self.layout = layout
        self.mesh = layout.mesh
        self.fsdp = self.mesh.fsdp
        self._model = model
        n_layers = len(model.model.layers) if hasattr(model, "model") else 0
        self._blocks: List[List[Tuple[str, str]]] = [[] for _ in range(n_layers)]
        for name in layout.leaves:
            parts = name.split(".")
            if parts[:2] == ["model", "layers"] and self._fetched(name):
                self._blocks[int(parts[2])].append((".".join(parts[3:]), name))
        self._side = (torch.cuda.Stream(self.mesh.device)
                      if self.mesh.device.type == "cuda" else None)
        self._pending: Dict[int, tuple] = {}
        self._plan: List[int] = []
        self._pos = 0

    def _fetched(self, name: str) -> bool:
        pl = self.layout.leaves[name]
        return pl.fsdp_dim is not None or pl.host

    def _param(self, name: str) -> torch.Tensor:
        owner, leaf = _param_owner(self._model, name)
        return getattr(owner, leaf)

    def begin(self, recomputed: Sequence[int]) -> None:
        """A forward over every block, then (training under remat) the
        recompute of ``recomputed`` in the backward, last first."""
        self.end()
        self._plan = list(range(len(self._blocks))) + sorted(recomputed, reverse=True)
        self._pos = 0

    def end(self) -> None:
        """Let the fetches no block used go, their gathers waited on first
        (the step calls it after its last backward: a CUDA graph's capture
        must join every collective it issued)."""
        for _, _, gathers in self._pending.values():
            for ready in gathers.values():
                for _, work in ready:
                    if work is not None:
                        work.wait()
        self._pending.clear()

    def _issue(self, names: Sequence[str]) -> tuple:
        """Start copying the host leaves among ``names`` to the card, and
        gathering the ``fsdp`` shards of the others: ``(bufs, event,
        gathers)``."""
        leaves = self.layout.leaves
        gathers = {n: [_gather_start(self._param(n), self.fsdp, async_op=True)]
                   for n in names if leaves[n].fsdp_dim is not None and not leaves[n].host}
        host = [n for n in names if leaves[n].host]
        if not host or self._side is None:
            return {}, None, gathers
        cur = torch.cuda.current_stream(self.mesh.device)
        bufs = {n: torch.empty_like(self._param(n), device=self.mesh.device) for n in host}
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            for n, b in bufs.items():
                b.copy_(self._param(n), non_blocking=True)
            event = self._side.record_event()
        return bufs, event, gathers

    def _resolve(self, names: Sequence[str], issued: tuple) -> Dict[str, torch.Tensor]:
        bufs, event, gathers = issued
        if event is not None:
            torch.cuda.current_stream(self.mesh.device).wait_event(event)
        out = {}
        for n in names:
            t = bufs.get(n, None)
            if t is None:
                t = self._param(n)
            d = self.layout.leaves[n].fsdp_dim
            if d is not None:
                t = GatherAtUse.apply(t, d, self.fsdp, gathers.get(n))
            out[n] = t
        return out

    def fetches(self, name: str) -> bool:
        return name in self.layout.leaves and self._fetched(name)

    def leaf(self, name: str) -> torch.Tensor:
        """``name`` whole over ``fsdp`` on the device (the parameter itself
        when it is held so)."""
        if not self._fetched(name):
            return self._param(name)
        return self._resolve([name], self._issue([name]))[name]

    def block(self, i: int) -> Dict[str, torch.Tensor]:
        """Block ``i``'s fetched leaves by their names within the block;
        starts the next planned block's fetches."""
        issued = self._pending.pop(i, None)
        if issued is None:
            issued = self._issue([n for _, n in self._blocks[i]])
        if self._pos < len(self._plan) and self._plan[self._pos] == i:
            self._pos += 1
            # Not across the forward's end: the loss (a pipeline stage's
            # next ticks) runs between it and the first recompute.
            if self._pos != len(self._blocks) and self._pos < len(self._plan):
                nxt = self._plan[self._pos]
                if nxt not in self._pending:
                    self._pending[nxt] = self._issue([n for _, n in self._blocks[nxt]])
        full = self._resolve([n for _, n in self._blocks[i]], issued)
        return {rel: full[n] for rel, n in self._blocks[i]}

    def run_block(self, i: int, layer: nn.Module, *args):
        """``layer(*args)`` with block ``i``'s fetched leaves in place of
        its parameters."""
        return torch.func.functional_call(layer, self.block(i), args)


def _zero3(layout: Layout) -> bool:
    return layout.mesh.zero_stage == ZeROStage.ZERO3


def owned_grad(g: torch.Tensor, name: str, layout: Layout,
               summed: bool = False) -> torch.Tensor:
    """A trainable leaf's summed local gradient (of this rank's part; an
    ``fsdp`` shard's reduce-scattered over ``fsdp`` by autograd already) as
    the global gradient this rank owns: a shard's summed over ``data``; a
    leaf with an ``opt_dim``, the shard along it (reduce-scattered over the
    moments' axis under ZeRO-2/3 and, under ZeRO-3, summed over ``data``;
    sliced from the all-reduced whole under ZeRO-1); any other, summed
    over the batch axes. ``summed``: ``g`` is the global sum already
    (:func:`reduce_in_dtype` per microbatch), so this rank takes its
    part."""
    pl, mesh = layout.leaves[name], layout.mesh
    if pl.fsdp_dim is not None:
        return g if summed else axis_sum_(g, mesh.data)
    if summed:
        return shard_of(g, pl.opt_dim, layout.opt_view(name))
    if pl.opt_dim is not None and mesh.zero_stage in (ZeROStage.ZERO2, ZeROStage.ZERO3):
        g = reduce_scatter_dim(g, pl.opt_dim, layout.opt_view(name))
        return axis_sum_(g, mesh.data) if _zero3(layout) else g
    axis_sum_(g, mesh.batch)
    return shard_of(g, pl.opt_dim, layout.opt_view(name))


def reduce_in_dtype(g: torch.Tensor, name: str, layout: Layout,
                    dtype: torch.dtype) -> torch.Tensor:
    """One microbatch's gradient of a trainable leaf (float32 holding the
    values of a ``dtype`` gradient, this rank's rows) summed over the ranks
    and rounded to ``dtype``, as the reference's sharded step sums the
    compute-dtype partial products of a data-parallel dot: in float16 a sum
    past 65504 is inf on every rank, as on one device, and the loss scaler
    takes the single device's decision. An ``fsdp`` shard's gradient
    arrives reduce-scattered over ``fsdp`` already (``GatherAtUse``) and is
    summed over ``data``."""
    mesh = layout.mesh
    g = axis_sum_(g, mesh.data if layout.leaves[name].fsdp_dim is not None else mesh.batch)
    return g.to(dtype).float()


def _norm_axes(pl: LeafPlacement) -> Tuple[str, ...]:
    """The axes over which a leaf's owned gradient is split."""
    axes = [a for _, a in pl.axes]
    if not axes and pl.opt_dim is not None:
        axes.append(pl.opt_axis)
    if pl.stage:
        axes.append("pipe")
    return tuple(sorted(axes))


def sharded_sq_norm(grads: Mapping[str, torch.Tensor], layout: Layout) -> torch.Tensor:
    """The whole gradient's sum of squares (float32) from the owned
    gradients: each leaf's squares summed over every axis that splits it
    (``fsdp``, ``tensor``, ``expert``, its moments' axis, ``pipe`` for a
    stage's layer leaf; one all-reduce for each axis of each combination,
    in one order on every rank), so each element counts once, then every
    leaf's in order. The leaves add up in one order whatever the
    placement, so a world of 1 sums as one device does."""
    leaves, mesh = layout.leaves, layout.mesh
    sq = {n: torch.sum(g.float() * g.float()) for n, g in grads.items()}
    groups: Dict[Tuple[str, ...], List[str]] = {}
    for n in grads:
        groups.setdefault(_norm_axes(leaves[n]), []).append(n)
    for axes in sorted(groups):
        if not axes:
            continue
        parts = groups[axes]
        summed = torch.stack([sq[n] for n in parts])
        for a in axes:
            summed = axis_sum_(summed, axis_view(mesh, a))
        sq.update(zip(parts, summed.unbind()))
    return sum(sq[n] for n in grads)


@torch.no_grad()
def gather_whole(t: torch.Tensor, axes: Sequence[Tuple[Optional[int], Mesh]],
                 keep: bool = True) -> Optional[torch.Tensor]:
    """The whole leaf of which ``t`` is this rank's part along each ``(dim,
    axis view)`` of ``axes`` (a collective on each axis), or ``t`` itself
    when it is whole (no dim, or views of one rank), so a leaf that is not
    split keeps its identity. A gathered leaf comes back in host memory
    (pinned when the mesh is on the card) when ``keep``, else None: it is
    whole on the device only until it is copied off, so a caller that
    gathers leaf after leaf holds at most one whole leaf there."""
    axes = [(d, m) for d, m in axes if d is not None and m.world > 1]
    if not axes:
        return t
    whole = t.detach().to(axes[0][1].device)
    for d, m in axes:
        whole = all_gather_dim(whole, d, m)
    if not keep:
        return None
    if whole.device.type == "cpu":
        return whole
    host = torch.empty(whole.shape, dtype=whole.dtype, pin_memory=True)
    return host.copy_(whole)
