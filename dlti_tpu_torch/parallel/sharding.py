"""ZeRO placement rules, expert parallelism and their collectives: the port
of ``dlti_tpu/parallel/sharding.py`` for the batch axes and the expert axis.

The reference expresses DeepSpeed's ZeRO stages as shardings over a mesh
and lets GSPMD insert the collectives. The port places each leaf by the
same rules and runs plain ``torch.distributed`` collectives on per-leaf
shards, on the current stream, so that one CUDA graph captures a whole
step with them:

* **baseline** (``ZeROStage.NONE``): everything replicated; gradients
  all-reduced.
* **ZeRO-1**: the optimizer moments of a trainable leaf hold only this
  rank's shard (:func:`opt_shard_dim`: the leaf's largest dim divisible by
  the world, any size); gradients are all-reduced, the update runs on the
  shard, and the new parameter is all-gathered.
* **ZeRO-2**: as ZeRO-1, but the gradient is reduce-scattered to the shard.
* **ZeRO-3**: a leaf whose largest dim divisible by the world is at least
  :data:`_MIN_FSDP_DIM` is itself stored as this rank's shard
  (:func:`param_shard_dim`) and gathered at use (:class:`GatherAtUse`:
  all-gather forward, reduce-scatter of a trainable leaf's gradient
  backward); the rest behaves as under ZeRO-2.

The ZeRO rules run over the batch axes (``Mesh.batch``: the whole world
unless ``expert`` is above 1). The two rules pick the same dim for a leaf
that both shard. A shard is a
contiguous run of ``shape[d] // world`` indices along dim ``d``, rank
``r`` holding run ``r``. At a world of 1 a leaf the rules shard is one
shard, the whole leaf, and its collectives still run (copies), so a group
of one exercises the same path as a larger world.

Host offload (``ds_config_zero3.json:19-27`` parity): ``offload_optimizer``
keeps the moments, ``offload_params`` the frozen base (every leaf no step
changes: under LoRA the kernels, norms, embedding and head), in pinned host
memory. The update copies the moments to the card and back inside the
step; :class:`ParamFetcher` streams the base into the step one block ahead
on a side stream. On the CPU host and device memory are one, so offload
moves nothing there.

Tensor parallelism (a tensor group, ``parallel.tensor``): the model comes
in at this rank's parts, sliced by ``models.interop.shard_params`` and
built at local widths by ``load_model(tensor=)`` (its modules issue the
tensor group's collectives); the layout records each split leaf's
``tensor_dim`` and whole shape. Every
leaf a tensor rank holds whole gets the same gradient on every tensor rank
through those collectives, so gradients are reduced over the batch axes
alone (``Mesh.batch``: the ranks of this tensor rank), ZeRO-1/2 shard the
moments of whole leaves over them, and a split leaf's moments are its
part's, never split further; the gradient norm sums a split leaf's squares
over the tensor group and counts a whole one once.

Expert parallelism (``expert`` above 1, the reference's ``_EP_PATTERN``
rule): a mixture of experts' ``mlp.w1/w2/w3`` (and their int8 pairs) keep
only this rank's ``E / ep`` experts, dim 0 split over the expert group,
when ``ep`` divides ``E`` (else they stay whole, and every rank runs every
expert). Each MoE layer gets a :class:`MoEGroups`: every rank routes every
token and runs its own experts on them; :class:`ExpertIn` (identity
forward, all-reduce backward) brings the tokens and their routing weights
in, :class:`ExpertOut` (all-reduce forward, identity backward) sums the
partial combines, so every leaf held whole gets the same gradient on every
expert rank, and gradients are reduced over the batch axes alone. An expert
leaf's moments are its shard's, never split further. Under data
parallelism too (any ``expert``), :class:`MoEGroups` makes capacity and the
load-balance loss the global microbatch's: it all-gathers each batch rank's
per-(slot, expert) counts and sums the loss's statistics
(:class:`BatchSum`, all-reduce forward and backward). ZeRO-3 with
``expert`` above 1 raises (``parallel.mesh.check_strategy``).
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
from dlti_tpu_torch.parallel.mesh import Mesh
from dlti_tpu_torch.parallel.tensor import (
    CopyIn, ReduceOut, all_reduce_, tensor_shard_dim, whole_shapes)

# Expert-parallel rule: stacked expert weights (or their int8 pairs) split
# dim 0 over 'expert'.
_EP_PATTERN = re.compile(r".*\.mlp\.(w1|w2|w3)(\.q|\.scale)?$")

# Don't ZeRO-3-shard leaves with no dim this long (norm scales, LoRA
# factors with every dim < 1024): the all-gather latency outweighs the
# memory saved. Tests lower it to place shards on tiny models.
_MIN_FSDP_DIM = 1024


def _largest_divisible_dim(shape: Sequence[int], size: int) -> Optional[int]:
    """The largest dim divisible by ``size`` (the first of equals)."""
    best, best_len = None, 0
    for d, n in enumerate(shape):
        if n % size == 0 and n > best_len:
            best, best_len = d, n
    return best


def param_shard_dim(shape: Sequence[int], mesh: Mesh) -> Optional[int]:
    """The dim a parameter leaf is stored sharded along (ZeRO-3 only), or
    None when it is stored whole."""
    if mesh.zero_stage != ZeROStage.ZERO3 or not mesh.distributed or not shape:
        return None
    d = _largest_divisible_dim(shape, mesh.world)
    return d if d is not None and shape[d] >= _MIN_FSDP_DIM else None


def opt_shard_dim(shape: Sequence[int], mesh: Mesh) -> Optional[int]:
    """The dim a trainable leaf's optimizer moments (and its owned gradient)
    are sharded along (ZeRO-1/2/3) over the batch axes, or None when they
    are whole."""
    if mesh.zero_stage == ZeROStage.NONE or not mesh.distributed or not shape:
        return None
    return _largest_divisible_dim(shape, mesh.batch.world)


def expert_shard_dim(name: str, shape: Sequence[int], mesh: Mesh) -> Optional[int]:
    """0 for a stacked expert leaf whose expert count the expert axis
    divides (stored as this rank's experts), else None."""
    if mesh.ep > 1 and _EP_PATTERN.match(name) and shape and shape[0] % mesh.ep == 0:
        return 0
    return None


def shard_of(t: torch.Tensor, d: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the whole ``t`` along ``d`` (a view), or ``t``."""
    if d is None:
        return t
    n = t.shape[d] // mesh.world
    return t.narrow(d, mesh.rank * n, n)


def all_gather_dim(shard: torch.Tensor, d: int, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's shard along ``d``."""
    s = shard.contiguous()
    w, shape = mesh.world, tuple(s.shape)
    # The shards concatenated along dim 0 (the layout every backend takes).
    out = torch.empty((w * shape[0],) + shape[1:], dtype=s.dtype, device=s.device)
    dist.all_gather_into_tensor(out, s, group=mesh.group)
    if d == 0:
        return out
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


def tensor_dim_of(name: str, shape: Sequence[int], mesh: Mesh) -> Optional[int]:
    """The dim of leaf ``name`` split over the tensor group, or None (no
    tensor group, or a leaf every tensor rank holds whole)."""
    return tensor_shard_dim(name, shape, mesh.tp) if mesh.tensor_parallel else None


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
    """A sharded leaf, whole, for the computation that uses it: the forward
    all-gathers the shards; the backward reduce-scatters the gradient to
    this rank's shard (autograd calls it only for a trainable leaf)."""

    @staticmethod
    def forward(ctx, shard, d, mesh):
        ctx.d, ctx.mesh = d, mesh
        return all_gather_dim(shard, d, mesh)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.d, ctx.mesh), None, None


@dataclass(frozen=True)
class LeafPlacement:
    """Where one parameter leaf lives: ``param_dim`` (stored as this rank's
    shard along it, ZeRO-3), ``opt_dim`` (its moments and owned gradient
    sharded along it over the batch axes; trainable leaves), ``expert_dim``
    (stored as this rank's experts along it, the expert axis), ``shape``
    (the whole leaf's), ``host`` (kept in pinned host memory: an offloaded
    frozen leaf), ``tensor_dim`` (stored as this rank's part along it, the
    tensor axis)."""

    shape: Tuple[int, ...]
    trainable: bool
    param_dim: Optional[int] = None
    opt_dim: Optional[int] = None
    host: bool = False
    expert_dim: Optional[int] = None
    tensor_dim: Optional[int] = None


@dataclass
class Layout:
    """The placement of every parameter leaf of a model under a mesh,
    built once by :func:`shard_model`."""

    mesh: Mesh
    leaves: Dict[str, LeafPlacement] = field(default_factory=dict)

    @property
    def offload_optimizer(self) -> bool:
        return self.mesh.parallel.offload_optimizer

    def param_axis(self, name: str) -> Tuple[Optional[int], Mesh]:
        """``(dim, axis)``: the dim along which this rank holds a shard of the
        parameter ``name``, and the mesh view of the ranks holding the
        others ((None, mesh) for a leaf held whole)."""
        pl = self.leaves[name]
        if pl.expert_dim is not None:
            return pl.expert_dim, self.mesh.experts
        if pl.tensor_dim is not None:
            return pl.tensor_dim, self.mesh.tensor
        return pl.param_dim, self.mesh

    def moment_axis(self, name: str) -> Tuple[Optional[int], Mesh]:
        """``(dim, axis)`` as :meth:`param_axis`, for ``name``'s moments."""
        pl = self.leaves[name]
        if pl.param_dim is not None or pl.expert_dim is not None or pl.tensor_dim is not None:
            return self.param_axis(name)
        return pl.opt_dim, self.mesh.batch

    def gathers_update(self, name: str) -> bool:
        """Whether the update of ``name`` runs on a shard of a whole
        parameter, which is all-gathered after it (ZeRO-1/2 leaves, and
        ZeRO-3 leaves that are stored whole)."""
        pl = self.leaves[name]
        return pl.param_dim is None and pl.opt_dim is not None


def plan_layout(model: nn.Module, mesh: Mesh, lora_enabled: bool) -> Layout:
    """Every leaf's :class:`LeafPlacement` under ``mesh``. Under a tensor
    group ``model`` holds this rank's parts already (``models.interop``'s
    ``shard_params`` and ``load_model(tensor=)``), and each placement
    records the whole leaf's shape."""
    offload = mesh.parallel.offload_params and mesh.device.type == "cuda"
    layout = Layout(mesh)
    shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    if mesh.tensor_parallel:
        shapes = whole_shapes(shapes, mesh.tp)
    for name, shape in shapes.items():
        trainable = not lora_enabled or is_lora_name(name)
        ep_dim = expert_shard_dim(name, shape, mesh)
        tp_dim = tensor_dim_of(name, shape, mesh)
        whole = ep_dim is None and tp_dim is None
        layout.leaves[name] = LeafPlacement(
            shape=shape, trainable=trainable,
            param_dim=param_shard_dim(shape, mesh),
            opt_dim=opt_shard_dim(shape, mesh) if trainable and whole else None,
            host=offload and not trainable, expert_dim=ep_dim, tensor_dim=tp_dim)
    return layout


def _param_owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    prefix, _, leaf = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), leaf


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh, lora_enabled: bool) -> Layout:
    """Place ``model``'s parameters by :func:`plan_layout`, in place: a
    ZeRO-3 leaf keeps only this rank's shard (a new ``nn.Parameter`` with
    the old one's ``requires_grad``), an expert leaf only this rank's
    experts, an offloaded leaf moves to pinned host memory. Installs a
    :class:`ParamFetcher` on the model when any leaf must be fetched at
    use, gives each MoE layer its :class:`MoEGroups` under data or expert
    parallelism, and returns the layout. Under a tensor group the model
    comes in at its tensor rank's parts (:func:`plan_layout`)."""
    layout = plan_layout(model, mesh, lora_enabled)
    fetched = False
    for name, pl in layout.leaves.items():
        if pl.expert_dim is not None and mesh.ep > 1:
            owner, leaf = _param_owner(model, name)
            old = getattr(owner, leaf)
            t = shard_of(old.detach(), pl.expert_dim, mesh.experts).clone()
            setattr(owner, leaf, nn.Parameter(t, requires_grad=old.requires_grad))
            del old
        if pl.param_dim is None and not pl.host:
            continue
        fetched = True
        if not pl.host and mesh.world == 1:
            continue  # the one shard is the whole leaf, already in place
        owner, leaf = _param_owner(model, name)
        old = getattr(owner, leaf)
        t = shard_of(old.detach(), pl.param_dim, mesh)
        if pl.host:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            t = h.copy_(t)
        else:
            t = t.clone()
        setattr(owner, leaf, nn.Parameter(t, requires_grad=old.requires_grad))
        del old
    if fetched:
        model.model.fetcher = ParamFetcher(model, layout)
    if mesh.distributed and (mesh.batch.world > 1 or mesh.ep > 1):
        for name, mod in model.named_modules():
            if isinstance(mod, MoEMLP):
                w1 = next(n for n in layout.leaves if n.startswith(f"{name}.w1"))
                mod.groups = MoEGroups(mesh, split=layout.leaves[w1].expert_dim is not None)
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    return layout


class ParamFetcher:
    """Brings the leaves a model does not hold whole on its device to the
    computation that uses them: an offloaded leaf is copied from pinned
    host memory (``copy_(non_blocking=True)`` on a side stream, the next
    block's while this one runs), a ZeRO-3 shard is all-gathered
    (:class:`GatherAtUse`). The model calls :meth:`begin` at each forward
    with the blocks its backward will recompute, :meth:`run_block` for each
    block, and :meth:`leaf` for the embedding, the final norm and the head.
    Fetched tensors are ordinary intermediates: under remat the recompute
    in the backward fetches again, and a block's tensors are freed after
    its last use.

    Each prefetch buffer is allocated on the computing stream, which the
    side stream waits for before it writes, and the computing stream waits
    for the copy before its first use: no tensor changes streams, so the
    allocator frees buffers in stream order, within a CUDA graph's capture
    as outside it."""

    def __init__(self, model: nn.Module, layout: Layout):
        self.layout = layout
        self.mesh = layout.mesh
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
        return pl.param_dim is not None or pl.host

    def _param(self, name: str) -> torch.Tensor:
        owner, leaf = _param_owner(self._model, name)
        return getattr(owner, leaf)

    def begin(self, recomputed: Sequence[int]) -> None:
        """A forward over every block, then (training under remat) the
        recompute of ``recomputed`` in the backward, last first."""
        self._pending.clear()
        self._plan = list(range(len(self._blocks))) + sorted(recomputed, reverse=True)
        self._pos = 0

    def _issue(self, names: Sequence[str]) -> tuple:
        """Start copying the host leaves among ``names`` to the card."""
        host = [n for n in names if self.layout.leaves[n].host]
        if not host or self._side is None:
            return {}, None
        cur = torch.cuda.current_stream(self.mesh.device)
        bufs = {n: torch.empty_like(self._param(n), device=self.mesh.device) for n in host}
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            for n, b in bufs.items():
                b.copy_(self._param(n), non_blocking=True)
            event = self._side.record_event()
        return bufs, event

    def _resolve(self, names: Sequence[str], issued: tuple) -> Dict[str, torch.Tensor]:
        bufs, event = issued
        if event is not None:
            torch.cuda.current_stream(self.mesh.device).wait_event(event)
        out = {}
        for n in names:
            t = bufs.get(n, None)
            if t is None:
                t = self._param(n)
            pl = self.layout.leaves[n]
            if pl.param_dim is not None:
                t = GatherAtUse.apply(t, pl.param_dim, self.mesh)
            out[n] = t
        return out

    def fetches(self, name: str) -> bool:
        return name in self.layout.leaves and self._fetched(name)

    def leaf(self, name: str) -> torch.Tensor:
        """``name`` whole on the device (the parameter itself when it is
        held so)."""
        if not self._fetched(name):
            return self._param(name)
        return self._resolve([name], self._issue([name]))[name]

    def block(self, i: int) -> Dict[str, torch.Tensor]:
        """Block ``i``'s fetched leaves by their names within the block;
        starts the next planned block's copy."""
        issued = self._pending.pop(i, None)
        if issued is None:
            issued = self._issue([n for _, n in self._blocks[i]])
        if self._pos < len(self._plan) and self._plan[self._pos] == i:
            self._pos += 1
            if self._pos < len(self._plan):
                nxt = self._plan[self._pos]
                if nxt not in self._pending:
                    self._pending[nxt] = self._issue([n for _, n in self._blocks[nxt]])
        full = self._resolve([n for _, n in self._blocks[i]], issued)
        return {rel: full[n] for rel, n in self._blocks[i]}

    def run_block(self, i: int, layer: nn.Module, *args):
        """``layer(*args)`` with block ``i``'s fetched leaves in place of
        its parameters."""
        return torch.func.functional_call(layer, self.block(i), args)


def owned_grad(g: torch.Tensor, name: str, layout: Layout,
               summed: bool = False) -> torch.Tensor:
    """A trainable leaf's summed local gradient (whole, or the ZeRO-3 shard
    autograd reduce-scattered already) as the global gradient this rank
    owns: the shard along ``opt_dim`` (reduce-scattered under ZeRO-2/3,
    sliced from the all-reduced whole under ZeRO-1) or the whole
    (all-reduced). ``summed``: ``g`` is the global sum already
    (:func:`reduce_in_dtype` per microbatch), so this rank takes its part."""
    pl, mesh = layout.leaves[name], layout.mesh.batch
    if pl.param_dim is not None:
        return g
    if summed:
        return shard_of(g, pl.opt_dim, mesh)
    if pl.opt_dim is not None and mesh.zero_stage in (ZeROStage.ZERO2, ZeROStage.ZERO3):
        return reduce_scatter_dim(g, pl.opt_dim, mesh)
    all_reduce_(g, mesh)
    return shard_of(g, pl.opt_dim, mesh)


def reduce_in_dtype(g: torch.Tensor, name: str, layout: Layout,
                    dtype: torch.dtype) -> torch.Tensor:
    """One microbatch's gradient of a trainable leaf (float32 holding the
    values of a ``dtype`` gradient, this rank's rows) summed over the ranks
    and rounded to ``dtype``, as the reference's sharded step sums the
    compute-dtype partial products of a data-parallel dot: in float16 a sum
    past 65504 is inf on every rank, as on one device, and the loss scaler
    takes the single device's decision. A ZeRO-3 leaf's gradient arrives
    reduce-scattered already (``GatherAtUse``) and is only rounded."""
    if layout.leaves[name].param_dim is None:
        g = all_reduce_(g, layout.mesh.batch)
    return g.to(dtype).float()


def sharded_sq_norm(grads: Mapping[str, torch.Tensor], layout: Layout) -> torch.Tensor:
    """The whole gradient's sum of squares (float32) from the owned
    gradients: each leaf's squares summed over the ranks holding its other
    parts (the batch axes for a ZeRO shard, the expert group for an expert
    leaf, the tensor group for a tensor-split one; one all-reduce an axis),
    then every leaf's in order, each leaf held whole on every rank counted
    once. The leaves add up in one order whatever the placement, so a world
    of 1 sums as one device does."""
    leaves, mesh = layout.leaves, layout.mesh
    sq = {n: torch.sum(g.float() * g.float()) for n, g in grads.items()}

    def axis(pl):
        if pl.expert_dim is not None:
            return "experts"
        if pl.tensor_dim is not None:
            return "tensor"
        if pl.opt_dim is not None or pl.param_dim is not None:
            return "batch"
        return None

    for name in ("batch", "experts", "tensor"):  # one order on every rank
        parts = [n for n in grads if axis(leaves[n]) == name]
        if parts:
            summed = all_reduce_(torch.stack([sq[n] for n in parts]), getattr(mesh, name))
            sq.update(zip(parts, summed.unbind()))
    return sum(sq[n] for n in grads)


@torch.no_grad()
def gather_whole(t: torch.Tensor, d: Optional[int], mesh: Mesh) -> torch.Tensor:
    """The whole leaf of which ``t`` is this rank's shard along ``d`` (a
    collective), or ``t`` itself when it is whole (``d`` None or a world of
    1), so a leaf that is not sharded keeps its identity. A gathered leaf
    comes back in host memory (pinned when the mesh is on the card): it is
    whole on the device only until it is copied off, so a caller that
    gathers leaf after leaf holds at most one whole leaf there."""
    if d is None or mesh.world == 1:
        return t
    whole = all_gather_dim(t.detach().to(mesh.device), d, mesh)
    if whole.device.type == "cpu":
        return whole
    host = torch.empty(whole.shape, dtype=whole.dtype, pin_memory=True)
    return host.copy_(whole)
