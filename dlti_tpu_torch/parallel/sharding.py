"""ZeRO placement rules and collectives: the port of
``dlti_tpu/parallel/sharding.py`` for the batch axes.

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

The two rules pick the same dim for a leaf that both shard. A shard is a
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
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from dlti_tpu_torch.config import ZeROStage
from dlti_tpu_torch.models.lora import is_lora_name
from dlti_tpu_torch.parallel.mesh import Mesh

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
    are sharded along (ZeRO-1/2/3), or None when they are whole."""
    if mesh.zero_stage == ZeROStage.NONE or not mesh.distributed or not shape:
        return None
    return _largest_divisible_dim(shape, mesh.world)


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


def all_reduce_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


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
    sharded along it; trainable leaves), ``shape`` (the whole leaf's),
    ``host`` (kept in pinned host memory: an offloaded frozen leaf)."""

    shape: Tuple[int, ...]
    trainable: bool
    param_dim: Optional[int] = None
    opt_dim: Optional[int] = None
    host: bool = False


@dataclass
class Layout:
    """The placement of every parameter leaf of a model under a mesh,
    built once by :func:`shard_model`."""

    mesh: Mesh
    leaves: Dict[str, LeafPlacement] = field(default_factory=dict)

    @property
    def offload_optimizer(self) -> bool:
        return self.mesh.parallel.offload_optimizer

    def gathers_update(self, name: str) -> bool:
        """Whether the update of ``name`` runs on a shard of a whole
        parameter, which is all-gathered after it (ZeRO-1/2 leaves, and
        ZeRO-3 leaves that are stored whole)."""
        pl = self.leaves[name]
        return pl.param_dim is None and pl.opt_dim is not None


def plan_layout(model: nn.Module, mesh: Mesh, lora_enabled: bool) -> Layout:
    """Every leaf's :class:`LeafPlacement` under ``mesh``."""
    offload = mesh.parallel.offload_params and mesh.device.type == "cuda"
    layout = Layout(mesh)
    for name, p in model.named_parameters():
        trainable = not lora_enabled or is_lora_name(name)
        shape = tuple(p.shape)
        layout.leaves[name] = LeafPlacement(
            shape=shape, trainable=trainable,
            param_dim=param_shard_dim(shape, mesh),
            opt_dim=opt_shard_dim(shape, mesh) if trainable else None,
            host=offload and not trainable)
    return layout


def _param_owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    prefix, _, leaf = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), leaf


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh, lora_enabled: bool) -> Layout:
    """Place ``model``'s parameters by :func:`plan_layout`, in place: a
    ZeRO-3 leaf keeps only this rank's shard (a new ``nn.Parameter`` with
    the old one's ``requires_grad``), an offloaded leaf moves to pinned
    host memory. Installs a :class:`ParamFetcher` on the model when any
    leaf must be fetched at use, and returns the layout."""
    layout = plan_layout(model, mesh, lora_enabled)
    fetched = False
    for name, pl in layout.leaves.items():
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
    pl, mesh = layout.leaves[name], layout.mesh
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
        g = all_reduce_(g, layout.mesh)
    return g.to(dtype).float()


def sharded_sq_norm(grads: Mapping[str, torch.Tensor], layout: Layout) -> torch.Tensor:
    """The whole gradient's sum of squares (float32) from the owned
    gradients: each shard's squares summed over the ranks, each leaf held
    whole on every rank counted once."""
    sharded = [n for n in grads if layout.leaves[n].opt_dim is not None
               or layout.leaves[n].param_dim is not None]
    whole = [n for n in grads if n not in sharded]
    sq = sum(torch.sum(grads[n].float() * grads[n].float()) for n in sharded)
    if sharded:
        all_reduce_(sq, layout.mesh)
    return sq + sum(torch.sum(grads[n].float() * grads[n].float()) for n in whole)


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
