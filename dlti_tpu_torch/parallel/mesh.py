"""The mesh: the port of ``dlti_tpu/parallel/mesh.py``, all six axes.

The reference's mesh has six axes, and the port runs them all, one process
per device: the two that carry the batch, ``data`` (replicated data
parallelism and ZeRO-1/2) and ``fsdp`` (ZeRO-3's parameter sharding),
``tensor`` (attention heads, MLP hidden units and the vocabulary split over
it, Megatron-style: ``parallel.tensor``), ``sequence`` (each rank holds a
contiguous chunk of every row's tokens; attention runs the ring,
``parallel.ring_attention``), ``pipe`` (each rank holds ``num_layers /
pipe`` consecutive layers, GPipe's stages: ``parallel.pipeline``) and
``expert`` (a mixture of experts' stacked expert weights split over it).
Only the batch axes split the rows: the ranks of one tensor, sequence, pipe
or expert group see the same rows. The product of the extents is the world
of the ``torch.distributed`` process group, which
``launcher.maybe_initialize_from_env`` joins. Ranks are laid out in the
reference's axis order (data, fsdp, tensor, sequence, pipe, expert), the
last axis varying fastest: rank ``r`` is expert rank ``r % expert``, pipe
rank ``(r // expert) % pipe``, and so on out to data rank ``r // (fsdp *
tensor * sequence * pipe * expert)``; its batch rank (the rows it takes) is
``data rank * fsdp + fsdp rank``. With an axis above 1 that is not the whole
world, :func:`build_mesh` forms a process subgroup per axis and rank of the
others (``torch.distributed.new_group``), the batch axes' together too; the
whole world stays the group of everything else. A tensor group of one can
be asked for (``build_mesh(..., tensor_group=True)``): the model then takes
the tensor-parallel path at extent 1, its collectives issued on a group of
one, as ZeRO's run at a world of 1. :func:`build_mesh` checks the strategy
against the world with the reference trainer's legality rules
(``dlti_tpu/training/trainer.py:73-169``) and raises for what the port
cannot run: host offload with ``tensor``, ``sequence`` or ``pipe`` above 1,
``sequence`` with ``pipe`` or ``expert`` above 1, and ``tensor`` with
``expert`` above 1. ZeRO-3 shards over its own ``fsdp`` axis
(``parallel.sharding.strategy_axes``), so it runs with every model axis and
beside ``data``.

The entry points own the process group: the launcher's env, or
``launcher.init_group_of_one`` for a ZeRO strategy run without it.
:func:`build_mesh` only reads the group, and a strategy that needs one in
a process without one raises. The baseline without a group is
:func:`single_device_mesh`: one device and no collectives. On the card the
group runs NCCL; gloo there (every rank on one card,
``launcher --one-device``) is admitted only when the launcher asked for it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from dlti_tpu_torch.config import ParallelConfig, ZeROStage
from dlti_tpu_torch.launcher import one_device

MESH_AXES = ("data", "fsdp", "tensor", "sequence", "pipe", "expert")
# The model axes in rank order after the batch axes, the last fastest.
_MODEL_AXES = ("tensor", "sequence", "pipe", "expert")


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the world: the strategy (with its extents), the
    world size, this process's rank and device, and the process group
    (None: one process and no collectives, the baseline's single-device
    path). ``data_group``, ``fsdp_group``, ``batch_group`` (the two
    together), ``tensor_group``, ``sequence_group``, ``pipe_group`` and
    ``expert_group`` are this rank's subgroups of the axes (:attr:`data`,
    :attr:`fsdp`, :attr:`batch`, :attr:`tensor`, :attr:`sequence`,
    :attr:`pipe`, :attr:`experts`), formed for an axis above 1 that is not
    the whole world; ``tensor_group`` may also be a group of one (the
    tensor-parallel path at extent 1). ``control_group``: the tensor group
    again over gloo, for the host messages a tensor-parallel engine sends
    its followers.

    A view of an axis whose extent is the whole world runs on the world's
    group; a view of extent 1 in a larger world has no group (a sum over
    it is the identity, :func:`axis_sum_`)."""

    parallel: ParallelConfig
    world: int
    rank: int
    device: torch.device
    group: Optional["dist.ProcessGroup"] = None
    batch_group: Optional["dist.ProcessGroup"] = None
    expert_group: Optional["dist.ProcessGroup"] = None
    tensor_group: Optional["dist.ProcessGroup"] = None
    control_group: Optional["dist.ProcessGroup"] = None
    sequence_group: Optional["dist.ProcessGroup"] = None
    pipe_group: Optional["dist.ProcessGroup"] = None
    data_group: Optional["dist.ProcessGroup"] = None
    fsdp_group: Optional["dist.ProcessGroup"] = None

    @property
    def ep(self) -> int:
        """The expert axis's extent."""
        return self.parallel.expert

    @property
    def tp(self) -> int:
        """The tensor axis's extent."""
        return self.parallel.tensor

    @property
    def sp(self) -> int:
        """The sequence axis's extent."""
        return self.parallel.sequence

    @property
    def pp(self) -> int:
        """The pipe axis's extent (the number of stages)."""
        return self.parallel.pipe

    @property
    def tensor_parallel(self) -> bool:
        """Whether the model takes the tensor-parallel path (a tensor group
        exists, of any size)."""
        return self.tensor_group is not None

    def _view(self, **kw) -> "Mesh":
        return dataclasses.replace(self, batch_group=None, expert_group=None,
                                   tensor_group=None, control_group=None,
                                   sequence_group=None, pipe_group=None, data_group=None,
                                   fsdp_group=None, **kw)

    def _axis_rank(self, axis: str) -> int:
        """This rank's coordinate on axis ``axis``."""
        stride = 1
        for a in reversed(MESH_AXES):
            n = getattr(self.parallel, a)
            if a == axis:
                return (self.rank // stride) % n
            stride *= n
        raise KeyError(axis)

    def _axis_view(self, axis: str, subgroup) -> "Mesh":
        """The view of batch axis ``axis`` (``data`` or ``fsdp``): its own
        subgroup, the world's group when it spans the world, else none."""
        n = getattr(self.parallel, axis)
        group = subgroup if subgroup is not None else (self.group if n == self.world else None)
        return self._view(parallel=ParallelConfig(), world=n, rank=self._axis_rank(axis),
                          group=group)

    @property
    def batch(self) -> "Mesh":
        """This rank's view of the batch axes together (``data`` times
        ``fsdp``): the ranks that hold its tensor, sequence, pipe and expert
        ranks, which split the batch rows (rank ``data rank * fsdp + fsdp
        rank``) and reduce the loss's sums (the whole mesh when every model
        axis is 1). For collectives only: its rank 0 is not the writer."""
        inner = self.ep * self.tp * self.sp * self.pp
        if inner == 1:
            return self
        return self._view(parallel=dataclasses.replace(self.parallel, expert=1, tensor=1,
                                                       sequence=1, pipe=1),
                          world=self.world // inner, rank=self.rank // inner,
                          group=self.batch_group)

    @property
    def data(self) -> "Mesh":
        """This rank's view of the ``data`` axis: the replicas of its
        parameter shards (ZeRO-1/2 shard the moments over it). For
        collectives only."""
        return self._axis_view("data", self.data_group)

    @property
    def fsdp(self) -> "Mesh":
        """This rank's view of the ``fsdp`` axis: the ranks over which ZeRO-3
        shards each parameter and its moments. For collectives only."""
        return self._axis_view("fsdp", self.fsdp_group)

    @property
    def experts(self) -> "Mesh":
        """This rank's view of the expert axis: the ranks of its batch rank,
        over which the experts are split (a world of 1 when ``expert`` is
        1). For collectives only."""
        return self._view(parallel=ParallelConfig(), world=self.ep, rank=self.rank % self.ep,
                          group=self.expert_group if self.ep > 1 else None)

    @property
    def tensor(self) -> "Mesh":
        """This rank's view of the tensor axis: the ranks of its batch rank
        over which heads, hidden units and the vocabulary are split (a world
        of 1, with a group when the tensor path runs at extent 1). For
        collectives only."""
        return self._view(parallel=ParallelConfig(), world=self.tp,
                          rank=self._axis_rank("tensor"), group=self.tensor_group)

    @property
    def sequence(self) -> "Mesh":
        """This rank's view of the sequence axis: the ranks of its batch rank
        over which each row's tokens are split, in order (a world of 1 when
        ``sequence`` is 1). For collectives only."""
        return self._view(parallel=ParallelConfig(), world=self.sp,
                          rank=self._axis_rank("sequence"),
                          group=self.sequence_group if self.sp > 1 else None)

    @property
    def pipe(self) -> "Mesh":
        """This rank's view of the pipe axis: the stages of its batch rank,
        rank ``k`` holding layers ``k * L/P .. (k+1) * L/P - 1`` (a world of 1
        when ``pipe`` is 1). For collectives only."""
        return self._view(parallel=ParallelConfig(), world=self.pp,
                          rank=self._axis_rank("pipe"),
                          group=self.pipe_group if self.pp > 1 else None)

    @property
    def zero_stage(self) -> ZeROStage:
        return ZeROStage(self.parallel.zero_stage)

    @property
    def fsdp_extent(self) -> int:
        """The extent ZeRO-3 shards parameters over: ``fsdp`` under ZeRO-3,
        else 1 (the reference's ``param_pspec``)."""
        return self.parallel.fsdp if self.zero_stage == ZeROStage.ZERO3 else 1

    @property
    def splits_leaves(self) -> bool:
        """Whether the placement rule cuts any leaf under this mesh (a tensor
        group, the experts split, or ZeRO-3 over ``fsdp``)."""
        return self.tensor_parallel or self.ep > 1 or self.fsdp_extent > 1

    @property
    def distributed(self) -> bool:
        """Whether the step runs collectives (a group exists, of any size)."""
        return self.group is not None

    @property
    def is_writer(self) -> bool:
        """Rank 0: the one that logs, writes checkpoints and sidecars."""
        return self.rank == 0


def axis_sum_(t: torch.Tensor, view: Mesh) -> torch.Tensor:
    """Sum ``t`` over the ranks of axis view ``view``, in place; a view
    without a group (extent 1 in a larger world, or no process group) is
    the identity."""
    if view.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=view.group)
    return t


def fit_parallel_to_devices(cfg: ParallelConfig, n_devices: int) -> ParallelConfig:
    """Shrink the batch axes (``data``/``fsdp``) of a mesh config to fit
    ``n_devices``: the model-parallel axes keep their extent while the
    batch extent absorbs the loss. A no-op when the config already fits."""
    if cfg.num_devices <= n_devices:
        return cfg
    fixed = cfg.tensor * cfg.sequence * cfg.pipe * cfg.expert
    rows = n_devices // fixed
    if rows < 1:
        raise ValueError(
            f"cannot reshape mesh to {n_devices} devices: the model-parallel "
            f"extent tensor*sequence*pipe*expert={fixed} alone exceeds the "
            "surviving world")
    if cfg.data > 1 and cfg.fsdp > 1:
        raise ValueError(
            f"cannot reshape a mixed data={cfg.data} x fsdp={cfg.fsdp} mesh "
            "automatically; relaunch with explicit extents")
    if cfg.fsdp > 1:
        return dataclasses.replace(cfg, fsdp=rows)
    return dataclasses.replace(cfg, data=rows)


def check_strategy(par: ParallelConfig, lora_enabled: bool = True) -> None:
    """Raise for a strategy that is illegal (the reference's rules) or that
    the port does not run."""
    for axis in MESH_AXES:
        if getattr(par, axis) < 1:
            raise ValueError(f"{axis}={getattr(par, axis)}: an extent must be at least 1")
    offload = par.offload_optimizer or par.offload_params
    refused = []
    for axis in ("tensor", "sequence", "pipe"):
        if getattr(par, axis) > 1 and offload:
            refused.append(f"{axis}={getattr(par, axis)} with host offload ({axis} x offload)")
    if par.sequence > 1 and par.pipe > 1:
        refused.append(f"sequence={par.sequence} with pipe={par.pipe} (pipe x sequence: "
                       "all-gather sequence parallelism inside the stages)")
    if par.sequence > 1 and par.expert > 1:
        refused.append(f"sequence={par.sequence} with expert={par.expert} (sequence x "
                       "expert: routing over the global token order)")
    if par.tensor > 1 and par.expert > 1:
        refused.append(f"tensor={par.tensor} with expert={par.expert} (tensor x expert)")
    if refused:
        raise NotImplementedError(
            f"{'; '.join(refused)}: not ported yet (see ROADMAP.md); every other "
            "combination of data, fsdp (ZeRO-3), tensor, sequence, pipe and expert runs")
    if par.fsdp > 1 and int(par.zero_stage) != 3:
        raise ValueError(f"fsdp={par.fsdp} without zero_stage=3 (the fsdp axis only "
                         "carries ZeRO-3 param sharding)")
    if par.offload_params and not lora_enabled:
        raise ValueError("offload_params without LoRA (it offloads the frozen base "
                         "params; a full fine-tune has none)")


def single_device_mesh(device) -> Mesh:
    """The baseline on one device: no process group, no collectives."""
    return Mesh(parallel=ParallelConfig(), world=1, rank=0, device=torch.device(device))


def _axis_members(par: ParallelConfig, world: int, axis: str) -> list:
    """Every group of ranks that share all coordinates but ``axis``'s
    (``"batch"``: ``data`` and ``fsdp`` together), in one order."""
    extents = [getattr(par, a) for a in MESH_AXES]
    free = ("data", "fsdp") if axis == "batch" else (axis,)
    groups = {}
    for r in range(world):
        coords, rest = [], r
        for n in reversed(extents):
            coords.append(rest % n)
            rest //= n
        coords.reverse()
        key = tuple(c for a, c in zip(MESH_AXES, coords) if a not in free)
        groups.setdefault(key, []).append(r)
    return [groups[key] for key in sorted(groups)]


def build_mesh(par: ParallelConfig, device: torch.device,
               lora_enabled: bool = True, tensor_group: bool = False) -> Mesh:
    """This rank's :class:`Mesh` for ``par`` on ``device``, in the process
    group the entry point formed (every rank must call it together when a
    model axis is above 1: it forms the subgroups). ``tensor_group``: form
    the tensor groups at ``tensor`` 1 too (groups of one), so the model
    takes the tensor-parallel path. Raises when the strategy is illegal or
    unported (:func:`check_strategy`), when a ZeRO strategy or a model axis
    finds no group, or when the product of the extents differs from the
    group's world (1 without a group)."""
    check_strategy(par, lora_enabled)
    initialized = dist.is_available() and dist.is_initialized()
    stage = ZeROStage(par.zero_stage)
    tensor_group = tensor_group or par.tensor > 1
    model_axes = [f"{a}={getattr(par, a)}" for a in ("expert", "sequence", "pipe")
                  if getattr(par, a) > 1]
    if not initialized and (stage != ZeROStage.NONE or model_axes or tensor_group):
        what = (f"zero{int(stage)}" if stage != ZeROStage.NONE
                else model_axes[0] if model_axes else f"tensor={par.tensor}")
        raise ValueError(
            f"{what} runs its collectives in a process group and this "
            "process has none: start it with python -m dlti_tpu_torch.launcher, or "
            "form a group of one first (dlti_tpu_torch.launcher.init_group_of_one)")
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    need = par.num_devices
    if need != world:
        raise ValueError(
            f"data*fsdp*tensor*sequence*pipe*expert = {need} but the process group has "
            f"{world} rank(s); launch {need} processes with python -m "
            "dlti_tpu_torch.launcher --num-processes N, or set the extent to the "
            "world (cli.train --num-devices)")
    if initialized:
        backend = dist.get_backend()
        want = "nccl" if device.type == "cuda" else "gloo"
        if backend != want and not (device.type == "cuda" and backend == "gloo"
                                    and one_device()):
            raise ValueError(f"the process group runs {backend} but the device is "
                             f"{device}; the port runs {want} there (gloo on the "
                             "card only under launcher --one-device)")
    groups = {}
    inner = par.tensor * par.sequence * par.pipe * par.expert
    # Every rank forms every subgroup, in one order: the ranks that share
    # all coordinates but the axis's. An axis spanning the world runs on
    # the world's group.
    axes = [a for a in ("expert", "sequence", "pipe") if getattr(par, a) > 1]
    if tensor_group:
        axes.append("tensor")
    if inner > 1:
        axes.append("batch")
    axes += [a for a in ("data", "fsdp") if 1 < getattr(par, a) < world]
    for axis in axes:
        for ranks in _axis_members(par, world, axis):
            g = dist.new_group(ranks)
            if axis == "tensor":
                # The host messages of a tensor-parallel engine, over gloo
                # whatever the device's backend.
                ctl = dist.new_group(ranks, backend="gloo")
            if rank in ranks:
                groups[axis] = g
                if axis == "tensor":
                    groups["control"] = ctl
    return Mesh(parallel=par, world=world, rank=rank, device=device,
                group=dist.group.WORLD if initialized else None,
                batch_group=groups.get("batch"), expert_group=groups.get("expert"),
                tensor_group=groups.get("tensor"), control_group=groups.get("control"),
                sequence_group=groups.get("sequence"), pipe_group=groups.get("pipe"),
                data_group=groups.get("data"), fsdp_group=groups.get("fsdp"))
