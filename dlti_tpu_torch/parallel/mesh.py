"""The mesh: the port of ``dlti_tpu/parallel/mesh.py`` for the batch axes,
the tensor axis and the expert axis.

The reference's mesh has six axes. The port runs four, one process per
device: the two that carry the batch, ``data`` (replicated data
parallelism and ZeRO-1/2) and ``fsdp`` (ZeRO-3's parameter sharding),
``tensor`` (attention heads, MLP hidden units and the vocabulary split over
it, Megatron-style: ``parallel.tensor``) and ``expert`` (a mixture of
experts' stacked expert weights split over it). ``tensor`` and ``expert``
are not batch axes: the ranks of one tensor or expert group see the same
rows. Their product is the world of the ``torch.distributed`` process
group, which ``launcher.maybe_initialize_from_env`` joins. Ranks are laid
out as the reference's axis order (data, fsdp, tensor, ..., expert) puts
devices: rank ``r`` is expert rank ``r % expert``, tensor rank ``(r //
expert) % tensor`` and batch rank ``r // (tensor * expert)``. With
``tensor`` or ``expert`` above 1, :func:`build_mesh` forms a process
subgroup per axis and rank of the others (``torch.distributed.new_group``);
the whole world stays the group of everything else. A tensor group of one
can be asked for (``build_mesh(..., tensor_group=True)``): the model then
takes the tensor-parallel path at extent 1, its collectives issued on a
group of one, as ZeRO's run at a world of 1. :func:`build_mesh` checks the
strategy against the world with the reference trainer's legality rules
(``dlti_tpu/training/trainer.py:104-117``) and raises for what the port
cannot run: ``sequence`` or ``pipe`` above 1, ``data`` and ``fsdp`` both
above 1, ``fsdp`` with ``expert`` above 1, and ``tensor`` above 1 with
ZeRO-3, ``expert`` or host offload.

The entry points own the process group: the launcher's env, or
``launcher.init_group_of_one`` for a ZeRO strategy run without it.
:func:`build_mesh` only reads the group, and a ZeRO strategy in a process
without one raises. The baseline without a group is
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


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the world: the strategy (with its extents), the
    world size, this process's rank and device, and the process group
    (None: one process and no collectives, the baseline's single-device
    path). With ``tensor`` or ``expert`` above 1, ``batch_group``,
    ``tensor_group`` and ``expert_group`` are this rank's subgroups of the
    axes (:attr:`batch`, :attr:`tensor`, :attr:`experts`); ``tensor_group``
    may also be a group of one (the tensor-parallel path at extent 1).
    ``control_group``: the tensor group again over gloo, for the host
    messages a tensor-parallel engine sends its followers."""

    parallel: ParallelConfig
    world: int
    rank: int
    device: torch.device
    group: Optional["dist.ProcessGroup"] = None
    batch_group: Optional["dist.ProcessGroup"] = None
    expert_group: Optional["dist.ProcessGroup"] = None
    tensor_group: Optional["dist.ProcessGroup"] = None
    control_group: Optional["dist.ProcessGroup"] = None

    @property
    def ep(self) -> int:
        """The expert axis's extent."""
        return self.parallel.expert

    @property
    def tp(self) -> int:
        """The tensor axis's extent."""
        return self.parallel.tensor

    @property
    def tensor_parallel(self) -> bool:
        """Whether the model takes the tensor-parallel path (a tensor group
        exists, of any size)."""
        return self.tensor_group is not None

    def _view(self, **kw) -> "Mesh":
        return dataclasses.replace(self, batch_group=None, expert_group=None,
                                   tensor_group=None, control_group=None, **kw)

    @property
    def batch(self) -> "Mesh":
        """This rank's view of the batch axes alone: the ranks that hold its
        tensor and expert ranks, which split the batch rows, reduce
        gradients and shard ZeRO-1/2 moments (the whole mesh when ``tensor``
        and ``expert`` are 1). For collectives only: its rank 0 is not the
        writer."""
        inner = self.ep * self.tp
        if inner == 1:
            return self
        return self._view(parallel=dataclasses.replace(self.parallel, expert=1, tensor=1),
                          world=self.world // inner, rank=self.rank // inner,
                          group=self.batch_group)

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
                          rank=(self.rank // self.ep) % self.tp, group=self.tensor_group)

    @property
    def zero_stage(self) -> ZeROStage:
        return ZeROStage(self.parallel.zero_stage)

    @property
    def distributed(self) -> bool:
        """Whether the step runs collectives (a group exists, of any size)."""
        return self.group is not None

    @property
    def is_writer(self) -> bool:
        """Rank 0: the one that logs, writes checkpoints and sidecars."""
        return self.rank == 0


def fit_parallel_to_devices(cfg: ParallelConfig, n_devices: int) -> ParallelConfig:
    """Shrink the batch axes (``data``/``fsdp``) of a mesh config to fit
    ``n_devices``: the model-parallel axes (``expert`` among them) keep
    their extent while the batch extent absorbs the loss. A no-op when the
    config already fits."""
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
    unported = [f"{axis}={getattr(par, axis)}" for axis in ("sequence", "pipe")
                if getattr(par, axis) > 1]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: sequence and pipeline parallelism "
            "are not ported yet (see ROADMAP.md)")
    if par.tensor > 1:
        with_tensor = []
        if par.fsdp > 1 or int(par.zero_stage) == 3:
            with_tensor.append(f"zero_stage={int(par.zero_stage)}, fsdp={par.fsdp} "
                               "(tensor x ZeRO-3)")
        if par.expert > 1:
            with_tensor.append(f"expert={par.expert} (tensor x expert)")
        if par.offload_optimizer or par.offload_params:
            with_tensor.append("host offload (tensor x offload)")
        if with_tensor:
            raise NotImplementedError(
                f"tensor={par.tensor} with {'; '.join(with_tensor)}: not ported yet "
                "(see ROADMAP.md); tensor parallelism runs alone or with data "
                "(baseline, ZeRO-1, ZeRO-2)")
    if par.expert > 1 and (par.fsdp > 1 or int(par.zero_stage) == 3):
        # Whatever the fsdp extent: ZeRO-3 shards over the whole world,
        # expert ranks included, which would split the experts twice.
        raise NotImplementedError(
            f"zero_stage={int(par.zero_stage)}, fsdp={par.fsdp} with "
            f"expert={par.expert}: ZeRO-3 with expert parallelism (fsdp x "
            "expert) is not ported yet (see ROADMAP.md)")
    if par.fsdp > 1 and int(par.zero_stage) != 3:
        raise ValueError(f"fsdp={par.fsdp} without zero_stage=3 (the fsdp axis only "
                         "carries ZeRO-3 param sharding)")
    if par.data > 1 and par.fsdp > 1:
        raise NotImplementedError(
            f"data={par.data} with fsdp={par.fsdp}: the port shards ZeRO-3 over "
            "the whole world; a mixed data x fsdp mesh is not ported (see ROADMAP.md)")
    if par.offload_params and not lora_enabled:
        raise ValueError("offload_params without LoRA (it offloads the frozen base "
                         "params; a full fine-tune has none)")


def single_device_mesh(device) -> Mesh:
    """The baseline on one device: no process group, no collectives."""
    return Mesh(parallel=ParallelConfig(), world=1, rank=0, device=torch.device(device))


def build_mesh(par: ParallelConfig, device: torch.device,
               lora_enabled: bool = True, tensor_group: bool = False) -> Mesh:
    """This rank's :class:`Mesh` for ``par`` on ``device``, in the process
    group the entry point formed (every rank must call it together when
    ``tensor`` or ``expert`` is above 1: it forms the subgroups).
    ``tensor_group``: form the tensor groups at ``tensor`` 1 too (groups of
    one), so the model takes the tensor-parallel path. Raises when the
    strategy is illegal or unported (:func:`check_strategy`), when a ZeRO
    strategy, the tensor or the expert axis finds no group, or when ``data
    * fsdp * tensor * expert`` differs from the group's world (1 without a
    group)."""
    check_strategy(par, lora_enabled)
    initialized = dist.is_available() and dist.is_initialized()
    stage = ZeROStage(par.zero_stage)
    tensor_group = tensor_group or par.tensor > 1
    if not initialized and (stage != ZeROStage.NONE or par.expert > 1 or tensor_group):
        what = (f"zero{int(stage)}" if stage != ZeROStage.NONE
                else f"expert={par.expert}" if par.expert > 1 else f"tensor={par.tensor}")
        raise ValueError(
            f"{what} runs its collectives in a process group and this "
            "process has none: start it with python -m dlti_tpu_torch.launcher, or "
            "form a group of one first (dlti_tpu_torch.launcher.init_group_of_one)")
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    need = par.dp_like_size * par.tensor * par.expert
    if need != world:
        raise ValueError(
            f"data*fsdp*tensor*expert = {need} but the process group has {world} "
            f"rank(s); launch {need} processes with python -m "
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
    ep, tp = par.expert, par.tensor
    inner = ep * tp
    # Every rank forms every subgroup, in one order: the ranks that share
    # all coordinates but the axis's.
    axes = []
    if ep > 1:
        axes.append(("expert", [[b * inner + t * ep + x for x in range(ep)]
                                for b in range(world // inner) for t in range(tp)]))
    if tensor_group:
        axes.append(("tensor", [[b * inner + t * ep + x for t in range(tp)]
                                for b in range(world // inner) for x in range(ep)]))
    if inner > 1:
        axes.append(("batch", [[b * inner + t * ep + x for b in range(world // inner)]
                               for t in range(tp) for x in range(ep)]))
    for axis, members in axes:
        for ranks in members:
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
                tensor_group=groups.get("tensor"), control_group=groups.get("control"))
