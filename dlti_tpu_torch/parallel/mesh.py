"""The mesh: the port of ``dlti_tpu/parallel/mesh.py`` for the batch axes
and the expert axis.

The reference's mesh has six axes. The port runs three, one process per
device: the two that carry the batch, ``data`` (replicated data
parallelism and ZeRO-1/2) and ``fsdp`` (ZeRO-3's parameter sharding), and
``expert`` (a mixture of experts' stacked expert weights split over it;
not a batch axis: the ranks of one expert group see the same rows). Their
product is the world of the ``torch.distributed`` process group, which
``launcher.maybe_initialize_from_env`` joins. Ranks are laid out as the
reference's axis order puts devices, ``expert`` last: rank ``r`` is batch
rank ``r // expert`` and expert rank ``r % expert``. With ``expert`` above 1,
:func:`build_mesh` forms a process subgroup per batch rank (its expert
group) and per expert rank (its batch group) with
``torch.distributed.new_group``; the whole world stays the group of
everything else. :func:`build_mesh` checks the strategy against the world
with the reference trainer's legality rules
(``dlti_tpu/training/trainer.py:104-117``) and raises for what the port
cannot run: ``tensor``, ``sequence`` or ``pipe`` above 1, ``data`` and
``fsdp`` both above 1, and ``fsdp`` with ``expert`` above 1.

The entry points own the process group: the launcher's env, or
``launcher.init_group_of_one`` for a ZeRO strategy run without it.
:func:`build_mesh` only reads the group, and a ZeRO strategy in a process
without one raises. The baseline without a group is
:func:`single_device_mesh`: one device and no collectives.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from dlti_tpu_torch.config import ParallelConfig, ZeROStage

MESH_AXES = ("data", "fsdp", "tensor", "sequence", "pipe", "expert")


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the world: the strategy (with its extents), the
    world size, this process's rank and device, and the process group
    (None: one process and no collectives, the baseline's single-device
    path). With ``expert`` above 1, ``batch_group`` and ``expert_group`` are
    this rank's subgroups of the two axes (:attr:`batch`, :attr:`experts`)."""

    parallel: ParallelConfig
    world: int
    rank: int
    device: torch.device
    group: Optional["dist.ProcessGroup"] = None
    batch_group: Optional["dist.ProcessGroup"] = None
    expert_group: Optional["dist.ProcessGroup"] = None

    @property
    def ep(self) -> int:
        """The expert axis's extent."""
        return self.parallel.expert

    @property
    def batch(self) -> "Mesh":
        """This rank's view of the batch axes alone: the ranks that hold its
        expert rank, which split the batch rows, reduce gradients and shard
        ZeRO-1/2 moments (the whole mesh when ``expert`` is 1). For
        collectives only: its rank 0 is not the writer."""
        if self.ep == 1:
            return self
        return dataclasses.replace(
            self, parallel=dataclasses.replace(self.parallel, expert=1),
            world=self.world // self.ep, rank=self.rank // self.ep,
            group=self.batch_group, batch_group=None, expert_group=None)

    @property
    def experts(self) -> "Mesh":
        """This rank's view of the expert axis: the ranks of its batch rank,
        over which the experts are split (a world of 1 when ``expert`` is
        1). For collectives only."""
        return dataclasses.replace(
            self, parallel=ParallelConfig(), world=self.ep, rank=self.rank % self.ep,
            group=self.expert_group if self.ep > 1 else None,
            batch_group=None, expert_group=None)

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
    unported = [f"{axis}={getattr(par, axis)}" for axis in ("tensor", "sequence", "pipe")
                if getattr(par, axis) > 1]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: tensor, sequence and pipeline parallelism "
            "are not ported yet (see ROADMAP.md)")
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
               lora_enabled: bool = True) -> Mesh:
    """This rank's :class:`Mesh` for ``par`` on ``device``, in the process
    group the entry point formed (every rank must call it together when
    ``expert`` is above 1: it forms the subgroups). Raises when the
    strategy is illegal or unported (:func:`check_strategy`), when a ZeRO
    strategy or the expert axis finds no group, or when ``data * fsdp *
    expert`` differs from the group's world (1 without a group)."""
    check_strategy(par, lora_enabled)
    initialized = dist.is_available() and dist.is_initialized()
    stage = ZeROStage(par.zero_stage)
    if not initialized and (stage != ZeROStage.NONE or par.expert > 1):
        what = f"zero{int(stage)}" if stage != ZeROStage.NONE else f"expert={par.expert}"
        raise ValueError(
            f"{what} runs its collectives in a process group and this "
            "process has none: start it with python -m dlti_tpu_torch.launcher, or "
            "form a group of one first (dlti_tpu_torch.launcher.init_group_of_one)")
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    need = par.dp_like_size * par.expert
    if need != world:
        raise ValueError(
            f"data*fsdp*expert = {need} but the process group has {world} "
            f"rank(s); launch {need} processes with python -m "
            "dlti_tpu_torch.launcher --num-processes N, or set the extent to the "
            "world (cli.train --num-devices)")
    if initialized:
        backend = dist.get_backend()
        want = "nccl" if device.type == "cuda" else "gloo"
        if backend != want:
            raise ValueError(f"the process group runs {backend} but the device is "
                             f"{device}; the port runs {want} there")
    batch_group = expert_group = None
    ep = par.expert
    if ep > 1:
        # Every rank forms every subgroup, in one order.
        for d in range(world // ep):
            g = dist.new_group(list(range(d * ep, (d + 1) * ep)))
            if rank // ep == d:
                expert_group = g
        for x in range(ep):
            g = dist.new_group(list(range(x, world, ep)))
            if rank % ep == x:
                batch_group = g
    return Mesh(parallel=par, world=world, rank=rank, device=device,
                group=dist.group.WORLD if initialized else None,
                batch_group=batch_group, expert_group=expert_group)
