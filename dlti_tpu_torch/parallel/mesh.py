"""The data-parallel mesh: the port of ``dlti_tpu/parallel/mesh.py`` for the
batch axes.

The reference's mesh has six axes. The port runs the two that carry the
batch, one process per device: ``data`` (replicated data parallelism and
ZeRO-1/2) and ``fsdp`` (ZeRO-3's parameter sharding). Their product is the
world of the ``torch.distributed`` process group, which
``launcher.maybe_initialize_from_env`` joins. :func:`build_mesh` checks the
strategy against that world with the reference trainer's legality rules
(``dlti_tpu/training/trainer.py:104-117``) and raises for what the port
cannot run: ``tensor``, ``sequence``, ``pipe`` or ``expert`` above 1, and
``data`` and ``fsdp`` both above 1.

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
    """One rank's view of the data-parallel world: the strategy (with its
    ``data``/``fsdp`` extents), the world size, this process's rank and
    device, and the process group (None: one process and no collectives,
    the baseline's single-device path)."""

    parallel: ParallelConfig
    world: int
    rank: int
    device: torch.device
    group: Optional["dist.ProcessGroup"] = None

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
    ``n_devices``: the model-parallel axes keep their extent while the batch
    extent absorbs the loss. A no-op when the config already fits."""
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
    unported = [f"{axis}={getattr(par, axis)}" for axis in MESH_AXES[2:]
                if getattr(par, axis) > 1]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: tensor, sequence, pipeline and expert "
            "parallelism are not ported yet (see ROADMAP.md)")
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
    group the entry point formed. Raises when the strategy is illegal or
    unported (:func:`check_strategy`), when a ZeRO strategy finds no group,
    or when ``data * fsdp`` differs from the group's world (1 without a
    group)."""
    check_strategy(par, lora_enabled)
    initialized = dist.is_available() and dist.is_initialized()
    stage = ZeROStage(par.zero_stage)
    if not initialized and stage != ZeROStage.NONE:
        raise ValueError(
            f"zero{int(stage)} runs its collectives in a process group and this "
            "process has none: start it with python -m dlti_tpu_torch.launcher, or "
            "form a group of one first (dlti_tpu_torch.launcher.init_group_of_one)")
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if par.dp_like_size != world:
        raise ValueError(
            f"data*fsdp = {par.dp_like_size} but the process group has {world} "
            f"rank(s); launch {par.dp_like_size} processes with python -m "
            "dlti_tpu_torch.launcher --num-processes N, or set the extent to the "
            "world (cli.train --num-devices)")
    if initialized:
        backend = dist.get_backend()
        want = "nccl" if device.type == "cuda" else "gloo"
        if backend != want:
            raise ValueError(f"the process group runs {backend} but the device is "
                             f"{device}; the port runs {want} there")
    return Mesh(parallel=par, world=world, rank=rank, device=device,
                group=dist.group.WORLD if initialized else None)
