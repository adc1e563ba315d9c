"""Multi-process launcher, the torchrun analog: the port of
``dlti_tpu/launcher.py``.

* :func:`launch_local` spawns N local worker processes, each with the
  ``DLTI_*`` rendezvous env (coordinator address, world size, process id);
  on the first failure the rest are terminated and the return code that
  triggered the teardown is returned (torchrun's semantics).
* :func:`slurm_env` derives the same env from ``SLURM_*`` variables, so one
  ``srun`` task per host configures itself.
* :func:`maybe_initialize_from_env` is called by entry points
  (``cli.train``): a no-op without the launcher env; with it,
  ``torch.distributed.init_process_group`` over ``nccl`` on the card (one
  device per process, ``cuda:{local rank}``, selected before anything is
  allocated there) or over ``gloo`` when the entry point runs on the CPU.
* :func:`init_group_of_one` forms a group of one on a free localhost
  port, for an entry point that runs a ZeRO strategy without the launcher:
  its collectives then run at a world of 1 as at any other.
* ``--one-device`` (``DLTI_ONE_DEVICE=1``) puts every rank on ``cuda:0``
  over ``gloo``, which carries CUDA tensors through the host: how a
  tensor-parallel world runs on one card (NCCL refuses two ranks on one
  device). It is never chosen for the caller, ``parallel.mesh.build_mesh``
  admits gloo on the card only under it, and a CUDA graph under it raises
  (the decode and train-step graphs capture NCCL collectives only).

Rendezvous env contract:

==========================  =================================================
``DLTI_COORDINATOR``        ``host:port`` of process 0
``DLTI_NUM_PROCESSES``      world size
``DLTI_PROCESS_ID``         this process's id (0-based)
``DLTI_LOCAL_RANK``         its device index on its host (set by
                            :func:`launch_local`; else the process id)
``DLTI_ONE_DEVICE``         ``1``: every rank on ``cuda:0`` over gloo
==========================  =================================================

Elastic supervision (``--elastic``, ``training/elastic.py``) is not ported
and raises (see ROADMAP.md).

    python -m dlti_tpu_torch.launcher --num-processes 2 -- \\
        python -m dlti_tpu_torch.cli.train --preset zero3 --device cpu ...
"""

from __future__ import annotations

import datetime
import os
import re
import signal
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

ENV_COORDINATOR = "DLTI_COORDINATOR"
ENV_NUM_PROCESSES = "DLTI_NUM_PROCESSES"
ENV_PROCESS_ID = "DLTI_PROCESS_ID"
ENV_LOCAL_RANK = "DLTI_LOCAL_RANK"
ENV_ONE_DEVICE = "DLTI_ONE_DEVICE"

DEFAULT_PORT = 29400
# How long a collective may wait on a peer before the group raises.
DEFAULT_TIMEOUT_S = 600.0


def worker_env(coordinator: str, num_processes: int, process_id: int,
               base: Optional[Dict[str, str]] = None,
               local_rank: Optional[int] = None) -> Dict[str, str]:
    env = dict(os.environ if base is None else base)
    env[ENV_COORDINATOR] = coordinator
    env[ENV_NUM_PROCESSES] = str(num_processes)
    env[ENV_PROCESS_ID] = str(process_id)
    if local_rank is not None:
        env[ENV_LOCAL_RANK] = str(local_rank)
    return env


def launch_local(command: Sequence[str], num_processes: int,
                 port: int = DEFAULT_PORT,
                 log_dir: Optional[str] = None, one_device: bool = False) -> int:
    """Spawn ``num_processes`` copies of ``command`` on this host.

    Process i gets ``DLTI_PROCESS_ID=i`` and ``DLTI_LOCAL_RANK=i``; all share
    a localhost coordinator. Output is interleaved to our stdout/stderr
    unless ``log_dir`` is given (then ``rank{i}.out``/``.err`` per process).
    ``one_device``: every rank on ``cuda:0`` over gloo (``DLTI_ONE_DEVICE``).

    Returns the worst return code: the one of the first worker that failed,
    after terminating the rest, so a crashed rank cannot hang the job.
    """
    coordinator = f"127.0.0.1:{port}"
    procs: List[subprocess.Popen] = []
    files = []
    try:
        for i in range(num_processes):
            env = worker_env(coordinator, num_processes, i, local_rank=i)
            if one_device:
                env[ENV_ONE_DEVICE] = "1"
            stdout = stderr = None
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
                stdout = open(os.path.join(log_dir, f"rank{i}.out"), "wb")
                stderr = open(os.path.join(log_dir, f"rank{i}.err"), "wb")
                files += [stdout, stderr]
            procs.append(subprocess.Popen(list(command), env=env,
                                          stdout=stdout, stderr=stderr))
        rcs: List[Optional[int]] = [None] * num_processes
        first_bad_rc = None
        while any(rc is None for rc in rcs) and first_bad_rc is None:
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    try:
                        rcs[i] = p.wait(timeout=0.25)
                    except subprocess.TimeoutExpired:
                        continue
                    if rcs[i] != 0 and first_bad_rc is None:
                        first_bad_rc = rcs[i]
        if first_bad_rc is not None:
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    p.send_signal(signal.SIGTERM)
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    try:
                        rcs[i] = p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        rcs[i] = p.wait()
            # The rc that triggered the teardown, not the -15s of our own
            # SIGTERMs, and never max(), which would hide a signal code
            # (-11) behind a clean 0 of a rank that had finished.
            return first_bad_rc
        return next((rc for rc in rcs if rc), 0)
    finally:
        for p in procs:
            if p.poll() is None:  # an exception or interrupt: no orphans
                p.kill()
        for f in files:
            f.close()


def first_slurm_node(nodelist: str) -> str:
    """First hostname of a SLURM nodelist, without ``scontrol``: plain
    lists (``a,b``), compressed ranges (``host[003-006,009]`` ->
    ``host003``) and mixes (``alpha,gpu[01-04]`` -> ``alpha``)."""
    depth = 0
    head = nodelist
    for i, ch in enumerate(nodelist):
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            head = nodelist[:i]
            break
    m = re.match(r"^([^\[]+)\[([^\]\-,]+)", head)
    if m:
        return m.group(1) + m.group(2)
    return head


def slurm_env(environ: Optional[Dict[str, str]] = None,
              port: int = DEFAULT_PORT) -> Dict[str, str]:
    """Map ``SLURM_*`` vars to the ``DLTI_*`` rendezvous contract (the
    local rank from ``SLURM_LOCALID`` when set). Raises KeyError outside a
    SLURM allocation."""
    e = os.environ if environ is None else environ
    nodelist = e.get("SLURM_JOB_NODELIST") or e["SLURM_NODELIST"]
    coordinator = f"{first_slurm_node(nodelist)}:{port}"
    num = int(e.get("SLURM_NTASKS") or e["SLURM_NNODES"])
    pid = int(e.get("SLURM_PROCID") or e["SLURM_NODEID"])
    local = e.get("SLURM_LOCALID")
    return worker_env(coordinator, num, pid, base=dict(e),
                      local_rank=int(local) if local is not None else None)


def launched() -> bool:
    """Whether this process was started with the launcher env."""
    return ENV_NUM_PROCESSES in os.environ


def local_rank() -> int:
    """This process's device index on its host (0 outside the launcher)."""
    return int(os.environ.get(ENV_LOCAL_RANK, os.environ.get(ENV_PROCESS_ID, "0")))


def one_device() -> bool:
    """Whether the launcher put every rank on one card over gloo
    (``--one-device``)."""
    return os.environ.get(ENV_ONE_DEVICE) == "1"


def maybe_initialize_from_env(device=None) -> bool:
    """Join the process group the launcher env describes; a no-op (False)
    without it or when the group exists already. ``device``: the entry
    point's device argument; ``"cpu"`` selects ``gloo``, anything else
    ``nccl`` on ``cuda:{local rank}``, which becomes the current device
    first (and raises without a card: no quiet fall back to the CPU);
    under ``--one-device`` every rank ``gloo`` on ``cuda:0``, and the
    group's backend is printed. Entry points call it once, before they
    allocate on a device."""
    import torch
    import torch.distributed as dist

    if not launched() or (dist.is_available() and dist.is_initialized()):
        return False
    world = int(os.environ[ENV_NUM_PROCESSES])
    rank = int(os.environ[ENV_PROCESS_ID])
    init = f"tcp://{os.environ[ENV_COORDINATOR]}"
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank, timeout=timeout)
        return True
    if not torch.cuda.is_available():
        raise RuntimeError("the launcher env asks for a process group on the card "
                           "but no CUDA device is available; pass --device cpu to "
                           "run the group over gloo on the CPU")
    if one_device():
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                                timeout=timeout)
        print(f"rank {rank}/{world}: process group over {dist.get_backend()} on {dev} "
              "(launcher --one-device)", flush=True)
        return True
    dev = torch.device("cuda", local_rank())
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=init, world_size=world, rank=rank,
                            timeout=timeout, device_id=dev)
    return True


def init_group_of_one(device) -> None:
    """Form a process group of one on a free localhost port: ``gloo`` when
    ``device`` is the CPU, else ``nccl`` on that card."""
    import socket

    import torch
    import torch.distributed as dist

    device = torch.device(device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    kw = {"device_id": device} if device.type == "cuda" else {}
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S), **kw)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: ``launcher [--num-processes N | --coordinator-from-slurm] -- cmd...``"""
    import argparse

    p = argparse.ArgumentParser(description="Process launcher (torchrun analog)")
    p.add_argument("--num-processes", type=int, default=0,
                   help="spawn N local worker processes")
    p.add_argument("--coordinator-from-slurm", action="store_true",
                   help="derive rendezvous from SLURM_* env and exec the "
                        "command in-place (one srun task per host)")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--one-device", action="store_true",
                   help="every rank on cuda:0 over gloo (a tensor-parallel world "
                        "on one card; NCCL refuses two ranks on one device)")
    p.add_argument("--elastic", action="store_true",
                   help="elastic supervision (not ported: raises)")
    p.add_argument("command", nargs=argparse.REMAINDER, help="-- command to run")
    args = p.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("no command given (use: launcher ... -- python -m "
                "dlti_tpu_torch.cli.train ...)")
    if args.elastic:
        raise NotImplementedError("--elastic (training/elastic.py) is not ported yet "
                                  "(see ROADMAP.md)")
    if args.coordinator_from_slurm:
        env = slurm_env(port=args.port)
        os.execvpe(cmd[0], list(cmd), env)  # never returns
    if args.num_processes <= 0:
        p.error("--num-processes N or --coordinator-from-slurm required")
    return launch_local(cmd, args.num_processes, port=args.port, log_dir=args.log_dir,
                        one_device=args.one_device)


if __name__ == "__main__":
    sys.exit(main())
