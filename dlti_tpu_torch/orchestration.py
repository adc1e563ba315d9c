"""Experiment-matrix orchestration: the port of
``dlti_tpu/orchestration.py`` (``ExperimentSpec``, ``plan_matrix``,
``build_command``, ``run_matrix``, ``emit_slurm``), the reference's
notebook matrix (baseline + ZeRO-{1,2,3} over device counts) in code.

* :func:`plan_matrix`: strategy x device-count grid -> ordered specs (the
  baseline runs on one device only, as the reference's
  ``train_baseline.py``).
* :func:`build_command`: one spec -> the port's launcher command,
  ``python -m dlti_tpu_torch.launcher --num-processes N -- python -m
  dlti_tpu_torch.cli.train --preset S --num-devices N ...``: one process
  per card over NCCL, or per CPU rank over gloo with ``device="cpu"`` in
  the training arguments.
* :func:`run_matrix`: each cell in a fresh subprocess (a crashed run is
  recorded and the matrix goes on), every run appending its row to one
  metrics CSV, then the comparison (``analysis.compare``) over it.
* :func:`emit_slurm`: one ``sbatch`` script per cell and a
  ``submit_all.sh``, one task per card, each running the launcher with
  ``--coordinator-from-slurm``.

A spec with ``tensor`` above 1 launches ``num_devices * tensor`` ranks and
passes ``--tensor`` on, as the reference's command does. Sequence
parallelism is not ported: a spec with ``sequence`` above 1 raises.
"""

from __future__ import annotations

import dataclasses
import os
import shlex
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from dlti_tpu_torch.utils.experiment import create_experiment_name

STRATEGY_STAGE = {"baseline": 0, "zero1": 1, "zero2": 2, "zero3": 3}


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One cell of the matrix: a strategy at a device count."""

    strategy: str          # baseline | zero1 | zero2 | zero3
    num_devices: int
    tensor: int = 1
    sequence: int = 1

    @property
    def name(self) -> str:
        return create_experiment_name(self.num_devices, STRATEGY_STAGE[self.strategy])


def _refuse_model_parallel(tensor: int, sequence: int) -> None:
    if tensor < 1:
        raise ValueError(f"--tensor {tensor}: the extent must be at least 1")
    if sequence != 1:
        raise NotImplementedError(f"--sequence {sequence}: sequence parallelism is not "
                                  f"ported yet (see ROADMAP.md); only 1 is accepted")


def plan_matrix(strategies: Sequence[str], device_counts: Sequence[int],
                tensor: int = 1, sequence: int = 1) -> List[ExperimentSpec]:
    """The strategy x device grid: ``baseline`` once on one device, each
    ZeRO strategy at every count."""
    _refuse_model_parallel(tensor, sequence)
    specs: List[ExperimentSpec] = []
    for strat in strategies:
        if strat not in STRATEGY_STAGE:
            raise ValueError(f"unknown strategy {strat!r}; choose from "
                             f"{sorted(STRATEGY_STAGE)}")
        if strat == "baseline":
            specs.append(ExperimentSpec("baseline", 1))
            continue
        for n in device_counts:
            specs.append(ExperimentSpec(strat, n, tensor=tensor, sequence=sequence))
    return specs


def build_command(spec: ExperimentSpec, train_args: Dict[str, object],
                  python: str = sys.executable, port: Optional[int] = None) -> List[str]:
    """Spec -> argv of one training run under the launcher.
    ``train_args`` pass through as ``--key value`` (underscores become
    dashes; a true boolean is a bare flag, a false one and None are left
    out); ``port`` is the launcher's rendezvous port (its default
    without)."""
    _refuse_model_parallel(spec.tensor, spec.sequence)
    cmd = [python, "-m", "dlti_tpu_torch.launcher",
           "--num-processes", str(spec.num_devices * spec.tensor)]
    if port is not None:
        cmd += ["--port", str(port)]
    cmd += ["--", python, "-m", "dlti_tpu_torch.cli.train",
            "--preset", spec.strategy, "--num-devices", str(spec.num_devices)]
    if spec.tensor > 1:
        cmd += ["--tensor", str(spec.tensor)]
    for key, val in train_args.items():
        flag = "--" + key.replace("_", "-")
        if isinstance(val, bool):
            if val:
                cmd.append(flag)
        elif val is not None:
            cmd += [flag, str(val)]
    return cmd


def free_port() -> int:
    """A free localhost TCP port (for one run's rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_matrix(specs: Sequence[ExperimentSpec], train_args: Dict[str, object],
               metrics_csv: str = "results/training_metrics.csv",
               output_root: str = "checkpoints", analyze: bool = True,
               plot_path: Optional[str] = "results/plots/training_comparison.png",
               dry_run: bool = False, log_dir: Optional[str] = "logs") -> List[dict]:
    """Run every cell, recording each outcome; one failure never stops the
    matrix. Each run appends to ``metrics_csv`` (unless ``train_args``
    names another) and checkpoints under ``output_root/<name>``; its
    stdout and stderr go to ``log_dir/<name>.out`` / ``.err``. Returns one
    record per spec: ``{name, returncode, seconds, command}``; then, unless
    ``analyze`` is off, compares the CSV (plots only with ``plot_path``)."""
    results: List[dict] = []
    for spec in specs:
        args = dict(train_args)
        args.setdefault("metrics_csv", metrics_csv)
        args["output_dir"] = os.path.join(output_root, spec.name)
        if dry_run:
            cmd = build_command(spec, args)
            print(shlex.join(cmd))
            results.append({"name": spec.name, "returncode": None, "seconds": 0.0,
                            "command": cmd})
            continue
        cmd = build_command(spec, args, port=free_port())
        print(f"=== {spec.name}: {shlex.join(cmd)}", flush=True)
        t0 = time.perf_counter()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, f"{spec.name}.out"), "wb") as out, \
                    open(os.path.join(log_dir, f"{spec.name}.err"), "wb") as err:
                proc = subprocess.run(cmd, stdout=out, stderr=err)
        else:
            proc = subprocess.run(cmd)
        dt = time.perf_counter() - t0
        status = "ok" if proc.returncode == 0 else f"FAILED rc={proc.returncode}"
        print(f"=== {spec.name}: {status} in {dt:.1f}s", flush=True)
        results.append({"name": spec.name, "returncode": proc.returncode,
                        "seconds": dt, "command": cmd})
    csv_path = str(train_args.get("metrics_csv", metrics_csv))
    if analyze and not dry_run and os.path.isfile(csv_path):
        from dlti_tpu_torch.analysis import compare

        compare(csv_path, plot_path)
    return results


SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node={tasks}
#SBATCH --gpus-per-node={tasks}
#SBATCH --output=logs/{name}.out
#SBATCH --error=logs/{name}.err
{extra_directives}
# One task per card; the launcher derives the rendezvous (coordinator,
# world size, rank, local card) from the SLURM_* env and execs the
# training command.
srun {python} -m dlti_tpu_torch.launcher --coordinator-from-slurm -- {train_cmd}
"""


def emit_slurm(specs: Sequence[ExperimentSpec], train_args: Dict[str, object],
               out_dir: str = "slurm", hosts_per_pod: int = 1,
               partition: Optional[str] = None,
               time_limit: Optional[str] = None) -> List[str]:
    """Write one sbatch script per spec and ``submit_all.sh``; returns the
    scripts' paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    extra = ""
    if partition:
        extra += f"#SBATCH --partition={partition}\n"
    if time_limit:
        extra += f"#SBATCH --time={time_limit}\n"
    for spec in specs:
        args = dict(train_args)
        args["output_dir"] = os.path.join("checkpoints", spec.name)
        train_cmd = build_command(spec, args, python="python")
        train_cmd = train_cmd[train_cmd.index("--") + 1:]  # the launcher is srun's
        body = SBATCH_TEMPLATE.format(
            name=spec.name, nodes=hosts_per_pod,
            tasks=max(1, spec.num_devices * spec.tensor // max(hosts_per_pod, 1)),
            extra_directives=extra, python="python", train_cmd=shlex.join(train_cmd))
        path = os.path.join(out_dir, f"{spec.name}.sbatch")
        with open(path, "w") as f:
            f.write(body)
        paths.append(path)
    submit = os.path.join(out_dir, "submit_all.sh")
    with open(submit, "w") as f:
        f.write("#!/bin/bash\nset -e\n")
        for p in paths:
            f.write(f"sbatch {os.path.basename(p)}\n")
    os.chmod(submit, 0o755)
    return paths
