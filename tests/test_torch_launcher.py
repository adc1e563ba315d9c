"""The port's launcher (``dlti_tpu_torch.launcher``, the torchrun analog)
against the JAX package's, and ``cli.train`` under it on the CPU.

* ``launch_local`` gives each worker the ``DLTI_*`` rendezvous env, and on
  the first failure terminates the rest and returns that worker's code.
* The SLURM helpers agree with the JAX package's.
* ``--elastic`` and a missing command are refused.
* ``python -m dlti_tpu_torch.launcher --num-processes 2 -- python -m
  dlti_tpu_torch.cli.train --preset zero3 --device cpu ...`` trains, saves
  consolidated checkpoints (verified by the JAX store) and exports; the
  export is an ordinary merged export: ``cli.export`` of the ZeRO run's
  checkpoint gives the same manifest digest, its weights equal a
  single-process baseline run's (within the tolerance of two summation
  orders), and ``cli.serve`` loads it.
"""

import json
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

from dlti_tpu import launcher as jax_launcher
from dlti_tpu.checkpoint import store as jstore
from dlti_tpu_torch import launcher

ROOT = Path(__file__).resolve().parents[1]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launch_local_gives_each_worker_the_rendezvous_env(tmp_path):
    code = textwrap.dedent("""
        import json, os
        print(json.dumps({k: os.environ.get(k) for k in (
            "DLTI_COORDINATOR", "DLTI_NUM_PROCESSES", "DLTI_PROCESS_ID", "DLTI_LOCAL_RANK")}))
    """)
    port = _free_port()
    rc = launcher.launch_local([sys.executable, "-c", code], 3, port=port,
                               log_dir=str(tmp_path))
    assert rc == 0
    for i in range(3):
        env = json.loads((tmp_path / f"rank{i}.out").read_text())
        assert env == {"DLTI_COORDINATOR": f"127.0.0.1:{port}", "DLTI_NUM_PROCESSES": "3",
                       "DLTI_PROCESS_ID": str(i), "DLTI_LOCAL_RANK": str(i)}


def test_first_failure_terminates_the_rest_and_returns_its_code(tmp_path):
    code = ("import os, sys, time\n"
            "if os.environ['DLTI_PROCESS_ID'] == '1': sys.exit(3)\n"
            "time.sleep(120)\n")
    t0 = time.monotonic()
    rc = launcher.launch_local([sys.executable, "-c", code], 3, port=_free_port(),
                               log_dir=str(tmp_path))
    assert rc == 3
    assert time.monotonic() - t0 < 60  # the sleepers were terminated


def test_worker_env_and_slurm_helpers_match_jax():
    for nodelist in ("a,b", "gpu[003-006,009]", "alpha,gpu[01-04]", "node7"):
        assert launcher.first_slurm_node(nodelist) == jax_launcher.first_slurm_node(nodelist)
    env = {"SLURM_JOB_NODELIST": "gpu[12-13]", "SLURM_NTASKS": "8", "SLURM_PROCID": "5"}
    ours, theirs = launcher.slurm_env(env, port=1234), jax_launcher.slurm_env(env, port=1234)
    for k in (launcher.ENV_COORDINATOR, launcher.ENV_NUM_PROCESSES, launcher.ENV_PROCESS_ID):
        assert ours[k] == theirs[k]
    assert ours[launcher.ENV_COORDINATOR] == "gpu12:1234"
    assert launcher.ENV_LOCAL_RANK not in ours  # no SLURM_LOCALID: the process id
    assert launcher.slurm_env(dict(env, SLURM_LOCALID="1"))[launcher.ENV_LOCAL_RANK] == "1"
    assert launcher.worker_env("h:1", 2, 1, base={}) == jax_launcher.worker_env("h:1", 2, 1, base={})
    with pytest.raises(KeyError):
        launcher.slurm_env({})


def test_launcher_refuses_elastic_and_a_missing_command(monkeypatch):
    with pytest.raises(NotImplementedError, match="elastic"):
        launcher.main(["--num-processes", "2", "--elastic", "--", "true"])
    with pytest.raises(SystemExit):
        launcher.main(["--num-processes", "2"])
    for k in (launcher.ENV_NUM_PROCESSES, launcher.ENV_PROCESS_ID, launcher.ENV_COORDINATOR):
        monkeypatch.delenv(k, raising=False)
    assert launcher.maybe_initialize_from_env("cpu") is False  # no env: a no-op


def _write_data(d: Path) -> Path:
    d.mkdir()
    with open(d / "data.jsonl", "w") as f:
        for i in range(96):
            f.write(json.dumps({"text": " ".join(f"tok{(i * 5 + j) % 31}"
                                                 for j in range(4 + i % 13))}) + "\n")
    return d


def _cli(*args, timeout=300):
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-4000:]
    return proc.stdout


def _digest(out: str) -> str:
    return [ln.split(": ", 1)[1] for ln in out.splitlines()
            if ln.startswith("manifest sha256: ")][-1]


TRAIN = ["--device", "cpu", "--model", "llama_tiny", "--tokenizer", "byte",
         "--max-seq-len", "32", "--per-device-batch-size", "2",
         "--gradient-accumulation-steps", "2", "--max-steps", "4", "--save-steps", "2",
         "--learning-rate", "1e-2", "--warmup-steps", "1", "--logging-steps", "1"]


def test_cli_train_zero3_under_the_launcher_trains_saves_and_exports(tmp_path):
    from dlti_tpu_torch.checkpoint import load_exported_model, store

    data = _write_data(tmp_path / "data")
    ck, ex = tmp_path / "ck", tmp_path / "ex"
    out = _cli("-m", "dlti_tpu_torch.launcher", "--num-processes", "2",
               "--port", str(_free_port()), "--",
               sys.executable, "-m", "dlti_tpu_torch.cli.train", "--preset", "zero3",
               *TRAIN, "--per-device-batch-size", "1", "--dataset-path", str(data),
               "--output-dir", str(ck), "--export-dir", str(ex))
    summary = json.loads(out.strip().splitlines()[-1])
    assert (summary["strategy"], summary["world"]) == ("zero3", 2)
    assert summary["save_steps"] == [2, 4]
    assert out.count("manifest sha256: ") == 1  # rank 0 alone prints
    assert store.list_checkpoint_steps(str(ck)) == [2, 4]
    assert jstore.latest_verified_step(str(ck)) == 4
    meta = store.load_train_meta(str(ck), 4)
    assert meta["parallel"]["fsdp"] == 2 and meta["parallel"]["zero_stage"] == 3

    # cli.export of the consolidated checkpoint: the trainer's own export.
    export_out = _cli("-m", "dlti_tpu_torch.cli.export", "--device", "cpu",
                      "--checkpoint-dir", str(ck), "--model", "llama_tiny",
                      "--lora-r", "16", "--out", str(tmp_path / "ex2"))
    assert _digest(export_out) == _digest(out)

    # One process, the baseline, the same global batch: the same weights.
    base_out = _cli("-m", "dlti_tpu_torch.cli.train", *TRAIN, "--dataset-path", str(data),
                    "--output-dir", str(tmp_path / "ck1"), "--export-dir",
                    str(tmp_path / "ex1"))
    base = json.loads(base_out.strip().splitlines()[-1])
    assert (base["strategy"], base["world"]) == ("baseline", 1)
    np.testing.assert_allclose(summary["final_loss"], base["final_loss"], rtol=2e-4)
    zero_tree, cfg = load_exported_model(str(ex))
    base_tree, _ = load_exported_model(str(tmp_path / "ex1"))
    assert cfg.parallel.fsdp == 2 and not cfg.lora.enabled

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + "/")
            else:
                yield prefix + k, v.float().numpy()

    base_flat = dict(flat(base_tree))
    for k, v in flat(zero_tree):
        np.testing.assert_allclose(v, base_flat[k], rtol=2e-4, atol=2e-4, err_msg=k)

    # cli.serve loads it as any merged export.
    from dlti_tpu_torch.cli.serve import build, parse_args

    engine = build(parse_args(["--device", "cpu", "--model-dir", str(ex),
                               "--tokenizer", "byte", "--max-model-len", "64"]))[0]
    assert engine.cfg.max_model_len == 64


def test_cli_train_zero_without_the_launcher_forms_a_group_of_one(tmp_path):
    """``cli.train --preset zero2`` in one process without the launcher env
    forms its group of one itself (the library's ``build_mesh`` only reads
    a group), so its collectives run; the losses are the baseline's."""
    data = _write_data(tmp_path / "data")
    runs = {}
    for name in ("zero2", "baseline"):
        out = _cli("-m", "dlti_tpu_torch.cli.train", "--preset", name, *TRAIN,
                   "--dataset-path", str(data), "--save-strategy", "no")
        runs[name] = json.loads(out.strip().splitlines()[-1])
    assert (runs["zero2"]["strategy"], runs["zero2"]["world"]) == ("zero2", 1)
    assert runs["zero2"]["final_loss"] == runs["baseline"]["final_loss"]
