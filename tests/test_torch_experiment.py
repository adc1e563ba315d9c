"""The experiment layer in the port against the JAX package: the metrics
CSV (``utils.metrics``), the step log (``telemetry.steplog``), experiment
names (``utils.experiment``), the comparison (``analysis``, without pandas)
and the matrix (``orchestration``, on the port's launcher).

* ``save_training_metrics`` writes the JAX package's bytes for the same
  records: a first row, an appended row, a row of a dict with the columns
  reordered, and a row with a new column (the union-of-columns rewrite); a
  file either package started is appended to by the other to the same bytes.
* ``load_and_calculate`` agrees with the JAX DataFrame column by column
  (values, ints where pandas reads ints, nan where it reads nan; floats
  within 1e-12 relative, the same arithmetic).
* ``plan_matrix`` gives the JAX specs and names, ``build_command`` the JAX
  training flags behind the port's launcher, ``emit_slurm`` one script per
  JAX script name with the same flags.
* ``run_matrix`` over baseline / zero1 / zero3 at worlds 1 and 2 (gloo,
  ``device="cpu"``, ``llama_tiny``, 2 steps) writes five rows that both
  packages' ``compare`` read the same way.
* The Trainer's CSV row and step log against the JAX Trainer's for the same
  run: the same columns in the same order, the same identifying values and
  final loss (rtol 1e-5), one step record per step with the JAX record's
  keys; ``schedule_lr`` equals the JAX mirror.
"""

import csv
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlti_tpu import analysis as janalysis
from dlti_tpu import config as jc
from dlti_tpu import orchestration as jorch
from dlti_tpu.data import make_batches as jax_make_batches
from dlti_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.telemetry import steplog as jsteplog
from dlti_tpu.training.state import create_train_state as jax_create_state
from dlti_tpu.training.trainer import Trainer as JaxTrainer
from dlti_tpu.utils import experiment as jexp
from dlti_tpu.utils import metrics as jmetrics
from dlti_tpu_torch import analysis, orchestration
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.data import ByteTokenizer, make_batches
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.telemetry import steplog
from dlti_tpu_torch.training import Trainer
from dlti_tpu_torch.utils import experiment, metrics

ROOT = Path(__file__).resolve().parents[1]


def _record(mod, **kw):
    base = dict(experiment="zero3_2dev", num_gpus=2, zero_stage=3, strategy="zero3",
                training_time_hours=0.123456789, samples_per_second=12.5,
                peak_memory_gb=15.9375, final_loss=1.0 / 3.0,
                tokens_per_second_per_chip=7561.25, mfu_percent=20.5,
                peak_memory_source="device", eval_loss=float("nan"))
    base.update(kw)
    return mod.MetricsRecord(**base)


def test_metrics_record_schema_is_the_jax_schema():
    assert [f.name for f in dataclasses.fields(metrics.MetricsRecord)] == \
        [f.name for f in dataclasses.fields(jmetrics.MetricsRecord)]
    assert metrics.REFERENCE_CSV_COLUMNS == jmetrics.REFERENCE_CSV_COLUMNS
    assert steplog.metrics_csv_columns() == jsteplog.metrics_csv_columns()
    assert steplog.STEP_RECORD_FIELDS == jsteplog.STEP_RECORD_FIELDS
    assert steplog.RUN_RECORD_FIELDS == jsteplog.RUN_RECORD_FIELDS
    assert steplog.jsonl_stream_columns() == jsteplog.jsonl_stream_columns()
    assert set(metrics.REFERENCE_CSV_COLUMNS) <= steplog.jsonl_stream_columns()


def _write_sequence(mod, path):
    mod.save_training_metrics(_record(mod), str(path))
    mod.save_training_metrics(_record(mod, experiment="baseline", num_gpus=1, zero_stage=0,
                                      strategy="baseline", final_loss=2.5), str(path))
    row = _record(mod, experiment="zero1_2dev", zero_stage=1).to_dict()
    mod.save_training_metrics(dict(reversed(list(row.items()))), str(path))
    mod.save_training_metrics(dict(_record(mod).to_dict(), new_column=7), str(path))
    mod.save_training_metrics(_record(mod, final_loss=0.25), str(path))


def test_metrics_csv_is_byte_equal_to_the_jax_package(tmp_path):
    ours, theirs = tmp_path / "ours" / "m.csv", tmp_path / "theirs" / "m.csv"
    metrics.save_training_metrics(_record(metrics), str(ours))
    jmetrics.save_training_metrics(_record(jmetrics), str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()  # one record
    _write_sequence(metrics, tmp_path / "seq_ours.csv")
    _write_sequence(jmetrics, tmp_path / "seq_theirs.csv")
    got = (tmp_path / "seq_ours.csv").read_bytes()
    assert got == (tmp_path / "seq_theirs.csv").read_bytes()
    header = got.decode().splitlines()[0].split(",")
    assert header[-1] == "new_column" and header[:8] == list(metrics.REFERENCE_CSV_COLUMNS)
    assert not (tmp_path / "seq_ours.csv.tmp").exists()
    # A file one package started, the other appends to: the same bytes.
    for first, second, name in ((jmetrics, metrics, "j_then_t"), (metrics, jmetrics, "t_then_j")):
        first.save_training_metrics(_record(first), str(tmp_path / name))
        second.save_training_metrics(_record(second, final_loss=9.0), str(tmp_path / name))
    assert (tmp_path / "j_then_t").read_bytes() == (tmp_path / "t_then_j").read_bytes()


def test_experiment_names_match_jax(tmp_path):
    for n, z in ((1, None), (1, 0), (2, 1), (4, 3), (2, tc.ZeROStage.ZERO2)):
        assert experiment.create_experiment_name(n, z) == jexp.create_experiment_name(
            n, None if z is None else int(z))
    ds = tmp_path / "ds.json"
    ds.write_text(json.dumps({"zero_optimization": {"stage": 2}}))
    own = tmp_path / "own.json"
    own.write_text(tc.preset("zero3_4dev", model="llama_tiny").to_json())
    none = tmp_path / "none.json"
    none.write_text("{}")
    for p in (ds, own, none):
        assert experiment.get_zero_stage_from_config(str(p)) == \
            jexp.get_zero_stage_from_config(str(p))
    for name in ("baseline", "zero1_2dev", "zero3_4dev"):
        t = tc.preset(name, model="llama_tiny").replace(experiment_name="")
        j = jc.preset(name, model="llama_tiny").replace(experiment_name="")
        assert experiment.experiment_name_from_config(t) == \
            jexp.experiment_name_from_config(j)
    assert experiment.experiment_name_from_config(tc.preset("zero2")) == "zero2"


def _matrix_csv(path):
    fields = ["experiment", "num_gpus", "zero_stage", "strategy", "training_time_hours",
              "samples_per_second", "peak_memory_gb", "final_loss",
              "tokens_per_second_per_chip", "mfu_percent", "peak_memory_source", "eval_loss"]
    rows = [["zero1_2dev", 2, 1, "zero1", 0.05, 40.0, 7.5, 1.25, 5000.5, 18.0, "device", ""],
            ["baseline", 1, 0, "baseline", 0.1, 20.0, 15.9, 1.5, 5000.0, "nan", "device",
             "1.75"],
            ["zero3_4dev", 4, 3, "zero3", 0.0, 80.0, 4.1, 1.0, 4900.0, 17.5, "host_rss", ""],
            ["zero3_2dev", 2, 3, "zero3", 0.06, 35.0, 8.25, 1.3, 4700.0, 16.0, "device", "1.5"]]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(fields)
        w.writerows(rows)


def _same(a, b):
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    if isinstance(b, (float, np.floating)):
        return a == pytest.approx(float(b), rel=1e-12)
    return a == b and type(a) is type(b.item() if hasattr(b, "item") else b)


@pytest.mark.parametrize("anchor", ["baseline", "first"])
def test_load_and_calculate_agrees_with_the_jax_dataframe(tmp_path, anchor):
    path = tmp_path / "m.csv"
    _matrix_csv(path)
    if anchor == "first":  # no baseline row: the first row anchors
        text = path.read_text().replace("baseline,1,0", "solo,1,0")
        path.write_text(text)
    df = janalysis.load_and_calculate(str(path))
    rows = analysis.load_and_calculate(str(path))
    assert list(rows[0]) == list(df.columns)
    for col in df.columns:
        want = df[col].tolist()
        got = [r[col] for r in rows]
        assert all(_same(g, w) for g, w in zip(got, want)), (col, got, want)
    assert math.isnan(rows[2]["speedup"])  # a zero training time has no speedup


def test_compare_prints_the_table_and_findings(tmp_path, capsys):
    path = tmp_path / "m.csv"
    _matrix_csv(path)
    rows = analysis.compare(str(path))
    out = capsys.readouterr().out
    assert "TRAINING COMPARISON" in out and "KEY FINDINGS (vs baseline)" in out
    assert "zero1_2dev: 2.00x speedup, 100.0% scaling efficiency" in out
    assert len(rows) == 4


def test_create_plots_needs_matplotlib_and_draws_with_it(tmp_path, monkeypatch):
    path = tmp_path / "m.csv"
    _matrix_csv(path)
    rows = analysis.load_and_calculate(str(path))
    out = analysis.create_plots(rows, str(tmp_path / "plots" / "c.png"))
    assert os.path.getsize(out) > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        analysis.create_plots(rows, str(tmp_path / "plots" / "d.png"))


def test_plan_matrix_and_build_command_match_jax():
    strategies, counts = ["baseline", "zero1", "zero2", "zero3"], [1, 2, 4]
    ours = orchestration.plan_matrix(strategies, counts)
    theirs = jorch.plan_matrix(strategies, counts)
    assert [(s.strategy, s.num_devices, s.name) for s in ours] == \
        [(s.strategy, s.num_devices, s.name) for s in theirs]
    args = {"model": "llama_tiny", "max_steps": 3, "lora_r": 8, "pack": True,
            "no_resume": False, "dataset_path": None, "metrics_csv": "m.csv"}
    for spec, jspec in zip(ours, theirs):
        cmd = orchestration.build_command(spec, args, python="py", port=1234)
        jcmd = jorch.build_command(jspec, args, python="py", train_script="train.py")
        assert cmd[:8] == ["py", "-m", "dlti_tpu_torch.launcher", "--num-processes",
                           str(spec.num_devices), "--port", "1234", "--"]
        assert cmd[8:11] == ["py", "-m", "dlti_tpu_torch.cli.train"]
        assert cmd[11:] == jcmd[2:]  # the JAX script's flags, in its order
    with pytest.raises(ValueError, match="unknown strategy"):
        orchestration.plan_matrix(["zero4"], [1])
    # --tensor runs (the launcher's world is num_devices x tensor) and passes
    # on as the JAX command passes it.
    spec, = orchestration.plan_matrix(["zero1"], [2], tensor=2)
    jspec, = jorch.plan_matrix(["zero1"], [2], tensor=2)
    cmd = orchestration.build_command(spec, args, python="py", port=1234)
    jcmd = jorch.build_command(jspec, args, python="py", train_script="train.py")
    assert cmd[:5] == ["py", "-m", "dlti_tpu_torch.launcher", "--num-processes", "4"]
    assert cmd[11:] == jcmd[2:] and "--tensor" in cmd
    # --sequence too (a world of num_devices x sequence).
    spec, = orchestration.plan_matrix(["zero1"], [2], sequence=2)
    jspec, = jorch.plan_matrix(["zero1"], [2], sequence=2)
    cmd = orchestration.build_command(spec, args, python="py", port=1234)
    jcmd = jorch.build_command(jspec, args, python="py", train_script="train.py")
    assert cmd[:5] == ["py", "-m", "dlti_tpu_torch.launcher", "--num-processes", "4"]
    assert cmd[11:] == jcmd[2:] and "--sequence" in cmd


def test_emit_slurm_matches_the_jax_scripts(tmp_path):
    specs = orchestration.plan_matrix(["baseline", "zero3"], [2, 4])
    args = {"model": "llama2_7b", "max_steps": 10}
    ours = orchestration.emit_slurm(specs, args, out_dir=str(tmp_path / "t"),
                                    hosts_per_pod=2, partition="gpu", time_limit="01:00:00")
    theirs = jorch.emit_slurm(jorch.plan_matrix(["baseline", "zero3"], [2, 4]), args,
                              out_dir=str(tmp_path / "j"), hosts_per_pod=2,
                              partition="gpu", time_limit="01:00:00")
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    assert (tmp_path / "t" / "submit_all.sh").read_text() == \
        (tmp_path / "j" / "submit_all.sh").read_text()
    for p, q in zip(ours, theirs):
        body, jbody = Path(p).read_text(), Path(q).read_text()
        for line in ("#SBATCH --nodes=2", "#SBATCH --partition=gpu", "#SBATCH --time=01:00:00"):
            assert line in body and line in jbody
        flags = body.split("dlti_tpu_torch.cli.train ")[1].strip()
        assert jbody.strip().endswith(flags)  # the same training flags
        assert "dlti_tpu_torch.launcher --coordinator-from-slurm" in body


def test_run_matrix_on_gloo_writes_a_csv_both_compares_read_the_same(tmp_path):
    data = tmp_path / "data.jsonl"
    data.write_text("".join(json.dumps({"text": f"row {i} " + "ab" * (i % 13)}) + "\n"
                            for i in range(48)))
    specs = orchestration.plan_matrix(["baseline", "zero1", "zero3"], [1, 2])
    csv_path = tmp_path / "m.csv"
    results = orchestration.run_matrix(
        specs, {"model": "llama_tiny", "tokenizer": "byte", "dataset_path": str(data),
                "max_seq_len": 32, "per_device_batch_size": 1,
                "gradient_accumulation_steps": 2, "max_steps": 2, "lora_r": 4,
                "save_strategy": "no", "device": "cpu"},
        metrics_csv=str(csv_path), output_root=str(tmp_path / "ck"), plot_path=None,
        log_dir=str(tmp_path / "logs"))
    assert [r["returncode"] for r in results] == [0] * 5, \
        [(tmp_path / "logs" / f"{r['name']}.err").read_text()[-2000:] for r in results]
    # Each run checkpoints under output_root/<name>, never ./checkpoints.
    assert [r["command"][r["command"].index("--output-dir") + 1] for r in results] == \
        [str(tmp_path / "ck" / s.name) for s in specs]
    rows = analysis.compare(str(csv_path))
    df = janalysis.compare(str(csv_path))
    assert [r["experiment"] for r in rows] == df["experiment"].tolist() == \
        ["baseline", "zero1_1dev", "zero1_2dev", "zero3_1dev", "zero3_2dev"]
    assert [r["num_gpus"] for r in rows] == [1, 1, 2, 1, 2]
    assert [r["strategy"] for r in rows] == ["baseline", "zero1", "zero1", "zero3", "zero3"]
    for col in df.columns:
        assert all(_same(r[col], w) for r, w in zip(rows, df[col].tolist())), col
    assert all(r["peak_memory_source"] == "host_rss" and np.isfinite(r["final_loss"])
               for r in rows)
    # --per-device-batch-size is per rank, as in the reference: the runs of
    # one world size took the same batches and agree (2e-4, worlds that sum
    # in other orders); the two sizes took different ones.
    losses = {r["experiment"]: r["final_loss"] for r in rows}
    np.testing.assert_allclose([losses["zero1_1dev"], losses["zero3_1dev"]],
                               losses["baseline"], rtol=2e-4)
    np.testing.assert_allclose(losses["zero3_2dev"], losses["zero1_2dev"], rtol=2e-4)


def test_run_experiments_cli_refuses_what_is_not_ported(tmp_path):
    from dlti_tpu_torch.cli import run_experiments

    with pytest.raises(ValueError, match="--sequence 0"):
        run_experiments.main(["--sequence", "0", "--dry-run"])
    with pytest.raises(NotImplementedError, match="simulate-devices"):
        run_experiments.main(["--simulate-devices", "8", "--dry-run"])
    assert run_experiments.main(["--strategies", "baseline,zero3", "--device-counts", "2",
                                 "--emit-slurm", str(tmp_path / "s")]) == 0
    assert sorted(os.listdir(tmp_path / "s")) == ["baseline.sbatch", "submit_all.sh",
                                                  "zero3_2dev.sbatch"]


def test_schedule_lr_mirrors_jax():
    for sched in ("warmup_constant", "warmup_cosine"):
        for warm in (0, 3):
            t = tc.OptimizerConfig(schedule=sched, warmup_steps=warm, total_steps=20)
            j = jc.OptimizerConfig(schedule=sched, warmup_steps=warm, total_steps=20)
            assert [steplog.schedule_lr(t, s) for s in range(25)] == \
                [jsteplog.schedule_lr(j, s) for s in range(25)]


LORA = dict(r=4, alpha=8, dropout=0.0)


def test_trainer_csv_row_and_step_log_match_the_jax_trainer(tmp_path):
    texts = ["".join(chr(97 + (i * j) % 26) for j in range(5 + i % 40)) for i in range(24)]
    common = dict(micro_batch_size=2, grad_accum_steps=2, max_steps=5, logging_steps=100,
                  steps_per_sync=2)
    tree = jax.device_get(JaxLlama(jc.MODEL_PRESETS["llama_tiny"], jc.LoRAConfig(**LORA)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    jcfg = jc.Config(
        model=jc.MODEL_PRESETS["llama_tiny"], lora=jc.LoRAConfig(**LORA),
        data=jc.DataConfig(max_seq_len=32, tokenizer="byte"),
        checkpoint=jc.CheckpointConfig(save_strategy="no"),
        telemetry=jc.TelemetryConfig(step_log_path=str(tmp_path / "j.jsonl")),
        train=jc.TrainConfig(metrics_csv=str(tmp_path / "j.csv"), **common))
    jt = JaxTrainer(jcfg)
    jstate = jax_create_state(jax.random.PRNGKey(0), jt.model, jt.tx, (2, 32),
                              init_fn=lambda rng, x: jax.tree_util.tree_map(jnp.asarray, tree))
    jt.train(dataset=jax_make_batches(texts, JaxByteTokenizer(), seq_len=32,
                                      micro_batch_size=2, grad_accum_steps=2,
                                      shard_by_host=False), state=jstate)
    tcfg = tc.Config(
        model=tc.MODEL_PRESETS["llama_tiny"], lora=tc.LoRAConfig(**LORA),
        data=tc.DataConfig(max_seq_len=32, tokenizer="byte"),
        checkpoint=tc.CheckpointConfig(save_strategy="no"),
        train=tc.TrainConfig(metrics_csv=str(tmp_path / "t.csv"),
                             step_log_path=str(tmp_path / "t.jsonl"), **common))
    _, rec = Trainer(tcfg, params=params_from_jax(tree), device="cpu").train(
        dataset=make_batches(texts, ByteTokenizer(), seq_len=32, micro_batch_size=2,
                             grad_accum_steps=2))
    with open(tmp_path / "t.csv") as f, open(tmp_path / "j.csv") as g:
        [ours], [theirs] = list(csv.DictReader(f)), list(csv.DictReader(g))
    assert list(ours) == list(theirs)
    for k in ("experiment", "num_gpus", "zero_stage", "strategy", "peak_memory_source"):
        assert ours[k] == theirs[k], k
    assert float(ours["final_loss"]) == pytest.approx(float(theirs["final_loss"]), rel=1e-5)
    assert rec.metrics.final_loss == rec.final_loss
    tlog = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    jlog = [json.loads(x) for x in (tmp_path / "j.jsonl").read_text().splitlines()]
    assert [r["type"] for r in tlog] == [r["type"] for r in jlog] == \
        ["run"] + ["step"] * 5 + ["final"]
    for t, j in zip(tlog, jlog):
        assert list(t) == list(j)
        if t["type"] != "final":
            for k in ("type", "step", "lr", "skipped_update", "anomaly", "experiment",
                      "num_gpus", "zero_stage", "strategy"):
                assert t.get(k) == j.get(k), k
        if t["type"] == "step":
            assert t["loss"] == pytest.approx(j["loss"], rel=1e-5)
            assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-4)
    # A window's steps share its wall time and were booked at its one sync.
    steps = [r for r in tlog if r["type"] == "step"]
    assert steps[0]["step_time_s"] == steps[1]["step_time_s"]


def test_compare_training_cli(tmp_path, capsys):
    from dlti_tpu_torch.cli import compare_training

    path = tmp_path / "m.csv"
    _matrix_csv(path)
    compare_training.main(["--csv", str(path), "--no-plots"])
    assert "TRAINING COMPARISON" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="not found"):
        compare_training.main(["--csv", str(tmp_path / "missing.csv")])
    proc = subprocess.run([sys.executable, "-m", "dlti_tpu_torch.cli.compare_training",
                           "--csv", str(path), "--plot-out", str(tmp_path / "p.png")],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (tmp_path / "p.png").stat().st_size > 0
