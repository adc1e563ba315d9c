"""The pipeline through the port's entry points: a PP-2 ``Trainer`` that
trains, checkpoints the reference's stacked layout, resumes and evaluates,
and whose checkpoints cross to the JAX package's pipeline trainer and back;
``cli.train``'s mesh rules against ``scripts/train.py``'s; ``cli.train
--pipe 2 --data 1`` under the launcher; and every combination the port does
not run with the pipe axis, refused by name.

The JAX package's contract (``tests/test_pipeline.py:94-131``): the
pipelined ``Trainer`` checkpoints the stacked layout
(``.params['layers'][...]`` with a leading layer dim) and resumes from it.
"""

import dataclasses
import json
import os
import runpy
import shutil
import sys

import numpy as np
import pytest

import torch_dist_worker as W
from dlti_tpu import config as jc
from dlti_tpu.checkpoint import store as jstore
from dlti_tpu.data import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.data import make_batches as jax_make_batches
from dlti_tpu.training.trainer import Trainer as JaxTrainer
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.parallel.mesh import check_strategy

RTOL = 2e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LORA = W.LORA
TEXTS = [" ".join(f"w{(i * 7 + j) % 23}" for j in range(3 + i % 9)) for i in range(96)]
MAX_STEPS, SAVE_STEPS = 4, 2


def _common(out_dir, max_steps):
    return dict(train=dict(micro_batch_size=W.BS, grad_accum_steps=W.ACCUM,
                           max_steps=max_steps, logging_steps=100, seed=0,
                           eval_steps=SAVE_STEPS),
                checkpoint=dict(output_dir=str(out_dir), save_strategy="steps",
                                save_steps=SAVE_STEPS, save_total_limit=3, async_save=False))


def _port_cfg(out_dir, parallel, max_steps=MAX_STEPS):
    c = _common(out_dir, max_steps)
    return tc.Config(
        model=tc.MODEL_PRESETS["llama_tiny"], lora=tc.LoRAConfig(**LORA),
        optimizer=tc.OptimizerConfig(learning_rate=1e-2, warmup_steps=0),
        parallel=W._parallel(parallel), data=tc.DataConfig(max_seq_len=W.SEQ, tokenizer="byte"),
        checkpoint=tc.CheckpointConfig(**c["checkpoint"]),
        train=tc.TrainConfig(**c["train"])).to_dict()


def _jax_run(out_dir, tag, max_steps=MAX_STEPS):
    """The JAX pipelined ``Trainer`` (pipe 2 on the CPU mesh), resuming from
    ``out_dir`` when it holds a checkpoint: its losses by step."""
    c = _common(out_dir, max_steps)
    log = os.path.join(os.path.dirname(str(out_dir)), f"{tag}.jsonl")
    cfg = jc.Config(
        model=jc.MODEL_PRESETS["llama_tiny"], lora=jc.LoRAConfig(**LORA),
        optimizer=jc.OptimizerConfig(learning_rate=1e-2, warmup_steps=0),
        parallel=jc.ParallelConfig(pipe=2), data=jc.DataConfig(max_seq_len=W.SEQ,
                                                               tokenizer="byte"),
        checkpoint=jc.CheckpointConfig(**c["checkpoint"]),
        telemetry=jc.TelemetryConfig(step_log_path=log),
        train=jc.TrainConfig(metrics_csv=log[:-len(".jsonl")] + ".csv", **c["train"]))
    ds = jax_make_batches(TEXTS, JaxByteTokenizer(), seq_len=W.SEQ, micro_batch_size=W.BS,
                          grad_accum_steps=W.ACCUM, shard_by_host=False)
    JaxTrainer(cfg).train(dataset=ds)
    rows = [json.loads(line) for line in open(log)]
    return {r["step"]: r["loss"] for r in rows if r.get("type") == "step"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX pipe-2 trainer's 4 steps (checkpoints at 2 and 4), then one
    world of 2 running the port's pipe-2 trainer three ways: straight with
    checkpoints and evals; resumed from its own step 2; resumed from the JAX
    checkpoint's step 2."""
    tmp = tmp_path_factory.mktemp("pipe_trainer")
    jax_losses = _jax_run(tmp / "jax", "jax")
    pipe = dict(pipe=2)
    cases = [
        ("straight", "train", dict(cfg=_port_cfg(tmp / "port", pipe), params=None,
                                   texts=TEXTS, eval_texts=TEXTS[:32])),
        ("resume", "train", dict(cfg=_port_cfg(tmp / "port_resume", pipe), params=None,
                                 texts=TEXTS, copy_from=str(tmp / "port"),
                                 drop_steps=[4])),
        ("from_jax", "train", dict(cfg=_port_cfg(tmp / "from_jax", pipe), params=None,
                                   texts=TEXTS, copy_from=str(tmp / "jax"), drop_steps=[4])),
    ]
    world = W.spawn_world(2, cases, str(tmp))
    return {"tmp": tmp, "jax": jax_losses, "world": world}


def test_pipe2_trainer_trains_checkpoints_resumes_and_evals(runs, tmp_path):
    """The PP-2 trainer's losses and evals are one device's (the same
    seeded weights and rows), its checkpoint holds the stacked layout, and a
    resume from step 2 replays steps 3-4."""
    from dlti_tpu_torch.config import Config
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.training import Trainer

    got = runs["world"][0]["straight"]
    assert got["save_steps"] == [2, 4] and got["world"] == 2 and got["strategy"] == "pipe2"
    c = Config.from_dict(_port_cfg(tmp_path / "one", {}))
    ds = make_batches(TEXTS, ByteTokenizer(), seq_len=W.SEQ, micro_batch_size=W.BS,
                      grad_accum_steps=W.ACCUM, shuffle_seed=c.data.shuffle_seed)
    held = make_batches(TEXTS[:32], ByteTokenizer(), seq_len=W.SEQ, micro_batch_size=W.BS,
                        grad_accum_steps=1, shuffle_seed=None)
    _, one = Trainer(c, device="cpu", cuda_graphs=False).train(dataset=ds, eval_dataset=held)
    np.testing.assert_allclose(got["losses"], one.losses, rtol=RTOL)
    assert got["eval_steps"] == one.eval_steps == [2, 4]
    np.testing.assert_allclose(got["eval_losses"], one.eval_losses, rtol=RTOL)
    resumed = runs["world"][0]["resume"]
    assert resumed["resumed_from"] == 2
    np.testing.assert_allclose(resumed["losses"], got["losses"][2:], rtol=RTOL)
    ck = str(runs["tmp"] / "port")
    with open(f"{ck}/2/MANIFEST.json") as f:
        leaves = {e["name"]: tuple(e["shape"]) for e in json.load(f)["leaves"]}
    cfg = tc.MODEL_PRESETS["llama_tiny"]
    assert leaves[".params['layers']['attn']['q_proj']['kernel']"] == (
        cfg.num_layers, cfg.hidden_size, cfg.num_heads * cfg.resolved_head_dim)
    assert leaves[".params['embed_tokens']"] == (cfg.vocab_size, cfg.hidden_size)
    assert leaves[".opt_state[1][0].mu[('layers', 'attn', 'q_proj', 'lora_a')]"][0] == (
        cfg.num_layers)
    assert not any("layers_" in n for n in leaves)


def test_a_port_pipe_checkpoint_verifies_and_resumes_in_jax(runs, tmp_path):
    ck = str(runs["tmp"] / "port")
    assert jstore.verify_checkpoint(ck, 2) == (True, "ok")
    shutil.copytree(ck, tmp_path / "ck")
    shutil.rmtree(tmp_path / "ck" / "4")
    losses = _jax_run(tmp_path / "ck", "resumed")
    assert sorted(losses) == [3, 4]
    np.testing.assert_allclose([losses[3], losses[4]],
                               runs["world"][0]["straight"]["losses"][2:], rtol=RTOL)


def test_a_jax_pipe_checkpoint_resumes_in_the_port(runs):
    got = runs["world"][0]["from_jax"]
    assert got["resumed_from"] == 2
    np.testing.assert_allclose(got["losses"], [runs["jax"][3], runs["jax"][4]], rtol=RTOL)
    # The JAX trainer and the port's from their own seeded weights differ;
    # the resume continues the JAX run, not the port's.
    assert abs(got["losses"][0] - runs["world"][0]["straight"]["losses"][2]) > 1e-4


# argv -> what both packages' mesh rules give (the parallel block), or both
# raise SystemExit.
ARGV = [
    ["--pipe", "2", "--data", "2"],
    ["--pipe", "2"],
    ["--pipe", "2", "--data", "1", "--tensor", "2"],
    ["--pipe", "2", "--data", "2", "--tensor", "2", "--num-devices", "8"],
    ["--preset", "zero1", "--pipe", "2", "--data", "2"],
    ["--preset", "zero1_4dev", "--pipe", "2"],
    ["--pipe", "2", "--data", "2", "--expert", "2", "--model", "mixtral_tiny"],
    ["--sequence", "2", "--num-devices", "2"],
    ["--sequence", "2", "--tensor", "2", "--num-devices", "1"],
    ["--pipe", "2", "--data", "2", "--num-devices", "3"],
    ["--preset", "zero3", "--pipe", "2"],
    ["--data", "2"],
    ["--data", "1"],
]
FIELDS = ("data", "fsdp", "tensor", "sequence", "pipe", "expert")


def _reference(argv, monkeypatch):
    ns = runpy.run_path(os.path.join(ROOT, "scripts", "train.py"), run_name="reference_train")
    monkeypatch.setattr(sys, "argv", ["train.py", "--model", "llama_tiny", *argv])
    try:
        par = ns["build_config"](ns["parse_args"]()).parallel
    except SystemExit as e:
        return f"SystemExit: {e}"
    return {**{f: getattr(par, f) for f in FIELDS}, "zero_stage": int(par.zero_stage)}


def _port(argv):
    from dlti_tpu_torch.cli.train import build_config, parse_args

    try:
        par = build_config(parse_args(["--model", "llama_tiny", *argv])).parallel
    except SystemExit as e:
        return f"SystemExit: {e}"
    return {**{f: getattr(par, f) for f in FIELDS}, "zero_stage": int(par.zero_stage)}


@pytest.mark.parametrize("argv", ARGV, ids=[" ".join(a) for a in ARGV])
def test_cli_train_mesh_rules_equal_the_reference_scripts(argv, monkeypatch):
    want, got = _reference(argv, monkeypatch), _port(argv)
    if isinstance(want, str):
        assert isinstance(got, str), (argv, got)
        first = want.split(":")[1].split()[0]  # the flag the message names first
        assert first in got, (argv, want, got)
    else:
        assert got == want, argv


def test_pipe_axis_refusals():
    """What the port does not run with pipeline parallelism raises by name
    (``NotImplementedError`` naming ROADMAP.md); the reference's
    ``ValueError``s too."""
    from dlti_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from dlti_tpu_torch.models.llama import LlamaForCausalLM
    from dlti_tpu_torch.training.trainer import Trainer, check_model_axes

    P = tc.ParallelConfig
    # ZeRO-3 shards a stage's layers over its own fsdp axis (the steps are
    # held to JAX's in tests/test_torch_zero3_steps.py).
    check_strategy(P(zero_stage=tc.ZeROStage.ZERO3, fsdp=2, pipe=2))
    check_strategy(P(zero_stage=tc.ZeROStage.ZERO3, pipe=2))
    for par, match in [(dict(pipe=2, offload_optimizer=True), "pipe x offload"),
                       (dict(zero_stage=tc.ZeROStage.ZERO3, pipe=2, offload_params=True),
                        "pipe x offload"),
                       (dict(pipe=2, sequence=2), "pipe x sequence")]:
        with pytest.raises(NotImplementedError, match=f"{match}.*ROADMAP.md"):
            check_strategy(P(**par))
    check_strategy(P(pipe=2, tensor=2, data=2, zero_stage=tc.ZeROStage.ZERO2))
    check_strategy(P(pipe=2, expert=2, data=2, zero_stage=tc.ZeROStage.ZERO1))
    base = tc.Config(model=tc.MODEL_PRESETS["llama_tiny"], parallel=P(pipe=2),
                     checkpoint=tc.CheckpointConfig(save_strategy="no"))
    with pytest.raises(ValueError, match="grad_accum_steps must be >= 1 under pipe"):
        check_model_axes(base.replace(train=tc.TrainConfig(grad_accum_steps=0)))
    with pytest.raises(ValueError, match="grad_accum_steps must be >= 1 under pipe"):
        Trainer(base.replace(train=tc.TrainConfig(grad_accum_steps=0)), device="cpu")
    odd = dataclasses.replace(tc.MODEL_PRESETS["llama_tiny"], num_layers=3)
    with pytest.raises(ValueError, match="must divide into pipe=2 stages"):
        check_model_axes(base.replace(model=odd))
    moe = LlamaForCausalLM(tc.MODEL_PRESETS["mixtral_tiny"], device="meta", stage=(0, 2))
    with pytest.raises(ValueError, match="loss_chunk does not compose with MoE"):
        make_pipeline_train_step(moe, accum_steps=2, loss_chunk=8)


@pytest.mark.parametrize("data", [1, 2])
def test_cli_train_pipe2_under_the_launcher(tmp_path, data):
    """``launcher --num-processes 2D -- cli.train --pipe 2 --data D``: two
    stages over the microbatches (``--gradient-accumulation-steps``), D
    batch ranks each taking 2 rows of a microbatch, at the loss of one
    device given the same rows; the summary names the reference's
    ``pipe2``."""
    import socket

    from test_torch_tp_training import _cli_train

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    world = 2 * data
    got = _cli_train(tmp_path, "pp", ["--num-processes", str(world), "--port", str(port)],
                     ["--pipe", "2", "--data", str(data)])
    want = _cli_train(tmp_path, "one", flags=["--per-device-batch-size", str(2 * data)])
    assert (got["world"], got["strategy"]) == (world, "pipe2")
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=RTOL)
    assert got["trainable_params"] == want["trainable_params"]
