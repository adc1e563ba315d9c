"""ZeRO-3 checkpoints across meshes and packages: a ``fsdp 2 x tensor 2``
run of the port's ``Trainer`` (a gloo world of 4, ``tests/torch_dist_worker.py``,
``_MIN_FSDP_DIM`` lowered to 8 in every rank) saves each leaf gathered whole
over every axis that splits it, to rank 0 alone, in the JAX store's format;
restores cut the whole leaves by the placement rule.

* The JAX store verifies the port's ``fsdp 2 x tensor 2`` checkpoint and the
  JAX single-device ``Trainer`` resumes its step 2: steps 3-4 come within
  2e-4 of the port's.
* The port resumes it on one device: the same steps within 2e-4.
* A JAX single-device checkpoint resumes in the port at ``fsdp 2 x tensor
  2``: its steps 3-4 within 2e-4 of the JAX run's own.
* The merged export of the ``fsdp 2 x tensor 2`` run (``whole_params`` to
  rank 0, ``export_merged_model``) equals, leaf for leaf within 2e-4, the
  single-device export after the same steps from the same step-2 state.

The JAX package's contract: ``tests/test_checkpoint.py`` (a sharded save is
the single-device tree) and ``tests/test_e2e.py`` (resume).
"""

import json
import os
import shutil

import numpy as np
import pytest

import torch_dist_worker as W
from dlti_tpu import config as jc
from dlti_tpu.checkpoint import store as jstore
from dlti_tpu.data import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.data import make_batches as jax_make_batches
from dlti_tpu.training.trainer import Trainer as JaxTrainer
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.checkpoint import load_exported_model
from dlti_tpu_torch.data import ByteTokenizer, make_batches
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.training import Trainer

RTOL = ATOL = 2e-4
LORA = W.LORA
TEXTS = [" ".join(f"w{(i * 7 + j) % 23}" for j in range(3 + i % 9)) for i in range(96)]
MAX_STEPS, SAVE_STEPS = 4, 2
MESH = dict(zero_stage=3, fsdp=2, tensor=2)


def _common(out_dir, max_steps):
    return dict(train=dict(micro_batch_size=W.BS, grad_accum_steps=W.ACCUM,
                           max_steps=max_steps, logging_steps=100, seed=0),
                checkpoint=dict(output_dir=str(out_dir), save_strategy="steps",
                                save_steps=SAVE_STEPS, save_total_limit=3, async_save=False))


def _port_cfg(out_dir, parallel):
    c = _common(out_dir, MAX_STEPS)
    return tc.Config(
        model=tc.MODEL_PRESETS["llama_tiny"], lora=tc.LoRAConfig(**LORA),
        optimizer=tc.OptimizerConfig(learning_rate=1e-2, warmup_steps=0),
        parallel=W._parallel(parallel), data=tc.DataConfig(max_seq_len=W.SEQ, tokenizer="byte"),
        checkpoint=tc.CheckpointConfig(**c["checkpoint"]),
        train=tc.TrainConfig(**c["train"])).to_dict()


def _jax_run(out_dir, tag):
    """The JAX single-device ``Trainer``'s 4 steps (resuming from
    ``out_dir`` when it holds a checkpoint): its losses by step."""
    c = _common(out_dir, MAX_STEPS)
    log = os.path.join(os.path.dirname(str(out_dir)), f"{tag}.jsonl")
    cfg = jc.Config(
        model=jc.MODEL_PRESETS["llama_tiny"], lora=jc.LoRAConfig(**LORA),
        optimizer=jc.OptimizerConfig(learning_rate=1e-2, warmup_steps=0),
        data=jc.DataConfig(max_seq_len=W.SEQ, tokenizer="byte"),
        checkpoint=jc.CheckpointConfig(**c["checkpoint"]),
        telemetry=jc.TelemetryConfig(step_log_path=log),
        train=jc.TrainConfig(metrics_csv=log[:-len(".jsonl")] + ".csv", **c["train"]))
    ds = jax_make_batches(TEXTS, JaxByteTokenizer(), seq_len=W.SEQ, micro_batch_size=W.BS,
                          grad_accum_steps=W.ACCUM, shard_by_host=False)
    JaxTrainer(cfg).train(dataset=ds)
    rows = [json.loads(line) for line in open(log)]
    return {r["step"]: r["loss"] for r in rows if r.get("type") == "step"}


def _port_one_device(out_dir, export_dir):
    """The port's ``Trainer`` on one device resuming from ``out_dir``, then
    its merged export."""
    from dlti_tpu_torch.checkpoint import export_merged_model
    from dlti_tpu_torch.training import whole_params

    c = tc.Config.from_dict(_port_cfg(out_dir, {}))
    ds = make_batches(TEXTS, ByteTokenizer(), seq_len=W.SEQ, micro_batch_size=W.BS,
                      grad_accum_steps=W.ACCUM, shuffle_seed=c.data.shuffle_seed)
    state, rec = Trainer(c, device="cpu", cuda_graphs=False).train(dataset=ds)
    export_merged_model(str(export_dir), whole_params(state), c)
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX single-device run's checkpoints, then one world of 4 running
    the port's ``fsdp 2 x tensor 2`` trainer straight (with its export) and
    resumed from the JAX checkpoint's step 2."""
    tmp = tmp_path_factory.mktemp("zero3_ckpt")
    jax_losses = _jax_run(tmp / "jax", "jax")
    cases = [
        ("straight", "train", dict(cfg=_port_cfg(tmp / "port", MESH), params=None,
                                   texts=TEXTS, export_dir=str(tmp / "export4"))),
        ("from_jax", "train", dict(cfg=_port_cfg(tmp / "from_jax", MESH), params=None,
                                   texts=TEXTS, copy_from=str(tmp / "jax"), drop_steps=[4])),
    ]
    world = W.spawn_world(4, cases, str(tmp))
    return {"tmp": tmp, "jax": jax_losses, "world": world}


def test_a_fsdp2_tensor2_checkpoint_holds_whole_leaves_and_resumes_in_jax(runs, tmp_path):
    tmp, world = runs["tmp"], runs["world"]
    got = world[0]["straight"]
    assert got["save_steps"] == [2, 4] and got["world"] == 4 and got["strategy"] == "zero3"
    ck = str(tmp / "port")
    assert jstore.verify_checkpoint(ck, 2) == (True, "ok")
    assert jstore.latest_verified_step(ck) == 4
    with open(f"{ck}/2/MANIFEST.json") as f:
        leaves = {e["name"]: tuple(e["shape"]) for e in json.load(f)["leaves"]}
    cfg = tc.MODEL_PRESETS["llama_tiny"]
    q = [s for n, s in leaves.items() if n.startswith(".params") and "['q_proj']['kernel']" in n]
    mu = [s for n, s in leaves.items() if n.startswith(".opt_state[1][0].mu") and "lora_a" in n]
    # Whole leaves, consolidated from the four ranks' parts.
    assert q == [(cfg.hidden_size, cfg.num_heads * cfg.resolved_head_dim)] * cfg.num_layers
    assert (cfg.hidden_size, LORA["r"]) in mu
    shutil.copytree(ck, tmp_path / "jax_resume")
    shutil.rmtree(tmp_path / "jax_resume" / "4")
    resumed = _jax_run(tmp_path / "jax_resume", "jax_resume")
    assert sorted(resumed) == [3, 4]
    np.testing.assert_allclose([resumed[s] for s in (3, 4)], got["losses"][2:],
                               rtol=RTOL, atol=ATOL)


def test_it_resumes_on_one_device_and_the_exports_agree(runs, tmp_path):
    tmp, world = runs["tmp"], runs["world"]
    got = world[0]["straight"]
    shutil.copytree(tmp / "port", tmp_path / "one")
    shutil.rmtree(tmp_path / "one" / "4")
    rec = _port_one_device(tmp_path / "one", tmp_path / "export1")
    assert rec.resumed_from == 2 and rec.world == 1
    np.testing.assert_allclose(rec.losses, got["losses"][2:], rtol=RTOL, atol=ATOL)
    four = params_from_jax(load_exported_model(str(tmp / "export4"), device="cpu")[0])
    one_tree, cfg = load_exported_model(str(tmp_path / "export1"), device="cpu")
    one = params_from_jax(one_tree)
    assert not cfg.lora.enabled and sorted(four) == sorted(one)
    for n, t in one.items():
        np.testing.assert_allclose(four[n].float().numpy(), t.float().numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_a_jax_checkpoint_resumes_in_the_port_at_fsdp2_tensor2(runs):
    want, world = runs["jax"], runs["world"]
    got = world[0]["from_jax"]
    assert got["resumed_from"] == 2 and got["world"] == 4
    np.testing.assert_allclose(got["losses"], [want[3], want[4]], rtol=RTOL, atol=ATOL)
    for rank_out in world[1:]:
        assert rank_out["from_jax"]["losses"] == got["losses"]
