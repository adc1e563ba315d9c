"""Data-parallel training in the port (the baseline and ZeRO-1/2/3 over
gloo on the CPU) against the JAX package's single-device step.

The JAX package's own contract (``tests/test_sharding.py``): an N-device
sharded step gives the single-device step's numbers, for every ZeRO stage.
Here the N devices are N spawned processes in one gloo group
(``tests/torch_dist_worker.py``), each running its rows of every
microbatch, and the reference is the JAX ``make_train_step`` on the whole
batch, with the same weights (``params_from_jax``) and the JAX test's setup:
``llama_tiny``, LoRA r 4, micro-batch 8 x accum 2, seq 32, 3 steps, loss
and LoRA leaves within rtol 2e-4 / atol 2e-4 (two frameworks, and a world
that sums in another order). Loss masks are random, so the ranks hold
different token counts and only the global token mean agrees.

Each world is spawned once for the module and runs every case of its size.
``parallel.sharding._MIN_FSDP_DIM`` is lowered to 8 in the ranks, as the
JAX package's tests lower it: at 1024 ZeRO-3 would shard no leaf of
``llama_tiny`` (hidden 64), and a test checks that leaves really split.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from dlti_tpu import config as jc
from dlti_tpu.checkpoint import store as jstore
from dlti_tpu.data import TokenBatchDataset as JaxTokenBatchDataset
from dlti_tpu.data import tokenize_and_truncate as jax_tokenize
from dlti_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.training import build_optimizer as jax_build_optimizer
from dlti_tpu.training import create_train_state as jax_create_state
from dlti_tpu.training import make_train_step as jax_make_step
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.checkpoint import store
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.parallel.mesh import build_mesh, check_strategy, fit_parallel_to_devices

RTOL = ATOL = 2e-4
STEPS = 3
TINY = jc.MODEL_PRESETS["llama_tiny"]


def _jax_params(lora, seed=0):
    """JAX init plus numpy noise on every leaf (lora_b included, so every
    factor has a gradient from the first step)."""
    tree = JaxLlama(TINY, lora).init(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    shape = (W.ACCUM, W.BS, W.SEQ)
    return [{"input_ids": rng.integers(3, TINY.vocab_size, shape).astype(np.int32),
             "loss_mask": (rng.random(shape) > 0.3).astype(np.int32)} for _ in range(n)]


def _port_numpy(tree):
    return {n: t.numpy() for n, t in params_from_jax(tree).items()}


def _jax_reference(tree, batches, lora):
    """The JAX single-device step over ``batches``: metrics and the final
    params in the port's names."""
    model = JaxLlama(TINY, lora)
    tx = jax_build_optimizer(jc.OptimizerConfig(**W.OPT))
    state = jax_create_state(jax.random.PRNGKey(0), model, tx, (W.BS, W.SEQ),
                             lora_enabled=lora.enabled, init_fn=lambda rng, x: tree)
    step = jax.jit(jax_make_step(model, accum_steps=W.ACCUM))
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return metrics, _port_numpy(jax.device_get(state.params))


ZERO = {  # name -> (world, parallel)
    "baseline_data2": (2, dict(zero_stage=0, data=2)),
    "zero1_data2": (2, dict(zero_stage=1, data=2)),
    "zero1_data4": (4, dict(zero_stage=1, data=4)),
    "zero2_data2": (2, dict(zero_stage=2, data=2)),
    "zero2_data4": (4, dict(zero_stage=2, data=4)),
    "zero3_fsdp2": (2, dict(zero_stage=3, fsdp=2)),
    "zero3_fsdp4": (4, dict(zero_stage=3, fsdp=4)),
}
FP16 = dict(dtype="float16", param_dtype="float16")
# The reference's initial scale: llama_tiny's fp16 steps overflow six times
# (the scale halving through the hysteresis), then apply.
FP16_SCALE = 2.0 ** 16
DROPOUT_LORA = dict(W.LORA, dropout=0.05)
TEXTS = [" ".join(f"w{(i * 7 + j) % 23}" for j in range(3 + i % 17)) for i in range(112)]


EVAL_TEXTS = [" ".join(f"e{(i * 3 + j) % 19}" for j in range(5 + i % 11)) for i in range(24)]


def _train_cfg(out_dir, parallel, *, max_steps=6, save_steps=3, k=1, strategy="steps"):
    return tc.Config(
        model=tc.MODEL_PRESETS["llama_tiny"], lora=tc.LoRAConfig(**W.LORA),
        optimizer=tc.OptimizerConfig(learning_rate=1e-2, warmup_steps=2),
        parallel=W._parallel(parallel),
        data=tc.DataConfig(max_seq_len=W.SEQ, tokenizer="byte"),
        checkpoint=tc.CheckpointConfig(output_dir=str(out_dir), save_strategy=strategy,
                                       save_steps=save_steps, save_total_limit=10),
        train=tc.TrainConfig(micro_batch_size=W.BS, grad_accum_steps=W.ACCUM,
                             max_steps=max_steps, logging_steps=100, seed=0,
                             steps_per_sync=k, eval_steps=3)).to_dict()


@pytest.fixture(scope="module")
def setup():
    lora, full = jc.LoRAConfig(**W.LORA), jc.LoRAConfig(enabled=False)
    tree, tree_full = _jax_params(lora), _jax_params(full, seed=1)
    batches = _batches(STEPS)
    fp16_batches = _batches(8, seed=8)
    ref = _jax_reference(tree, batches, lora)
    ref_full = _jax_reference(tree_full, batches, full)
    params, params_full = _port_numpy(tree), _port_numpy(tree_full)
    base = dict(zero_stage=0)
    # The port's world of 1 (no group): the fp16 and dropout yardsticks.
    fp16_one = W.steps(params, fp16_batches, base, W.LORA, model=FP16, fp16_scale=FP16_SCALE)
    dropout_one = W.steps(params, batches, base, DROPOUT_LORA, seed=11)
    return dict(params=params, params_full=params_full, batches=batches,
                fp16_batches=fp16_batches, ref=ref, ref_full=ref_full,
                fp16_one=fp16_one, dropout_one=dropout_one)


def _cases(setup, world, tmp):
    p, b = setup["params"], setup["batches"]
    cases = [(name, "steps", dict(params=p, batches=b, parallel=par, lora=W.LORA))
             for name, (w, par) in ZERO.items() if w == world]
    cases.append(("rows", "data_rows", dict(texts=TEXTS, seq=W.SEQ, bs=W.BS, accum=W.ACCUM,
                                            n_steps=2, skip_steps=1)))
    cases.append(("norm", "norm", dict(shapes={"a": (4, 6), "b": (3, 5), "c": (8,),
                                               "d": (5, 7)})))
    if world == 2:
        cases += [
            ("zero3_full", "steps", dict(params=setup["params_full"], batches=b,
                                         parallel=dict(zero_stage=3, fsdp=2), lora=None)),
            ("zero1_fp16", "steps", dict(params=p, batches=setup["fp16_batches"],
                                         parallel=dict(zero_stage=1, data=2), lora=W.LORA,
                                         model=FP16, fp16_scale=FP16_SCALE)),
            ("zero2_dropout", "steps", dict(params=p, batches=b, lora=DROPOUT_LORA,
                                            parallel=dict(zero_stage=2, data=2), seed=11)),
            ("ckpt", "train", dict(cfg=_train_cfg(tmp / "zero3_w2", dict(zero_stage=3, fsdp=2)),
                                   params=None, texts=TEXTS, eval_texts=EVAL_TEXTS)),
            ("k4", "train", dict(cfg=_train_cfg(tmp / "k4", dict(zero_stage=3, fsdp=2), k=4,
                                                strategy="no"), params=None, texts=TEXTS)),
            ("k1", "train", dict(cfg=_train_cfg(tmp / "k1", dict(zero_stage=3, fsdp=2),
                                                strategy="no"), params=None, texts=TEXTS)),
            ("leaves", "gathered_leaves", dict(params=p, parallel=dict(zero_stage=3, fsdp=2),
                                               lora=W.LORA)),
        ]
    if world == 4:
        cases.append(("resume_zero1", "train", dict(
            cfg=_train_cfg(tmp / "zero1_w4", dict(zero_stage=1, data=4)), params=None,
            texts=TEXTS, copy_from=str(tmp / "zero3_w2"), drop_steps=[6],
            eval_texts=EVAL_TEXTS)))
    return cases


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    out = {1: None}
    out[2] = W.spawn_world(2, _cases(setup, 2, tmp), str(tmp))
    out[4] = W.spawn_world(4, _cases(setup, 4, tmp), str(tmp))  # resumes world 2's save
    out["tmp"] = tmp
    return out


def _assert_matches(got, ref, name):
    want_metrics, want_params = ref
    for i, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: step {i + 1} loss")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: step {i + 1} grad norm")
    assert len(got["metrics"]) == len(want_metrics) == STEPS
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, want_params[n], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: {n} diverged")


@pytest.mark.parametrize("name", list(ZERO))
def test_data_parallel_step_matches_jax_single_device(worlds, setup, name):
    world, _ = ZERO[name]
    got = worlds[world][0][name]
    assert len(got["trainable"]) == 2 * 4 * TINY.num_layers  # every LoRA factor
    _assert_matches(got, setup["ref"], name)


def test_zero3_full_finetune_matches_jax_single_device(worlds, setup):
    got = worlds[2][0]["zero3_full"]
    assert "lm_head" in got["trainable"] and "model.embed_tokens" in got["trainable"]
    _assert_matches(got, setup["ref_full"], "zero3 full fine-tune")


@pytest.mark.parametrize("world", [2, 4])
def test_zero3_really_splits_leaves_across_ranks(worlds, world):
    """Under the lowered threshold each rank holds 1/world of a sharded
    leaf: LoRA factors, norm scales, kernels, embedding and head."""
    shapes = worlds[world][0][f"zero3_fsdp{world}"]["shapes"]
    split = {n for n, (local, whole) in shapes.items() if local != whole}
    assert split == set(shapes), sorted(set(shapes) - split)
    for n in split:
        local, whole = shapes[n]
        assert np.prod(local) * world == np.prod(whole), n
    # A full fine-tune splits every leaf too, each on its largest dim.
    full = worlds[2][0]["zero3_full"]["shapes"]
    assert full["lm_head"] == ((64, 256), (64, 512))
    assert full["model.layers.0.input_norm.scale"] == ((32,), (64,))


def test_a_zero3_save_gathers_each_leaf_to_rank_0_alone(worlds):
    """At a world of 2 under ZeRO-3 the leaves a save hands the store are
    whole on rank 0, each a new host tensor (no live shard), and ``meta``
    placeholders of the same shapes on rank 1; both models keep their
    shards after the gathers."""
    r0, r1 = (worlds[2][rank]["leaves"] for rank in (0, 1))
    assert r0["leaves"].keys() == r1["leaves"].keys()
    gathered = [n for n in r0["leaves"] if n.startswith(
        (".params", ".opt_state[1][0].mu", ".opt_state[1][0].nu"))]
    assert len(gathered) > 2 * 4 * TINY.num_layers
    for n in gathered:
        (shape0, meta0, live0), (shape1, meta1, live1) = r0["leaves"][n], r1["leaves"][n]
        assert shape0 == shape1 and not meta0 and meta1 and not live0 and not live1, n
    local = {n: shards for n, (shards, _) in worlds[2][0]["zero3_fsdp2"]["shapes"].items()}
    assert r0["after"] == r1["after"] == local


def test_a_zero_strategy_without_a_process_group_raises():
    """A ZeRO strategy runs its collectives in the group the entry point
    formed; without one it raises instead of running the baseline."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    for stage in (tc.ZeROStage.ZERO1, tc.ZeROStage.ZERO2, tc.ZeROStage.ZERO3):
        with pytest.raises(ValueError, match="has none"):
            build_mesh(tc.ParallelConfig(zero_stage=stage), torch.device("cpu"))
    assert build_mesh(tc.ParallelConfig(), torch.device("cpu")).group is None


def test_a_second_train_after_the_weights_were_released_raises():
    """Under ``offload_params`` the trainer lets go of the weights it was
    given once they are placed: a second ``train()`` without ``state=``
    raises rather than starting from random weights, and ``state=``
    takes the run's state back."""
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.training import Trainer

    cfg = tc.Config.from_dict(_train_cfg("unused", dict(zero_stage=0, offload_params=True),
                                         max_steps=2, strategy="no"))
    params = init_params(cfg.model, seed=5, device="cpu", lora=cfg.lora)
    ds = make_batches(TEXTS, ByteTokenizer(), seq_len=W.SEQ, micro_batch_size=W.BS,
                      grad_accum_steps=W.ACCUM)
    trainer = Trainer(cfg, params=params, device="cpu")
    state, first = trainer.train(dataset=ds)
    with pytest.raises(RuntimeError, match="released"):
        trainer.train(dataset=ds)
    state, second = trainer.train(dataset=ds, state=state)  # already at max_steps
    assert first.steps == 2 and second.steps == 0 and state.step == 2


def test_zero1_fp16_matches_the_port_world_of_one(worlds, setup):
    """The same loss scales, overflow steps and losses as one device: the
    scaler decides on the global norm, equal on every rank, so the ranks
    skip and apply the same steps. (Near the overflow threshold a world can
    part from one device: a rank's float16 partial products over half the
    rows may stay finite where the whole batch's overflow, as in DeepSpeed;
    from the reference's 2**16 the overflows here are clear.)"""
    got, one = worlds[2][0]["zero1_fp16"]["metrics"], setup["fp16_one"]["metrics"]
    table = [[m[k] for k in sorted(m)] for m in got]  # every rank the same (NaN-aware)
    np.testing.assert_array_equal([[m[k] for k in sorted(m)]
                                   for m in worlds[2][1]["zero1_fp16"]["metrics"]], table)
    assert [m["loss_scale"] for m in got] == [m["loss_scale"] for m in one]
    assert [m["overflow"] for m in got] == [m["overflow"] for m in one]
    assert any(m["overflow"] for m in one) and not all(m["overflow"] for m in one)
    np.testing.assert_allclose([m["loss"] for m in got], [m["loss"] for m in one],
                               rtol=RTOL, atol=ATOL)
    for n, t in worlds[2][0]["zero1_fp16"]["trainable"].items():
        np.testing.assert_allclose(t, setup["fp16_one"]["trainable"][n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_zero2_dropout_draws_the_single_device_masks(worlds, setup):
    """LoRA dropout at 0.05: each rank hashes its rows by their global index,
    so the world draws the masks one device draws for the whole batch."""
    got, one = worlds[2][0]["zero2_dropout"], setup["dropout_one"]
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                               [m["loss"] for m in one["metrics"]], rtol=RTOL, atol=ATOL)
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, one["trainable"][n], rtol=RTOL, atol=ATOL, err_msg=n)
    # Without dropout the loss differs: the masks are really drawn.
    nodrop = worlds[2][0]["zero2_data2"]["metrics"]
    assert got["metrics"][0]["loss"] != pytest.approx(nodrop[0]["loss"], rel=1e-6)


def test_zero3_steps_per_sync_4_equals_1(worlds):
    k4, k1 = worlds[2][0]["k4"], worlds[2][0]["k1"]
    assert k4["windows"] == 2 and k1["windows"] == 6
    assert k4["losses"] == k1["losses"] and k4["grad_norms"] == k1["grad_norms"]
    assert (k4["strategy"], k4["world"]) == ("zero3", 2)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_per_rank_batches_equal_the_jax_schedule(worlds, world):
    """Each rank's batches are the JAX ``HostShardedSchedule``'s for that
    process (``_procs``/``_proc_id`` set), epoch 1 after a skipped step."""
    ds = JaxTokenBatchDataset(sequences=jax_tokenize(TEXTS, JaxByteTokenizer(), W.SEQ),
                              seq_len=W.SEQ, pad_id=JaxByteTokenizer().pad_id,
                              micro_batch_size=W.BS, grad_accum_steps=W.ACCUM,
                              shuffle_seed=3, shard_by_host=False)
    ranks = ([{"rows": W.data_rows(TEXTS, W.SEQ, W.BS, W.ACCUM, 2, 1)}] if world == 1
             else worlds[world])
    for rank, out in enumerate(ranks):
        ds._procs, ds._proc_id = world, rank
        want = []
        for b in ds.epoch(1, skip_steps=1):
            want.append(b)
            if len(want) == 2:
                break
        got = out["rows"]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            assert g["input_ids"].shape == (W.ACCUM, W.BS // world, W.SEQ)
            for k in w:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_global_norm_counts_a_replicated_leaf_once(worlds, world):
    out = worlds[world][0]["norm"]
    assert out["replicated"]  # some leaf has no dim the world divides
    np.testing.assert_allclose(out["sharded"], out["whole"], rtol=1e-6)


def test_zero3_world2_checkpoint_restores_in_jax_and_at_worlds_1_and_4(worlds, tmp_path):
    """A ZeRO-3 world-2 run saved at steps 3 and 6, consolidated by rank 0:
    the JAX store verifies and restores it; the port resumes it from step 3
    at world 1 (baseline) and world 4 (ZeRO-1), with world 2's steps 4-6."""
    tmp = worlds["tmp"]
    run = worlds[2][0]["ckpt"]
    d = str(tmp / "zero3_w2")
    assert run["save_steps"] == [3, 6] and run["resumed_from"] is None
    assert store.list_checkpoint_steps(d) == [3, 6]
    assert jstore.latest_verified_step(d) == 6 and jstore.verify_checkpoint(d, 3) == (True, "ok")
    meta = store.load_train_meta(d, 3)
    assert meta["parallel"]["strategy"] == "zero3" and meta["parallel"]["world"] == 2
    # JAX restores step 3 into its own single-device state.
    jlora = jc.LoRAConfig(**W.LORA)
    jmodel = JaxLlama(TINY, jlora)
    template = jax_create_state(jax.random.PRNGKey(0), jmodel,
                                jax_build_optimizer(jc.OptimizerConfig(learning_rate=1e-2,
                                                                       warmup_steps=2)),
                                (W.BS, W.SEQ))
    restored = jstore.restore_train_state(d, 3, template)
    assert int(restored.step) == 3 and int(restored.opt_state[1][0].count) == 3

    # World 1, in this process (no group): the baseline resumes step 3.
    import shutil

    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.training import Trainer

    w1 = tmp_path / "baseline_w1"
    shutil.copytree(d, w1)
    shutil.rmtree(w1 / "6")
    cfg = tc.Config.from_dict(_train_cfg(w1, dict(zero_stage=0)))
    ds = make_batches(TEXTS, ByteTokenizer(), seq_len=W.SEQ, micro_batch_size=W.BS,
                      grad_accum_steps=W.ACCUM)
    held_out = make_batches(EVAL_TEXTS, ByteTokenizer(), seq_len=W.SEQ,
                            micro_batch_size=W.BS, grad_accum_steps=1, shuffle_seed=None)
    _, rec = Trainer(cfg, device="cpu").train(dataset=ds, eval_dataset=held_out)
    four = worlds[4][0]["resume_zero1"]
    for other in (rec.losses, four["losses"]):
        np.testing.assert_allclose(other, run["losses"][3:], rtol=RTOL, atol=ATOL)
    assert rec.resumed_from == 3 and four["resumed_from"] == 3
    assert four["strategy"] == "zero1" and four["world"] == 4
    # The eval at step 6 (the global token mean over the held-out rows each
    # rank evaluates a slice of) agrees across the three worlds.
    assert run["eval_steps"] == [3, 6] and rec.eval_steps == four["eval_steps"] == [6]
    for other in (rec.eval_losses, four["eval_losses"]):
        np.testing.assert_allclose(other, run["eval_losses"][1:], rtol=RTOL, atol=ATOL)


def test_strategy_legality_errors():
    """The reference trainer's rules, and what the port does not run, raise
    before anything is built."""
    P = tc.ParallelConfig
    with pytest.raises(ValueError, match="fsdp=2 without zero_stage=3"):
        check_strategy(P(zero_stage=tc.ZeROStage.ZERO1, fsdp=2))
    with pytest.raises(ValueError, match="offload_params without LoRA"):
        check_strategy(P(zero_stage=tc.ZeROStage.ZERO3, offload_params=True),
                       lora_enabled=False)
    # ZeRO-3 shards over its own fsdp axis, so it runs with every model
    # axis and beside data (the steps are held to JAX's in
    # tests/test_torch_zero3_steps.py); host offload with a model axis
    # still raises by name.
    z3 = tc.ZeROStage.ZERO3
    for par in (dict(fsdp=2, sequence=2), dict(fsdp=2, pipe=2), dict(tensor=2),
                dict(fsdp=2, tensor=2), dict(data=2, fsdp=2), dict(fsdp=2, expert=2),
                dict(expert=2)):
        check_strategy(P(zero_stage=z3, **par))
    for axis in ("tensor", "sequence", "pipe"):
        check_strategy(P(**{axis: 2}))
        with pytest.raises(NotImplementedError, match=f"{axis}=2 .*{axis} x offload"):
            check_strategy(P(zero_stage=z3, fsdp=2, offload_optimizer=True, **{axis: 2}))
    # The reference's elastic reshape still refuses a mixed mesh.
    with pytest.raises(ValueError, match="mixed data=2 x fsdp=2"):
        fit_parallel_to_devices(P(zero_stage=z3, data=2, fsdp=2), 2)
    with pytest.raises(ValueError, match="process group has 1"):
        build_mesh(P(data=2), torch.device("cpu"))

    from dlti_tpu_torch.cli.train import build_config, parse_args

    # --data only under --pipe, as the reference's scripts/train.py.
    for n in ("1", "2"):
        with pytest.raises(SystemExit, match="only applies under --pipe"):
            build_config(parse_args(["--model", "llama_tiny", "--data", n]))
    assert build_config(parse_args(["--model", "llama_tiny", "--tensor", "2"])
                        ).parallel == P(tensor=2)
    assert build_config(parse_args(["--model", "mixtral_tiny", "--expert", "2"])
                        ).parallel == P(expert=2)
    assert build_config(parse_args(["--model", "llama_tiny", "--sequence", "2"])
                        ).parallel == P(sequence=2)
    cfg = build_config(parse_args(["--model", "llama_tiny", "--pipe", "2", "--data", "1",
                                   "--per-device-batch-size", "3"]))
    assert cfg.parallel == P(pipe=2) and cfg.train.micro_batch_size == 3


def test_presets_and_parallel_config_cross_packages():
    """``preset`` and the ``parallel`` block mean the same in both packages:
    each reads the other's ``to_dict``."""
    for name in ("baseline", "zero1", "zero2_4dev", "zero3", "zero3_4dev", "zero1_4dev"):
        ours, theirs = tc.preset(name, model="llama_tiny"), jc.preset(name, model="llama_tiny")
        assert ours.to_dict()["parallel"] == theirs.to_dict()["parallel"], name
        assert ours.experiment_name == theirs.experiment_name == name
        back = jc.Config.from_dict(ours.to_dict())
        assert back.parallel == theirs.parallel and back.model == theirs.model
        assert tc.Config.from_dict(theirs.to_dict()).parallel == ours.parallel
    assert tc.preset("zero3_4dev").parallel.fsdp == 4
    assert tc.preset("zero1_4dev").parallel.data == 4
    off = tc.ParallelConfig(zero_stage=tc.ZeROStage.ZERO3, fsdp=2, offload_optimizer=True,
                            offload_params=True)
    ours = tc.Config(parallel=off, checkpoint=tc.CheckpointConfig(save_strategy="no"))
    assert jc.Config.from_dict(ours.to_dict()).parallel == jc.ParallelConfig(
        zero_stage=jc.ZeROStage.ZERO3, fsdp=2, offload_optimizer=True, offload_params=True)
    assert fit_parallel_to_devices(tc.preset("zero3_4dev").parallel, 2).fsdp == 2
    with pytest.raises(ValueError, match="unknown preset"):
        tc.preset("zero4")
