"""Expert parallelism and data-parallel mixtures of experts in the port,
over gloo on the CPU, against the JAX package's step on the whole batch.

The JAX package's contract (``tests/test_moe.py::
test_expert_parallel_matches_single_device``): a step over an ``expert``
mesh, and over ``data x expert``, gives the single-device step's numbers.
Here the devices are spawned processes in one gloo group
(``tests/torch_dist_worker.py``): ``expert 2``, ``expert 4`` and ``data 2 x
expert 2`` split ``mixtral_tiny``'s four experts over the expert group, and
the ranks of one expert group take the same rows. The default capacity
(1.25) routes this batch without drops; the ``tight`` cases (capacity
0.5) drop about a third of the assignments, so they hold the global
capacity and slot-major ranks across batch ranks (each rank all-gathers
the others' per-slot counts). Every case holds the global load-balance
loss. Loss, ``aux_loss``, grad
norm and every trained leaf match the JAX single-device step within 2e-4
(two frameworks, and a world that sums in another order), under LoRA on
the attention projections and in a full fine-tune, where the expert
leaves' gradients stay on their ranks; ``data 2 x expert 2`` also matches
the JAX sharded step on a ``data 2 x expert 2`` mesh of the suite's
virtual host devices. Each world is spawned once for the module.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as W
from dlti_tpu import config as jc
from dlti_tpu.checkpoint import store as jstore
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.training import build_optimizer as jax_build_optimizer
from dlti_tpu.training import create_train_state as jax_create_state
from dlti_tpu.training import make_train_step as jax_make_step
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.parallel.mesh import check_strategy

RTOL = ATOL = 2e-4
STEPS = 2
ACCUM, BS, SEQ = 2, 4, 16
MOE = jc.MODEL_PRESETS["mixtral_tiny"]
LORA = dict(r=4, alpha=8, dropout=0.0)
OPT = W.OPT  # the JAX sharding test's: lr 0 at the first update, 1e-4 at the second

WORLDS = {  # name -> (world, parallel)
    "expert2": (2, dict(expert=2)),
    "data2": (2, dict(data=2)),
    "expert4": (4, dict(expert=4)),
    "data2_expert2": (4, dict(data=2, expert=2)),
    "zero1_data2_expert2": (4, dict(zero_stage=1, data=2, expert=2)),
}
FULL = {"expert2_full": (2, dict(expert=2)), "data2_expert2_full": (4, dict(data=2, expert=2))}
# Capacity 0.5: C = int(0.5 * 64 * 2 / 4) = 16 of ~32 assignments an expert.
TIGHT_CF = 0.5
TIGHT = {"data2_tight": (2, dict(data=2)), "expert2_tight": (2, dict(expert=2)),
         "data2_expert2_tight": (4, dict(data=2, expert=2))}
# ZeRO-3 with the expert axis on a world of 2: the batch extent is 1.
ZERO3_EXPERT_ARGV = ["--model", "mixtral_tiny", "--preset", "zero3", "--expert", "2"]


def _jax_params(lora, seed=0):
    tree = JaxLlama(MOE, lora).init(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    shape = (ACCUM, BS, SEQ)
    return [{"input_ids": rng.integers(3, MOE.vocab_size, shape).astype(np.int32),
             "loss_mask": (rng.random(shape) > 0.3).astype(np.int32)} for _ in range(n)]


def _port_numpy(tree):
    return {n: t.numpy() for n, t in params_from_jax(tree).items()}


def _jax_run(tree, batches, lora, parallel=None, mcfg=MOE):
    """The JAX step over ``batches`` (single device, or sharded over a
    ``parallel`` mesh): metrics and the final params in the port's names."""
    model = JaxLlama(mcfg, lora)
    tx = jax_build_optimizer(jc.OptimizerConfig(**OPT))
    state = jax_create_state(jax.random.PRNGKey(0), model, tx, (BS, SEQ),
                             lora_enabled=lora.enabled, init_fn=lambda rng, x: tree)
    if parallel is None:
        step = jax.jit(jax_make_step(model, accum_steps=ACCUM))
    else:
        from dlti_tpu.parallel import build_mesh, make_sharded_train_step, shard_train_state

        cfg = jc.Config(model=MOE, lora=lora, optimizer=jc.OptimizerConfig(**OPT),
                        parallel=jc.ParallelConfig(**parallel),
                        data=jc.DataConfig(max_seq_len=SEQ),
                        train=jc.TrainConfig(micro_batch_size=BS, grad_accum_steps=ACCUM),
                        checkpoint=jc.CheckpointConfig(save_strategy="no"))
        mesh = build_mesh(cfg.parallel)
        model = JaxLlama(MOE, lora, mesh)
        state = shard_train_state(state, cfg, mesh)
        step = make_sharded_train_step(model, state, cfg, mesh, accum_steps=ACCUM)
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return metrics, _port_numpy(jax.device_get(state.params))


@pytest.fixture(scope="module")
def setup():
    lora, full = jc.LoRAConfig(**LORA), jc.LoRAConfig(enabled=False)
    tree, tree_full = _jax_params(lora), _jax_params(full, seed=1)
    batches = _batches(STEPS)
    return dict(params=_port_numpy(tree), params_full=_port_numpy(tree_full),
                batches=batches, ref=_jax_run(tree, batches, lora),
                ref_full=_jax_run(tree_full, batches, full),
                ref_mesh=_jax_run(tree, batches, lora, dict(data=2, expert=2)),
                ref_tight=_jax_run(tree, batches, lora, mcfg=dataclasses.replace(
                    MOE, moe_capacity_factor=TIGHT_CF)))


def _train_cfg(out_dir, parallel):
    return tc.Config(
        model=tc.MODEL_PRESETS["mixtral_tiny"], lora=tc.LoRAConfig(**LORA),
        optimizer=tc.OptimizerConfig(learning_rate=1e-2, warmup_steps=0),
        parallel=W._parallel(parallel),
        data=tc.DataConfig(max_seq_len=SEQ, tokenizer="byte"),
        checkpoint=tc.CheckpointConfig(output_dir=str(out_dir), save_strategy="steps",
                                       save_steps=2, save_total_limit=2),
        train=tc.TrainConfig(micro_batch_size=BS, grad_accum_steps=ACCUM, max_steps=2,
                             logging_steps=100, seed=0)).to_dict()


TEXTS = [" ".join(f"w{(i * 7 + j) % 23}" for j in range(3 + i % 9)) for i in range(48)]


def _cases(setup, world, tmp):
    kw = dict(batches=setup["batches"], preset="mixtral_tiny", accum=ACCUM, opt=OPT)
    cases = [(name, "steps", dict(params=setup["params"], parallel=par, lora=LORA, **kw))
             for name, (w, par) in WORLDS.items() if w == world]
    cases += [(name, "steps", dict(params=setup["params_full"], parallel=par, lora=None, **kw))
              for name, (w, par) in FULL.items() if w == world]
    cases += [(name, "steps", dict(params=setup["params"], parallel=par, lora=LORA,
                                   model=dict(moe_capacity_factor=TIGHT_CF), **kw))
              for name, (w, par) in TIGHT.items() if w == world]
    if world == 2:
        cases.append(("ckpt", "train", dict(cfg=_train_cfg(tmp / "ep2", dict(expert=2)),
                                            params=None, texts=TEXTS)))
        cases.append(("zero3_expert2", "cli_mesh", dict(argv=ZERO3_EXPERT_ARGV)))
    return cases


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    return {w: W.spawn_world(w, _cases(setup, w, tmp), str(tmp)) for w in (2, 4)} | {
        "tmp": tmp}


def _assert_matches(got, ref, name):
    want_metrics, want_params = ref
    assert len(got["metrics"]) == len(want_metrics) == STEPS
    for i, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        for key in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name}: step {i + 1} {key}")
    assert got["trainable"]
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, want_params[n], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: {n} diverged")


@pytest.mark.parametrize("name", list(WORLDS))
def test_moe_parallel_lora_step_matches_jax_single_device(worlds, setup, name):
    world, _ = WORLDS[name]
    _assert_matches(worlds[world][0][name], setup["ref"], name)


@pytest.mark.parametrize("name", list(FULL))
def test_moe_parallel_full_finetune_matches_jax_single_device(worlds, setup, name):
    world, _ = FULL[name]
    got = worlds[world][0][name]
    assert any(".mlp.w1" in n for n in got["trainable"])  # the experts trained too
    _assert_matches(got, setup["ref_full"], name)


@pytest.mark.parametrize("name", list(TIGHT))
def test_dropped_tokens_are_the_global_batchs_across_ranks(worlds, setup, name):
    world, _ = TIGHT[name]
    _assert_matches(worlds[world][0][name], setup["ref_tight"], name)


def test_data2_expert2_matches_the_jax_data2_expert2_mesh(worlds, setup):
    _assert_matches(worlds[4][0]["data2_expert2"], setup["ref_mesh"], "jax mesh")


@pytest.mark.parametrize("name", ["expert2", "expert4", "data2_expert2"])
def test_each_rank_holds_only_its_experts(worlds, name):
    world, par = WORLDS[name]
    ep = par["expert"]
    for rank_out in worlds[world]:
        shapes = rank_out[name]["shapes"]
        for n, (local, whole) in shapes.items():
            if ".mlp.w" in n:
                assert local[0] == whole[0] // ep == MOE.num_experts // ep, n
            else:
                assert local == whole, n


def test_an_expert_parallel_checkpoint_verifies_in_the_jax_store(worlds):
    got = worlds[2][0]["ckpt"]
    assert got["save_steps"] == [2] and got["world"] == 2
    assert all(np.isfinite(got["losses"]))
    ck = str(worlds["tmp"] / "ep2")
    assert jstore.latest_verified_step(ck) == 2
    assert jstore.verify_checkpoint(ck, 2) == (True, "ok")
    with open(f"{ck}/2/MANIFEST.json") as f:
        leaves = {e["name"]: tuple(e["shape"]) for e in json.load(f)["leaves"]}
    w1 = [s for n, s in leaves.items() if n.startswith(".params") and "['w1']" in n]
    # Every expert, consolidated from both ranks' halves.
    assert w1 == [(MOE.num_experts, MOE.hidden_size, MOE.intermediate_size)] * MOE.num_layers


def test_expert_axis_strategy_rules():
    check_strategy(tc.ParallelConfig(expert=2))
    check_strategy(tc.ParallelConfig(data=2, expert=2))
    check_strategy(tc.ParallelConfig(zero_stage=tc.ZeROStage.ZERO2, data=2, expert=2))
    check_strategy(tc.ParallelConfig(pipe=2, expert=2))
    # ZeRO-3 shards over its own fsdp axis beside the expert one (the steps
    # are held to JAX's in tests/test_torch_zero3_steps.py).
    for par in (dict(fsdp=2, expert=2), dict(fsdp=1, expert=2), dict(pipe=2, fsdp=2, expert=2)):
        check_strategy(tc.ParallelConfig(zero_stage=tc.ZeROStage.ZERO3, **par))
    for par, match in [(dict(tensor=2, expert=2), "tensor x expert"),
                       (dict(sequence=2, expert=2), "sequence x expert")]:
        with pytest.raises(NotImplementedError, match=match):
            check_strategy(tc.ParallelConfig(**par))


def test_zero3_with_the_expert_axis_is_refused_at_a_batch_extent_of_one():
    """Under ``--pipe``, ``cli.train --preset zero3 --expert 2`` with no
    ``--data`` has a batch-row (fsdp) extent of one, which the reference
    refuses (``scripts/train.py:317-321``): fsdp 1 would shard nothing."""
    from dlti_tpu_torch.cli.train import build_config, parse_args

    with pytest.raises(SystemExit, match="needs a batch-row extent"):
        build_config(parse_args(["--model", "mixtral_tiny", "--preset", "zero3",
                                 "--expert", "2", "--pipe", "2"]))
    par = build_config(parse_args(["--model", "mixtral_tiny", "--preset", "zero3",
                                   "--expert", "2", "--pipe", "2", "--data", "2"])).parallel
    assert (par.fsdp, par.expert, par.pipe, par.zero_stage) == (2, 2, 2, tc.ZeROStage.ZERO3)


def test_zero3_with_the_expert_axis_at_a_batch_extent_of_one_builds(worlds):
    """Without ``--pipe``, ``cli.train --preset zero3 --expert 2`` on a world
    of 2 sizes fsdp to 1. ZeRO-3 shards over its own fsdp axis, so as in the
    reference the mesh builds on every rank and nothing is sharded over fsdp
    (the experts still split over expert)."""
    for rank_out in worlds[2]:
        got = rank_out["zero3_expert2"]
        assert (got["fsdp"], got["expert"], got["zero_stage"]) == (1, 2, 3)
        assert got["error"] is None, got["error"]
