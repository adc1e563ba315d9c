"""ZeRO-3 on its own ``fsdp`` axis beside every model axis, and the mixed
``data x fsdp`` mesh: the port's steps against the JAX package's.

The JAX package runs ZeRO-3 with ``tensor``, ``expert``, ``sequence`` and
``pipe`` and beside ``data`` (``dlti_tpu/training/trainer.py:73-169``), its
contract being that a sharded step gives the single-device step's numbers.
Here one gloo world of 4 spawned processes (``tests/torch_dist_worker.py``,
``_MIN_FSDP_DIM`` lowered to 8 in every rank so the tiny models' leaves
really split) runs each mesh, every rank its rows: ``fsdp 2 x tensor 2``
(LoRA, full fine-tune, the int8 frozen base), ``fsdp 2 x expert 2``
(``mixtral_tiny``, LoRA and full fine-tune), ``fsdp 2 x sequence 2``,
``fsdp 2 x pipe 2`` (LoRA and full fine-tune) and ``data 2 x fsdp 2`` (LoRA
and full fine-tune). Loss, grad norm (and ``aux_loss``) and every trained
leaf, gathered whole, come within rtol/atol 2e-4 of the JAX single-device
step on the whole batch over 2 steps. ``data 2 x fsdp 2`` in float16 from a
loss scale of 2**14 takes the JAX sharded step's decisions on a ``data 2 x
fsdp 2`` mesh of the suite's host devices (each microbatch's gradient
summed in float16: the whole batch's overflow is seen by every rank) and
comes within the same limits. Each rank reports its parts' shapes: a leaf
split over fsdp is held as half of what its tensor or expert rank holds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as W
from dlti_tpu import config as jc
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.models import quantization as jq
from dlti_tpu.parallel import build_mesh, make_sharded_train_step, shard_train_state
from dlti_tpu.training import build_optimizer as jax_build_optimizer
from dlti_tpu.training import create_train_state as jax_create_state
from dlti_tpu.training import make_train_step as jax_make_step
from dlti_tpu_torch.models import params_from_jax

RTOL = ATOL = 2e-4
STEPS = 2
LORA, OPT = W.LORA, W.OPT
WIDE = dict(hidden_size=128, intermediate_size=256)  # the int8 base quantizes projections
FP16 = dict(dtype="float16", param_dtype="float16")
FP16_SCALE = 2.0 ** 14
FP16_STEPS = 6
# name -> (preset, model overrides, LoRA or None, int8 base)
RUNS = {
    "lora": ("llama_tiny", {}, LORA, False),
    "full": ("llama_tiny", {}, None, False),
    "int8": ("llama_tiny", WIDE, LORA, True),
    "moe_lora": ("mixtral_tiny", {}, LORA, False),
    "moe_full": ("mixtral_tiny", {}, None, False),
}
Z3 = dict(zero_stage=3)
MESHES = {  # name -> (run, parallel)
    "fsdp2_tensor2": ("lora", dict(Z3, fsdp=2, tensor=2)),
    "fsdp2_tensor2_full": ("full", dict(Z3, fsdp=2, tensor=2)),
    "fsdp2_tensor2_int8": ("int8", dict(Z3, fsdp=2, tensor=2)),
    "fsdp2_expert2": ("moe_lora", dict(Z3, fsdp=2, expert=2)),
    "fsdp2_expert2_full": ("moe_full", dict(Z3, fsdp=2, expert=2)),
    "fsdp2_sequence2": ("lora", dict(Z3, fsdp=2, sequence=2)),
    "fsdp2_pipe2": ("lora", dict(Z3, fsdp=2, pipe=2)),
    "fsdp2_pipe2_full": ("full", dict(Z3, fsdp=2, pipe=2)),
    "data2_fsdp2": ("lora", dict(Z3, data=2, fsdp=2)),
    "data2_fsdp2_full": ("full", dict(Z3, data=2, fsdp=2)),
}
FP16_MESH = dict(Z3, data=2, fsdp=2)


def _cfg(preset, model):
    return dataclasses.replace(jc.MODEL_PRESETS[preset], **model)


def _jax_tree(cfg, lora, seed=0, fp16=False):
    """JAX init plus numpy noise on every leaf (lora_b included, so every
    factor has a gradient from the first step); with ``fp16`` the base in
    float16, the LoRA factors float32."""
    tree = JaxLlama(cfg, jc.LoRAConfig(**lora) if lora else None).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def noisy(path, a):
        a = (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        lora_leaf = str(getattr(path[-1], "key", path[-1])) in ("lora_a", "lora_b")
        return a.astype(np.float16) if fp16 and not lora_leaf else a

    return jax.tree_util.tree_map_with_path(noisy, jax.device_get(tree))


def _batches(vocab, n, seed=7):
    rng = np.random.default_rng(seed)
    shape = (W.ACCUM, W.BS, W.SEQ)
    return [{"input_ids": rng.integers(3, vocab, shape).astype(np.int32),
             "loss_mask": (rng.random(shape) > 0.3).astype(np.int32)} for _ in range(n)]


def _port_numpy(tree):
    return {n: t.numpy() for n, t in params_from_jax(jax.device_get(tree)).items()}


def _jax_run(cfg, tree, batches, lora, int8=False, parallel=None, fp16_scale=None):
    """The JAX step over ``batches`` (on one device, or sharded over
    ``parallel``'s mesh of host devices): metrics and the final params in
    the port's names."""
    lcfg = jc.LoRAConfig(**lora) if lora else None
    model = JaxLlama(cfg, lcfg)
    state = jax_create_state(jax.random.PRNGKey(0), model,
                             jax_build_optimizer(jc.OptimizerConfig(**OPT)), (W.BS, W.SEQ),
                             lora_enabled=lora is not None, init_fn=lambda r, x: tree,
                             fp16_initial_scale=fp16_scale)
    if int8:
        state = state.replace(params=jq.quantize_params_int8(state.params))
    if parallel is None:
        step = jax.jit(jax_make_step(model, accum_steps=W.ACCUM))
    else:
        config = jc.Config(model=cfg, lora=lcfg or jc.LoRAConfig(enabled=False),
                           optimizer=jc.OptimizerConfig(**OPT), parallel=parallel,
                           checkpoint=jc.CheckpointConfig(save_strategy="no"),
                           train=jc.TrainConfig(micro_batch_size=W.BS,
                                                grad_accum_steps=W.ACCUM,
                                                fp16=fp16_scale is not None))
        mesh = build_mesh(parallel, devices=jax.devices()[:parallel.num_devices])
        state = shard_train_state(state, config, mesh)
        step = make_sharded_train_step(model, state, config, mesh, accum_steps=W.ACCUM,
                                       donate=False)
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return metrics, _port_numpy(state.params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    setup, cases = {}, []
    for name, (preset, model, lora, int8) in RUNS.items():
        cfg = _cfg(preset, model)
        tree = _jax_tree(cfg, lora)
        batches = _batches(cfg.vocab_size, STEPS)
        params = _port_numpy(jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree))
                             if int8 else tree)
        setup[name] = dict(params=params, batches=batches,
                           ref=_jax_run(cfg, tree, batches, lora, int8))
    for mesh_name, (run, par) in MESHES.items():
        preset, model, lora, _ = RUNS[run]
        cases.append((mesh_name, "steps", dict(params=setup[run]["params"],
                                               batches=setup[run]["batches"], parallel=par,
                                               lora=lora, opt=OPT, model=model,
                                               preset=preset)))
    tiny = jc.MODEL_PRESETS["llama_tiny"]
    f16_tree = _jax_tree(dataclasses.replace(tiny, **FP16), LORA, fp16=True)
    f16_batches = _batches(tiny.vocab_size, FP16_STEPS, seed=8)
    cases.append(("data2_fsdp2_fp16", "steps", dict(
        params=_port_numpy(f16_tree), batches=f16_batches, parallel=FP16_MESH, lora=LORA,
        opt=OPT, model=FP16, fp16_scale=FP16_SCALE)))
    world = W.spawn_world(4, cases, str(tmp_path_factory.mktemp("zero3_steps")))
    fp16_par = jc.ParallelConfig(zero_stage=jc.ZeROStage.ZERO3, data=2, fsdp=2)
    fp16_ref = _jax_run(dataclasses.replace(tiny, **FP16), f16_tree, f16_batches, LORA,
                        parallel=fp16_par, fp16_scale=FP16_SCALE)
    return setup, world, fp16_ref


def _trained(got, lora):
    return {n for n in got["trainable"]} if lora is None else {
        n for n in got["trainable"] if n.endswith(("lora_a", "lora_b"))}


@pytest.mark.parametrize("name", list(MESHES))
def test_zero3_step_on_a_model_axis_matches_jax_single_device(runs, name):
    setup, world, _ = runs
    run, par = MESHES[name]
    lora = RUNS[run][2]
    got = world[0][name]
    want_metrics, want_params = setup[run]["ref"]
    assert len(got["metrics"]) == len(want_metrics) == STEPS
    keys = ["loss", "grad_norm"] + (["aux_loss"] if "aux_loss" in want_metrics[0] else [])
    for i, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name}: step {i + 1} {k}")
    # Every rank reports the same metrics.
    for rank_out in world[1:]:
        assert rank_out[name]["metrics"] == got["metrics"], name
    assert got["trainable"] and _trained(got, lora) == set(got["trainable"])
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, want_params[n], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: {n} diverged")
    # The leaves really split over fsdp: some leaf is held at half of what
    # its other axes leave this rank.
    shapes = got["shapes"]
    split = [n for n, (local, whole) in shapes.items()
             if np.prod(local) * 2 * par.get("tensor", 1) * par.get("expert", 1)
             <= np.prod(whole)]
    assert split, name


def test_zero3_fp16_on_a_mixed_mesh_takes_the_jax_sharded_decisions(runs):
    """fp16 at ``data 2 x fsdp 2`` from a loss scale of 2**14: the loss
    scales and overflow steps are the JAX sharded step's on the same mesh,
    some steps overflowing and some applying; losses, finite gradient
    norms and the LoRA factors within 2e-4."""
    _, world, (want, want_params) = runs
    got = world[0]["data2_fsdp2_fp16"]
    np.testing.assert_array_equal([[m[k] for k in sorted(m)] for m in got["metrics"]],
                                  [[m[k] for k in sorted(m)]
                                   for m in world[3]["data2_fsdp2_fp16"]["metrics"]])
    decisions = [(m["loss_scale"], m["overflow"]) for m in got["metrics"]]
    assert decisions == [(m["loss_scale"], m["overflow"]) for m in want]
    overflows = [m["overflow"] for m in want]
    assert 0 < sum(overflows) < len(overflows), overflows
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                               [m["loss"] for m in want], rtol=RTOL, atol=ATOL)
    for i, (g, w) in enumerate(zip(got["metrics"], want)):
        if not w["overflow"]:
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i + 1}")
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, want_params[n], rtol=RTOL, atol=ATOL, err_msg=n)
