"""fp16 data parallelism in the port against the JAX package's sharded fp16
step, near the overflow threshold.

The JAX package's sharded step (``make_sharded_train_step`` on a 2-device
mesh of the 8 simulated CPU devices, ``tests/conftest.py``) sums each
microbatch's float16 partial products over the devices in float16: when the
whole batch's gradient passes float16's range it overflows on every device,
as on one device, and the dynamic loss scaler skips that step. The port's
world of 2 (gloo, ``tests/torch_dist_worker.py``) must take the same
decisions: from a loss scale of 2**14, where a rank's half of the rows stays
finite while the whole batch overflows at step 3, the loss scales and
overflow steps equal the JAX sharded step's (and the JAX single device's);
losses, finite gradient norms and the LoRA factors agree within rtol/atol
2e-4, the tolerance of the port's other data-parallel tests.

Setup as ``tests/test_torch_zero.py``: ``llama_tiny`` in float16 (LoRA
factors float32), LoRA r 4, micro-batch 8 x accum 2, seq 32, 8 steps of
numpy batches (seed 8), weights from the JAX init plus numpy noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as W
from dlti_tpu import config as jc
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.parallel import build_mesh, make_sharded_train_step, shard_train_state
from dlti_tpu.training import build_optimizer, create_train_state, make_train_step
from dlti_tpu_torch.models import params_from_jax

RTOL = ATOL = 2e-4
SCALE = 2.0 ** 14
STEPS = 8
FP16 = dict(dtype="float16", param_dtype="float16")
TINY = jc.MODEL_PRESETS["llama_tiny"]
STRATEGIES = {  # name -> (the JAX mesh's ParallelConfig, the port's parallel dict)
    "zero1": (jc.ParallelConfig(zero_stage=jc.ZeROStage.ZERO1, data=2),
              dict(zero_stage=1, data=2)),
    "zero3": (jc.ParallelConfig(zero_stage=jc.ZeROStage.ZERO3, fsdp=2),
              dict(zero_stage=3, fsdp=2)),
}


def _tree(seed=0):
    """JAX init plus numpy noise; the base in float16, LoRA factors float32
    (the port's fp16 state holds the same leaves)."""
    lora = jc.LoRAConfig(**W.LORA)
    tree = JaxLlama(TINY, lora).init(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    noisy = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))

    def cast(path, a):
        lora_leaf = str(getattr(path[-1], "key", path[-1])) in ("lora_a", "lora_b")
        return a.astype(np.float32 if lora_leaf else np.float16)

    return jax.tree_util.tree_map_with_path(cast, noisy)


def _batches(n, seed=8):
    rng = np.random.default_rng(seed)
    shape = (W.ACCUM, W.BS, W.SEQ)
    return [{"input_ids": rng.integers(3, TINY.vocab_size, shape).astype(np.int32),
             "loss_mask": (rng.random(shape) > 0.3).astype(np.int32)} for _ in range(n)]


def _jax_run(tree, batches, parallel=None):
    """The JAX fp16 step from ``SCALE`` over ``batches``, on one device or
    sharded over ``parallel``'s mesh; metrics and the final LoRA leaves (port
    names)."""
    mcfg = dataclasses.replace(TINY, **FP16)
    lora = jc.LoRAConfig(**W.LORA)
    cfg = jc.Config(model=mcfg, lora=lora, optimizer=jc.OptimizerConfig(**W.OPT),
                    parallel=parallel or jc.ParallelConfig(),
                    checkpoint=jc.CheckpointConfig(save_strategy="no"),
                    train=jc.TrainConfig(micro_batch_size=W.BS, grad_accum_steps=W.ACCUM,
                                         fp16=True))
    model = JaxLlama(mcfg, lora)
    state = create_train_state(jax.random.PRNGKey(0), model, build_optimizer(cfg.optimizer),
                               (W.BS, W.SEQ), lora_enabled=True, init_fn=lambda r, x: tree,
                               fp16_initial_scale=SCALE)
    if parallel is None:
        step = jax.jit(make_train_step(model, accum_steps=W.ACCUM))
    else:
        mesh = build_mesh(cfg.parallel)
        state = shard_train_state(state, cfg, mesh)
        step = make_sharded_train_step(model, state, cfg, mesh, accum_steps=W.ACCUM,
                                       donate=False)
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    params = params_from_jax(jax.device_get(state.params))
    return metrics, {n: t.numpy() for n, t in params.items()
                     if n.endswith(("lora_a", "lora_b"))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree, batches = _tree(), _batches(STEPS)
    params = {n: t.numpy() for n, t in params_from_jax(tree).items()}
    cases = [(name, "steps", dict(params=params, batches=batches, parallel=port_par,
                                  lora=W.LORA, model=FP16, fp16_scale=SCALE))
             for name, (_, port_par) in STRATEGIES.items()]
    port = W.spawn_world(2, cases, str(tmp_path_factory.mktemp("fp16")))
    return {"one": _jax_run(tree, batches),
            "jax": {name: _jax_run(tree, batches, jax_par)
                    for name, (jax_par, _) in STRATEGIES.items()},
            "port": port}


def _decisions(metrics):
    return [(m["loss_scale"], m["overflow"]) for m in metrics]


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_jax_sharded_fp16_step_takes_the_single_device_decisions(runs, name):
    """The reference: its 2-device step overflows where one device does,
    and from 2**14 it both overflows and applies steps (the band where a
    half batch's partial sums stay finite while the whole batch's do not)."""
    one, _ = runs["one"]
    sharded, _ = runs["jax"][name]
    assert _decisions(sharded) == _decisions(one)
    overflows = [m["overflow"] for m in one]
    assert 0 < sum(overflows) < len(overflows), overflows


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_port_world_2_fp16_matches_jax_sharded_step(runs, name):
    want, want_lora = runs["jax"][name]
    got = runs["port"][0][name]
    # Every rank takes the same decisions (NaN-aware equality of all metrics).
    np.testing.assert_array_equal([[m[k] for k in sorted(m)] for m in got["metrics"]],
                                  [[m[k] for k in sorted(m)]
                                   for m in runs["port"][1][name]["metrics"]])
    assert _decisions(got["metrics"]) == _decisions(want)
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                               [m["loss"] for m in want], rtol=RTOL, atol=ATOL)
    for i, (g, w) in enumerate(zip(got["metrics"], want)):
        if not w["overflow"]:
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name}: step {i + 1}")
    assert got["trainable"].keys() == want_lora.keys()
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, want_lora[n], rtol=RTOL, atol=ATOL, err_msg=n)
