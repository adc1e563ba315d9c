"""Pipeline parallelism in the port, over gloo on the CPU, against the JAX
package.

The JAX package's contract (``tests/test_pipeline.py:59-1027``): the stacked
layout round-trips, ``pipeline_param_shardings`` places each stacked leaf
over ``pipe`` (and ``tensor``/``expert`` by the flat rules shifted one dim),
``pipeline_forward`` is the unpipelined model's function whatever the
microbatch count, and the pipelined train step equals the single-device
step alone and with ``data`` (ZeRO-1/2), ``tensor`` and ``expert``, under
the fp16 scaler, on an int8 base, with ``loss_chunk`` and on packed rows.
Here the port's stages run in worlds of 2 and 4 spawned processes
(``tests/torch_dist_worker.py``): every PP-2 step is held to JAX's
``make_pipeline_train_step`` on a pipe-2 mesh and to the JAX single-device
step within 2e-4; with LoRA dropout a PP-2 step equals the port's own
single-device step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from conftest import make_packed_segments
from dlti_tpu import config as jc
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.models import quantization as jq
from dlti_tpu.parallel import build_mesh as jax_build_mesh
from dlti_tpu.parallel import pipeline as jp
from dlti_tpu.training import build_optimizer as jax_build_optimizer
from dlti_tpu.training import create_train_state as jax_create_state
from dlti_tpu.training import make_train_step as jax_make_step
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.models import load_model, params_from_jax
from dlti_tpu_torch.models.llama import LlamaForCausalLM
from dlti_tpu_torch.parallel import pipeline as tp
from dlti_tpu_torch.parallel.mesh import Mesh

TOL = 2e-4
FWD_TOL = 1e-5
ACCUM, BS, SEQ = 4, 4, W.SEQ
STEPS = 2
LORA, OPT = W.LORA, W.OPT
WIDE = dict(hidden_size=128, intermediate_size=256)  # the int8 base quantizes projections
F16 = dict(dtype="float16", param_dtype="float16")
F16_SCALE = 2.0 ** 8
CHUNK = 8
# name -> (preset, model overrides, LoRA, int8 base, fp16 scale, loss_chunk, packed)
RUNS = {
    "lora": ("llama_tiny", {}, LORA, False, None, 0, False),
    "full": ("llama_tiny", {}, None, False, None, 0, False),
    "moe": ("mixtral_tiny", {}, LORA, False, None, 0, False),
    "fp16": ("llama_tiny", F16, LORA, False, F16_SCALE, 0, False),
    "int8_base": ("llama_tiny", WIDE, LORA, True, None, 0, False),
    "loss_chunk": ("llama_tiny", {}, LORA, False, None, CHUNK, False),
    "packed": ("llama_tiny", {}, LORA, False, None, 0, True),
    "remat": ("llama_tiny", dict(remat=True), LORA, False, None, 0, False),
}
# name -> (world, parallel, run): the PP-2 steps.
MESHES = {
    **{f"pipe2_{run}": (2, dict(pipe=2), run) for run in RUNS if run != "moe"},
    "zero1_pipe2_data2": (4, dict(zero_stage=1, pipe=2, data=2), "lora"),
    "zero2_pipe2_data2": (4, dict(zero_stage=2, pipe=2, data=2), "lora"),
    "pipe2_tensor2": (4, dict(pipe=2, tensor=2), "lora"),
    "pipe2_expert2_moe": (4, dict(pipe=2, expert=2), "moe"),
    "pipe2_data2_moe": (4, dict(pipe=2, data=2), "moe"),
}
DROPOUT = dict(LORA, dropout=0.1)
MICROBATCHES = (1, 2, 4)


def _jcfg(preset, model):
    return dataclasses.replace(jc.MODEL_PRESETS[preset], **model)


def _jax_tree(cfg, lora, seed=0):
    tree = JaxLlama(cfg, jc.LoRAConfig(**lora) if lora else None).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def _batches(vocab, packed, seed=7):
    from dlti_tpu.data.pipeline import packed_loss_mask, packed_positions

    rng = np.random.default_rng(seed)
    shape = (ACCUM, BS, SEQ)
    out = []
    for i in range(STEPS):
        ids = rng.integers(3, vocab, shape).astype(np.int32)
        if not packed:
            out.append({"input_ids": ids,
                        "loss_mask": (rng.random(shape) > 0.3).astype(np.int32)})
            continue
        segs = np.asarray(make_packed_segments(ACCUM * BS, SEQ, n_docs=2, seed=i + 3))
        out.append({"input_ids": np.where(segs > 0, ids.reshape(-1, SEQ), 0).reshape(shape),
                    "loss_mask": packed_loss_mask(segs).reshape(shape).astype(np.int32),
                    "segment_ids": segs.reshape(shape).astype(np.int32),
                    "positions": packed_positions(segs).reshape(shape).astype(np.int32)})
    return out


def _to_port(tree):
    return {n: t.numpy() for n, t in params_from_jax(jax.device_get(tree)).items()}


def _state(cfg, tree, lora, int8, scale):
    model = JaxLlama(cfg, jc.LoRAConfig(**lora) if lora else None)
    tx = jax_build_optimizer(jc.OptimizerConfig(**OPT))
    state = jax_create_state(jax.random.PRNGKey(0), model, tx, (BS, SEQ),
                             lora_enabled=lora is not None, init_fn=lambda r, x: tree,
                             fp16_initial_scale=scale)
    if int8:
        state = state.replace(params=jq.quantize_params_int8(state.params))
    return model, tx, state


def _jax_single(cfg, tree, batches, lora, int8, scale, chunk):
    model, _, state = _state(cfg, tree, lora, int8, scale)
    step = jax.jit(jax_make_step(model, accum_steps=ACCUM, loss_chunk=chunk))
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return metrics, _to_port(state.params)


def _jax_pipe(cfg, tree, batches, lora, int8, scale, chunk):
    """JAX's ``make_pipeline_train_step`` on a pipe-2 mesh, from the same
    state, on the flattened batches; params back in the flat layout."""
    _, tx, state = _state(cfg, tree, lora, int8, scale)
    mesh = jax_build_mesh(jc.ParallelConfig(pipe=2))
    jcfg = jc.Config(model=cfg, lora=jc.LoRAConfig(**lora) if lora else jc.LoRAConfig(
        enabled=False), optimizer=jc.OptimizerConfig(**OPT), parallel=jc.ParallelConfig(pipe=2),
        train=jc.TrainConfig(micro_batch_size=BS, grad_accum_steps=ACCUM, loss_chunk=chunk),
        checkpoint=jc.CheckpointConfig(save_strategy="no"))
    state = jp.to_pipeline_state(state, cfg.num_layers)
    sh = jp.pipeline_param_shardings(state.params, mesh)
    state = state.replace(params=jax.tree_util.tree_map(jax.device_put, state.params, sh))
    step = jp.make_pipeline_train_step(jcfg, tx, mesh, num_microbatches=ACCUM)
    metrics = []
    for i, b in enumerate(batches):
        flat = {k: jnp.asarray(v.reshape((-1,) + v.shape[2:])) for k, v in b.items()}
        state, m = step(state, flat, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return metrics, _to_port(jp.from_pipeline_params(state.params, cfg.num_layers))


@pytest.fixture(scope="module")
def setup():
    out = {}
    for name, (preset, model, lora, int8, scale, chunk, packed) in RUNS.items():
        cfg = _jcfg(preset, model)
        tree = _jax_tree(cfg, lora)
        batches = _batches(cfg.vocab_size, packed)
        params = (_to_port(jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree)))
                  if int8 else _to_port(tree))
        args = (cfg, tree, batches, lora, int8, scale, chunk)
        out[name] = dict(params=params, batches=batches, single=_jax_single(*args),
                         pipe=_jax_pipe(*args))
    lora = out["lora"]
    ids = lora["batches"][0]["input_ids"].reshape(-1, SEQ)
    out["forward"] = dict(ids=ids, tree=_jax_tree(_jcfg("llama_tiny", {}), None, seed=3))
    return out


def _cases(setup, world):
    cases = []
    for name, (w, par, run) in MESHES.items():
        if w != world:
            continue
        preset, model, lora, _, scale, chunk, _ = RUNS[run]
        r = setup[run]
        cases.append((name, "steps", dict(params=r["params"], batches=r["batches"],
                                          parallel=par, lora=lora, opt=OPT, model=model,
                                          preset=preset, fp16_scale=scale, accum=ACCUM,
                                          loss_chunk=chunk)))
    if world == 2:
        r = setup["lora"]
        cases.append(("dropout", "steps", dict(params=r["params"], batches=r["batches"],
                                               parallel=dict(pipe=2), lora=DROPOUT, opt=OPT,
                                               seed=5, accum=ACCUM)))
        cases.append(("pipe_state", "pipe_state", dict(params=r["params"],
                                                       batches=r["batches"], lora=LORA,
                                                       opt=OPT, accum=ACCUM)))
        fwd = setup["forward"]
        packed = setup["packed"]["batches"][0]
        for m in MICROBATCHES:
            cases.append((f"forward_{m}", "pipe_forward", dict(
                params=_to_port(fwd["tree"]), ids=fwd["ids"], num_microbatches=m)))
        cases.append(("forward_packed", "pipe_forward", dict(
            params=_to_port(fwd["tree"]), ids=packed["input_ids"].reshape(-1, SEQ),
            num_microbatches=2, segment_ids=packed["segment_ids"].reshape(-1, SEQ),
            positions=packed["positions"].reshape(-1, SEQ))))
    return cases


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    return {w: W.spawn_world(w, _cases(setup, w), str(tmp)) for w in (2, 4)}


def _assert_matches(got, ref, name):
    want_metrics, want_params = ref
    assert len(got["metrics"]) == len(want_metrics) == STEPS
    for i, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        keys = ("loss", "grad_norm") + tuple(k for k in ("aux_loss", "loss_scale") if k in w)
        for key in keys:
            np.testing.assert_allclose(g[key], w[key], rtol=TOL, atol=TOL,
                                       err_msg=f"{name}: step {i + 1} {key}")
    assert got["trainable"]
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, want_params[n], rtol=TOL, atol=TOL,
                                   err_msg=f"{name}: {n} diverged")


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("ref", ["pipe", "single"])
def test_pipelined_step_matches_jax(worlds, setup, name, ref):
    """Each PP-2 composition against JAX's pipelined step and its
    single-device step, every stage reporting the same metrics."""
    world, _, run = MESHES[name]
    _assert_matches(worlds[world][0][name], setup[run][ref], f"{name} vs JAX {ref}")
    for rank_out in worlds[world][1:]:
        assert rank_out[name]["metrics"] == worlds[world][0][name]["metrics"]


def test_a_stage_holds_its_layers(worlds):
    """Every rank of a pipe-2 world holds half the layers under local names."""
    layers = tc.MODEL_PRESETS["llama_tiny"].num_layers
    for rank_out in worlds[2]:
        shapes = rank_out["pipe2_lora"]["shapes"]
        assert {int(n.split(".")[2]) for n in shapes if n.startswith("model.layers.")} == set(
            range(layers // 2))


def test_to_pipeline_state_steps_as_the_stage_built_state(worlds):
    """A whole one-device state turned into a stage's by
    ``to_pipeline_state`` (optimizer state made anew) steps as the state
    the trainer builds for the stage."""
    for rank_out in worlds[2]:
        got = rank_out["pipe_state"]
        assert got["layers"] == tc.MODEL_PRESETS["llama_tiny"].num_layers // 2
        assert got["metrics"] == rank_out["pipe2_lora"]["metrics"]


def test_dropout_masks_are_the_single_device_masks(worlds, setup):
    r = setup["lora"]
    one = W.steps(r["params"], r["batches"], {}, lora=DROPOUT, opt=OPT, seed=5, accum=ACCUM)
    got = worlds[2][0]["dropout"]
    for g, w in zip(got["metrics"], one["metrics"]):
        np.testing.assert_allclose([g["loss"], g["grad_norm"]], [w["loss"], w["grad_norm"]],
                                   rtol=TOL, atol=TOL)
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, one["trainable"][n], rtol=TOL, atol=TOL, err_msg=n)
    assert abs(got["metrics"][0]["loss"] - r["single"][0][0]["loss"]) > 1e-4


@pytest.mark.parametrize("m", MICROBATCHES)
def test_pipeline_forward_matches_jax_and_the_unpipelined_model(worlds, setup, m):
    """Rank 0's logits equal JAX's ``pipeline_forward`` on a pipe-2 mesh and
    the port's unpipelined model, whatever the microbatch count."""
    fwd = setup["forward"]
    cfg = _jcfg("llama_tiny", {})
    mesh = jax_build_mesh(jc.ParallelConfig(pipe=2))
    pparams = jp.to_pipeline_params(jax.tree_util.tree_map(jnp.asarray, fwd["tree"]),
                                    cfg.num_layers)
    want = np.asarray(jp.pipeline_forward(pparams, jnp.asarray(fwd["ids"]), cfg, mesh,
                                          num_microbatches=m))
    flat = load_model(tc.MODEL_PRESETS["llama_tiny"],
                      {n: torch.from_numpy(a) for n, a in _to_port(fwd["tree"]).items()},
                      "cpu")
    with torch.no_grad():
        unpiped = flat(torch.from_numpy(fwd["ids"])).numpy()
    got = worlds[2][0][f"forward_{m}"]
    assert got["layers"] == cfg.num_layers // 2
    np.testing.assert_allclose(got["logits"], want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got["logits"], unpiped, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(worlds[2][1][f"forward_{m}"]["logits"], got["logits"],
                               rtol=0, atol=0)


def test_pipeline_forward_on_packed_rows_matches_the_unpipelined_model(worlds, setup):
    fwd, packed = setup["forward"], setup["packed"]["batches"][0]
    flat = load_model(tc.MODEL_PRESETS["llama_tiny"],
                      {n: torch.from_numpy(a) for n, a in _to_port(fwd["tree"]).items()},
                      "cpu")
    t = lambda k: torch.from_numpy(packed[k].reshape(-1, SEQ).copy())  # noqa: E731
    with torch.no_grad():
        want = flat(t("input_ids"), positions=t("positions"), segment_ids=t("segment_ids"))
    np.testing.assert_allclose(worlds[2][0]["forward_packed"]["logits"], want.numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_pipeline_forward_raises_on_indivisible_stages_and_microbatches():
    cfg = tc.MODEL_PRESETS["llama_tiny"]
    with pytest.raises(ValueError, match="must divide into pipe=3 stages"):
        LlamaForCausalLM(cfg, device="meta", stage=(0, 3))
    with pytest.raises(ValueError, match="must divide into pipe=3 stages"):
        tp.stage_params({}, 0, 3, cfg.num_layers)
    model = LlamaForCausalLM(cfg, device="meta", stage=(0, 2))
    mesh = Mesh(parallel=tc.ParallelConfig(pipe=2), world=2, rank=0,
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide by microbatches"):
        tp.pipeline_forward(model, torch.zeros((3, 8), dtype=torch.long), mesh,
                            num_microbatches=2)
    jcfg = dataclasses.replace(_jcfg("llama_tiny", {}), num_layers=3)
    with pytest.raises(ValueError, match="stages"):
        jp.pipeline_forward({}, jnp.zeros((4, 8), jnp.int32), jcfg,
                            jax_build_mesh(jc.ParallelConfig(pipe=2)))


@pytest.mark.parametrize("run", ["lora", "int8_base", "moe"])
def test_layout_round_trip_and_placement_equal_jax(setup, run):
    """``to_pipeline_params`` stacks as JAX's does (same names, values),
    ``from_pipeline_params`` inverts it, and each leaf's placement under
    pipe, pipe x tensor and pipe x expert is JAX's
    ``pipeline_param_shardings``'s spec."""
    preset, model, lora, int8, _, _, _ = RUNS[run]
    cfg = _jcfg(preset, model)
    tree = _jax_tree(cfg, lora)
    if int8:
        tree = jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    flat = {n: torch.from_numpy(a) for n, a in _to_port(tree).items()}
    stacked = tp.to_pipeline_params(flat, cfg.num_layers)
    jstacked = jp.to_pipeline_params(jax.tree_util.tree_map(jnp.asarray, tree), cfg.num_layers)
    want = _to_port(jstacked)
    assert sorted(stacked) == sorted(want)
    for n, t in stacked.items():
        np.testing.assert_array_equal(t.numpy(), want[n], err_msg=n)
    back = tp.from_pipeline_params(stacked, cfg.num_layers)
    assert sorted(back) == sorted(flat)
    assert all(torch.equal(back[n], flat[n]) for n in flat)
    shapes = {n: tuple(t.shape) for n, t in stacked.items()}
    for par in (dict(pipe=2), dict(pipe=2, tensor=2), dict(pipe=2, expert=2)):
        mesh = jax_build_mesh(jc.ParallelConfig(**par))
        sh = jp.pipeline_param_shardings(jstacked, mesh)
        specs = {".".join(str(k.key) for k in path): tuple(s.spec)
                 for path, s in jax.tree_util.tree_flatten_with_path(sh)[0]}
        got = tp.pipeline_param_placement(shapes, tensor=par.get("tensor", 1),
                                          expert=par.get("expert", 1))
        for n, spec in specs.items():
            spec = tuple(spec) + (None,) * (len(shapes[n]) - len(spec))
            assert got[n] == spec, (run, par, n, got[n], spec)
