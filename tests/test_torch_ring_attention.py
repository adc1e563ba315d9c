"""Sequence parallelism in the port, over gloo on the CPU, against the JAX
package.

The JAX package's contract (``tests/test_ring_attention.py:47-171``): ring
attention over the ``sequence`` axis equals dense attention, forward and
gradient, with custom positions, packed segments, a sliding window, both,
and composed with ``tensor`` and ``data``; a sequence-parallel train step
equals the single-device step. Here the port's ``ring_attention`` runs in
worlds of 2 and 4 spawned processes (``tests/torch_dist_worker.py``) and is
held to the JAX ``ring_attention`` on the CPU mesh at 1e-5 in float32, and
SP-2 and data 2 x SP-2 LoRA steps of ``llama_tiny`` (padded and packed rows)
to the JAX single-device step within 2e-4. With LoRA dropout the SP-2 step
equals the port's own single-device step (every rank draws the single-device
masks), ``cli.train --sequence 2`` runs under the launcher at one device's
loss, and each refused combination raises by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from conftest import make_packed_segments
from dlti_tpu import config as jc
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.parallel import build_mesh as jax_build_mesh
from dlti_tpu.parallel.ring_attention import ring_attention as jax_ring
from dlti_tpu.training import build_optimizer as jax_build_optimizer
from dlti_tpu.training import create_train_state as jax_create_state
from dlti_tpu.training import make_train_step as jax_make_step
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.parallel.mesh import Mesh, check_strategy, single_device_mesh
from dlti_tpu_torch.parallel.ring_attention import ring_attention

ATOL = RTOL = 1e-5
STEP_TOL = 2e-4
B, S, H, HK, D = 2, 32, 4, 2, 8
# name -> (world, parallel, keyword arguments): the JAX test's cases.
RING = {
    "causal": (2, dict(sequence=2), dict()),
    "full": (2, dict(sequence=2), dict(causal=False)),
    "positions": (2, dict(sequence=2), dict(positions="shifted")),
    "segments": (2, dict(sequence=2), dict(segment_ids="packed")),
    "window": (2, dict(sequence=2), dict(window=12)),
    "window_segments": (4, dict(sequence=4), dict(window=10, segment_ids="packed")),
    "grads": (2, dict(sequence=2), dict(w=True)),
    "causal_seq4": (4, dict(sequence=4), dict()),
    "grads_seq4": (4, dict(sequence=4), dict(w=True, segment_ids="packed")),
    "tensor2": (4, dict(tensor=2, sequence=2), dict(w=True)),
    "data2": (4, dict(data=2, sequence=2), dict(w=True)),
}
LORA, OPT = W.LORA, W.OPT
# name -> (world, parallel, packed rows, model overrides): SP LoRA steps
# against the JAX step (remat changes what the backward recomputes, not the
# numbers: the ring's recompute reuses the chunks its forward received).
STEPS = {
    "sequence2": (2, dict(sequence=2), False, {}),
    "sequence2_packed": (2, dict(sequence=2), True, {}),
    "sequence2_remat": (2, dict(sequence=2), False, dict(remat=True)),
    "sequence4_remat_packed": (4, dict(sequence=4), True, dict(remat=True)),
    "data2_sequence2": (4, dict(data=2, sequence=2), False, {}),
    "zero2_data2_sequence2": (4, dict(zero_stage=2, data=2, sequence=2), False, {}),
    "tensor2_sequence2": (4, dict(tensor=2, sequence=2), False, {}),
}
DROPOUT = dict(LORA, dropout=0.1)


def _qkv():
    rng = np.random.default_rng(11)
    return [rng.standard_normal((B, S, h, D)).astype(np.float32) for h in (H, HK, HK)]


def _kwargs(kw):
    out = dict(kw)
    if out.get("positions") == "shifted":
        out["positions"] = (np.arange(S, dtype=np.int32)[None] + 7).repeat(B, 0)
    if out.get("segment_ids") == "packed":
        out["segment_ids"] = np.asarray(make_packed_segments(B, S, n_docs=2, seed=3))
    if out.pop("w", False):
        out["w"] = np.random.default_rng(9).standard_normal((B, S, H, D)).astype(np.float32)
    return out


def _jax_ring(parallel, kw):
    q, k, v = (jnp.asarray(a) for a in _qkv())
    mesh = jax_build_mesh(jc.ParallelConfig(**parallel))
    args = {n: jnp.asarray(kw[n]) for n in ("positions", "segment_ids") if n in kw}
    args.update({n: kw[n] for n in ("causal", "window") if n in kw})
    out = jax.jit(lambda q, k, v: jax_ring(q, k, v, mesh, **args))(q, k, v)
    grads = None
    if "w" in kw:
        w = jnp.asarray(kw["w"])
        grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jax_ring(q, k, v, mesh, **args) * w),
                                 argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), grads and [np.asarray(g) for g in grads]


def _packed(batch):
    """The rows packed as the JAX pipeline packs them: 2-3 documents a row,
    per-document positions, segment ids, the packed loss mask."""
    from dlti_tpu.data.pipeline import packed_loss_mask, packed_positions

    a, b, s = batch["input_ids"].shape
    segs = np.stack([np.asarray(make_packed_segments(b, s, n_docs=2 + i % 2, seed=i))
                     for i in range(a)])
    flat = segs.reshape(a * b, s)
    return {"input_ids": np.where(segs > 0, batch["input_ids"], 0).astype(np.int32),
            "loss_mask": packed_loss_mask(flat).reshape(a, b, s).astype(np.int32),
            "segment_ids": segs.astype(np.int32),
            "positions": packed_positions(flat).reshape(a, b, s).astype(np.int32)}


def _jax_tree(cfg, lora, seed=0):
    tree = JaxLlama(cfg, jc.LoRAConfig(**lora)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def _jax_steps(cfg, tree, batches):
    model = JaxLlama(cfg, jc.LoRAConfig(**LORA))
    state = jax_create_state(jax.random.PRNGKey(0), model,
                             jax_build_optimizer(jc.OptimizerConfig(**OPT)), (W.BS, W.SEQ),
                             lora_enabled=True, init_fn=lambda r, x: tree)
    step = jax.jit(jax_make_step(model, accum_steps=W.ACCUM))
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return metrics, {n: t.numpy() for n, t in
                     params_from_jax(jax.device_get(state.params)).items()}


@pytest.fixture(scope="module")
def setup():
    cfg = jc.MODEL_PRESETS["llama_tiny"]
    tree = _jax_tree(cfg, LORA)
    rng = np.random.default_rng(7)
    shape = (W.ACCUM, W.BS, W.SEQ)
    batches = [{"input_ids": rng.integers(3, cfg.vocab_size, shape).astype(np.int32),
                "loss_mask": (rng.random(shape) > 0.3).astype(np.int32)} for _ in range(2)]
    packed = [_packed(b) for b in batches]
    params = {n: t.numpy() for n, t in params_from_jax(tree).items()}
    return {"params": params, "batches": batches, "packed": packed,
            "ref": _jax_steps(cfg, tree, batches), "ref_packed": _jax_steps(cfg, tree, packed)}


def _cases(setup, world):
    q, k, v = _qkv()
    cases = [(name, "ring", dict(q=q, k=k, v=v, parallel=par, **_kwargs(kw)))
             for name, (w, par, kw) in RING.items() if w == world]
    for name, (w, par, packed, model) in STEPS.items():
        if w == world:
            cases.append((name, "steps", dict(
                params=setup["params"], batches=setup["packed" if packed else "batches"],
                parallel=par, lora=LORA, opt=OPT, model=model)))
    cases += [(f"permute_{shift}", "permute", dict(shift=shift)) for shift in (1, -1, 2)]
    if world == 2:
        cases.append(("dropout", "steps", dict(params=setup["params"],
                                               batches=setup["batches"],
                                               parallel=dict(sequence=2), lora=DROPOUT,
                                               opt=OPT, seed=5)))
        cases += [(f"cli_{n}", "cli_mesh", dict(argv=argv))
                  for n, (argv, _) in REFUSED_ARGV.items()]
    return cases


REFUSED_ARGV = {  # cli.train argv on a world of 2 -> what it names (None: runs)
    "zero3": (["--preset", "zero3", "--sequence", "2"], None),
    "offload": (["--preset", "zero2", "--sequence", "2", "--offload-optimizer"],
                "sequence x offload"),
    "expert": (["--model", "mixtral_tiny", "--sequence", "2", "--expert", "2",
                "--num-devices", "1"], "sequence x expert"),
}


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    return {w: W.spawn_world(w, _cases(setup, w), str(tmp)) for w in (2, 4)}


@pytest.mark.parametrize("name", list(RING))
def test_ring_matches_the_jax_ring(worlds, name):
    world, par, kw = RING[name]
    kw = _kwargs(kw)
    out, grads = _jax_ring(par, kw)
    for rank_out in worlds[world]:
        got = rank_out[name]
        np.testing.assert_allclose(got["out"], out, rtol=RTOL, atol=ATOL, err_msg=name)
        for g, want, which in zip(got.get("grads") or [], grads or [], "qkv"):
            np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name}: d{which}")
    if "segment_ids" in kw:  # padding rows come out zero
        pad = kw["segment_ids"] == 0
        assert pad.any() and not worlds[world][0][name]["out"][pad].any()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("shift", [1, -1, 2])
def test_permute_is_ppermute_and_its_transpose(worlds, world, shift):
    """``parallel.tensor.permute``: rank ``r``'s tensor reaches rank ``r +
    shift`` (``jax.lax.ppermute``'s pairs), and its gradient comes back from
    there (the transpose, the reverse permute)."""
    for rank, rank_out in enumerate(worlds[world]):
        got = rank_out[f"permute_{shift}"]
        assert got["got"] == [float((rank - shift) % world + 1)] * 3
        assert got["grad"] == [float(i + 10 * ((rank + shift) % world)) for i in range(3)]


def test_sequence_one_is_plain_attention_and_an_indivisible_length_raises():
    from dlti_tpu.ops.attention import reference_attention as jax_reference

    q, k, v = _qkv()
    segs = np.asarray(make_packed_segments(B, S, n_docs=2, seed=3))
    got = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         single_device_mesh("cpu"), segment_ids=torch.from_numpy(segs.copy()),
                         window=12)
    want = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                         segment_ids=jnp.asarray(segs), window=12)
    valid = segs[:, :, None, None] != 0
    np.testing.assert_allclose(got.numpy() * valid, np.asarray(want) * valid,
                               rtol=RTOL, atol=ATOL)
    mesh = Mesh(parallel=tc.ParallelConfig(sequence=4), world=4, rank=0,
                device=torch.device("cpu"))
    short = [torch.from_numpy(a[:, :30]) for a in (q, k, v)]
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(*short, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        jax_ring(*(jnp.asarray(a[:, :30]) for a in (q, k, v)),
                 jax_build_mesh(jc.ParallelConfig(sequence=4)))


def _assert_matches(got, ref, name):
    want_metrics, want_params = ref
    assert len(got["metrics"]) == len(want_metrics) == 2
    for i, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        for key in ("loss", "grad_norm", "num_tokens"):
            np.testing.assert_allclose(g[key], w[key], rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"{name}: step {i + 1} {key}")
    assert got["trainable"]
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, want_params[n], rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=f"{name}: {n} diverged")


@pytest.mark.parametrize("name", list(STEPS))
def test_sequence_parallel_step_matches_jax_single_device(worlds, setup, name):
    world, _, packed, _ = STEPS[name]
    _assert_matches(worlds[world][0][name], setup["ref_packed" if packed else "ref"], name)


def test_dropout_masks_are_the_single_device_masks(worlds, setup):
    one = W.steps(setup["params"], setup["batches"], {}, lora=DROPOUT, opt=OPT, seed=5)
    got = worlds[2][0]["dropout"]
    for g, w in zip(got["metrics"], one["metrics"]):
        np.testing.assert_allclose([g["loss"], g["grad_norm"]], [w["loss"], w["grad_norm"]],
                                   rtol=STEP_TOL, atol=STEP_TOL)
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, one["trainable"][n], rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=n)
    assert abs(got["metrics"][0]["loss"] - setup["ref"][0][0]["loss"]) > 1e-4


def test_sequence_axis_refusals(worlds):
    """What the port does not run with sequence parallelism raises by name
    (``NotImplementedError`` naming ROADMAP.md); ``loss_chunk`` raises the
    reference's ``ValueError``."""
    from dlti_tpu_torch.training.trainer import Trainer, check_model_axes

    P = tc.ParallelConfig
    # ZeRO-3 shards over its own fsdp axis beside the sequence one (the
    # steps are held to JAX's in tests/test_torch_zero3_steps.py).
    check_strategy(P(zero_stage=tc.ZeROStage.ZERO3, fsdp=2, sequence=2))
    for par, match in [(dict(zero_stage=tc.ZeROStage.ZERO1, sequence=2,
                             offload_optimizer=True), "sequence x offload"),
                       (dict(sequence=2, pipe=2), "pipe x sequence"),
                       (dict(sequence=2, expert=2), "sequence x expert")]:
        with pytest.raises(NotImplementedError, match=f"{match}.*ROADMAP.md"):
            check_strategy(P(**par))
    cfg = tc.Config(model=tc.MODEL_PRESETS["llama_tiny"], parallel=P(sequence=2),
                    checkpoint=tc.CheckpointConfig(save_strategy="no"),
                    train=tc.TrainConfig(loss_chunk=16))
    with pytest.raises(ValueError, match="loss_chunk does not compose with sequence"):
        check_model_axes(cfg)
    with pytest.raises(ValueError, match="loss_chunk does not compose with sequence"):
        Trainer(cfg, device="cpu")
    moe = cfg.replace(model=tc.MODEL_PRESETS["mixtral_tiny"], train=tc.TrainConfig())
    with pytest.raises(NotImplementedError, match="mixture of experts.*ROADMAP.md"):
        check_model_axes(moe)
    for rank_out in worlds[2]:
        for name, (_, match) in REFUSED_ARGV.items():
            err = rank_out[f"cli_{name}"]["error"]
            if match is None:  # --preset zero3 --sequence 2 on 2 ranks: fsdp 1, ZeRO-3
                assert err is None and rank_out[f"cli_{name}"]["zero_stage"] == 3, (name, err)
            else:
                assert err is not None and err.startswith("NotImplementedError") \
                    and match in err, (name, err)


def test_cli_train_sequence2_under_the_launcher(tmp_path):
    """``launcher --num-processes 2 -- cli.train --sequence 2``: a world of
    2 at a batch extent of 1, at one device's loss."""
    import socket

    from test_torch_tp_training import _cli_train

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = _cli_train(tmp_path, "sp", ["--num-processes", "2", "--port", str(port)],
                     ["--sequence", "2"])
    want = _cli_train(tmp_path, "one")
    assert (got["world"], got["strategy"]) == (2, "baseline")
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=STEP_TOL)
