"""The port's fp16 path against the JAX package (``llama_tiny``, CPU, shared
weights through ``params_from_jax``, inputs from numpy seeds).

* The kernels' plain versions in float16: flash attention forward and
  backward against the Pallas kernel in interpret mode (causal, GQA, window,
  packed), and paged decode on float16 pools with float16 and bfloat16
  queries. Both sides compute in float32 and round their outputs to the
  inputs' type, so they may land one step of it apart: flash within
  ``chip_smoke.py``'s float16 limit (atol 1e-3, rtol 2**-10), decode within
  one step of the query's type below |x| = 4 (2**-9 float16, 2**-6 bf16).
* The forward of a float16 model, block by block: RMSNorm, RoPE, SwiGLU,
  the residual adds and the dropout's scaling run in float16 where the JAX
  model runs them in float16, so each block's output agrees to a few
  float16 steps of its scale (``F16_BLOCK_RTOL``). RoPE, RMSNorm and the
  dropout's scaling are bit-equal: flax divides kept elements by ``1 -
  rate`` rounded to float16, and so does the port (dividing by the float
  ``1 - rate`` put 29% of the kept elements one float16 step off).
* The dynamic loss scaler on float32 models, exactly against the JAX step
  (``tests/test_fp16_and_offload.py``'s cases on the port's side): its
  initial state, growth after ``scale_window`` good steps, a poisoned LoRA
  factor absorbed by the hysteresis and then halving the scale with the
  parameters and moments untouched, the scaled step equal to the unscaled
  one, and the scaler through a checkpoint.
* The JAX ``Trainer`` and the port's with ``train.fp16`` on a float16
  ``llama_tiny`` from 2**16, where its first steps overflow, at
  ``steps_per_sync`` 1 and 4: the same loss scales and skipped steps, losses
  within ``F16_LOSS_RTOL``; a k=4 fp16 run stopped mid-window and resumed
  equals the uninterrupted one bit for bit, scaler included. (Float16
  checkpoints with the scaler cross between the packages bit for bit in
  ``tests/test_torch_checkpoint.py``'s float16 cases.)
* ``cli.train --fp16`` -> ``cli.export --fp16`` -> ``load_exported_model``
  -> the port's engine on a float16 pool gives the JAX engine's greedy
  tokens on the same export; and what the JAX package's export script does
  with such a checkpoint: it builds its template from the float32 (or bf16)
  preset and adds only the scaler, so it refuses the float16 base.
"""

import dataclasses
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_packed_segments
from dlti_tpu import config as jc
from dlti_tpu.checkpoint import export as jexport
from dlti_tpu.checkpoint import store as jstore
from dlti_tpu.data import make_batches as jax_make_batches
from dlti_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from dlti_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention,
)
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu.training.optimizer import build_optimizer as jax_build_optimizer
from dlti_tpu.training.state import create_train_state as jax_create_state
from dlti_tpu.training.step import make_train_step as jax_make_step
from dlti_tpu.training.trainer import Trainer as JaxTrainer
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.checkpoint import load_exported_model, store
from dlti_tpu_torch.cli import export as export_cli
from dlti_tpu_torch.cli import serve as serve_cli
from dlti_tpu_torch.cli import train as train_cli
from dlti_tpu_torch.models import load_model, params_from_jax
from dlti_tpu_torch.models.lora import is_lora_name
from dlti_tpu_torch.ops import flash_attention as tfa
from dlti_tpu_torch.ops import paged_attention as tpa
from dlti_tpu_torch.serving import SamplingParams
from dlti_tpu_torch.training import (
    Trainer, build_optimizer, create_train_state, make_train_step,
)
from dlti_tpu_torch.training.state import load_state_leaves, state_leaves
from test_torch_export import ENGINE, PROMPTS
from test_torch_export import _params as _export_params
from test_torch_train_window import _dataset, _jax_params, _StopAt, _texts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LORA = dict(r=4, alpha=8, dropout=0.0)
ACCUM, BS, SEQ = 2, 2, 32
# chip_smoke.py's FLASH_TOL["float16"]: rtol one float16 step, atol the
# float32 sums' order near zero.
FLASH_F16 = dict(atol=1e-3, rtol=2.0 ** -10)
# One step of the output's type below |x| = 4.
DECODE_ATOL = {torch.float16: 2.0 ** -9, torch.bfloat16: 2.0 ** -6}
# A float16 block's output against the JAX block's, relative to the
# output's largest |x|: the two frameworks sum each float16 matmul in their
# own order before rounding, a few float16 steps (2**-11 relative each)
# after two blocks. Read: 1.0e-3 and 1.3e-3 (blocks), 1.1e-3 (logits).
F16_BLOCK_RTOL = 4e-3
# Losses of the two Trainers in float16: the same steps skipped, the same
# scales, and losses that drift apart by the rounding above as the LoRA
# factors move. Read: 4.7e-6 relative over 10 steps, at k 1 and 4.
F16_LOSS_RTOL = 1e-4
# Greedy decode logprobs of the two engines on one float16 export. Read:
# 5.0e-4.
F16_LOGPROB_ATOL = 5e-3


def _f16(shape, rng, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float16)


# ----------------------------------------------------------------------
# The kernels' plain versions in float16
# ----------------------------------------------------------------------

FLASH_CASES = {
    "causal": dict(h=4, hkv=4),
    "gqa": dict(h=8, hkv=2),
    "window": dict(h=4, hkv=2, window=40),
    "packed": dict(h=4, hkv=2, segments=True),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_float16_matches_pallas_interpret(case):
    """o, dq, dk and dv of the port's plain flash version against the
    Pallas kernel in interpret mode, float16 in and out."""
    c = FLASH_CASES[case]
    rng = np.random.default_rng(11)
    b, s, d = 1, 128, 64
    q, k, v, do = (_f16(shape, rng) for shape in (
        (b, s, c["h"], d), (b, s, c["hkv"], d), (b, s, c["hkv"], d), (b, s, c["h"], d)))
    segs = (np.array(make_packed_segments(b, s, n_docs=2)) if c.get("segments") else None)
    window = c.get("window")

    def jax_fn(q, k, v):
        return jax_flash(q, k, v, causal=True, block_q=64, block_kv=64, window=window,
                         interpret=True,
                         segment_ids=None if segs is None else jnp.asarray(segs))

    want_o, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    want = [want_o, *vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, window=window,
                              segment_ids=None if segs is None else torch.from_numpy(segs))
    out.backward(torch.from_numpy(do))
    for name, got, w in zip(("o", "dq", "dk", "dv"), (out, tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == torch.float16, name
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(w, np.float32), err_msg=name, **FLASH_F16)


@pytest.mark.parametrize("q_dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 20])
def test_paged_decode_plain_on_float16_pools_matches_pallas_interpret(q_dtype, window):
    """The port's plain paged decode on a float16 pool, with a float16 or a
    bf16 query, against the Pallas kernel in interpret mode: the output in
    the query's type, within one step of it."""
    rng = np.random.default_rng(3)
    batch, heads, kvh, d, bs, nb, mb = 3, 8, 2, 64, 16, 16, 4
    k, v = _f16((nb, bs, kvh, d), rng), _f16((nb, bs, kvh, d), rng)
    q32 = rng.standard_normal((batch, 1, heads, d)).astype(np.float32)
    lens = np.array([5, 37, 0], np.int32)
    tables = rng.permutation(nb)[:batch * mb].reshape(batch, mb).astype(np.int32)
    tq = torch.from_numpy(q32).to(q_dtype)
    jq = jnp.asarray(q32).astype(jnp.float16 if q_dtype == torch.float16 else jnp.bfloat16)
    want = jax_paged_decode_attention(jq, jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
                                      jnp.asarray(lens), window=window, interpret=True)
    got = tpa.paged_decode_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                                     torch.from_numpy(tables), torch.from_numpy(lens),
                                     window=window)
    assert got.dtype == q_dtype and str(want.dtype) == str(q_dtype).split(".")[-1]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=DECODE_ATOL[q_dtype], rtol=0)
    assert not got[2].any()


def test_float16_pools_take_writes_and_serve_decode():
    """A float16 pool is allocated, ``paged_update`` writes rows into it in
    float16, and the model's decode reads them back through the plain paged
    decode."""
    from dlti_tpu_torch.ops.kv_cache import init_paged_cache, paged_update, slot_mapping

    cache = init_paged_cache(2, 8, 4, 2, 16, torch.float16, device="cpu")
    assert cache[0]["k"].dtype == torch.float16 and set(cache[0]) == {"k", "v"}
    rows = torch.randn(1, 3, 2, 16)
    tables = torch.tensor([[5, 6]], dtype=torch.int32)
    slots = slot_mapping(tables, torch.tensor([[0, 1, 4]]), 4)
    paged_update(cache[0], rows, rows * 2, slots)
    assert torch.equal(cache[0]["k"][5, 1], rows[0, 1].half())
    assert torch.equal(cache[0]["v"][6, 0], (rows[0, 2] * 2).half())


# ----------------------------------------------------------------------
# A float16 model's forward, block by block
# ----------------------------------------------------------------------

def _f16_params(seed=0):
    """llama_tiny in float16 with LoRA, JAX init plus numpy noise on every
    leaf (lora_b included, so the adapters are live)."""
    jcfg = dataclasses.replace(jc.MODEL_PRESETS["llama_tiny"], dtype="float16",
                               param_dtype="float16")
    return jcfg, _export_params("float16", seed)


def _tcfg(jcfg):
    return dataclasses.replace(tc.MODEL_PRESETS["llama_tiny"], dtype=jcfg.dtype,
                               param_dtype=jcfg.param_dtype)


def test_float16_model_forward_matches_jax_block_by_block():
    jcfg, params = _f16_params()
    ids = np.random.default_rng(1).integers(3, 512, (2, 32)).astype(np.int32)
    jmodel = JaxLlama(jcfg, jc.LoRAConfig(**LORA))
    (jlogits, _), inter = jmodel.apply({"params": params}, jnp.asarray(ids),
                                       capture_intermediates=True)
    jinter = inter["intermediates"]["model"]
    model = load_model(_tcfg(jcfg), params_from_jax(params), "cpu", lora=tc.LoRAConfig(**LORA))
    assert model.model.layers[0].attn.q_proj.kernel.dtype == torch.float16
    outs = {}
    hooks = [layer.register_forward_hook(
        lambda _m, _i, out, i=i: outs.__setitem__(i, out.detach()))
        for i, layer in enumerate(model.model.layers)]
    with torch.no_grad():
        logits = model(torch.from_numpy(ids))
    for h in hooks:
        h.remove()
    for i in range(jcfg.num_layers):
        want = jinter[f"layers_{i}"]["__call__"][0]
        want = np.asarray(want[0] if isinstance(want, tuple) else want)
        got = outs[i]
        assert got.dtype == torch.float16 and want.dtype == np.float16
        err = np.abs(got.float().numpy() - want.astype(np.float32)).max()
        assert err <= F16_BLOCK_RTOL * np.abs(want.astype(np.float32)).max(), (i, err)
    err = np.abs(logits.numpy() - np.asarray(jlogits)).max()
    assert logits.dtype == torch.float32
    assert err <= F16_BLOCK_RTOL * np.abs(np.asarray(jlogits)).max(), err


def test_float16_rope_norm_and_dropout_scaling_match_jax_bit_for_bit():
    """The elementwise pieces on identical float16 inputs: RoPE (float32
    inside, float16 out), RMSNorm (float32 statistics) and dropout's 1/keep
    scaling of kept elements round the same way in both packages."""
    import flax.linen as fnn

    from dlti_tpu.models.llama import RMSNorm as JaxRMSNorm
    from dlti_tpu.ops.rope import apply_rope as jax_rope
    from dlti_tpu.ops.rope import rope_frequencies as jax_freqs
    from dlti_tpu_torch.models.llama import RMSNorm
    from dlti_tpu_torch.models.lora import dropout
    from dlti_tpu_torch.ops.rope import apply_rope, rope_frequencies

    rng = np.random.default_rng(2)
    x = _f16((2, 16, 4, 16), rng, 3.0)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    jc_, js_ = jax_freqs(16, 64)
    want = np.asarray(jax_rope(jnp.asarray(x), jc_, js_, jnp.asarray(pos)))
    tcos, tsin = rope_frequencies(16, 64, device="cpu")
    got = apply_rope(torch.from_numpy(x), tcos, tsin, torch.from_numpy(pos))
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.numpy(), want)

    h = _f16((2, 16, 64), rng, 5.0)
    jnorm = JaxRMSNorm(eps=1e-5)
    jn = np.asarray(jnorm.apply(jnorm.init(jax.random.PRNGKey(0), jnp.asarray(h)),
                                jnp.asarray(h)))
    tn = RMSNorm(64)(torch.from_numpy(h))
    assert tn.dtype == torch.float16
    np.testing.assert_array_equal(tn.detach().numpy(), jn)

    # dropout: the kept elements are x / keep_prob in float16 on both sides.
    jd = fnn.Dropout(rate=0.05)
    jout = np.asarray(jd.apply({}, jnp.asarray(h), deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(0)}))
    kept = jout != 0
    keep_all = (torch.zeros(h.shape[0] * h.shape[1], dtype=torch.int32) - 2 ** 31,
                torch.zeros(64, dtype=torch.int32))  # every element kept
    tout = dropout(torch.from_numpy(h), 0.05, *keep_all).reshape(h.shape)
    assert tout.dtype == torch.float16
    np.testing.assert_array_equal(tout.numpy()[kept], jout[kept])


# ----------------------------------------------------------------------
# The dynamic loss scaler against the JAX step (float32 models)
# ----------------------------------------------------------------------

def _f32_params():
    return _jax_params(jc.MODEL_PRESETS["llama_tiny"], jc.LoRAConfig(**LORA))


class _ScalerPair:
    """llama_tiny (float32) with LoRA in both packages from the same weights,
    each with the loss scaler from ``scale`` (None: without)."""

    def __init__(self, scale, *, scale_window=1000, hysteresis=2, params=None):
        params = _f32_params() if params is None else params
        jmodel = JaxLlama(jc.MODEL_PRESETS["llama_tiny"], jc.LoRAConfig(**LORA))
        opt = dict(warmup_steps=0)  # lr > 0 at step 1
        self.jstate = jax_create_state(
            jax.random.PRNGKey(0), jmodel, jax_build_optimizer(jc.OptimizerConfig(**opt)),
            (BS, SEQ), init_fn=lambda rng, x: params, fp16_initial_scale=scale,
            fp16_hysteresis=hysteresis)
        kw = dict(accum_steps=ACCUM, fp16_scale_window=scale_window,
                  fp16_hysteresis=hysteresis)
        self.jstep = jax.jit(jax_make_step(jmodel, **kw))
        model = load_model(tc.MODEL_PRESETS["llama_tiny"], params_from_jax(params), "cpu",
                           lora=tc.LoRAConfig(**LORA), trainable_lora=True)
        self.tstate = create_train_state(model, build_optimizer(tc.OptimizerConfig(**opt)),
                                         fp16_initial_scale=scale,
                                         fp16_hysteresis=hysteresis)
        self.tstep = make_train_step(model, **kw)

    def step(self, batch):
        self.jstate, jm = self.jstep(self.jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                     jax.random.PRNGKey(0))
        tm = self.tstep(self.tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
        return jax.device_get(jm), {k: float(v) for k, v in tm.items()}

    def port_scaler(self):
        return {k: float(v) for k, v in self.tstate.scaler.items()}

    def jax_scaler(self):
        return {k: float(v) for k, v in jax.device_get(self.jstate.scaler).items()}


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(3, 512, (ACCUM, BS, SEQ)).astype(np.int32),
            "loss_mask": np.ones((ACCUM, BS, SEQ), np.int32)}


def test_scaler_state_is_created_as_the_reference_creates_it():
    pair = _ScalerPair(2.0 ** 16)
    assert pair.port_scaler() == pair.jax_scaler() == {
        "scale": 65536.0, "good_steps": 0.0, "hysteresis_left": 2.0}
    assert {t.dtype for t in pair.tstate.scaler.values()} == {torch.float32, torch.int32}
    assert _ScalerPair(None).tstate.scaler is None


def test_fp16_step_trains_and_grows_the_scale_as_the_reference():
    """From 2**4 with a scale window of 2: both steps apply, the scale
    doubles after the second, and every metric equals the JAX step's."""
    pair = _ScalerPair(2.0 ** 4, scale_window=2)
    before = pair.tstate.model.model.layers[0].attn.q_proj.lora_b.detach().clone()
    for want_scale in (16.0, 32.0):
        jm, tm = pair.step(_batch())
        assert tm["overflow"] == float(jm["overflow"]) == 0.0
        assert tm["loss_scale"] == float(jm["loss_scale"]) == want_scale
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-5)
    assert pair.port_scaler() == pair.jax_scaler()
    assert pair.port_scaler()["good_steps"] == 0
    assert not torch.equal(before, pair.tstate.model.model.layers[0].attn.q_proj.lora_b)


def test_overflow_skips_the_update_and_shrinks_after_hysteresis_as_the_reference():
    """A NaN in one LoRA factor: the first overflow is absorbed by the
    hysteresis (scale kept), the second halves the scale and re-arms the
    hysteresis; parameters, moments and the count stay as they were; the
    scaler equals the JAX step's after each step."""
    params = _f32_params()
    params["model"]["layers_0"]["attn"]["q_proj"]["lora_a"][0, 0] = np.nan
    pair = _ScalerPair(2.0 ** 8, params=params)
    lora_before = {n: p.detach().clone() for n, p in pair.tstate.model.named_parameters()
                   if is_lora_name(n)}
    for want in ({"scale": 256.0, "good_steps": 0.0, "hysteresis_left": 1.0},
                 {"scale": 128.0, "good_steps": 0.0, "hysteresis_left": 2.0}):
        jm, tm = pair.step(_batch())
        assert tm["overflow"] == tm["nonfinite"] == tm["skipped_update"] == 1.0
        assert float(jm["overflow"]) == 1.0 and tm["loss_scale"] == float(jm["loss_scale"])
        assert pair.port_scaler() == pair.jax_scaler() == want
    opt = pair.tstate.opt_state
    assert int(opt.count) == 0
    assert all(not t.any() for t in [*opt.mu.values(), *opt.nu.values()])
    for n, p in pair.tstate.model.named_parameters():
        if n in lora_before:
            assert torch.equal(p, lora_before[n]) or torch.isnan(p).any(), n


def test_scaled_step_equals_the_unscaled_one():
    """At a scale that does not overflow, with float32 parameters, the
    scaled step is the unscaled one: loss to 1e-6 relative, LoRA factors to
    1e-5; and the port's scaled step agrees with the JAX one."""
    scaled, plain = _ScalerPair(2.0 ** 6), _ScalerPair(None)
    jm, tm = scaled.step(_batch())
    _, tm0 = plain.step(_batch())
    np.testing.assert_allclose(tm["loss"], tm0["loss"], rtol=1e-6)
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    assert tm0["loss_scale"] == 1.0 and tm0["overflow"] == 0.0
    for (n, a), (_, b) in zip(scaled.tstate.model.named_parameters(),
                              plain.tstate.model.named_parameters()):
        if is_lora_name(n):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=n)


def test_scaler_survives_a_checkpoint(tmp_path):
    """The scaler is saved with the state, restores into a fresh state, and
    training goes on from it."""
    pair = _ScalerPair(2.0 ** 8, scale_window=2)
    pair.step(_batch())
    pair.step(_batch())
    assert pair.port_scaler()["scale"] == 512.0
    d = str(tmp_path / "ck")
    store.save_train_state(d, 2, state_leaves(pair.tstate), async_save=False)
    fresh = _ScalerPair(2.0 ** 8).tstate
    leaves, step, _ = store.restore_latest_verified(d, state_leaves(fresh))
    load_state_leaves(fresh, leaves)
    assert step == 2 and {k: float(v) for k, v in fresh.scaler.items()} == pair.port_scaler()
    m = make_train_step(fresh.model, accum_steps=ACCUM)(
        fresh, {k: torch.from_numpy(v) for k, v in _batch(2).items()}, None)
    assert torch.isfinite(m["loss"]) and float(m["loss_scale"]) == 512.0


# ----------------------------------------------------------------------
# The Trainer in fp16 against the JAX Trainer
# ----------------------------------------------------------------------

FP16_TRAIN = dict(micro_batch_size=BS, grad_accum_steps=ACCUM, logging_steps=100,
                  fp16=True, fp16_scale_window=2)
F16_OPT = dict(learning_rate=1e-2, warmup_steps=2)


def _port_fp16_cfg(tmp_path, *, strategy="no", **train):
    return tc.Config(
        model=_tcfg(_f16_params()[0]), lora=tc.LoRAConfig(**LORA),
        optimizer=tc.OptimizerConfig(**F16_OPT),
        data=tc.DataConfig(max_seq_len=SEQ, tokenizer="byte"),
        checkpoint=tc.CheckpointConfig(output_dir=str(tmp_path / "tck"),
                                       save_strategy=strategy, save_steps=100),
        train=tc.TrainConfig(**dict(FP16_TRAIN, **train)))


@pytest.mark.parametrize("k", [1, 4])
def test_fp16_trainer_matches_the_jax_trainer(tmp_path, k):
    """10 steps from 2**16 with a scale window of 2: the first steps
    overflow (skipped, the hysteresis spent, then the scale halved), later
    ones grow it; the loss scales and skipped steps are the JAX Trainer's,
    the losses within F16_LOSS_RTOL."""
    jcfg16, params = _f16_params()
    texts = _texts(28)
    common = dict(FP16_TRAIN, max_steps=10, num_epochs=2, steps_per_sync=k)
    replay = tmp_path / "replay"
    jcfg = jc.Config(
        model=jcfg16, lora=jc.LoRAConfig(**LORA), optimizer=jc.OptimizerConfig(**F16_OPT),
        data=jc.DataConfig(max_seq_len=SEQ, tokenizer="byte"),
        checkpoint=jc.CheckpointConfig(output_dir=str(tmp_path / "jck"),
                                       save_strategy="no"),
        train=jc.TrainConfig(metrics_csv=str(tmp_path / "m.csv"),
                             record_replay_dir=str(replay), record_replay_keep=100,
                             record_replay_every=1, **common))
    jtrainer = JaxTrainer(jcfg)
    jstate = jax_create_state(jax.random.PRNGKey(0), jtrainer.model, jtrainer.tx, (BS, SEQ),
                              init_fn=lambda rng, x: params, fp16_initial_scale=2.0 ** 16,
                              fp16_hysteresis=2)
    jstate, _ = jtrainer.train(
        dataset=jax_make_batches(texts, JaxByteTokenizer(), seq_len=SEQ, micro_batch_size=BS,
                                 grad_accum_steps=ACCUM, shard_by_host=False),
        state=jstate)
    jm = [json.loads(bytes(np.load(replay / f)["metrics_json"]).decode())
          for f in sorted(os.listdir(replay))]

    tcfg = _port_fp16_cfg(tmp_path, **common)
    tstate, rec = Trainer(tcfg, params=params_from_jax(params), device="cpu").train(
        dataset=_dataset(texts))
    assert rec.steps == len(jm) == 10
    assert rec.loss_scales == [m["loss_scale"] for m in jm]
    skipped = [m["overflow"] for m in jm]
    assert rec.skipped_updates == sum(skipped) >= 2
    assert max(rec.loss_scales) > min(rec.loss_scales)  # halved, then grew
    applied = [i for i, s in enumerate(skipped) if not s]
    np.testing.assert_allclose(np.array(rec.losses)[applied],
                               np.array([jm[i]["loss"] for i in applied]),
                               rtol=F16_LOSS_RTOL)
    jscaler = jax.device_get(jstate.scaler)
    assert {n: float(t) for n, t in tstate.scaler.items()} == {
        n: float(v) for n, v in jscaler.items()}


def test_fp16_window_run_stopped_mid_window_and_resumed_is_bit_equal(tmp_path):
    """k=4, dropout 0.05, from 2**16: stopped while its second window fills,
    checkpointed at step 4 (the sidecar says fp16), resumed by a fresh
    trainer from other weights: steps 5-10 (losses, grad norms, loss
    scales) and the final scaler equal the uninterrupted run's."""
    _, params = _f16_params()
    _, other = _f16_params(seed=3)
    texts = _texts(28)
    full = _port_fp16_cfg(tmp_path, max_steps=10, num_epochs=2, steps_per_sync=4)
    full = dataclasses.replace(full, lora=tc.LoRAConfig(**dict(LORA, dropout=0.05)))
    ref_state, ref = Trainer(full, params=params_from_jax(params), device="cpu").train(
        dataset=_dataset(texts))
    assert ref.skipped_updates >= 2 and len(set(ref.loss_scales)) > 1
    cfg = dataclasses.replace(full, checkpoint=dataclasses.replace(
        full.checkpoint, save_strategy="steps"))
    first = Trainer(cfg, params=params_from_jax(params), device="cpu")
    state, half = first.train(dataset=_StopAt(_dataset(texts), first, stop_at=5))
    ck = cfg.checkpoint.output_dir
    assert state.step == 4 and half.save_steps == [4]
    np.testing.assert_array_equal(half.losses, ref.losses[:4])
    assert store.load_train_meta(ck, 4)["fp16"] is True
    state, rest = Trainer(cfg, params=params_from_jax(other), device="cpu").train(
        dataset=_dataset(texts))
    assert rest.resumed_from == 4 and state.step == 10
    # Overflowing steps' losses and grad norms are inf or NaN in both runs.
    np.testing.assert_array_equal(rest.losses, ref.losses[4:])
    np.testing.assert_array_equal(rest.grad_norms, ref.grad_norms[4:])
    assert rest.loss_scales == ref.loss_scales[4:]
    assert all(torch.equal(state.scaler[n], ref_state.scaler[n]) for n in state.scaler)


# ----------------------------------------------------------------------
# cli.train --fp16 -> cli.export --fp16 -> serve on a float16 pool
# ----------------------------------------------------------------------

def _data(tmp_path):
    data = tmp_path / "data.jsonl"
    rng = np.random.default_rng(3)
    data.write_text("".join(json.dumps({"text": " ".join(
        rng.choice(["lora", "model", "token", "x", "(y)"], rng.integers(3, 30)))}) + "\n"
        for _ in range(24)))
    return str(data)


def _train_fp16_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    train_cli.main(["--device", "cpu", "--model", "llama_tiny", "--tokenizer", "byte",
                    "--dataset-path", _data(tmp_path), "--max-seq-len", "32",
                    "--per-device-batch-size", "2", "--gradient-accumulation-steps", "2",
                    "--max-steps", "4", "--save-steps", "4", "--warmup-steps", "1",
                    "--learning-rate", "1e-2", "--lora-r", "4", "--fp16",
                    "--output-dir", ck])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return ck, summary


def test_cli_fp16_train_export_serve_matches_the_jax_engine(tmp_path, capsys):
    """``cli.train --fp16`` writes a float16 checkpoint with the scaler;
    ``cli.export --fp16`` exports it; the export loads as a float16 model,
    and the port's engine on a float16 pool (``cli.serve.build
    --kv-cache-dtype float16``) gives the JAX engine's greedy tokens on it,
    logprobs within F16_LOGPROB_ATOL."""
    ck, summary = _train_fp16_checkpoint(tmp_path, capsys)
    assert summary["windows"] == 4 and summary["final_loss_scale"] > 0
    manifest = json.loads((tmp_path / "ck" / "4" / "MANIFEST.json").read_text())
    kinds = {e["name"]: e["dtype"] for e in manifest["leaves"]}
    assert kinds[".params['model']['layers_0']['attn']['q_proj']['kernel']"] == "float16"
    assert kinds[".scaler['scale']"] == "float32"
    assert store.load_train_meta(ck, 4)["fp16"] is True
    ex = str(tmp_path / "ex")
    export_cli.main(["--device", "cpu", "--checkpoint-dir", ck, "--model", "llama_tiny",
                     "--lora-r", "4", "--fp16", "--out", ex])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("manifest sha256: ")
    tree, cfg = load_exported_model(ex)
    assert cfg.model.dtype == cfg.model.param_dtype == "float16"
    assert tree["model"]["layers_0"]["attn"]["q_proj"]["kernel"].dtype == torch.float16

    jparams, jcfg = jexport.load_exported_model(ex)
    jengine = JaxEngine(jcfg.model, jax.tree_util.tree_map(jnp.asarray, jparams),
                        JaxEngineConfig(cache_dtype="float16", **ENGINE))
    jres = jengine.generate(PROMPTS, JaxSamplingParams(temperature=0.0, max_tokens=8))
    args = serve_cli.parse_args(["--device", "cpu", "--model-dir", ex, "--tokenizer", "byte",
                                 "--kv-cache-dtype", "float16", "--max-seqs", "4",
                                 "--block-size", "8", "--num-blocks", "32",
                                 "--max-model-len", "64"])
    engine, _, _ = serve_cli.build(args)
    assert engine.cache[0]["k"].dtype == torch.float16
    res = engine.generate(PROMPTS, SamplingParams(temperature=0.0, max_tokens=8))
    assert [list(r.output_token_ids) for r in res] == [list(r.output_token_ids) for r in jres]
    np.testing.assert_allclose([lp for r in res for lp in r.output_logprobs],
                               [lp for r in jres for lp in r.output_logprobs],
                               atol=F16_LOGPROB_ATOL)


def test_jax_export_script_refuses_an_fp16_runs_checkpoint(tmp_path, capsys, monkeypatch):
    """The JAX package's ``scripts/export_from_checkpoint.py --fp16`` builds
    its restore template from the preset (float32 for llama_tiny) plus the
    scaler subtree, and its store refuses a leaf whose dtype differs: an
    fp16 run's float16 base. The port's ``cli.export --fp16`` exports the
    same checkpoint (a reference behaviour the port does not inherit)."""
    ck, _ = _train_fp16_checkpoint(tmp_path, capsys)
    monkeypatch.setattr(sys, "argv", [
        "export_from_checkpoint.py", "--checkpoint-dir", ck, "--model", "llama_tiny",
        "--lora-r", "4", "--fp16", "--out", str(tmp_path / "jex")])
    with pytest.raises(ValueError, match=r"is float16.*target expects float32"):
        runpy.run_path(os.path.join(ROOT, "scripts", "export_from_checkpoint.py"),
                       run_name="__main__")
    export_cli.main(["--device", "cpu", "--checkpoint-dir", ck, "--model", "llama_tiny",
                     "--lora-r", "4", "--fp16", "--out", str(tmp_path / "tex")])
    assert jstore.verify_pytree_dir(str(tmp_path / "tex" / "model")) == (True, "ok")
