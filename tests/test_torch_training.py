"""The port's LoRA training path against the JAX package's (``llama_tiny``,
float32, CPU, shared weights through ``params_from_jax``).

* 20 steps of ``make_train_step`` + ``build_optimizer`` +
  ``create_train_state`` on both sides, dropout 0, warmup 5 and a
  ``grad_clip`` small enough that clipping fires: losses, grad norms and
  final LoRA factors agree within 1e-5 relative (float32 in two frameworks
  that sum in different orders). A factor is compared by the relative L2
  norm of its difference: Adam moves an element whose gradient is near 0 by
  up to lr whatever that gradient's rounding, so single elements may differ
  by more than 1e-5 of their own size while the factor agrees.
* One step with ``attention_impl="flash"``: the Pallas kernel in interpret
  mode against the port's plain flash version, on a packed batch.
* A nonfinite batch skips the update and holds the schedule.
* Remat on and off give equal grads with LoRA dropout at 0.05.
* The port's ``Trainer`` against the JAX ``Trainer`` for 6 steps.
* ``count_params``, ``lora_param_mask`` and ``merge_lora_params`` against
  the JAX helpers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlti_tpu import config as jc
from dlti_tpu.data import make_batches as jax_make_batches
from dlti_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.training.optimizer import build_optimizer as jax_build_optimizer
from dlti_tpu.training.optimizer import build_schedule as jax_schedule
from dlti_tpu.training.state import create_train_state as jax_create_state
from dlti_tpu.training.step import make_train_step as jax_make_step
from dlti_tpu.training.trainer import Trainer as JaxTrainer
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.data import ByteTokenizer, make_batches
from dlti_tpu_torch.models import load_model, params_from_jax
from dlti_tpu_torch.models.lora import is_lora_name
from dlti_tpu_torch.training import (
    Trainer, build_optimizer, build_schedule, create_train_state, make_train_step,
)

RTOL = 1e-5
LORA = dict(r=4, alpha=8, dropout=0.0)
OPT = dict(learning_rate=1e-2, warmup_steps=5, grad_clip=0.05)
ACCUM, BS, SEQ = 2, 2, 32


def _assert_rel(got, want, name):
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= RTOL, f"{name}: relative L2 difference {err:.2e} > {RTOL}"


def _jax_params(jcfg, lora, seed=0):
    """JAX init plus numpy noise on every leaf (lora_b included, so every
    LoRA factor gets a gradient from the first step)."""
    tree = JaxLlama(jcfg, lora).init(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def _batches(n, vocab, seed=1, packed=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(3, vocab, (ACCUM, BS, SEQ)).astype(np.int32)
        mask = (rng.random((ACCUM, BS, SEQ)) > 0.2).astype(np.int32)
        batch = {"input_ids": ids, "loss_mask": mask}
        if packed:
            segs = np.zeros((ACCUM, BS, SEQ), np.int32)
            segs[..., :10], segs[..., 10:25] = 1, 2  # two docs, then padding
            pos = np.concatenate([np.arange(10), np.arange(15), np.zeros(SEQ - 25)])
            batch.update(segment_ids=segs,
                         positions=np.broadcast_to(pos, segs.shape).astype(np.int32),
                         loss_mask=mask * (segs > 0))
        out.append(batch)
    return out


class _Pair:
    """The same model, optimizer and initial weights in both packages."""

    def __init__(self, overrides=None, opt=None):
        over = overrides or {}
        self.jcfg = dataclasses.replace(jc.MODEL_PRESETS["llama_tiny"], **over)
        self.tcfg = dataclasses.replace(tc.MODEL_PRESETS["llama_tiny"], **over)
        jlora, tlora = jc.LoRAConfig(**LORA), tc.LoRAConfig(**LORA)
        params = _jax_params(self.jcfg, jlora)
        jmodel = JaxLlama(self.jcfg, jlora)
        tx = jax_build_optimizer(jc.OptimizerConfig(**(opt or OPT)))
        self.jstate = jax_create_state(jax.random.PRNGKey(0), jmodel, tx, (BS, SEQ),
                                       init_fn=lambda rng, x: params)
        self.jstep = jax.jit(jax_make_step(jmodel, accum_steps=ACCUM))
        model = load_model(self.tcfg, params_from_jax(params), "cpu", lora=tlora,
                           trainable_lora=True)
        self.tstate = create_train_state(model, build_optimizer(tc.OptimizerConfig(**(opt or OPT))))
        self.tstep = make_train_step(model, accum_steps=ACCUM)

    def step(self, batch, i=0):
        self.jstate, jm = self.jstep(self.jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                     jax.random.PRNGKey(i))
        tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        tm = self.tstep(self.tstate, tb, None)
        return jax.device_get(jm), tm

    def lora_pairs(self):
        flat = params_from_jax(jax.device_get(self.jstate.params))
        return [(n, p.detach().numpy(), flat[n].numpy())
                for n, p in self.tstate.model.named_parameters() if is_lora_name(n)]


def test_twenty_step_lora_trajectory_matches_jax():
    pair = _Pair()
    clipped = 0
    for i, batch in enumerate(_batches(20, 512)):
        jm, tm = pair.step(batch, i)
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=RTOL)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=RTOL)
        assert tm["num_tokens"] == float(jm["num_tokens"])
        clipped += tm["grad_norm"] > OPT["grad_clip"]
    assert clipped >= 10  # the clip fired on most steps
    assert pair.tstate.step == 20 and pair.tstate.opt_state.count == 20
    for name, got, want in pair.lora_pairs():
        _assert_rel(got, want, name)


def test_flash_step_matches_jax_interpret_on_a_packed_batch():
    pair = _Pair({"attention_impl": "flash"})
    [batch] = _batches(1, 512, seed=2, packed=True)
    jm, tm = pair.step(batch)
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=RTOL)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=RTOL)
    for name, got, want in pair.lora_pairs():
        _assert_rel(got, want, name)


def test_nonfinite_batch_skips_update_and_holds_schedule():
    pair = _Pair()
    good = _batches(3, 512, seed=3)
    bad = dict(good[1], loss_mask=good[1]["loss_mask"].astype(np.float32))
    bad["loss_mask"][0, 0, 5] = np.nan
    for i, batch in enumerate([good[0], bad, good[2]]):
        before = [p.copy() for _, p, _ in pair.lora_pairs()]
        jm, tm = pair.step(batch, i)
        assert tm["skipped_update"] == float(jm["skipped_update"]) == (1.0 if i == 1 else 0.0)
        assert tm["nonfinite"] == float(jm["nonfinite"])
        if i == 1:
            assert all(np.array_equal(b, p) for b, (_, p, _) in zip(before, pair.lora_pairs()))
            assert pair.tstate.opt_state.count == 1  # the schedule did not advance
        else:
            np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=RTOL)
    assert pair.tstate.step == 3 and pair.tstate.opt_state.count == 2
    for name, got, want in pair.lora_pairs():
        _assert_rel(got, want, name)


@pytest.mark.parametrize("schedule", ["warmup_constant", "warmup_cosine"])
def test_schedule_matches_optax(schedule):
    kw = dict(learning_rate=3e-4, warmup_steps=4, schedule=schedule, total_steps=20)
    mine = build_schedule(tc.OptimizerConfig(**kw))
    ref = jax_schedule(jc.OptimizerConfig(**kw))
    for count in range(25):
        # Both evaluate in float32, each with its own cos.
        np.testing.assert_allclose(mine(count), float(ref(count)), rtol=1e-5, atol=1e-12)
    assert mine(0) == 0.0  # the first update of a warmup has lr 0


def _grads(model, batch, seed):
    logits = model(batch["input_ids"][0], dropout_seed=seed)
    loss = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]),
        batch["input_ids"][0][:, 1:].reshape(-1).long())
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = [p for n, p in model.named_parameters() if p.requires_grad]
    return dict(zip(names, torch.autograd.grad(loss, params)))


def test_remat_on_and_off_give_equal_grads_with_dropout():
    lora = tc.LoRAConfig(r=4, alpha=8, dropout=0.05)
    base = dataclasses.replace(tc.MODEL_PRESETS["llama_tiny"], num_layers=3,
                               attention_impl="flash")
    params = _jax_params(dataclasses.replace(jc.MODEL_PRESETS["llama_tiny"], num_layers=3),
                         jc.LoRAConfig(r=4, alpha=8))
    [batch] = _batches(1, 512, seed=4)
    batch = {"input_ids": torch.from_numpy(batch["input_ids"])}
    grads = {}
    for remat, stride in [(False, 1), (True, 1), (True, 2)]:
        cfg = dataclasses.replace(base, remat=remat, remat_stride=stride)
        model = load_model(cfg, params_from_jax(params), "cpu", lora=lora,
                           trainable_lora=True)
        grads[(remat, stride)] = _grads(model, batch, seed=1234)
    no_dropout = _grads(model, batch, seed=None)
    for key in [(True, 1), (True, 2)]:
        for n, g in grads[(False, 1)].items():
            torch.testing.assert_close(grads[key][n], g, atol=0, rtol=0, msg=n)
    # The masks were live: grads differ from a run without dropout.
    assert any(not torch.allclose(g, no_dropout[n]) for n, g in grads[(False, 1)].items())


def test_unported_remat_policy_raises():
    cfg = dataclasses.replace(tc.MODEL_PRESETS["llama_tiny"], remat=True,
                              remat_policy="dots_saveable")
    with pytest.raises(NotImplementedError, match="remat_policy"):
        load_model(cfg, {}, "cpu")


@pytest.mark.parametrize("field,value", [("quantize_frozen_base", True)])
def test_trainer_refuses_unported_train_options(field, value):
    """``quantize_frozen_base`` is ported for ``"int8"`` alone, as the JAX
    Trainer takes it; any other value is refused when the Trainer is built."""
    cfg = tc.Config(model=tc.MODEL_PRESETS["llama_tiny"],
                    checkpoint=tc.CheckpointConfig(save_strategy="no"),
                    train=tc.TrainConfig(**{field: value}))
    with pytest.raises(ValueError, match="only 'int8'"):
        Trainer(cfg, device="cpu")


def _texts(n=48):
    rng = np.random.default_rng(5)
    return ["".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(5, 60)))
            for _ in range(n)]


def test_trainer_matches_jax_trainer_for_six_steps(tmp_path):
    common = dict(micro_batch_size=BS, grad_accum_steps=ACCUM, max_steps=6,
                  logging_steps=100, num_epochs=2)
    jcfg = jc.Config(
        model=jc.MODEL_PRESETS["llama_tiny"], lora=jc.LoRAConfig(**LORA),
        optimizer=jc.OptimizerConfig(**OPT),
        data=jc.DataConfig(max_seq_len=SEQ, tokenizer="byte"),
        checkpoint=jc.CheckpointConfig(output_dir=str(tmp_path / "ck"),
                                       save_strategy="no"),
        train=jc.TrainConfig(metrics_csv=str(tmp_path / "m.csv"), **common))
    tcfg = tc.Config(
        model=tc.MODEL_PRESETS["llama_tiny"], lora=tc.LoRAConfig(**LORA),
        optimizer=tc.OptimizerConfig(**OPT),
        data=tc.DataConfig(max_seq_len=SEQ, tokenizer="byte"),
        checkpoint=tc.CheckpointConfig(output_dir=str(tmp_path / "tck"),
                                       save_strategy="no"),
        train=tc.TrainConfig(**common))
    texts = _texts()
    jtrainer = JaxTrainer(jcfg)
    jstate = jtrainer.init_state()
    params = params_from_jax(jax.device_get(jstate.params))
    jstate, jrecord = jtrainer.train(
        dataset=jax_make_batches(texts, JaxByteTokenizer(), seq_len=SEQ,
                                 micro_batch_size=BS, grad_accum_steps=ACCUM,
                                 shard_by_host=False),
        state=jstate)
    tstate, trecord = Trainer(tcfg, params=params, device="cpu").train(
        dataset=make_batches(texts, ByteTokenizer(), seq_len=SEQ,
                             micro_batch_size=BS, grad_accum_steps=ACCUM))
    assert trecord.steps == 6 and tstate.step == 6
    np.testing.assert_allclose(trecord.final_loss, jrecord.final_loss, rtol=RTOL)
    assert trecord.mfu_percent is None and trecord.peak_memory_gb is None  # CPU
    flat = params_from_jax(jax.device_get(jstate.params))
    for n, p in tstate.model.named_parameters():
        if is_lora_name(n):
            _assert_rel(p.detach().numpy(), flat[n].numpy(), n)


def test_lora_param_helpers_match_jax():
    from dlti_tpu.models.lora import count_params as jax_count
    from dlti_tpu.models.lora import lora_param_mask as jax_mask
    from dlti_tpu.models.lora import merge_lora_params as jax_merge
    from dlti_tpu_torch.models import count_params, lora_param_mask, merge_lora_params

    params = _jax_params(jc.MODEL_PRESETS["llama_tiny"], jc.LoRAConfig(**LORA))
    flat = params_from_jax(params)
    assert count_params(flat) == jax_count(params)
    assert lora_param_mask(flat) == params_from_jax(jax_mask(params))
    merged, want = merge_lora_params(flat, alpha=8), params_from_jax(jax_merge(params, alpha=8))
    assert merged.keys() == want.keys() and not any(is_lora_name(n) for n in merged)
    for n, t in merged.items():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), rtol=1e-6, atol=1e-7, err_msg=n)
    base = _jax_params(jc.MODEL_PRESETS["llama_tiny"], None)
    assert all(lora_param_mask(params_from_jax(base)).values())  # full fine-tune
