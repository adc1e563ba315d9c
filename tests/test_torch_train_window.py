"""The train step's host path in the port against the JAX package
(``llama_tiny``, float32, CPU, shared weights through ``params_from_jax``):
``steps_per_sync`` windows, the cadence-crossing eval and saves, the
sequence-chunked loss, the eval step, and the counter-hash LoRA dropout.

* ``Trainer`` at ``steps_per_sync=4`` over 10 steps (7 a epoch, so one
  window ends at the epoch's end and the last is cut by ``max_steps``),
  ``save_steps=3`` and ``eval_steps=3``, against the JAX ``Trainer`` under
  the same settings: losses and final LoRA factors within ``RTOL`` (float32
  in two frameworks that sum in different orders; a factor by the relative
  L2 norm of its difference, as in ``test_torch_training.py``), the same
  checkpointed steps, the same eval steps, eval losses within ``RTOL``.
* Within the port, bit for bit: windows of 4 and of 1 with LoRA dropout at
  0.05; a window-of-4 run stopped mid-window, checkpointed and resumed,
  against the uninterrupted run; a nonfinite batch inside a window (its
  update skipped, the count and schedule held), with nothing in the window
  reading the device back.
* ``chunked_causal_lm_loss`` at chunks 64 and 128 (the tail pads), a
  ``loss_chunk`` train step and ``make_eval_step`` against the JAX functions
  (float32, 1e-5).
* The dropout mask: keeps ``1 - rate`` of the elements within 5 standard
  deviations, neighbours independent within the same bound, and a function
  of (key, element) alone.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dlti_tpu import config as jc
from dlti_tpu.checkpoint.store import list_checkpoint_steps as jax_checkpoint_steps
from dlti_tpu.data import make_batches as jax_make_batches
from dlti_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.training.optimizer import build_optimizer as jax_build_optimizer
from dlti_tpu.training.state import create_train_state as jax_create_state
from dlti_tpu.training.step import chunked_causal_lm_loss as jax_chunked_loss
from dlti_tpu.training.step import make_eval_step as jax_make_eval_step
from dlti_tpu.training.step import make_train_step as jax_make_step
from dlti_tpu.training.trainer import Trainer as JaxTrainer
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.checkpoint import store
from dlti_tpu_torch.data import ByteTokenizer, make_batches
from dlti_tpu_torch.models import load_model, params_from_jax
from dlti_tpu_torch.models.lora import dropout_hashes, is_lora_name, keep_mask_from
from dlti_tpu_torch.models.llama import PROJECTIONS, dropout_keys
from dlti_tpu_torch.training import (
    StepWindow, Trainer, build_optimizer, chunked_causal_lm_loss, create_train_state,
    make_eval_step, make_train_step,
)
from dlti_tpu_torch.training.step import causal_lm_loss

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


def _texts(n, seed=5):
    rng = np.random.default_rng(seed)
    return ["".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(5, 60)))
            for _ in range(n)]


def _dataset(texts):
    return make_batches(texts, ByteTokenizer(), seq_len=SEQ, micro_batch_size=BS,
                        grad_accum_steps=ACCUM)


def _port_cfg(tmp_path, *, dropout=0.0, strategy="no", **train):
    common = dict(micro_batch_size=BS, grad_accum_steps=ACCUM, logging_steps=100)
    common.update(train)
    return tc.Config(
        model=tc.MODEL_PRESETS["llama_tiny"], lora=tc.LoRAConfig(**dict(LORA, dropout=dropout)),
        optimizer=tc.OptimizerConfig(**OPT),
        data=tc.DataConfig(max_seq_len=SEQ, tokenizer="byte"),
        checkpoint=tc.CheckpointConfig(output_dir=str(tmp_path / "tck"),
                                       save_strategy=strategy, save_steps=3,
                                       save_total_limit=10),
        train=tc.TrainConfig(**common))


@pytest.fixture(scope="module")
def params():
    return _jax_params(jc.MODEL_PRESETS["llama_tiny"], jc.LoRAConfig(**LORA))


def _lora(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()
            if is_lora_name(n)}


# ----------------------------------------------------------------------
# The window loop against the JAX Trainer
# ----------------------------------------------------------------------

def test_window_of_four_over_ten_steps_matches_the_jax_trainer(tmp_path, params, monkeypatch):
    """7 steps an epoch, max_steps 10, steps_per_sync 4: windows of 4, 3
    (the epoch's end), 3 (max_steps), so saves and evals at steps 4, 7, 10."""
    texts, eval_texts = _texts(28), _texts(8, seed=9)
    common = dict(micro_batch_size=BS, grad_accum_steps=ACCUM, max_steps=10,
                  num_epochs=2, logging_steps=100, steps_per_sync=4, eval_steps=3)
    jck, tck = tmp_path / "jck", tmp_path / "tck"
    jcfg = jc.Config(
        model=jc.MODEL_PRESETS["llama_tiny"], lora=jc.LoRAConfig(**LORA),
        optimizer=jc.OptimizerConfig(**OPT),
        data=jc.DataConfig(max_seq_len=SEQ, tokenizer="byte"),
        checkpoint=jc.CheckpointConfig(output_dir=str(jck), save_steps=3,
                                       save_total_limit=10),
        telemetry=jc.TelemetryConfig(step_log_path=str(tmp_path / "steps.jsonl")),
        train=jc.TrainConfig(metrics_csv=str(tmp_path / "m.csv"), **common))
    jax_evals = []
    run_eval = JaxTrainer._run_eval

    def recording_eval(self, eval_fn, state, eval_dataset, step):
        loss = run_eval(self, eval_fn, state, eval_dataset, step)
        jax_evals.append((step, loss))
        return loss

    monkeypatch.setattr(JaxTrainer, "_run_eval", recording_eval)
    jtrainer = JaxTrainer(jcfg)
    jstate = jax_create_state(jax.random.PRNGKey(0), jtrainer.model, jtrainer.tx,
                              (BS, SEQ), init_fn=lambda rng, x: params)
    jstate, _ = jtrainer.train(
        dataset=jax_make_batches(texts, JaxByteTokenizer(), seq_len=SEQ,
                                 micro_batch_size=BS, grad_accum_steps=ACCUM,
                                 shard_by_host=False),
        eval_dataset=jax_make_batches(eval_texts, JaxByteTokenizer(), seq_len=SEQ,
                                      micro_batch_size=BS, grad_accum_steps=1,
                                      shuffle_seed=None, shard_by_host=False),
        state=jstate)
    rows = [json.loads(line) for line in (tmp_path / "steps.jsonl").read_text().splitlines()]
    jlosses = [r["loss"] for r in rows if r.get("type") == "step"]

    tcfg = tc.Config(
        model=tc.MODEL_PRESETS["llama_tiny"], lora=tc.LoRAConfig(**LORA),
        optimizer=tc.OptimizerConfig(**OPT),
        data=tc.DataConfig(max_seq_len=SEQ, tokenizer="byte"),
        checkpoint=tc.CheckpointConfig(output_dir=str(tck), save_steps=3,
                                       save_total_limit=10),
        train=tc.TrainConfig(**common))
    tstate, rec = Trainer(tcfg, params=params_from_jax(params), device="cpu").train(
        dataset=_dataset(texts),
        eval_dataset=make_batches(eval_texts, ByteTokenizer(), seq_len=SEQ,
                                  micro_batch_size=BS, grad_accum_steps=1,
                                  shuffle_seed=None))

    assert rec.steps == len(jlosses) == 10 and rec.windows == 3
    np.testing.assert_allclose(rec.losses, jlosses, rtol=RTOL)
    assert rec.save_steps == [4, 7, 10]
    assert store.list_checkpoint_steps(str(tck)) == jax_checkpoint_steps(str(jck)) == [4, 7, 10]
    assert store.load_train_meta(str(tck), 7)["data_pos"] == 7
    assert rec.eval_steps == [s for s, _ in jax_evals] == [4, 7, 10]
    np.testing.assert_allclose(rec.eval_losses, [loss for _, loss in jax_evals], rtol=RTOL)
    assert rec.host_syncs_per_step == 0.3
    flat = params_from_jax(jax.device_get(jstate.params))
    for n, p in _lora(tstate).items():
        _assert_rel(p.numpy(), flat[n].numpy(), n)


def test_steps_per_sync_four_and_one_are_bit_equal_with_dropout(tmp_path, params):
    texts = _texts(28)
    runs = {}
    for k in (1, 4):
        cfg = _port_cfg(tmp_path, dropout=0.05, max_steps=10, num_epochs=2,
                        steps_per_sync=k)
        state, rec = Trainer(cfg, params=params_from_jax(params), device="cpu").train(
            dataset=_dataset(texts))
        runs[k] = (rec, _lora(state), int(state.opt_state.count))
    (r1, p1, c1), (r4, p4, c4) = runs[1], runs[4]
    assert r1.losses == r4.losses and r1.grad_norms == r4.grad_norms
    assert (r1.windows, r4.windows) == (10, 3) and c1 == c4 == 10
    for n, p in p1.items():
        assert torch.equal(p, p4[n]), n
    # The masks were live: dropout 0 gives other losses.
    cfg = _port_cfg(tmp_path, max_steps=2, steps_per_sync=4)
    _, plain = Trainer(cfg, params=params_from_jax(params), device="cpu").train(
        dataset=_dataset(texts))
    assert plain.losses[1] != r4.losses[1]


class _StopAt:
    """A dataset that asks ``trainer`` to stop as it hands out batch
    ``stop_at`` (0-based) of its first epoch, as a SIGTERM would."""

    def __init__(self, inner, trainer, stop_at):
        self.inner, self.trainer, self.stop_at = inner, trainer, stop_at
        self.shuffle_seed, self.pack = inner.shuffle_seed, inner.pack

    def steps_per_epoch(self):
        return self.inner.steps_per_epoch()

    def epoch(self, epoch_idx=0, skip_steps=0):
        for i, batch in enumerate(self.inner.epoch(epoch_idx, skip_steps)):
            if epoch_idx == 0 and i == self.stop_at:
                self.trainer.request_stop()
            yield batch


def test_a_window_run_stopped_mid_window_and_resumed_is_bit_equal(tmp_path, params):
    """Stopped while its second window fills (batch 6 of 7): that window is
    dropped, the preemption checkpoint holds step 4 and data position 4,
    and a fresh trainer resumes there; steps 5-10 equal the uninterrupted
    run's, bit for bit, with dropout on."""
    texts = _texts(28)
    full = _port_cfg(tmp_path, dropout=0.05, max_steps=10, num_epochs=2, steps_per_sync=4)
    _, ref = Trainer(full, params=params_from_jax(params), device="cpu").train(
        dataset=_dataset(texts))

    cfg = dataclasses.replace(full, checkpoint=dataclasses.replace(
        full.checkpoint, save_strategy="steps", save_steps=100))
    first = Trainer(cfg, params=params_from_jax(params), device="cpu")
    state, half = first.train(dataset=_StopAt(_dataset(texts), first, stop_at=5))
    ck = cfg.checkpoint.output_dir
    assert state.step == 4 and half.losses == ref.losses[:4] and half.save_steps == [4]
    assert store.load_train_meta(ck, 4)["data_pos"] == 4
    other = _jax_params(jc.MODEL_PRESETS["llama_tiny"], jc.LoRAConfig(**LORA), seed=3)
    state, rest = Trainer(cfg, params=params_from_jax(other), device="cpu").train(
        dataset=_dataset(texts))
    assert rest.resumed_from == 4 and state.step == 10
    assert rest.losses == ref.losses[4:] and rest.grad_norms == ref.grad_norms[4:]


class _Shorter:
    """``inner``'s batches, batch ``at`` (0-based, in epoch 0) cut to 16
    positions: a batch of another shape mid-epoch."""

    def __init__(self, inner, at):
        self.inner, self.at = inner, at
        self.shuffle_seed, self.pack = inner.shuffle_seed, inner.pack

    def steps_per_epoch(self):
        return self.inner.steps_per_epoch()

    def epoch(self, epoch_idx=0, skip_steps=0):
        for i, batch in enumerate(self.inner.epoch(epoch_idx, skip_steps)):
            yield ({k: v[..., :16] for k, v in batch.items()}
                   if epoch_idx == 0 and i == self.at else batch)


def test_a_batch_of_another_shape_starts_a_new_window(tmp_path, params):
    """As the reference's ``_batch_compatible``: the pending window runs
    before a batch of another shape, which starts the next one; the steps
    are those of windows of 1."""
    texts = _texts(28)
    runs = {}
    for k in (1, 4):
        cfg = _port_cfg(tmp_path, dropout=0.05, max_steps=7, steps_per_sync=k)
        _, runs[k] = Trainer(cfg, params=params_from_jax(params), device="cpu").train(
            dataset=_Shorter(_dataset(texts), at=2))
    assert runs[4].windows == 3  # steps 1-2, then 3-6 from the short batch, then 7
    assert runs[4].losses == runs[1].losses and runs[4].grad_norms == runs[1].grad_norms


def test_resume_from_another_dropout_schedule_warns(tmp_path, params, monkeypatch, caplog):
    """A checkpoint whose sidecar names another dropout schedule (the
    earlier ``splitmix64_v1``) resumes, with a warning that the losses will
    not match the original run's, as a seed mismatch does."""
    from dlti_tpu_torch.training import trainer as trainer_module

    texts = _texts(28)
    cfg = _port_cfg(tmp_path, dropout=0.05, strategy="steps", max_steps=3, steps_per_sync=4)
    with monkeypatch.context() as m:
        m.setattr(trainer_module, "RNG_SCHEDULE", "splitmix64_v1")
        Trainer(cfg, params=params_from_jax(params), device="cpu").train(
            dataset=_dataset(texts))
    assert store.load_train_meta(cfg.checkpoint.output_dir, 3)["rng_schedule"] == "splitmix64_v1"
    later = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, max_steps=4))
    with caplog.at_level("WARNING", logger="dlti_tpu_torch.train"):
        _, rec = Trainer(later, params=params_from_jax(params), device="cpu").train(
            dataset=_dataset(texts))
    assert rec.resumed_from == 3 and rec.steps == 1
    assert any("splitmix64_v1" in r.getMessage() and "counter_hash_v1" in r.getMessage()
               for r in caplog.records)


class _NoHostSync(TorchDispatchMode):
    """Raises on an op that reads a tensor back to the host (``.item()``,
    ``float()``, ``int()``, ``bool()`` of a tensor: ``_local_scalar_dense``),
    ``nonzero`` and ``masked_select``."""

    FORBIDDEN = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
                 torch.ops.aten.masked_select.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.FORBIDDEN:
            raise AssertionError(f"host sync: {func}")
        return func(*args, **(kwargs or {}))


class _Poisoned:
    """``inner``'s batches with float loss masks; batch ``bad`` (0-based, in
    epoch 0) has a NaN in its mask."""

    def __init__(self, inner, bad):
        self.inner, self.bad = inner, bad
        self.shuffle_seed, self.pack = inner.shuffle_seed, inner.pack

    def steps_per_epoch(self):
        return self.inner.steps_per_epoch()

    def epoch(self, epoch_idx=0, skip_steps=0):
        for i, batch in enumerate(self.inner.epoch(epoch_idx, skip_steps)):
            batch = dict(batch, loss_mask=batch["loss_mask"].astype(np.float32))
            if epoch_idx == 0 and i == self.bad:
                batch["loss_mask"][0, 0, 5] = np.nan
            yield batch


def test_nonfinite_batch_inside_a_window_skips_its_update_without_reading_the_device(
        tmp_path, params, monkeypatch):
    texts = _texts(28)
    run = StepWindow.run

    def guarded(self, *args, **kw):
        with _NoHostSync():
            return run(self, *args, **kw)

    with _NoHostSync(), pytest.raises(AssertionError, match="host sync"):
        float(torch.ones(()))  # the guard sees float()
    runs = {}
    for k in (1, 4):
        cfg = _port_cfg(tmp_path, dropout=0.05, max_steps=7, steps_per_sync=k)
        trainer = Trainer(cfg, params=params_from_jax(params), device="cpu")
        with monkeypatch.context() as m:
            m.setattr(StepWindow, "run", guarded)
            state, rec = trainer.train(dataset=_Poisoned(_dataset(texts), bad=5))
        runs[k] = (rec, _lora(state), int(state.opt_state.count))
    rec, lora, count = runs[4]
    assert np.isnan(rec.losses[5]) and not np.isnan(rec.losses[4] + rec.losses[6])
    # 7 steps, 6 updates: the count, and with it the schedule, held once.
    assert rec.skipped_updates == 1 and count == 6 and rec.windows == 2
    rec1, lora1, count1 = runs[1]
    assert rec1.losses[:5] == rec.losses[:5] and rec1.losses[6:] == rec.losses[6:]
    assert count1 == count and all(torch.equal(p, lora1[n]) for n, p in lora.items())


# ----------------------------------------------------------------------
# The chunked loss, a loss_chunk train step and the eval step
# ----------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [64, 128])
def test_chunked_loss_matches_jax_in_loss_and_grads(chunk):
    """Sequence 100: 99 targets, so both chunk sizes pad the tail."""
    rng = np.random.default_rng(chunk)
    b, s, h, v = 2, 100, 16, 48
    hidden = rng.standard_normal((b, s, h)).astype(np.float32)
    head = rng.standard_normal((h, v)).astype(np.float32)
    ids = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.int32)

    def jloss(x, w):
        return jax_chunked_loss(x, w, jnp.asarray(ids), jnp.asarray(mask), chunk)

    xj, wj = jnp.asarray(hidden), jnp.asarray(head)
    jls, jnt = jloss(xj, wj)
    jgx, jgw = jax.grad(lambda x, w: jloss(x, w)[0], argnums=(0, 1))(xj, wj)
    x = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(head).requires_grad_()
    ls, nt = chunked_causal_lm_loss(x, w, torch.from_numpy(ids), torch.from_numpy(mask), chunk)
    gx, gw = torch.autograd.grad(ls, (x, w))
    assert float(nt) == float(jnt)
    ls = ls.detach()
    np.testing.assert_allclose(float(ls), float(jls), rtol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-6)
    # ... and the port's unchunked loss on the same logits.
    full, _ = causal_lm_loss(x @ w, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(float(ls), float(full.detach()), rtol=1e-5)


def _pair(params):
    jcfg, tcfg = jc.MODEL_PRESETS["llama_tiny"], tc.MODEL_PRESETS["llama_tiny"]
    jlora, tlora = jc.LoRAConfig(**LORA), tc.LoRAConfig(**LORA)
    jmodel = JaxLlama(jcfg, jlora)
    jstate = jax_create_state(jax.random.PRNGKey(0), jmodel,
                              jax_build_optimizer(jc.OptimizerConfig(**OPT)), (BS, SEQ),
                              init_fn=lambda rng, x: params)
    model = load_model(tcfg, params_from_jax(params), "cpu", lora=tlora, trainable_lora=True)
    tstate = create_train_state(model, build_optimizer(tc.OptimizerConfig(**OPT)))
    return jmodel, jstate, model, tstate


def _batch(seed, shape=(ACCUM, BS, SEQ)):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(3, 512, shape).astype(np.int32),
            "loss_mask": (rng.random(shape) > 0.2).astype(np.int32)}


def test_loss_chunk_train_step_matches_jax(params):
    jmodel, jstate, model, tstate = _pair(params)
    jstep = jax.jit(jax_make_step(jmodel, accum_steps=ACCUM, loss_chunk=16))
    tstep = make_train_step(model, accum_steps=ACCUM, loss_chunk=16)
    for i in range(3):
        batch = _batch(20 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(i))
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=RTOL)
    flat = params_from_jax(jax.device_get(jstate.params))
    for n, p in _lora(tstate).items():
        _assert_rel(p.numpy(), flat[n].numpy(), n)


@pytest.mark.parametrize("loss_chunk", [0, 16])
def test_eval_step_matches_jax(params, loss_chunk):
    jmodel, jstate, model, tstate = _pair(params)
    batch = _batch(30, shape=(2 * BS, SEQ))
    jm = jax.jit(jax_make_eval_step(jmodel, loss_chunk=loss_chunk))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = make_eval_step(model, loss_chunk=loss_chunk)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL)
    assert float(tm["num_tokens"]) == float(jm["num_tokens"])


# ----------------------------------------------------------------------
# The dropout mask
# ----------------------------------------------------------------------

def _keep_mask(shape, key, keep_prob):
    rows = int(np.prod(shape[:-1]))
    row_hash, col_hash = dropout_hashes(key, rows, shape[-1])
    return keep_mask_from(row_hash, col_hash, shape[-1], keep_prob).reshape(shape)


def test_dropout_mask_keeps_one_minus_rate_and_depends_only_on_key_and_element():
    rate, shape = 0.05, (4, 512, 1024)
    key = torch.tensor(0x12345678, dtype=torch.int64)
    keep = _keep_mask(shape, key, 1 - rate)
    n = keep.numel()
    # Kept share, and both-dropped shares of row and column neighbours, each
    # within 5 standard deviations of independent Bernoulli draws.
    kept = keep.float().mean().item()
    assert abs(kept - (1 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / n)
    dropped = ~keep
    p2 = rate * rate
    for both in ((dropped[..., 1:] & dropped[..., :-1]), (dropped[:, 1:] & dropped[:, :-1])):
        share = both.float().mean().item()
        assert abs(share - p2) <= 5 * np.sqrt(p2 * (1 - p2) / both.numel()), share
    # A function of (key, element): the same element of a reshaped or
    # shorter tensor draws the same; another key draws another mask.
    assert torch.equal(_keep_mask((2048, 1024), key, 1 - rate).reshape(shape), keep)
    assert torch.equal(_keep_mask((3, 512, 1024), key, 1 - rate), keep[:3])
    # Hashes of a longer column range give the same mask on the first columns.
    row_hash, col_hash = dropout_hashes(key, 2048, 4096)
    assert torch.equal(keep_mask_from(row_hash, col_hash, 1024, 1 - rate).reshape(shape), keep)
    other = _keep_mask(shape, key + 1, 1 - rate)
    assert (other != keep).float().mean().item() > rate


def test_dropout_keys_differ_by_layer_projection_and_seed():
    keys = dropout_keys(7, 3, "cpu")
    assert keys.shape == (3, len(PROJECTIONS)) and keys.unique().numel() == keys.numel()
    assert torch.equal(dropout_keys(torch.tensor(7), 3, "cpu"), keys)
    assert not torch.equal(dropout_keys(8, 3, "cpu"), keys)


# ----------------------------------------------------------------------
# cli.train with the new flags
# ----------------------------------------------------------------------

def test_cli_runs_windows_with_loss_chunk_and_eval(tmp_path, capsys):
    from dlti_tpu_torch.cli import train as cli

    for name, n in (("train", 28), ("held_out", 8)):
        (tmp_path / name).mkdir()
        (tmp_path / name / "data.jsonl").write_text(
            "".join(json.dumps({"text": t}) + "\n" for t in _texts(n, seed=len(name))))
    args = ["--device", "cpu", "--model", "llama_tiny", "--tokenizer", "byte",
            "--dataset-path", str(tmp_path / "train"), "--max-seq-len", "32",
            "--per-device-batch-size", "2", "--gradient-accumulation-steps", "2",
            "--max-steps", "6", "--steps-per-sync", "4", "--loss-chunk", "8",
            "--eval-dataset", str(tmp_path / "held_out"), "--eval-steps", "4",
            "--save-strategy", "no", "--logging-steps", "1"]
    cli.main(args)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["windows"] == 2 and summary["eval_steps"] == [4]
    assert np.isfinite(summary["eval_losses"][0]) and summary["host_syncs_per_step"] == 2 / 6
    (tmp_path / "store").mkdir()
    (tmp_path / "store" / "meta.json").write_text("{}")
    i = args.index("--eval-dataset") + 1
    with pytest.raises(SystemExit, match="data/streaming.py"):
        cli.main(args[:i] + [str(tmp_path / "store")] + args[i + 1:])
    with pytest.raises(SystemExit, match="--eval-steps"):
        i = args.index("--eval-steps")
        cli.main(args[:i] + args[i + 2:])
