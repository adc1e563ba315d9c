"""The port's checkpoint store and the trainer's save/resume, against the
JAX package's store on the same bytes (``llama_tiny``, CPU).

* The store's contract, ported from ``tests/test_crash_consistency.py``:
  roundtrip with sidecar, idempotent re-save, rotation, every
  ``dlti_tpu.checkpoint.chaos.CORRUPT_MODES`` damage quarantined with
  fallback, a torn async save, all checkpoints corrupt, a transient retry,
  a bounded failure that never raises on wait, structure mismatch,
  truncation, and pytree verification. The damage is made by the JAX
  package's own chaos helpers, on the port's checkpoints.
* The frozen-leaf host cache: a save that reuses it writes the same bytes
  as one that does not, and an in-place write to a cached tensor is saved.
* The trainer: a mid-epoch resume replays the uninterrupted run's losses
  bit for bit (packed and unpadded rows, LoRA dropout on); the epoch and
  ``no`` strategies; SIGTERM's final checkpoint; saves settle when a run
  raises.
* Across the packages (LoRA dropout 0, inputs from numpy seeds): a JAX
  checkpoint restores bit-equal in the port and two more steps agree to
  ``RTOL``; a port checkpoint passes the JAX ``verify_checkpoint``,
  restores bit-equal into a JAX template and exports through
  ``export_params_host``; both packages write the same manifest for the
  same state; a run resumed in the other package matches the
  uninterrupted one to ``RTOL``, both ways.
"""

import ast
import dataclasses
import json
import logging
import os
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlti_tpu import config as jc
from dlti_tpu.checkpoint import store as jstore
from dlti_tpu.checkpoint.chaos import CORRUPT_MODES, corrupt_checkpoint, make_torn_save
from dlti_tpu.data import make_batches as jax_make_batches
from dlti_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.training.optimizer import build_optimizer as jax_build_optimizer
from dlti_tpu.training.state import create_train_state as jax_create_state
from dlti_tpu.training.step import make_train_step as jax_make_step
from dlti_tpu.training.trainer import Trainer as JaxTrainer
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.checkpoint import export_params_host as port_export_params_host
from dlti_tpu_torch.checkpoint import store
from dlti_tpu_torch.checkpoint.store import (
    CheckpointCorruptError, HostCache, corrupt_skipped, flatten_tree, save_retries,
)
from dlti_tpu_torch.data import ByteTokenizer, TokenBatchDataset, make_batches
from dlti_tpu_torch.models import load_model, params_from_jax
from dlti_tpu_torch.training import (
    Trainer, build_optimizer, create_train_state, make_train_step,
)
from dlti_tpu_torch.training.state import load_state_leaves, state_leaves
from dlti_tpu_torch.utils import durable_io

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5  # tests/test_torch_training.py: float32 in two frameworks
LORA = dict(r=4, alpha=8, dropout=0.0)
OPT = dict(learning_rate=1e-2, warmup_steps=2, grad_clip=0.5)
ACCUM, BS, SEQ = 2, 2, 32


# ----------------------------------------------------------------------
# Store contract (no Trainer)
# ----------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 3, generator=g),
            "b": {"scale": torch.arange(3, dtype=torch.bfloat16) + seed,
                  "count": torch.tensor(7 + seed, dtype=torch.int32)}}


def _leaves(seed=0):
    return flatten_tree(_tree(seed))


def _zeros():
    return [(n, torch.zeros_like(t)) for n, t in _leaves(0)]


def _value(leaves, name):
    return dict(leaves)[name]


def test_save_restore_roundtrip_and_sidecar(tmp_path):
    d = str(tmp_path)
    store.save_train_state(d, 2, _leaves(0), keep=3, async_save=True,
                           train_meta={"step": 2, "epoch": 0})
    store.save_train_state(d, 5, _leaves(1), keep=3, async_save=True,
                           train_meta={"step": 5, "epoch": 1})
    store.wait_for_saves(d)
    assert store.list_checkpoint_steps(d) == [2, 5]
    assert store.latest_step(d) == 5 and store.latest_verified_step(d) == 5
    assert store.verify_checkpoint(d, 5) == (True, "ok")
    out = store.restore_train_state(d, 5, _zeros())
    for (n, got), (_, want) in zip(out, _leaves(1)):
        assert got.dtype == want.dtype and torch.equal(got, want), n
    assert _value(out, "['b']['scale']").dtype == torch.bfloat16
    assert int(_value(out, "['b']['count']")) == 8
    assert store.load_train_meta(d, 5) == {"step": 5, "epoch": 1}
    assert (tmp_path / "5" / "COMMIT").is_file()
    assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]


def test_duplicate_save_is_idempotent(tmp_path):
    d = str(tmp_path)
    store.save_train_state(d, 3, _leaves(0), async_save=False)
    store.save_train_state(d, 3, _leaves(1), async_save=False)  # resumed re-save
    out = store.restore_train_state(d, 3, _zeros())
    assert torch.equal(_value(out, "['w']"), _tree(0)["w"])


def test_rotation_keeps_newest(tmp_path):
    for step in (1, 2, 3, 4):
        store.save_train_state(str(tmp_path), step, _leaves(step), keep=2,
                               async_save=False)
    assert store.list_checkpoint_steps(str(tmp_path)) == [3, 4]


@pytest.mark.parametrize("mode", CORRUPT_MODES)
def test_corruption_quarantined_with_fallback(tmp_path, mode):
    """Every damage mode of the JAX package's chaos helpers, on the newest
    of two port checkpoints: the resume scan quarantines it (renamed and
    counted) and restores the older one."""
    d = str(tmp_path)
    store.save_train_state(d, 2, _leaves(0), async_save=False, train_meta={"step": 2})
    store.save_train_state(d, 4, _leaves(1), async_save=False, train_meta={"step": 4})
    corrupt_checkpoint(d, 4, mode)
    before = corrupt_skipped.value
    leaves, step, meta = store.restore_latest_verified(d, _zeros())
    assert step == 2 and meta == {"step": 2}
    assert torch.equal(_value(leaves, "['w']"), _tree(0)["w"])
    assert corrupt_skipped.value > before
    assert os.listdir(tmp_path / "_quarantine")
    assert store.list_checkpoint_steps(d) == [2]


def test_torn_async_save_is_quarantined(tmp_path):
    d = str(tmp_path)
    store.save_train_state(d, 2, _leaves(0), async_save=False)
    make_torn_save(d, 4)
    assert [n for n in os.listdir(d) if n.startswith(".tmp-")]
    assert store.latest_verified_step(d) == 2
    assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]
    assert os.listdir(tmp_path / "_quarantine")


def test_all_checkpoints_corrupt_returns_none(tmp_path):
    d = str(tmp_path)
    store.save_train_state(d, 2, _leaves(0), async_save=False)
    corrupt_checkpoint(d, 2, "bitflip-array")
    assert store.restore_latest_verified(d, _zeros()) is None


def _failing_writes(monkeypatch, match, n):
    """The next ``n`` writes to a path containing ``match`` raise EIO."""
    real, left = durable_io._raw_write_bytes, [n]

    def write(path, data):
        if match in path and left[0] > 0:
            left[0] -= 1
            raise OSError(5, "injected EIO", path)
        real(path, data)

    monkeypatch.setattr(durable_io, "_raw_write_bytes", write)
    return left


@pytest.mark.parametrize("faults,store_retries", [(2, 0), (4, 1)])
def test_save_retries_transient_failure(tmp_path, monkeypatch, faults, store_retries):
    """EIOs on one file: within the durable writer's budget (3 retries)
    they heal below the store; past it the store books a retry, restages
    into a fresh staging dir, and the commit still lands."""
    left = _failing_writes(monkeypatch, "l00000.bin", faults)
    before = save_retries.value
    store.save_train_state(str(tmp_path), 2, _leaves(0), async_save=False,
                           retries=3, retry_backoff_s=0.001)
    assert left[0] == 0
    assert save_retries.value == before + store_retries
    assert store.verify_checkpoint(str(tmp_path), 2) == (True, "ok")
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]


def test_save_failure_is_bounded_and_never_raises_on_wait(tmp_path, monkeypatch):
    def always_fail(tmp, p):
        raise OSError("disk on fire")

    monkeypatch.setattr(store, "_write_staging", always_fail)
    store.save_train_state(str(tmp_path), 2, _leaves(0), async_save=True,
                           retries=1, retry_backoff_s=0.001)
    store.wait_for_saves(str(tmp_path))  # must not raise
    assert store.list_checkpoint_steps(str(tmp_path)) == []


def test_restore_structure_mismatch_raises_value_error(tmp_path):
    d = str(tmp_path)
    store.save_train_state(d, 2, _leaves(0), async_save=False)
    with pytest.raises(ValueError, match="leaves|structure"):
        store.restore_train_state(d, 2, [("['only']", torch.zeros(2))])
    bad = [(n, torch.zeros(5, 5) if n == "['w']" else t) for n, t in _zeros()]
    with pytest.raises(ValueError, match="expects"):
        store.restore_train_state(d, 2, bad)
    renamed = [(n.replace("count", "cnt"), t) for n, t in _zeros()]
    with pytest.raises(ValueError, match="structure"):
        store.restore_train_state(d, 2, renamed)


def test_truncated_array_raises_corrupt_not_garbage(tmp_path):
    from dlti_tpu.checkpoint.chaos import truncate_file

    d = str(tmp_path)
    store.save_train_state(d, 2, _leaves(0), async_save=False)
    truncate_file(os.path.join(d, "2", "train_state", "l00000.bin"))
    with pytest.raises(CheckpointCorruptError):
        store.restore_train_state(d, 2, _zeros())


def test_export_pytree_verify_detects_corruption(tmp_path):
    from dlti_tpu.checkpoint.chaos import bit_flip_file

    p = {"m": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}}
    d = store.save_pytree(str(tmp_path / "model"), p)
    assert store.verify_pytree_dir(d) == (True, "ok")
    assert torch.equal(store.load_pytree(d, verify=True)["m"]["w"], p["m"]["w"])
    bit_flip_file(os.path.join(d, "train_state", "l00000.bin"))
    assert store.verify_pytree_dir(d)[0] is False
    with pytest.raises(CheckpointCorruptError):
        store.load_pytree(d, verify=True)


def test_store_metrics_render_with_the_reference_names():
    from dlti_tpu.checkpoint.store import CKPT_METRIC_NAMES as JAX_NAMES
    from dlti_tpu_torch.telemetry import MetricsRegistry

    assert store.CKPT_METRIC_NAMES == JAX_NAMES
    reg = MetricsRegistry()
    for m in (store.save_seconds, store.restore_seconds, store.corrupt_skipped,
              store.save_retries, store.last_verified_step):
        reg.register(m)
    corrupt_skipped.inc(0)
    store.last_verified_step.set(4)
    text = reg.render_prometheus()
    for name in JAX_NAMES:
        assert f"# TYPE {name} " in text, name
    assert "dlti_ckpt_last_verified_step 4.0" in text
    assert reg.stats_dict()["dlti_ckpt_last_verified_step"] == 4.0


# ----------------------------------------------------------------------
# The frozen-leaf host cache
# ----------------------------------------------------------------------

def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(Path(root).rglob("*.bin"))}


def _count_copies(monkeypatch):
    copied = []
    real = store._copy_to_host

    def copy(tensors):
        copied.append(len(tensors))
        return real(tensors)

    monkeypatch.setattr(store, "_copy_to_host", copy)
    return copied


def test_host_cache_reuse_writes_the_same_bytes(tmp_path, monkeypatch):
    live = _leaves(0)
    cache = HostCache(["['w']", "['b']['scale']"])
    copied = _count_copies(monkeypatch)
    store.save_train_state(str(tmp_path / "a"), 1, live, async_save=False, cache=cache)
    store.save_train_state(str(tmp_path / "a"), 2, live, async_save=False, cache=cache)
    store.save_train_state(str(tmp_path / "b"), 2, live, async_save=False)
    # Cold: the two cached leaves and the rest in their own buffers; warm:
    # only the uncached leaf is copied.
    assert copied == [1, 2, 1, 3]
    assert _files(tmp_path / "a" / "1") == _files(tmp_path / "a" / "2") == \
        _files(tmp_path / "b" / "2")
    for f in ("MANIFEST.json", "COMMIT"):
        assert (tmp_path / "a" / "2" / f).read_bytes() == (tmp_path / "b" / "2" / f).read_bytes()
    # An in-place write to a cached tensor bumps its version: saved anew.
    _value(live, "['w']").add_(1.0)
    store.save_train_state(str(tmp_path / "a"), 3, live, async_save=False, cache=cache)
    out = store.restore_train_state(str(tmp_path / "a"), 3, _zeros())
    assert torch.equal(_value(out, "['w']"), _tree(0)["w"] + 1.0)
    assert copied[-1] == 1 and copied[-2] == 1  # 'w' again, then the count


def test_restored_host_copies_serve_the_next_save(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    store.save_train_state(d, 1, _leaves(3), async_save=False)
    cache = HostCache(["['w']", "['b']['scale']"])
    leaves, step, _ = store.restore_latest_verified(d, _zeros(), cache=cache)
    live = [(n, t.clone()) for n, t in leaves]
    cache.bind_restored(live)
    assert len(cache) == 2
    copied = _count_copies(monkeypatch)
    store.save_train_state(d, 2, live, async_save=False, cache=cache)
    assert copied == [1]
    assert _files(Path(d) / "1") == _files(Path(d) / "2")


def test_async_saves_under_thread_switching_keep_each_snapshot(tmp_path):
    """Saves queued back to back while the live tensors change in place
    between them (the cached one every other save), with the interpreter
    switching threads every few microseconds: each committed step restores
    the values it had when it was saved."""
    import sys

    d = str(tmp_path)
    live = _leaves(0)
    cache = HostCache(["['w']"])
    want = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for step in range(1, 17):
            _value(live, "['b']['scale']").add_(1)
            if step % 2:
                _value(live, "['w']").mul_(1.5)
            want[step] = {n: t.clone() for n, t in live}
            store.save_train_state(d, step, live, keep=None, async_save=True, cache=cache)
        store.wait_for_saves(d)
    finally:
        sys.setswitchinterval(old)
    assert store.list_checkpoint_steps(d) == list(range(1, 17))
    for step, values in want.items():
        for name, t in store.restore_train_state(d, step, _zeros()):
            assert torch.equal(t, values[name]), (step, name)


# ----------------------------------------------------------------------
# The trainer: resume, strategies, preemption
# ----------------------------------------------------------------------

def _dataset(pack=False, n=96, seq_len=16):
    rng = np.random.default_rng(11)
    seqs = [list(map(int, rng.integers(1, 500, size=int(rng.integers(6, 12)))))
            for _ in range(n)]
    return TokenBatchDataset(sequences=seqs, seq_len=seq_len, pad_id=0,
                             micro_batch_size=2, grad_accum_steps=1, pack=pack)


@pytest.fixture
def caplog(caplog):
    """pytest's ``caplog``, its handler attached to the trainer's logger
    itself: once ``utils.logging.get_logger()`` has run in this process (the
    server calls it), the ``dlti_tpu_torch`` logger stops propagation, and a
    warning of ``dlti_tpu_torch.train`` never reaches the root handler."""
    train_logger = logging.getLogger("dlti_tpu_torch.train")
    train_logger.addHandler(caplog.handler)
    try:
        yield caplog
    finally:
        train_logger.removeHandler(caplog.handler)


def _tcfg(tmp_path, max_steps, save_steps=1000, save_strategy="steps", num_epochs=1,
          dropout=0.05, **ck):
    return tc.Config(
        model=tc.MODEL_PRESETS["llama_tiny"], lora=tc.LoRAConfig(r=2, alpha=4, dropout=dropout),
        optimizer=tc.OptimizerConfig(warmup_steps=2),
        data=tc.DataConfig(max_seq_len=16),
        checkpoint=tc.CheckpointConfig(output_dir=str(tmp_path / "ckpt"),
                                       save_strategy=save_strategy, save_steps=save_steps,
                                       save_total_limit=3, **ck),
        train=tc.TrainConfig(num_epochs=num_epochs, max_steps=max_steps,
                             micro_batch_size=2, grad_accum_steps=1, logging_steps=1000))


@pytest.mark.parametrize("pack", [False, True])
def test_midepoch_resume_bit_identical_losses(tmp_path, pack):
    """Weights, optimizer state, data cursor and the dropout schedule all
    restore: the steps after a mid-epoch resume give the uninterrupted
    run's exact losses."""
    _, ref = Trainer(_tcfg(tmp_path, 6, save_strategy="no"), device="cpu").train(
        dataset=_dataset(pack))
    assert len(ref.losses) == 6
    _, half = Trainer(_tcfg(tmp_path, 3, save_steps=3), device="cpu").train(
        dataset=_dataset(pack))
    ck = str(tmp_path / "ckpt")
    assert half.save_steps == [3] and store.latest_verified_step(ck) == 3
    meta = store.load_train_meta(ck, 3)
    assert meta["step"] == 3 and meta["data_pos"] == 3
    assert meta["rng_schedule"] == "counter_hash_v1"
    assert meta["dataset"]["steps_per_epoch"] > 0 and meta["dataset"]["packed"] == pack
    assert meta["skip_list"] == [] and meta["fp16"] is False
    state, rest = Trainer(_tcfg(tmp_path, 6), device="cpu").train(dataset=_dataset(pack))
    assert rest.resumed_from == 3 and state.step == 6
    assert rest.losses == ref.losses[3:]


def test_resume_across_an_epoch_boundary_and_no_resume(tmp_path):
    ds = _dataset(n=16)  # 8 steps an epoch
    _, ref = Trainer(_tcfg(tmp_path, 12, save_strategy="no", num_epochs=2),
                     device="cpu").train(dataset=ds)
    Trainer(_tcfg(tmp_path, 10, save_steps=5, num_epochs=2), device="cpu").train(dataset=ds)
    assert store.load_train_meta(str(tmp_path / "ckpt"), 10)["epoch"] == 1
    _, rest = Trainer(_tcfg(tmp_path, 12, num_epochs=2), device="cpu").train(dataset=ds)
    assert rest.resumed_from == 10 and rest.losses == ref.losses[10:]
    _, fresh = Trainer(_tcfg(tmp_path, 2, num_epochs=2, resume=False),
                       device="cpu").train(dataset=ds)
    assert fresh.resumed_from is None and fresh.losses == ref.losses[:2]


def test_epoch_and_no_strategies(tmp_path):
    ds = _dataset(n=12)  # 6 steps an epoch
    Trainer(_tcfg(tmp_path, 0, save_strategy="epoch", num_epochs=2), device="cpu").train(
        dataset=ds)
    assert store.list_checkpoint_steps(str(tmp_path / "ckpt")) == [6, 12]
    Trainer(_tcfg(tmp_path / "n", 4, save_strategy="no"), device="cpu").train(dataset=ds)
    assert not (tmp_path / "n").exists()
    # A save_steps boundary that is also the epoch's end saves once.
    _, rec = Trainer(_tcfg(tmp_path / "s", 6, save_steps=6), device="cpu").train(dataset=ds)
    assert rec.save_steps == [6]
    with pytest.raises(ValueError, match="save_strategy"):
        Trainer(_tcfg(tmp_path, 1, save_strategy="often"), device="cpu")


class _StopAt:
    """A dataset whose iteration sends SIGTERM (or, off the main thread,
    calls ``request_stop``) as it yields the batch of step ``at``."""

    def __init__(self, ds, at, trainer):
        self.ds, self.at, self.trainer = ds, at, trainer
        self.shuffle_seed, self.pack = ds.shuffle_seed, ds.pack

    def steps_per_epoch(self):
        return self.ds.steps_per_epoch()

    def epoch(self, epoch_idx=0, skip_steps=0):
        for i, b in enumerate(self.ds.epoch(epoch_idx, skip_steps), start=skip_steps + 1):
            if i == self.at:
                if signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL, None):
                    os.kill(os.getpid(), signal.SIGTERM)
                else:
                    self.trainer.request_stop()
            yield b


def test_sigterm_writes_one_final_checkpoint_and_resume_continues(tmp_path):
    _, ref = Trainer(_tcfg(tmp_path, 8, save_strategy="no"), device="cpu").train(
        dataset=_dataset())
    prev = signal.getsignal(signal.SIGTERM)
    trainer = Trainer(_tcfg(tmp_path, 8, save_steps=2), device="cpu")
    state, rec = trainer.train(dataset=_StopAt(_dataset(), 5, trainer))
    assert signal.getsignal(signal.SIGTERM) == prev  # handler restored
    assert state.step == 5 and rec.save_steps == [2, 4, 5]
    assert store.list_checkpoint_steps(str(tmp_path / "ckpt")) == [2, 4, 5]
    _, rest = Trainer(_tcfg(tmp_path, 8, save_steps=2), device="cpu").train(
        dataset=_dataset())
    assert rest.resumed_from == 5 and rest.losses == ref.losses[5:]


def test_pending_async_save_commits_when_the_run_raises(tmp_path):
    class Boom(RuntimeError):
        pass

    class Failing(_StopAt):
        def epoch(self, epoch_idx=0, skip_steps=0):
            for i, b in enumerate(self.ds.epoch(epoch_idx, skip_steps), start=1):
                if i == self.at:
                    raise Boom()
                yield b

    with pytest.raises(Boom):
        Trainer(_tcfg(tmp_path, 8, save_steps=3), device="cpu").train(
            dataset=Failing(_dataset(), 5, None))
    assert store.list_checkpoint_steps(str(tmp_path / "ckpt")) == [3]
    assert store.verify_checkpoint(str(tmp_path / "ckpt"), 3) == (True, "ok")


def test_seed_mismatch_on_resume_warns(tmp_path, caplog):
    Trainer(_tcfg(tmp_path, 2, save_steps=2), device="cpu").train(dataset=_dataset())
    cfg = _tcfg(tmp_path, 3)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=7))
    with caplog.at_level(logging.WARNING, logger="dlti_tpu_torch.train"):
        _, rec = Trainer(cfg, device="cpu").train(dataset=_dataset())
    assert rec.resumed_from == 2
    assert "train.seed=42 but this run uses 7" in caplog.text


def test_seed_mismatch_warning_is_captured_after_the_server_logger_exists(tmp_path, caplog):
    """The server's ``get_logger()`` turns off the package logger's
    propagation for the rest of the process; the trainer's warning must
    still reach ``caplog`` (the ``caplog`` fixture above)."""
    from dlti_tpu_torch.utils.logging import get_logger

    assert get_logger().propagate is False
    Trainer(_tcfg(tmp_path, 2, save_steps=2), device="cpu").train(dataset=_dataset())
    cfg = _tcfg(tmp_path, 3)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=7))
    with caplog.at_level(logging.WARNING, logger="dlti_tpu_torch.train"):
        _, rec = Trainer(cfg, device="cpu").train(dataset=_dataset())
    assert rec.resumed_from == 2
    assert "train.seed=42 but this run uses 7" in caplog.text


def _config_calls(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if name == "Config":
                yield node
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "Config(" in node.value:
            try:  # test programs run in a child process
                yield from _config_calls(ast.parse(node.value))
            except SyntaxError:
                pass


def test_no_port_test_relies_on_the_default_checkpoint_dir():
    """The default ``CheckpointConfig`` saves under, and resumes from,
    ``./checkpoints/run`` (the reference's default): every root ``Config``
    the port's tests and the chip scripts build names its checkpoint
    config, so none of them scans or writes the repository's
    ``./checkpoints``."""
    files = sorted(ROOT.glob("tests/test_torch_*.py")) + [ROOT / "chip_smoke.py",
                                                          ROOT / "chip_ab.py"]
    missing = []
    for path in files:
        for call in _config_calls(ast.parse(path.read_text())):
            if not any(k.arg in ("checkpoint", None) for k in call.keywords):
                missing.append(f"{path.name}:{call.lineno}")
    assert not missing, f"Config(...) without checkpoint=: {missing}"
    runs_cli = [p.name for p in files
                if ('"dlti_tpu_torch.cli.train"' in p.read_text()
                    or "train_cli.main(" in p.read_text())
                and "--output-dir" not in p.read_text()]
    assert not runs_cli, f"cli.train without --output-dir in {runs_cli}"


# ----------------------------------------------------------------------
# Across the packages
# ----------------------------------------------------------------------

def _jax_params(jcfg, seed=0):
    """JAX init plus numpy noise on every leaf (lora_b included)."""
    tree = JaxLlama(jcfg, jc.LoRAConfig(**LORA)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.asarray(a).dtype), jax.device_get(tree))


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(3, 512, (ACCUM, BS, SEQ)).astype(np.int32),
             "loss_mask": (rng.random((ACCUM, BS, SEQ)) > 0.2).astype(np.int32)}
            for _ in range(n)]


# float16 runs carry the dynamic loss scaler (the reference pairs them), here
# from a scale at which llama_tiny's steps do not overflow (at the default
# 2**16 both packages skip its first steps), so the moments move.
FP16_SCALE = 2.0 ** 8


class _Pair:
    """One model, optimizer and initial weights in both packages; ``dtype``
    is the base params' storage and compute dtype (LoRA factors stay
    float32); a float16 state carries the loss scaler."""

    def __init__(self, dtype="float32"):
        over = dict(dtype=dtype, param_dtype=dtype)
        self.jcfg = dataclasses.replace(jc.MODEL_PRESETS["llama_tiny"], **over)
        self.tcfg = dataclasses.replace(tc.MODEL_PRESETS["llama_tiny"], **over)
        self.fp16_scale = FP16_SCALE if dtype == "float16" else None
        params = _jax_params(self.jcfg)
        jmodel = JaxLlama(self.jcfg, jc.LoRAConfig(**LORA))
        self.jstate = jax_create_state(
            jax.random.PRNGKey(0), jmodel, jax_build_optimizer(jc.OptimizerConfig(**OPT)),
            (BS, SEQ), init_fn=lambda rng, x: params, fp16_initial_scale=self.fp16_scale)
        self.jstep = jax.jit(jax_make_step(jmodel, accum_steps=ACCUM))
        self.tstate = self.fresh_port_state(params)

    def fresh_port_state(self, params=None):
        if params is None:
            params = _jax_params(self.jcfg, seed=5)  # other weights: a template
        model = load_model(self.tcfg, params_from_jax(params), "cpu",
                           lora=tc.LoRAConfig(**LORA), trainable_lora=True)
        return create_train_state(model, build_optimizer(tc.OptimizerConfig(**OPT)),
                                  fp16_initial_scale=self.fp16_scale)

    def jax_steps(self, batches):
        out = []
        for b in batches:
            self.jstate, m = self.jstep(self.jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                        jax.random.PRNGKey(0))
            out.append(jax.device_get(m))
        return out

    def port_steps(self, batches, state=None):
        state = state or self.tstate
        step = make_train_step(state.model, accum_steps=ACCUM)
        return [step(state, {k: torch.from_numpy(v) for k, v in b.items()}, None)
                for b in batches]


def _jax_leaves(jstate):
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(jstate))
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in flat]


def _port_bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jax_bits(a):
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_jax_checkpoint_restores_bit_equal_in_the_port(tmp_path, dtype):
    pair = _Pair(dtype)
    batches = _batches(4)
    pair.jax_steps(batches[:2])
    jstore.save_train_state(str(tmp_path), 2, pair.jstate, async_save=False)
    state = pair.fresh_port_state()
    leaves, step, _ = store.restore_latest_verified(str(tmp_path), state_leaves(state))
    load_state_leaves(state, leaves)
    assert step == 2 and state.step == 2 and state.opt_state.count == 2
    ours = state_leaves(state)
    theirs = _jax_leaves(pair.jstate)
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    for (n, t), (_, a) in zip(ours, theirs):
        np.testing.assert_array_equal(_port_bits(t), _jax_bits(a), err_msg=n)
    if dtype == "float32":  # two more steps agree (bf16 compute would not)
        jm, tm = pair.jax_steps(batches[2:]), pair.port_steps(batches[2:], state)
        for j, t in zip(jm, tm):
            np.testing.assert_allclose(t["loss"], j["loss"], rtol=RTOL)
            np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_port_checkpoint_verifies_restores_and_exports_in_jax(tmp_path, dtype):
    from dlti_tpu.checkpoint.export import export_params_host

    pair = _Pair(dtype)
    pair.port_steps(_batches(2))
    d = str(tmp_path / "ck")
    store.save_train_state(d, pair.tstate.step, state_leaves(pair.tstate), async_save=False,
                           train_meta={"step": 2})
    assert jstore.verify_checkpoint(d, 2) == (True, "ok")
    assert jstore.latest_verified_step(d) == 2
    restored = jstore.restore_train_state(d, 2, pair.jstate)
    for (n, t), (_, a) in zip(state_leaves(pair.tstate), _jax_leaves(restored)):
        np.testing.assert_array_equal(_port_bits(t), _jax_bits(a), err_msg=n)
    assert int(restored.step) == 2
    digest = export_params_host(d, 2, str(tmp_path / "ex"))
    assert digest == jstore.manifest_digest(str(tmp_path / "ex"))
    assert port_export_params_host(d, 2, str(tmp_path / "ex_port")) == digest


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_both_packages_write_the_same_manifest(tmp_path, dtype):
    """The same state saved by each package: the same leaves in the same
    order with the same names, files, shapes, dtypes, sizes and digests,
    so the manifest and commit marker are byte-identical."""
    pair = _Pair(dtype)
    batches = _batches(2)
    pair.jax_steps(batches)
    jstore.save_train_state(str(tmp_path / "j"), 2, pair.jstate, async_save=False)
    state = pair.fresh_port_state()
    leaves, _, _ = store.restore_latest_verified(str(tmp_path / "j"), state_leaves(state))
    load_state_leaves(state, leaves)
    store.save_train_state(str(tmp_path / "t"), 2, state_leaves(state), async_save=False)
    mj = json.loads((tmp_path / "j" / "2" / "MANIFEST.json").read_text())
    mt = json.loads((tmp_path / "t" / "2" / "MANIFEST.json").read_text())
    scaler_leaves = 3 if dtype == "float16" else 0
    assert len(mj["leaves"]) == len(mt["leaves"]) == 72 + scaler_leaves
    for a, b in zip(mj["leaves"], mt["leaves"]):
        for key in ("name", "file", "shape", "dtype", "size", "sha256"):
            assert a[key] == b[key], (a["name"], key)
    for f in ("MANIFEST.json", "COMMIT"):
        assert (tmp_path / "j" / "2" / f).read_bytes() == (tmp_path / "t" / "2" / f).read_bytes()
    kinds = {e["dtype"] for e in mt["leaves"]}
    assert kinds == ({"int32", "float32"} | ({dtype} if dtype != "float32" else set()))
    if scaler_leaves:
        assert [e["name"] for e in mt["leaves"][-3:]] == [
            ".scaler['good_steps']", ".scaler['hysteresis_left']", ".scaler['scale']"]


def _texts(n=48):
    rng = np.random.default_rng(5)
    return ["".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(5, 60)))
            for _ in range(n)]


def _trainer_cfgs(tmp_path, tag, max_steps, save_strategy):
    common = dict(micro_batch_size=BS, grad_accum_steps=ACCUM, max_steps=max_steps,
                  logging_steps=100, num_epochs=1)
    ck = dict(output_dir=str(tmp_path / "ck"), save_strategy=save_strategy, save_steps=3)
    jcfg = jc.Config(
        model=jc.MODEL_PRESETS["llama_tiny"], lora=jc.LoRAConfig(**LORA),
        optimizer=jc.OptimizerConfig(**OPT),
        data=jc.DataConfig(max_seq_len=SEQ, tokenizer="byte"),
        checkpoint=jc.CheckpointConfig(**ck),
        telemetry=jc.TelemetryConfig(step_log_path=str(tmp_path / f"{tag}.jsonl")),
        train=jc.TrainConfig(metrics_csv=str(tmp_path / f"{tag}.csv"), **common))
    tcfg = tc.Config(
        model=tc.MODEL_PRESETS["llama_tiny"], lora=tc.LoRAConfig(**LORA),
        optimizer=tc.OptimizerConfig(**OPT),
        data=tc.DataConfig(max_seq_len=SEQ, tokenizer="byte"),
        checkpoint=tc.CheckpointConfig(**ck),
        train=tc.TrainConfig(**common))
    return jcfg, tcfg


def _jax_run(jcfg, params=None):
    trainer = JaxTrainer(jcfg)
    state = trainer.init_state()
    if params is not None:
        state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    ds = jax_make_batches(_texts(), JaxByteTokenizer(), seq_len=SEQ, micro_batch_size=BS,
                          grad_accum_steps=ACCUM, shard_by_host=False)
    trainer.train(dataset=ds, state=state)
    rows = [json.loads(line) for line in open(jcfg.telemetry.step_log_path)]
    return {r["step"]: r["loss"] for r in rows if r.get("type") == "step"}


def _port_run(tcfg, params=None):
    ds = make_batches(_texts(), ByteTokenizer(), seq_len=SEQ, micro_batch_size=BS,
                      grad_accum_steps=ACCUM)
    _, rec = Trainer(tcfg, params=params, device="cpu").train(dataset=ds)
    return rec


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_packages_matches_the_uninterrupted_run(tmp_path, first):
    """One package trains 3 steps and checkpoints; the other resumes to 6.
    Steps 4-6 match the resuming package's own uninterrupted 6-step run
    (same weights) to RTOL."""
    jcfg6, tcfg6 = _trainer_cfgs(tmp_path / "ref", "ref", 6, "no")
    start = jax.device_get(JaxTrainer(jcfg6).init_state().params)
    jcfg3, tcfg3 = _trainer_cfgs(tmp_path / "run", "half", 3, "steps")
    jcfg_rest, tcfg_rest = _trainer_cfgs(tmp_path / "run", "rest", 6, "steps")
    if first == "jax":
        _jax_run(jcfg3, start)
        assert store.latest_verified_step(str(tmp_path / "run" / "ck")) == 3
        ref = _port_run(tcfg6, params_from_jax(start)).losses
        rec = _port_run(tcfg_rest)
        assert rec.resumed_from == 3
        got = rec.losses
    else:
        half = _port_run(tcfg3, params_from_jax(start))
        assert half.save_steps == [3]
        assert jstore.latest_verified_step(str(tmp_path / "run" / "ck")) == 3
        ref = [v for _, v in sorted(_jax_run(jcfg6, start).items())]
        losses = _jax_run(jcfg_rest)
        assert sorted(losses) == [4, 5, 6]
        got = [losses[s] for s in (4, 5, 6)]
    assert len(ref) == 6
    np.testing.assert_allclose(got, ref[3:], rtol=RTOL)
