"""The training loop for one device: the port of
``dlti_tpu/training/trainer.py``'s ``Trainer`` on its flat single-device
path (``_build_step``'s last branch and the loop of ``train``, with its
``steps_per_sync`` windows, eval, checkpoint save and verified resume).

``Trainer(cfg).train(dataset=..., eval_dataset=...)`` builds the model
(random weights from ``cfg.train.seed`` unless the caller passes
``params``), the optimizer and the train state, then runs epochs of the
dataset's batches up to ``cfg.train.max_steps``, in windows of
``cfg.train.steps_per_sync`` steps with one host synchronisation each
(``training.step.StepWindow``; the reference's ``exec_window``). On the
card every step runs as one CUDA graph, at every window length including 1:
the port's counterpart of the reference's jitted step.
``Trainer(..., cuda_graphs=False)`` runs the steps eagerly on the card
instead, for tests and ``chip_smoke.py`` only; on the CPU they always run
eagerly. A window that ``max_steps`` or an epoch's end cuts short runs
with its shorter length, as the reference's ``drain_window``.

Step N (1-based) seeds its LoRA dropout with ``step_seed(cfg.train.seed + 1,
N)``, as the reference folds the step index into ``PRNGKey(seed + 1)``, so
the masks do not depend on how the run got to step N or on the window
length. After each window the host books its steps (losses, grad norms,
skipped updates; every ``logging_steps`` a log line), then evaluates when
the window crossed a multiple of ``cfg.train.eval_steps`` (``eval_dataset``,
every batch of its first epoch, token-weighted), then saves when it crossed
a multiple of ``save_steps``: eval and saves land at window boundaries, at
the window's end state. The returned :class:`TrainRecord` has the per-step
losses and grad norms, the eval losses, tokens/s, step time, MFU, peak
device memory, host syncs per step, and the checkpoint's stalls and restore
time.

Checkpoints follow ``cfg.checkpoint`` as in the reference: when a window
crossed a multiple of ``save_steps`` (``"steps"``), at each epoch's end
(``"epoch"``) or never (``"no"``), through ``checkpoint.store`` in the JAX
package's format (async, rotated to ``save_total_limit``), with a sidecar
holding the data cursor (executed steps only), the seeds and the dataset's
schedule. Unless ``cfg.checkpoint.resume`` is off, ``train`` first restores
the newest checkpoint under ``output_dir`` that verifies, and skips the data
the checkpoint had consumed (``dataset.epoch(..., skip_steps=...)``), so a
resumed run replays the uninterrupted run's steps bit for bit. SIGTERM (from
the main thread) asks for one last checkpoint at the next window boundary
and a clean return: a window still filling is dropped (its batches were
never counted, so a resume replays them). Under LoRA the frozen base's host
copy is kept from one save to the next (``checkpoint.store.HostCache``).
Every exit path waits for the pending saves.

Runs on ``cuda`` unless given ``device="cpu"``; without a card and without a
device it raises. Not ported (each raises or is absent, see ROADMAP.md):
meshes, ZeRO, TP/SP/PP, host offload, the int8 frozen base, the fp16
scaler, the step log and other telemetry, the sentinel's rollback and data
quarantine, chaos and elastic training.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Mapping, Optional

import numpy as np
import torch

from dlti_tpu_torch.checkpoint import store
from dlti_tpu_torch.config import Config
from dlti_tpu_torch.models.interop import init_params, load_model
from dlti_tpu_torch.models.lora import count_params
from dlti_tpu_torch.training.optimizer import build_optimizer
from dlti_tpu_torch.training.state import (
    TrainState, create_train_state, frozen_param_keys, load_state_leaves, state_leaves,
)
from dlti_tpu_torch.training.step import (
    METRICS, StepWindow, batch_signature, make_eval_step,
)
from dlti_tpu_torch.utils.device import resolve_device, to_host, upload
from dlti_tpu_torch.utils.metrics import H100_BF16_PEAK_FLOPS, compute_mfu

logger = logging.getLogger("dlti_tpu_torch.train")

# Steps whose time is left out of the throughput (allocator and kernel
# build warm-up), as the reference's StepTimer(warmup_steps=2); the whole
# first window is left out too, since it holds the graph's capture.
WARMUP_STEPS = 2
# The sidecar's name for how step N's dropout masks are drawn: a counter
# hash of (step_seed(seed + 1, N), microbatch, layer, projection, element),
# not the reference's fold_in, so the two packages draw different masks.
RNG_SCHEDULE = "counter_hash_v1"


@dataclass
class TrainRecord:
    """What a run measured. Times are host wall clock around each window,
    which ends in its one device synchronisation (the metrics are read);
    each of a window's steps is booked the window's time over its length."""

    device: str
    losses: List[float] = field(default_factory=list)
    grad_norms: List[float] = field(default_factory=list)
    skipped_updates: int = 0
    step_times_s: List[float] = field(default_factory=list)
    tokens_per_step: int = 0
    step_time_s: float = 0.0           # mean after the warm-up steps
    tokens_per_second: float = 0.0
    mfu_percent: Optional[float] = None  # vs the H100's dense bf16 peak; card only
    peak_memory_gb: Optional[float] = None  # None: not measured (CPU)
    trainable_params: int = 0
    total_params: int = 0
    resumed_from: Optional[int] = None   # the checkpoint step restored
    restore_s: Optional[float] = None    # scan, re-hash, read, placement
    save_steps: List[int] = field(default_factory=list)
    # Time each save held the loop (the host snapshot), in seconds.
    save_stall_s: List[float] = field(default_factory=list)
    # Windows run (each one host synchronisation) and graph captures.
    windows: int = 0
    captures: int = 0
    eval_steps: List[int] = field(default_factory=list)
    eval_losses: List[float] = field(default_factory=list)

    @property
    def steps(self) -> int:
        return len(self.losses)

    @property
    def final_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")

    @property
    def host_syncs_per_step(self) -> float:
        """Window synchronisations per step (evals and saves add their own)."""
        return self.windows / self.steps if self.steps else 0.0


class Trainer:
    def __init__(self, cfg: Config, params: Optional[Mapping[str, torch.Tensor]] = None,
                 device=None, *, cuda_graphs: bool = True):
        t = cfg.train
        unported = [name for name, on in (
            ("train.fp16", t.fp16),
            ("train.quantize_frozen_base", t.quantize_frozen_base),
            ("mixture-of-experts models", cfg.model.num_experts > 0)) if on]
        if unported:
            raise NotImplementedError(f"not ported yet (see ROADMAP.md): "
                                      f"{', '.join(unported)}")
        if cfg.checkpoint.save_strategy not in ("steps", "epoch", "no"):
            raise ValueError(f"unknown save_strategy {cfg.checkpoint.save_strategy!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        self.cuda_graphs = cuda_graphs
        self.tx = build_optimizer(cfg.optimizer)
        self._stop_requested = False
        self._last_save_step: Optional[int] = None
        self._cache: Optional[store.HostCache] = None

    def request_stop(self) -> None:
        """Ask the loop to checkpoint and return at the next window boundary
        (what the SIGTERM handler calls on preemption)."""
        self._stop_requested = True

    def init_state(self) -> TrainState:
        cfg = self.cfg
        lora = cfg.lora if cfg.lora.enabled else None
        params = self.params
        if params is None:
            params = init_params(cfg.model, seed=cfg.train.seed, device=self.device,
                                 lora=lora)
        model = load_model(cfg.model, params, self.device, lora=lora,
                           trainable_lora=True)
        return create_train_state(model, self.tx, lora_enabled=cfg.lora.enabled)

    def train(self, dataset, eval_dataset=None, state: Optional[TrainState] = None
              ) -> tuple:
        """Run the configured epochs of ``dataset`` (a ``TokenBatchDataset``,
        re-iterated per epoch), first resuming from the newest verified
        checkpoint unless ``cfg.checkpoint.resume`` is off, evaluating on
        ``eval_dataset`` every ``cfg.train.eval_steps``; returns
        ``(state, TrainRecord)``."""
        cfg, ck = self.cfg, self.cfg.checkpoint
        state = state or self.init_state()
        sync_k = max(1, int(cfg.train.steps_per_sync))
        dropout = cfg.lora.enabled and cfg.lora.dropout > 0
        window = StepWindow(state.model, accum_steps=cfg.train.grad_accum_steps,
                            loss_chunk=cfg.train.loss_chunk,
                            seed=cfg.train.seed + 1 if dropout else None,
                            capacity=sync_k, cuda_graphs=self.cuda_graphs)
        eval_fn = (make_eval_step(state.model, loss_chunk=cfg.train.loss_chunk)
                   if eval_dataset is not None and cfg.train.eval_steps else None)
        trainable, total = count_params(dict(state.model.named_parameters()))
        logger.info("trainable params: %s / %s (%.4f%%)", f"{trainable:,}",
                    f"{total:,}", 100 * trainable / total)
        tokens_per_step = (cfg.train.micro_batch_size * cfg.train.grad_accum_steps
                           * cfg.data.max_seq_len)
        record = TrainRecord(device=str(self.device), tokens_per_step=tokens_per_step,
                             trainable_params=trainable, total_params=total)
        on_cuda = self.device.type == "cuda"
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        saving = ck.save_strategy != "no"
        self._stop_requested = False
        self._last_save_step = None
        self._cache = store.HostCache(frozen_param_keys(state)) if saving else None

        prev_handler, sigterm_installed = None, False
        if threading.current_thread() is threading.main_thread():
            prev_handler = signal.signal(signal.SIGTERM, lambda *_: self.request_stop())
            sigterm_installed = True
        first_window = 0  # steps of the first window, left out of the timing
        try:
            resume_meta, data_cursor = None, 0
            if saving and ck.resume:
                resume_meta, data_cursor = self._resume(state, record)
            spe = dataset.steps_per_epoch()
            start_epoch, skip_steps = 0, 0
            if data_cursor > 0 and spe > 0:
                start_epoch = min(data_cursor // spe, cfg.train.num_epochs)
                skip_steps = data_cursor % spe
                self._check_schedule(resume_meta, dataset, spe)

            cursor, samples_seen = data_cursor, 0

            def sidecar() -> dict:
                return {
                    "format": 1, "step": state.step, "data_pos": cursor,
                    "epoch": cursor // spe if spe else 0,
                    "step_in_epoch": cursor % spe if spe else 0,
                    "samples_seen": samples_seen, "seed": cfg.train.seed,
                    "rng_schedule": RNG_SCHEDULE, "skip_list": [],
                    "dataset": {
                        "kind": type(dataset).__name__, "steps_per_epoch": spe,
                        "shuffle_seed": getattr(dataset, "shuffle_seed", None),
                        "packed": bool(getattr(dataset, "pack", False))},
                    "prefetch_depth": 0, "fp16": False,
                }

            def run_window(batches: list) -> None:
                """Execute ``batches`` as one window, read its metrics once,
                book its steps, then eval and save at its boundary."""
                nonlocal cursor, samples_seen, first_window
                before, k = state.step, len(batches)
                t0 = time.perf_counter()
                rows = to_host(window.run(state, batches, before + 1))[0]
                dt = time.perf_counter() - t0
                record.windows += 1
                first_window = first_window or k
                for i, row in enumerate(rows.tolist()):
                    m = dict(zip(METRICS, row))
                    record.losses.append(m["loss"])
                    record.grad_norms.append(m["grad_norm"])
                    record.skipped_updates += int(m["skipped_update"])
                    record.step_times_s.append(dt / k)
                    cursor += 1
                    samples_seen += cfg.train.micro_batch_size * cfg.train.grad_accum_steps
                    step = before + i + 1
                    if step % cfg.train.logging_steps == 0:
                        logger.info("step %d | loss %.4f | grad_norm %.3f | %.3f s",
                                    step, m["loss"], m["grad_norm"], dt / k)
                every = cfg.train.eval_steps
                if eval_fn is not None and state.step // every > before // every:
                    self._run_eval(eval_fn, state, eval_dataset, record)
                self._maybe_save(state, record, epoch_end=False, sidecar=sidecar,
                                 crossed_from=before)

            for epoch in range(start_epoch, cfg.train.num_epochs):
                skip = skip_steps if epoch == start_epoch else 0
                pending: list = []
                for host_batch in dataset.epoch(epoch, skip_steps=skip):
                    # A pending window is shorter than the steps left, so
                    # this never skips a queued step.
                    if cfg.train.max_steps and state.step >= cfg.train.max_steps:
                        break
                    if pending and batch_signature(pending[0]) != batch_signature(host_batch):
                        run_window(pending)  # a batch of another shape: a new window
                        pending = []
                        if self._stop_requested:
                            break
                    pending.append(host_batch)
                    take = sync_k
                    if cfg.train.max_steps:
                        take = min(take, cfg.train.max_steps - state.step)
                    if len(pending) < take:
                        if self._stop_requested:
                            pending = []  # never counted: a resume replays them
                            break
                        continue
                    run_window(pending)
                    pending = []
                    if self._stop_requested:
                        break
                if pending and not self._stop_requested:
                    run_window(pending)  # the epoch's tail, shorter than a window
                self._maybe_save(state, record, epoch_end=True, sidecar=sidecar)
                if cfg.train.max_steps and state.step >= cfg.train.max_steps:
                    break
                if self._stop_requested:
                    break
            if self._stop_requested and saving:
                # The stop may have landed on a step that was just saved.
                store.wait_for_saves(ck.output_dir)
                if self._last_save_step != state.step:
                    self._save(state, record, sidecar(), async_save=False)
                    logger.info("preemption checkpoint written at step %d", state.step)
        finally:
            record.captures = window.captures
            window.release()
            if sigterm_installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)
            if saving:
                # Settle async saves on every exit path; failures are logged
                # by the store, never raised, so an exception stays unmasked.
                try:
                    store.wait_for_saves(ck.output_dir)
                except Exception:
                    logger.exception("settling in-flight checkpoint saves failed")
            self._cache = None  # the frozen base's host copy goes with the run

        timed = (record.step_times_s[max(WARMUP_STEPS, first_window):]
                 or record.step_times_s)
        if timed:
            record.step_time_s = sum(timed) / len(timed)
            record.tokens_per_second = tokens_per_step / record.step_time_s
        if on_cuda and timed:
            record.mfu_percent = compute_mfu(
                record.tokens_per_second, cfg.model.num_params(),
                H100_BF16_PEAK_FLOPS, trainable_params=trainable)
        if on_cuda:
            record.peak_memory_gb = torch.cuda.max_memory_allocated(self.device) / 1e9
        return state, record

    def _run_eval(self, eval_fn, state: TrainState, eval_dataset,
                  record: TrainRecord) -> None:
        """Book the token-weighted loss over every batch of
        ``eval_dataset``'s first epoch (the accum axis flattened into rows),
        read back once."""
        parts = []
        for batch in eval_dataset.epoch(0):
            flat = {k: upload(np.ascontiguousarray(v.reshape((-1,) + v.shape[2:])),
                              self.device) for k, v in batch.items()}
            m = eval_fn(state, flat)
            parts.append(torch.stack([m["loss"], m["num_tokens"]]))
        losses, toks = 0.0, 0.0
        if parts:
            for loss, n in to_host(torch.stack(parts))[0].tolist():
                losses += loss * n
                toks += n
        eval_loss = losses / toks if toks else float("nan")
        if toks:
            logger.info("eval @ step %d | loss %.4f", state.step, eval_loss)
        record.eval_steps.append(state.step)
        record.eval_losses.append(eval_loss)

    def _resume(self, state: TrainState, record: TrainRecord) -> tuple:
        """Restore the newest verified checkpoint into ``state``; returns
        (sidecar, data cursor), (None, 0) when there is nothing to resume."""
        cfg = self.cfg
        t0 = time.perf_counter()
        restored = store.restore_latest_verified(
            cfg.checkpoint.output_dir, state_leaves(state), cache=self._cache)
        if restored is None:
            return None, 0
        leaves, step, meta = restored
        load_state_leaves(state, leaves)
        self._cache.bind_restored(state_leaves(state))
        record.resumed_from, record.restore_s = step, time.perf_counter() - t0
        self._last_save_step = step  # committed already: a due save there is a no-op
        logger.info("resumed from verified checkpoint step %d", step)
        if meta and meta.get("seed", cfg.train.seed) != cfg.train.seed:
            logger.warning("checkpoint was saved with train.seed=%s but this run uses "
                           "%s; the resumed loss trajectory will not match the "
                           "original run's", meta.get("seed"), cfg.train.seed)
        if meta and meta.get("rng_schedule", RNG_SCHEDULE) != RNG_SCHEDULE:
            logger.warning("checkpoint was saved under the dropout schedule %r but "
                           "this run draws with %r; the resumed loss trajectory will "
                           "not match the original run's", meta.get("rng_schedule"),
                           RNG_SCHEDULE)
        cursor = int(meta["data_pos"]) if meta and meta.get("data_pos") is not None \
            else int(step)
        return meta, cursor

    @staticmethod
    def _check_schedule(meta: Optional[dict], dataset, spe: int) -> None:
        saved = (meta or {}).get("dataset")
        if not saved:
            return
        if saved.get("steps_per_epoch") not in (None, 0, spe):
            logger.warning("checkpoint sidecar recorded steps_per_epoch=%s but this "
                           "dataset yields %s; mid-epoch resume will replay a "
                           "different batch schedule", saved.get("steps_per_epoch"), spe)
        current = getattr(dataset, "shuffle_seed", None)
        if saved.get("shuffle_seed", current) != current:
            logger.warning("checkpoint sidecar recorded shuffle_seed=%s but this "
                           "dataset uses %s; batch order will differ from the "
                           "original run", saved.get("shuffle_seed"), current)

    def _maybe_save(self, state: TrainState, record: TrainRecord, epoch_end: bool,
                    sidecar: Callable[[], dict],
                    crossed_from: Optional[int] = None) -> None:
        """Save when due: under ``"steps"``, when the window that advanced
        the step from ``crossed_from`` crossed a multiple of ``save_steps``
        (without ``crossed_from``, when the step is one); under ``"epoch"``,
        at an epoch's end."""
        ck = self.cfg.checkpoint
        if crossed_from is None:
            steps_due = state.step % ck.save_steps == 0
        else:
            steps_due = state.step // ck.save_steps > crossed_from // ck.save_steps
        due = ((ck.save_strategy == "steps" and state.step > 0 and steps_due)
               or (ck.save_strategy == "epoch" and epoch_end))
        # A save_steps boundary that is also the epoch's end is due twice.
        if due and self._last_save_step != state.step:
            self._save(state, record, sidecar(), async_save=ck.async_save)

    def _save(self, state: TrainState, record: TrainRecord, meta: dict,
              async_save: bool) -> None:
        ck = self.cfg.checkpoint
        self._last_save_step = state.step
        t0 = time.perf_counter()
        store.save_train_state(
            ck.output_dir, state.step, state_leaves(state), keep=ck.save_total_limit,
            async_save=async_save, train_meta=meta, retries=ck.save_retries,
            retry_backoff_s=ck.save_retry_backoff_s, cache=self._cache)
        record.save_steps.append(state.step)
        record.save_stall_s.append(time.perf_counter() - t0)
