"""The training loop: the port of ``dlti_tpu/training/trainer.py``'s
``Trainer`` on its flat path (``_build_step`` and the loop of ``train``,
with its ``steps_per_sync`` windows, eval, checkpoint save and verified
resume), on one device or data parallel under ``cfg.parallel``: the
baseline or ZeRO-1/2/3, with ZeRO-3's host offload.

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
never counted, so a resume replays them). Under LoRA on one rank the frozen
base's host copy is kept from one save to the next
(``checkpoint.store.HostCache``).
Every exit path waits for the pending saves.

``cfg.train.fp16`` runs DeepSpeed's dynamic loss scaler (pair it with a
float16 model, as ``cli.train --fp16`` does): the state carries the scaler
from ``2 ** fp16_initial_scale_power``, a checkpoint saves it and a resume
restores it, each step's scale is in ``TrainRecord.loss_scales`` and its
overflows are counted in ``skipped_updates``.

Data parallelism: the trainer builds the mesh (``parallel.mesh.build_mesh``:
one process per device, in the process group the entry point formed, the
launcher's or ``launcher.init_group_of_one``) and places the state by the
strategy (``parallel.sharding.shard_model``; on one device without a
strategy every leaf stays whole); every rank runs its rows of each
microbatch (the dataset slices them, ``data.pipeline``), and the step's
collectives make the update the one a single device would make on the whole
batch. Rank 0 alone logs and writes checkpoints, consolidated (every leaf
whole, so a checkpoint of any strategy and world is the baseline's and the
JAX store's); the others join the gathers and wait on a barrier after the
commit. A resume scans on rank 0 and every rank restores the chosen step,
taking its shard. A stop (SIGTERM) is agreed by every rank at the window
boundary.

``cfg.train.quantize_frozen_base="int8"`` (LoRA only) keeps the frozen
base as int8 weights with per-channel scales (``models.quantization``):
each leaf is quantized as it is placed and its bf16 source let go, the
model expands a layer's weights at their use, and checkpoints hold the
``{q, scale}`` leaves under the JAX store's names.

Host batches come from a prefetch thread (``data.prefetch.HostPrefetcher``,
``cfg.data.prefetch_depth`` deep; 0 reads them on the training thread);
their copies into the step's inputs stay on the training thread. Rank 0
writes the per-step JSONL stream (``cfg.train.step_log_path``,
``telemetry.steplog``): a window's steps are booked at its one
synchronisation, from its metric rows. At the end rank 0 appends the
run's row of the reference's metrics CSV (``cfg.train.metrics_csv``,
``utils.metrics``); the row is also ``TrainRecord.metrics``, which
``cli.train`` prints as the reference's summary.

A mixture of experts (``cfg.model.num_experts`` > 0) trains with its
router's load-balance loss in the objective; each step's ``aux_loss`` is in
``TrainRecord.aux_losses``, and MFU counts the parameters a token touches
(``ModelConfig.num_active_params``), as the reference's trainer does. Under
``cfg.parallel.expert`` above 1 the experts are split over the expert axis
(``parallel.sharding``), and the ranks of one expert group take the same
rows of each batch (the dataset is sliced by the batch axes). Under
``cfg.parallel.tensor`` above 1 each rank holds its part of the heads,
hidden units and vocabulary (``parallel.tensor``'s rule), and the ranks of
one tensor group take the same rows. Under ZeRO-3 each leaf is sharded
over its own ``fsdp`` axis on a dim the tensor and expert axes leave free,
beside any model axis and beside ``data`` (a mixed ``data x fsdp`` mesh):
the one placement rule (``parallel.sharding.strategy_axes``) cuts every
leaf, by ``models.interop``'s ``shard_params`` or as drawn, and a
checkpoint or an export gathers the parts over every axis that splits
them into whole leaves on rank 0. ``params`` may be whole (this package's
names) or already this rank's tree under the mesh, as ``init_params(...,
mesh=)`` draws it (under pipe its stage's layers by their local names).

Under ``cfg.parallel.sequence`` above 1 each rank of a sequence group
runs its chunk of every row's tokens, attention over the ring, and the
group's ranks take the same rows (``training.step``). Under
``cfg.parallel.pipe`` above 1 each rank builds its stage's layers only
(``parallel.pipeline.stage_params``, or drawn so), ``grad_accum_steps`` is
the number of microbatches of the GPipe schedule (fewer than ``4 * pipe``
logs the reference's bubble warning), evals run the whole eval batch through
the stages as one microbatch, and a checkpoint holds the reference's stacked
layout, gathered whole on rank 0 (``training.state``).

Runs on ``cuda`` unless given ``device="cpu"``; without a card and without a
device it raises. Not ported (each raises or is absent, see ROADMAP.md):
tensor, sequence or pipe with offload, pipe x sequence, sequence with a
mixture of experts, tensor with expert, the reference's other telemetry
(tracer, goodput and memory ledgers, watchdog), the sentinel's rollback and
data quarantine, chaos and elastic training.
"""

from __future__ import annotations

import logging
import math
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from dlti_tpu_torch.checkpoint import store
from dlti_tpu_torch.config import Config, ZeROStage
from dlti_tpu_torch.data.pipeline import HostShardedSchedule
from dlti_tpu_torch.data.prefetch import HostPrefetcher
from dlti_tpu_torch.models.interop import (
    init_params, init_params_int8, load_model, shard_params)
from dlti_tpu_torch.models.quantization import quantize_params_int8
from dlti_tpu_torch.parallel.mesh import build_mesh
from dlti_tpu_torch.parallel.pipeline import _LAYER, stage_params
from dlti_tpu_torch.parallel.sharding import all_reduce_, shard_model
from dlti_tpu_torch.training.optimizer import build_optimizer
from dlti_tpu_torch.training.state import (
    TrainState, create_train_state, frozen_param_keys, load_state_leaves, state_leaves,
)
from dlti_tpu_torch.training.step import (
    StepWindow, batch_signature, make_eval_step,
)
from dlti_tpu_torch.telemetry.steplog import StepLogWriter, schedule_lr
from dlti_tpu_torch.utils.device import resolve_device, to_host, upload
from dlti_tpu_torch.utils.experiment import experiment_name_from_config
from dlti_tpu_torch.utils.metrics import (
    H100_BF16_PEAK_FLOPS, MetricsRecord, compute_mfu, device_peak_memory,
    save_training_metrics,
)

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
    # fp16 runs: each step's loss scale after the step (the reference's
    # ``loss_scale`` metric); empty without the scaler.
    loss_scales: List[float] = field(default_factory=list)
    # Mixture of experts: each step's load-balance loss (the reference's
    # ``aux_loss`` metric); empty for a dense model.
    aux_losses: List[float] = field(default_factory=list)
    skipped_updates: int = 0          # nonfinite steps; fp16: overflows
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
    strategy: str = "baseline"   # baseline | zero1 | zero2 | zero3
    world: int = 1               # data-parallel ranks
    # The run's row of the reference's metrics CSV (rank 0; None elsewhere).
    metrics: Optional[MetricsRecord] = None

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


def check_model_axes(cfg: Config) -> None:
    """The reference's refusals for the sequence and pipe axes that need the
    model or the train config (``dlti_tpu/training/trainer.py:73-169``,
    ``dlti_tpu/parallel/sharding.py:392-396``); the mesh's own rules are
    ``parallel.mesh.check_strategy``'s."""
    par = cfg.parallel
    if par.sequence > 1 and cfg.train.loss_chunk:
        raise ValueError(
            "train.loss_chunk does not compose with sequence parallelism (the chunk "
            "reshape would regather the 'sequence'-sharded activations); set "
            "loss_chunk=0")
    if par.sequence > 1 and cfg.model.num_experts > 0:
        raise NotImplementedError(
            f"sequence={par.sequence} with a mixture of experts (capacity and the aux "
            "loss over the global token order) is not ported yet (see ROADMAP.md)")
    if par.pipe > 1:
        if cfg.train.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1 under pipe")
        if cfg.model.num_layers % par.pipe:
            raise ValueError(f"num_layers={cfg.model.num_layers} must divide into "
                             f"pipe={par.pipe} stages")


class Trainer:
    def __init__(self, cfg: Config, params: Optional[Mapping[str, torch.Tensor]] = None,
                 device=None, *, cuda_graphs: bool = True, mesh=None):
        """``mesh``: a prebuilt ``parallel.mesh.Mesh`` for ``cfg.parallel``
        (e.g. ``build_mesh(..., tensor_group=True)``, the tensor-parallel
        path at extent 1); built from ``cfg.parallel`` by default."""
        t = cfg.train
        if t.quantize_frozen_base:
            if t.quantize_frozen_base != "int8":
                raise ValueError(f"unknown quantize_frozen_base="
                                 f"{t.quantize_frozen_base!r} (only 'int8')")
            if not cfg.lora.enabled:
                raise ValueError("quantize_frozen_base requires LoRA: it compresses "
                                 "the frozen base params, and a full fine-tune has none")
        if cfg.checkpoint.save_strategy not in ("steps", "epoch", "no"):
            raise ValueError(f"unknown save_strategy {cfg.checkpoint.save_strategy!r}")
        check_model_axes(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh or build_mesh(cfg.parallel, self.device, cfg.lora.enabled)
        self.params = params
        # Set once the strategy placed the given weights and they were let go.
        self._params_released = False
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
        """A fresh state from the weights given to the constructor (random
        ones from ``cfg.train.seed`` without), placed by the strategy. Under
        ``offload_params`` or at a world above 1 the trainer lets go of the
        given weights once they are placed, and a second call raises
        (pass ``state=`` to :meth:`train` instead)."""
        if self._params_released:
            raise RuntimeError(
                "the weights given to this Trainer were placed by the strategy and "
                "released by the first init_state (offload_params or a world above "
                "1); pass the state train() returned as train(state=...), or build "
                "a new Trainer with the weights")
        cfg, mesh = self.cfg, self.mesh
        lora = cfg.lora if cfg.lora.enabled else None
        params = self.params
        per_stage = cfg.model.num_layers // mesh.pp
        if params is not None and mesh.pp > 1 and any(
                int(m.group(1)) >= per_stage for m in map(_LAYER.fullmatch, params) if m):
            # This stage's layers under their local names, from a whole tree
            # (a tree init_params(mesh=) drew holds them so already).
            params = stage_params(dict(params), mesh.pipe.rank, mesh.pp,
                                  cfg.model.num_layers)
        # Each leaf is cut to this rank's part (its tensor part, experts and
        # fsdp shard) as it is drawn or placed, an int8 weight quantized
        # whole first.
        if params is None and cfg.train.quantize_frozen_base:
            # Drawn and quantized leaf by leaf: the full-precision tree never
            # exists.
            params = init_params_int8(cfg.model, seed=cfg.train.seed, device=self.device,
                                      lora=lora, mesh=mesh)
        elif params is None:
            params = init_params(cfg.model, seed=cfg.train.seed, device=self.device,
                                 lora=lora, mesh=mesh)
        elif mesh.splits_leaves:
            params = shard_params(dict(params), mesh, cfg.model, lora, device=self.device,
                                  quantize=cfg.train.quantize_frozen_base, donate=True)
        elif cfg.train.quantize_frozen_base:
            # Leaf by leaf on the device.
            params = quantize_params_int8(dict(params), device=self.device, donate=True)
        model = load_model(cfg.model, params, self.device, lora=lora, trainable_lora=True,
                           mesh=mesh, stage=(mesh.pipe.rank, mesh.pp))
        del params
        layout = shard_model(model, self.mesh, cfg.lora.enabled)
        if self.params is not None and (cfg.parallel.offload_params or self.mesh.world > 1):
            # Holding the whole weights would undo what the strategy saves.
            self.params = None
            self._params_released = True
        t = cfg.train
        return create_train_state(
            model, self.tx, lora_enabled=cfg.lora.enabled,
            fp16_initial_scale=float(2 ** t.fp16_initial_scale_power) if t.fp16 else None,
            fp16_hysteresis=t.fp16_hysteresis, layout=layout)

    @property
    def strategy(self) -> str:
        """The reference's strategy label (``pipe{P}`` under pipeline
        parallelism)."""
        if self.cfg.parallel.pipe > 1:
            return f"pipe{self.cfg.parallel.pipe}"
        stage = ZeROStage(self.cfg.parallel.zero_stage)
        return "baseline" if stage == ZeROStage.NONE else f"zero{int(stage)}"

    def _info(self, *args) -> None:
        if self.mesh.is_writer:
            logger.info(*args)

    def _warning(self, *args) -> None:
        if self.mesh.is_writer:
            logger.warning(*args)

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
        accum, pipe = cfg.train.grad_accum_steps, cfg.parallel.pipe
        if pipe > 1 and accum < 4 * pipe:
            self._warning("GPipe bubble: grad_accum_steps=%d microbatches over pipe=%d "
                          "stages idles %.0f%% of ticks; use >= %d microbatches for >80%% "
                          "utilization", accum, pipe, 100 * (pipe - 1) / (accum + pipe - 1),
                          4 * pipe)
        dropout = cfg.lora.enabled and cfg.lora.dropout > 0
        window = StepWindow(state.model, accum_steps=cfg.train.grad_accum_steps,
                            loss_chunk=cfg.train.loss_chunk,
                            seed=cfg.train.seed + 1 if dropout else None,
                            capacity=sync_k, cuda_graphs=self.cuda_graphs,
                            fp16_scale_window=cfg.train.fp16_scale_window,
                            fp16_min_scale=cfg.train.fp16_min_scale,
                            fp16_hysteresis=cfg.train.fp16_hysteresis)
        eval_fn = (make_eval_step(state.model, loss_chunk=cfg.train.loss_chunk)
                   if eval_dataset is not None and cfg.train.eval_steps else None)
        if self.mesh.batch.world != self.mesh.world:
            # A tensor, sequence, pipe or expert group's ranks take the same
            # rows: slice by the batch axes.
            for ds in (dataset, eval_dataset):
                if isinstance(ds, HostShardedSchedule):
                    ds.shard_rows(self.mesh.batch.rank, self.mesh.batch.world)
        # Whole leaves, whatever this rank holds (a stage's layer leaves stand
        # for every stage's).
        leaves = [(pl, self.mesh.pp if pl.stage else 1) for pl in state.layout.leaves.values()]
        total = sum(int(np.prod(pl.shape)) * n for pl, n in leaves)
        trainable = sum(int(np.prod(pl.shape)) * n for pl, n in leaves if pl.trainable)
        self._trainable = trainable
        self._info("trainable params: %s / %s (%.4f%%) | %s over %d rank(s)",
                   f"{trainable:,}", f"{total:,}", 100 * trainable / total,
                   self.strategy, self.mesh.world)
        # micro_batch_size is global: every rank's rows together.
        tokens_per_step = (cfg.train.micro_batch_size * cfg.train.grad_accum_steps
                           * cfg.data.max_seq_len)
        record = TrainRecord(device=str(self.device), tokens_per_step=tokens_per_step,
                             trainable_params=trainable, total_params=total,
                             strategy=self.strategy, world=self.mesh.world)
        on_cuda = self.device.type == "cuda"
        t_start = time.perf_counter()
        steplog = None
        if cfg.train.step_log_path and self.mesh.is_writer:
            steplog = StepLogWriter(cfg.train.step_log_path, run_meta={
                "experiment": experiment_name_from_config(cfg),
                "num_gpus": cfg.parallel.num_devices,
                "zero_stage": int(cfg.parallel.zero_stage),
                "strategy": self.strategy})
        prefetcher: Optional[HostPrefetcher] = None
        # Wall clock of the current window's phases, for the step log.
        waits = {"data": 0.0, "ckpt": 0.0}
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        saving = ck.save_strategy != "no"
        self._stop_requested = False
        self._last_save_step = None
        # The frozen base's host copy, kept from save to save; at a world
        # above 1 every save gathers it anew, so there is none to keep.
        self._cache = (store.HostCache(frozen_param_keys(state))
                       if saving and self.mesh.world == 1 else None)

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
                    "prefetch_depth": 0, "fp16": bool(cfg.train.fp16),
                    "parallel": {"strategy": self.strategy, "world": self.mesh.world,
                                 **cfg.to_dict()["parallel"]},
                }

            def run_window(batches: list) -> None:
                """Execute ``batches`` as one window, read its metrics once,
                book its steps, then eval and save at its boundary."""
                nonlocal cursor, samples_seen, first_window
                before, k = state.step, len(batches)
                t0 = time.perf_counter()
                out = window.run(state, batches, before + 1)
                t_sync = time.perf_counter()
                rows = to_host(out)[0]
                t1 = time.perf_counter()
                dt, sync_s = t1 - t0, t1 - t_sync
                record.windows += 1
                first_window = first_window or k
                for i, row in enumerate(rows.tolist()):
                    m = dict(zip(window.metrics, row))
                    record.losses.append(m["loss"])
                    record.grad_norms.append(m["grad_norm"])
                    if state.scaler is not None:
                        record.loss_scales.append(m["loss_scale"])
                    if "aux_loss" in m:
                        record.aux_losses.append(m["aux_loss"])
                    record.skipped_updates += int(m["skipped_update"])
                    record.step_times_s.append(dt / k)
                    cursor += 1
                    samples_seen += cfg.train.micro_batch_size * cfg.train.grad_accum_steps
                    step = before + i + 1
                    if step % cfg.train.logging_steps == 0:
                        self._info("step %d | loss %.4f | grad_norm %.3f | %.3f s",
                                   step, m["loss"], m["grad_norm"], dt / k)
                    if steplog is not None:
                        self._log_step(steplog, step, m, tokens_per_step, dt / k,
                                       sync_s / k, waits, k)
                waits["data"] = waits["ckpt"] = 0.0
                every = cfg.train.eval_steps
                if eval_fn is not None and state.step // every > before // every:
                    self._run_eval(eval_fn, state, eval_dataset, record)
                t_save = time.perf_counter()
                self._maybe_save(state, record, epoch_end=False, sidecar=sidecar,
                                 crossed_from=before)
                waits["ckpt"] += time.perf_counter() - t_save  # booked to the next window
                self._agree_on_stop()

            def epoch_batches(epoch: int, skip: int):
                """The epoch's host batches, from the prefetch thread when
                ``prefetch_depth`` > 0 and the dataset is one of the
                package's (whose ``epoch`` has no side effects: another
                object's may depend on being read lazily, as in the
                reference); the time spent waiting for each is booked to
                the window it joins."""
                nonlocal prefetcher
                source = dataset.epoch(epoch, skip_steps=skip)
                if cfg.data.prefetch_depth > 0 and isinstance(dataset, HostShardedSchedule):
                    source = prefetcher = HostPrefetcher(source,
                                                         depth=cfg.data.prefetch_depth)
                it = iter(source)
                while True:
                    t = time.perf_counter()
                    host_batch = next(it, None)
                    waits["data"] += time.perf_counter() - t
                    if host_batch is None:
                        return
                    yield host_batch

            for epoch in range(start_epoch, cfg.train.num_epochs):
                skip = skip_steps if epoch == start_epoch else 0
                pending: list = []
                for host_batch in epoch_batches(epoch, skip):
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
                if prefetcher is not None:
                    prefetcher.close()
                    prefetcher = None
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
                    self._info("preemption checkpoint written at step %d", state.step)
        finally:
            if prefetcher is not None:
                prefetcher.close()
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
                record.tokens_per_second, self._flops_params(),
                H100_BF16_PEAK_FLOPS, trainable_params=trainable)
        if on_cuda:
            record.peak_memory_gb = torch.cuda.max_memory_allocated(self.device) / 1e9
        if self.mesh.is_writer:
            record.metrics = self._final_metrics(record, time.perf_counter() - t_start,
                                                 samples_seen)
            if steplog is not None:
                steplog.log_final(record.metrics)
                steplog.close()
            if cfg.train.metrics_csv:
                save_training_metrics(record.metrics, csv_path=cfg.train.metrics_csv)
        return state, record

    def _log_step(self, steplog: StepLogWriter, step: int, m: dict, tokens: int,
                  step_s: float, sync_s: float, waits: dict, k: int) -> None:
        """One step's record of the step log (``tokens`` a step over all
        ranks); the window's wall clock phases are split evenly over its
        ``k`` steps."""
        cfg, dev = self.cfg, self.device
        tok_s_chip = tokens / step_s / self.mesh.world if step_s > 0 else 0.0
        peak_gb, peak_src = device_peak_memory(dev)
        mfu = (compute_mfu(tok_s_chip, self._flops_params(), H100_BF16_PEAK_FLOPS,
                           trainable_params=self._trainable) if dev.type == "cuda"
               else float("nan"))
        in_use = headroom = 0
        if dev.type == "cuda":
            in_use = torch.cuda.memory_allocated(dev)
            headroom = (torch.cuda.get_device_properties(dev).total_memory
                        - torch.cuda.memory_reserved(dev))
        finite = math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
        steplog.log_step(
            step, loss=m["loss"], grad_norm=m["grad_norm"],
            lr=schedule_lr(cfg.optimizer, step),
            tokens_per_second_per_chip=round(tok_s_chip, 2),
            mfu_percent=round(mfu, 4), peak_memory_gb=round(peak_gb, 4),
            peak_memory_source=peak_src, step_time_s=round(step_s, 6),
            anomaly="" if finite else "nonfinite",
            skipped_update=int(m["skipped_update"]), rollbacks_total=0,
            data_wait_s=round(waits["data"] / k, 6), sync_s=round(sync_s, 6),
            ckpt_s=round(waits["ckpt"] / k, 6), rollback_s=0.0,
            hbm_bytes_in_use=int(in_use), hbm_headroom_bytes=int(headroom))

    def _flops_params(self) -> int:
        """The parameter count FLOPs a token follow: the configuration's
        analytic count, for a mixture of experts the parameters a token
        touches (k routed experts, not all E)."""
        model = self.cfg.model
        return model.num_active_params() if model.num_experts > 0 else model.num_params()

    def _final_metrics(self, record: TrainRecord, wall: float,
                       samples_seen: int) -> MetricsRecord:
        """The run's row of the reference's metrics CSV. Throughput is the
        record's (the steps after the warm-up, a card's share);
        ``training_time_hours`` and ``samples_per_second`` are over the whole
        ``train`` call, as the reference's. MFU is nan off the card."""
        cfg = self.cfg
        tok_s_chip = record.tokens_per_second / self.mesh.world
        peak_gb, peak_src = device_peak_memory(self.device)
        return MetricsRecord(
            experiment=experiment_name_from_config(cfg),
            num_gpus=cfg.parallel.num_devices,
            zero_stage=int(cfg.parallel.zero_stage),
            strategy=self.strategy,
            training_time_hours=wall / 3600.0,
            samples_per_second=samples_seen / wall if wall > 0 else 0.0,
            peak_memory_gb=peak_gb,
            final_loss=record.final_loss,
            tokens_per_second_per_chip=tok_s_chip,
            mfu_percent=(record.mfu_percent / self.mesh.world
                         if record.mfu_percent is not None else float("nan")),
            peak_memory_source=peak_src,
            eval_loss=record.eval_losses[-1] if record.eval_losses else float("nan"))

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
            self._info("eval @ step %d | loss %.4f", state.step, eval_loss)
        record.eval_steps.append(state.step)
        record.eval_losses.append(eval_loss)

    def _resume(self, state: TrainState, record: TrainRecord) -> tuple:
        """Restore the newest verified checkpoint into ``state``; returns
        (sidecar, data cursor), (None, 0) when there is nothing to resume."""
        cfg, mesh = self.cfg, self.mesh
        ck_dir = cfg.checkpoint.output_dir
        t0 = time.perf_counter()
        # Whole leaves are live tensors unless this rank holds shards.
        live = mesh.world == 1
        target = state_leaves(state, whole=live)
        device = None if live else "cpu"
        if mesh.world == 1:
            restored = store.restore_latest_verified(ck_dir, target, device=device,
                                                     cache=self._cache)
        else:
            # Rank 0 scans (and quarantines); every rank reads the step it chose.
            restored = None
            if mesh.is_writer:
                restored = store.restore_latest_verified(ck_dir, target, device=device)
            chosen = [restored[1] if restored is not None else None]
            dist.broadcast_object_list(chosen, src=0, group=mesh.group)
            if chosen[0] is not None and not mesh.is_writer:
                restored = (store.restore_train_state(ck_dir, chosen[0], target,
                                                      device=device),
                            chosen[0], store.load_train_meta(ck_dir, chosen[0]))
        if restored is None:
            return None, 0
        leaves, step, meta = restored
        load_state_leaves(state, leaves)
        if live:
            self._cache.bind_restored(state_leaves(state))
        record.resumed_from, record.restore_s = step, time.perf_counter() - t0
        self._last_save_step = step  # committed already: a due save there is a no-op
        self._info("resumed from verified checkpoint step %d", step)
        if meta and meta.get("seed", cfg.train.seed) != cfg.train.seed:
            self._warning("checkpoint was saved with train.seed=%s but this run uses "
                          "%s; the resumed loss trajectory will not match the "
                          "original run's", meta.get("seed"), cfg.train.seed)
        if meta and meta.get("rng_schedule", RNG_SCHEDULE) != RNG_SCHEDULE:
            self._warning("checkpoint was saved under the dropout schedule %r but "
                          "this run draws with %r; the resumed loss trajectory will "
                          "not match the original run's", meta.get("rng_schedule"),
                          RNG_SCHEDULE)
        cursor = int(meta["data_pos"]) if meta and meta.get("data_pos") is not None \
            else int(step)
        return meta, cursor

    def _check_schedule(self, meta: Optional[dict], dataset, spe: int) -> None:
        saved = (meta or {}).get("dataset")
        if not saved:
            return
        if saved.get("steps_per_epoch") not in (None, 0, spe):
            self._warning("checkpoint sidecar recorded steps_per_epoch=%s but this "
                          "dataset yields %s; mid-epoch resume will replay a "
                          "different batch schedule", saved.get("steps_per_epoch"), spe)
        current = getattr(dataset, "shuffle_seed", None)
        if saved.get("shuffle_seed", current) != current:
            self._warning("checkpoint sidecar recorded shuffle_seed=%s but this "
                          "dataset uses %s; batch order will differ from the "
                          "original run", saved.get("shuffle_seed"), current)

    def _agree_on_stop(self) -> None:
        """Every rank stops at the same window boundary: a stop any rank
        was asked for is every rank's (one host-side collective a window,
        at a world above 1)."""
        if self.mesh.world == 1:
            return
        flag = torch.tensor([float(self._stop_requested)], device=self.device)
        self._stop_requested = bool(all_reduce_(flag, self.mesh).item() > 0)

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
        """Rank 0 writes the consolidated state; every rank joins the gathers
        of the leaves it holds shards of, and at a world above 1 waits on a
        barrier after the commit."""
        ck, mesh = self.cfg.checkpoint, self.mesh
        self._last_save_step = state.step
        t0 = time.perf_counter()
        leaves = state_leaves(state)
        if mesh.is_writer:
            store.save_train_state(
                ck.output_dir, state.step, leaves, keep=ck.save_total_limit,
                async_save=async_save and mesh.world == 1, train_meta=meta,
                retries=ck.save_retries, retry_backoff_s=ck.save_retry_backoff_s,
                cache=self._cache)
        del leaves
        if mesh.world > 1:
            dist.barrier(group=mesh.group)
        record.save_steps.append(state.step)
        record.save_stall_s.append(time.perf_counter() - t0)
