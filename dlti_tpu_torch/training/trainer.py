"""The training loop for one device: the port of
``dlti_tpu/training/trainer.py``'s ``Trainer`` on its flat single-device
path (``_build_step``'s last branch and the loop of ``train``).

``Trainer(cfg).train(dataset=...)`` builds the model (random weights from
``cfg.train.seed`` unless the caller passes ``params``), the optimizer and
the train state, then runs epochs of the dataset's batches up to
``cfg.train.max_steps``. Step N (1-based) seeds its LoRA dropout with a
seed derived from ``(cfg.train.seed + 1, N)``, as the reference folds the
step index into ``PRNGKey(seed + 1)``, so the schedule of random masks does
not depend on how the run got to step N. Every ``logging_steps`` it logs
loss, grad norm and throughput; the returned :class:`TrainRecord` has the
per-step losses and grad norms, tokens/s, step time, MFU and peak device
memory.

Runs on ``cuda`` unless given ``device="cpu"``; without a card and without a
device it raises. Not ported (each raises or is absent, see ROADMAP.md):
meshes, ZeRO, TP/SP/PP, host offload, the int8 frozen base, the fp16
scaler, ``loss_chunk``, ``steps_per_sync``, eval, checkpoint save/resume and
export, telemetry, the sentinel, chaos and elastic training.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import List, Mapping, Optional

import numpy as np
import torch

from dlti_tpu_torch.config import Config
from dlti_tpu_torch.models.interop import init_params, load_model
from dlti_tpu_torch.models.llama import derive_seed
from dlti_tpu_torch.models.lora import count_params
from dlti_tpu_torch.training.optimizer import build_optimizer
from dlti_tpu_torch.training.state import TrainState, create_train_state
from dlti_tpu_torch.training.step import make_train_step
from dlti_tpu_torch.utils.device import resolve_device
from dlti_tpu_torch.utils.metrics import H100_BF16_PEAK_FLOPS, compute_mfu

logger = logging.getLogger("dlti_tpu_torch.train")

# Steps whose time is left out of the throughput (allocator and kernel
# build warm-up), as the reference's StepTimer(warmup_steps=2).
WARMUP_STEPS = 2


@dataclass
class TrainRecord:
    """What a run measured. Times are host wall clock around each step,
    which ends in a device synchronisation (the loss is read)."""

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

    @property
    def steps(self) -> int:
        return len(self.losses)

    @property
    def final_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")


class Trainer:
    def __init__(self, cfg: Config, params: Optional[Mapping[str, torch.Tensor]] = None,
                 device=None):
        t = cfg.train
        unported = [name for name, on in (
            ("train.fp16", t.fp16), ("train.loss_chunk", t.loss_chunk),
            ("train.steps_per_sync > 1", t.steps_per_sync > 1),
            ("train.quantize_frozen_base", t.quantize_frozen_base),
            ("mixture-of-experts models", cfg.model.num_experts > 0)) if on]
        if unported:
            raise NotImplementedError(f"not ported yet (see ROADMAP.md): "
                                      f"{', '.join(unported)}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        self.tx = build_optimizer(cfg.optimizer)

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


    def train(self, dataset, state: Optional[TrainState] = None) -> tuple:
        """Run the configured epochs of ``dataset`` (a ``TokenBatchDataset``,
        re-iterated per epoch); returns ``(state, TrainRecord)``."""
        cfg = self.cfg
        state = state or self.init_state()
        step_fn = make_train_step(state.model, accum_steps=cfg.train.grad_accum_steps)
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

        done = False
        for epoch in range(cfg.train.num_epochs):
            for host_batch in dataset.epoch(epoch):
                if cfg.train.max_steps and state.step >= cfg.train.max_steps:
                    done = True
                    break
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                         for k, v in host_batch.items()}
                seed = derive_seed(cfg.train.seed + 1, state.step + 1)
                m = step_fn(state, batch, seed)  # reads the loss: ends in a sync
                record.step_times_s.append(time.perf_counter() - t0)
                record.losses.append(m["loss"])
                record.grad_norms.append(m["grad_norm"])
                record.skipped_updates += int(m["skipped_update"])
                if state.step % cfg.train.logging_steps == 0:
                    logger.info("step %d | loss %.4f | grad_norm %.3f | %.3f s",
                                state.step, m["loss"], m["grad_norm"],
                                record.step_times_s[-1])
            if done:
                break

        timed = record.step_times_s[WARMUP_STEPS:] or record.step_times_s
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
