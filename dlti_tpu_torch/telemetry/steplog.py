"""Per-step JSONL stream of a training run (rank 0): the port of
``dlti_tpu/telemetry/steplog.py`` (``StepLogWriter``,
``metrics_csv_columns``, ``jsonl_stream_columns``, ``schedule_lr``).

One JSON object a line, three record types:

* ``{"type": "run", ...}``: written once at the start (experiment, cards,
  ZeRO stage, strategy: the identifying half of the metrics CSV);
* ``{"type": "step", ...}``: one per optimizer step, the
  :data:`STEP_RECORD_FIELDS`;
* ``{"type": "final", ...}``: the run's whole ``MetricsRecord``, so the
  stream's columns are a superset of the CSV's.

Lines are flushed as they are written, so a stopped run's stream reads up
to its last booked step. A write that fails (``OSError``) is dropped and
counted (:attr:`StepLogWriter.dropped`), never raised: a sick telemetry
disk costs log lines, not training steps.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional

from dlti_tpu_torch.config import OptimizerConfig
from dlti_tpu_torch.utils.metrics import MetricsRecord

# Keys of every "step" record, the reference's. The port has no sentinel,
# goodput ledger or memory ledger: ``anomaly`` is "nonfinite" for a step
# whose loss or gradient norm was not finite (else ""), ``rollbacks_total``
# and ``rollback_s`` are 0; ``data_wait_s`` (waiting for batches),
# ``sync_s`` (the window's one read of its metrics, which waits for its
# device work) and ``ckpt_s`` (save stalls, booked to the window after the
# save) are the window's wall clock split evenly over its steps;
# ``hbm_bytes_in_use`` is the card's allocated bytes and
# ``hbm_headroom_bytes`` its total minus the allocator's reserved bytes
# (both 0 off the card).
STEP_RECORD_FIELDS = (
    "type", "step", "loss", "grad_norm", "lr",
    "tokens_per_second_per_chip", "mfu_percent",
    "peak_memory_gb", "peak_memory_source", "step_time_s",
    "anomaly", "skipped_update", "rollbacks_total",
    "data_wait_s", "sync_s", "ckpt_s", "rollback_s",
    "hbm_bytes_in_use", "hbm_headroom_bytes",
)

RUN_RECORD_FIELDS = ("type", "experiment", "num_gpus", "zero_stage", "strategy")


def metrics_csv_columns() -> tuple:
    """The metrics CSV's columns (``utils.metrics.MetricsRecord``)."""
    return tuple(f.name for f in dataclasses.fields(MetricsRecord))


def jsonl_stream_columns() -> frozenset:
    """Every key the writer can emit, over the three record types."""
    return (frozenset(STEP_RECORD_FIELDS) | frozenset(RUN_RECORD_FIELDS)
            | frozenset(metrics_csv_columns()))


def schedule_lr(cfg: OptimizerConfig, step: int) -> float:
    """The reference's host-side lr of a logged step (its mirror of the
    optimizer's schedule, evaluated at the global step)."""
    lr, w = cfg.learning_rate, max(cfg.warmup_steps, 1)
    if cfg.schedule == "warmup_constant":
        if cfg.warmup_steps <= 0:
            return lr
        return lr * min(1.0, step / w)
    if cfg.schedule == "warmup_cosine":
        total = max(cfg.total_steps, cfg.warmup_steps + 1)
        if step < w:
            return lr * step / w
        frac = min(1.0, (step - w) / max(1, total - w))
        return lr * 0.5 * (1.0 + math.cos(math.pi * frac))
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


class StepLogWriter:
    """Append-mode JSONL writer; one a (rank-0) training run."""

    def __init__(self, path: str, run_meta: Optional[dict] = None):
        self.path = path
        self.dropped = 0  # lines lost to I/O errors
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")
        if run_meta is not None:
            self._write({"type": "run", **run_meta})

    def _write(self, obj: dict) -> None:
        try:
            self._f.write(json.dumps(obj) + "\n")
            self._f.flush()
        except OSError:
            self.dropped += 1

    def log_step(self, step: int, **fields) -> None:
        self._write({"type": "step", "step": step, **fields})

    def log_final(self, record) -> None:
        row = record.to_dict() if isinstance(record, MetricsRecord) else dict(record)
        self._write({"type": "final", **row})

    def close(self) -> None:
        self._f.close()
