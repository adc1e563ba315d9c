"""Training metrics: the port of ``dlti_tpu/utils/metrics.py``: the
reference's metrics CSV (``MetricsRecord``, ``save_training_metrics``,
``print_metrics_summary``), peak memory (``device_peak_memory``) and the
throughput formulas (``training_flops_per_token``, ``compute_mfu``).

The CSV keeps the reference's columns, names and order
(``experiment, num_gpus, zero_stage, strategy, training_time_hours,
samples_per_second, peak_memory_gb, final_loss``; ``num_gpus`` is the
number of cards), then the JAX package's additions: tokens/s per card, MFU,
where the peak came from, the last eval loss. A file written by either
package is appended to by the other, and a file whose header lacks a
column is rewritten under the union of columns.

The peak is the card's own: ``H100_BF16_PEAK_FLOPS`` is the H100 SXM's dense
bf16 tensor-core rate from NVIDIA's data sheet (at its 700 W limit).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

H100_BF16_PEAK_FLOPS = 989e12

# The reference repo's CSV schema: the columns MetricsRecord starts with.
REFERENCE_CSV_COLUMNS = (
    "experiment", "num_gpus", "zero_stage", "strategy",
    "training_time_hours", "samples_per_second", "peak_memory_gb",
    "final_loss",
)


@dataclass
class MetricsRecord:
    experiment: str
    num_gpus: int  # the reference's column name; the number of cards
    zero_stage: int
    strategy: str
    training_time_hours: float
    samples_per_second: float
    peak_memory_gb: float
    final_loss: float
    tokens_per_second_per_chip: float = 0.0
    mfu_percent: float = 0.0
    # "device" (the card's allocator peak) or "host_rss" (the process's
    # VmHWM, on the CPU), or "none": two quantities, told apart here.
    peak_memory_source: str = "none"
    eval_loss: float = float("nan")  # the last eval's (nan: none ran)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def training_flops_per_token(num_params: int,
                             trainable_params: Optional[int] = None) -> float:
    """Approximate FLOPs per token of one train step: 6N for a full
    fine-tune (forward 2N, backward 4N); 4N under LoRA, whose backward skips
    the frozen weights' dW."""
    if trainable_params is not None and trainable_params < 0.5 * num_params:
        return 4.0 * num_params
    return 6.0 * num_params


def compute_mfu(tokens_per_second_per_chip: float, num_params: int,
                chip_peak_flops: float = H100_BF16_PEAK_FLOPS,
                trainable_params: Optional[int] = None) -> float:
    """Model FLOPs utilization in percent."""
    achieved = tokens_per_second_per_chip * training_flops_per_token(
        num_params, trainable_params)
    return 100.0 * achieved / chip_peak_flops


def device_peak_memory(device=None) -> tuple:
    """Peak memory as ``(GiB, source)``: on a CUDA device the allocator's
    peak since its last reset (``torch.cuda.max_memory_allocated``,
    ``"device"``); elsewhere the process's peak resident set (VmHWM,
    ``"host_rss"``), as the JAX package falls back on the CPU; ``(0.0,
    "none")`` when neither is readable. GiB, as the reference's column."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device) / 1024 ** 3, "device"
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1024 ** 2, "host_rss"  # kB -> GiB
    except OSError:
        pass
    return 0.0, "none"


def save_training_metrics(metrics, csv_path: str = "results/training_metrics.csv") -> None:
    """Append one row (a :class:`MetricsRecord` or a dict), writing the
    header on the first write. When the file's header differs from the
    row's columns, the file is rewritten under the union of columns (old
    columns first) through a temporary file and an atomic replace, instead
    of appending a misaligned row."""
    row = metrics.to_dict() if isinstance(metrics, MetricsRecord) else dict(metrics)
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    old_fields: list = []
    if os.path.isfile(csv_path):
        with open(csv_path, newline="") as f:
            old_fields = next(csv.reader(f), []) or []
    if old_fields and set(old_fields) == set(row):
        with open(csv_path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=old_fields).writerow(row)
        return
    if old_fields and old_fields != list(row.keys()):
        with open(csv_path, newline="") as f:
            old_rows = list(csv.DictReader(f))
        fields = old_fields + [k for k in row if k not in old_fields]
        tmp_path = csv_path + ".tmp"
        with open(tmp_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fields, restval="")
            writer.writeheader()
            for r in old_rows:
                writer.writerow(r)
            writer.writerow(row)
        os.replace(tmp_path, csv_path)
        return
    with open(csv_path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(row.keys()))
        if not old_fields:
            writer.writeheader()
        writer.writerow(row)


def print_metrics_summary(metrics) -> None:
    """The row, formatted for stdout."""
    row = metrics.to_dict() if isinstance(metrics, MetricsRecord) else dict(metrics)
    print("\n" + "=" * 60)
    print("TRAINING METRICS SUMMARY")
    print("=" * 60)
    for k, v in row.items():
        if isinstance(v, float):
            print(f"  {k:<28} {v:.4f}")
        else:
            print(f"  {k:<28} {v}")
    print("=" * 60 + "\n")
