"""Training-run comparison: the port of ``dlti_tpu/analysis.py``
(``load_and_calculate``, ``print_comparison_table``, ``print_key_findings``,
``create_plots``, ``compare``), the reference's ``compare_training.py``.

It reads the metrics CSV that ``utils.metrics.save_training_metrics``
appends to (either package's), derives speedup and scaling efficiency
against the ``baseline`` row by the reference's definitions:

* ``speedup = baseline_training_time / training_time``
* ``efficiency_percent = speedup / num_chips * 100``

(the first row is the anchor when no row is ``baseline``), prints the
table and the key findings, and draws a 2x2 panel figure (training time,
speedup, peak memory per card, scaling efficiency against the ideal).

The table is a list of row dicts computed with ``csv`` and numpy, not a
pandas DataFrame: the card machine has no pandas. Columns are typed as
pandas reads them: a column whose values are all integers holds ints, one
whose values all parse as numbers floats (an empty cell is nan), any other
column strings. matplotlib is imported inside :func:`create_plots` only,
which raises without it.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Optional

import numpy as np

TABLE_COLUMNS = (
    "experiment", "num_gpus", "zero_stage", "strategy",
    "training_time_hours", "samples_per_second", "peak_memory_gb",
    "final_loss", "speedup", "efficiency_percent",
    "tokens_per_second_per_chip", "mfu_percent",
)


def _typed_column(values: List[str]) -> list:
    """One CSV column's cells, typed as ``pandas.read_csv`` types them."""
    present = [v for v in values if v != ""]
    try:
        if present and len(present) == len(values):
            return [int(v) for v in values]
    except ValueError:
        pass
    try:
        return [float(v) if v != "" else float("nan") for v in values]
    except ValueError:
        return [v if v != "" else float("nan") for v in values]


def load_and_calculate(csv_path: str) -> List[Dict[str, object]]:
    """The metrics CSV as typed row dicts, each with ``speedup`` and
    ``efficiency_percent`` added."""
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        fields = list(reader.fieldnames or [])
        raw = list(reader)
    if not raw:
        raise ValueError(f"{csv_path} has no rows")
    columns = {k: _typed_column([r.get(k) or "" for r in raw]) for k in fields}
    rows = [{k: columns[k][i] for k in fields} for i in range(len(raw))]
    base = next((r for r in rows if r["experiment"] == "baseline"), rows[0])
    base_time = float(base["training_time_hours"])
    times = np.array([float(r["training_time_hours"]) for r in rows])
    times[times == 0.0] = np.nan
    gpus = np.array([float(r["num_gpus"]) for r in rows])
    speedup = base_time / times
    efficiency = speedup / gpus * 100.0
    for r, s, e in zip(rows, speedup.tolist(), efficiency.tolist()):
        r["speedup"], r["efficiency_percent"] = s, e
    return rows


def _cell(v) -> str:
    if isinstance(v, float):
        return "NaN" if math.isnan(v) else f"{round(v, 3):g}"
    return str(v)


def print_comparison_table(rows: List[Dict[str, object]]) -> None:
    cols = [c for c in TABLE_COLUMNS if c in rows[0]]
    cells = [[_cell(r[c]) for c in cols] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells)) for i, c in enumerate(cols)]
    print("=" * 72)
    print("TRAINING COMPARISON")
    print("=" * 72)
    print(" ".join(c.rjust(w) for c, w in zip(cols, widths)))
    for row in cells:
        print(" ".join(v.rjust(w) for v, w in zip(row, widths)))


def _anchor(rows: List[Dict[str, object]]) -> int:
    return next((i for i, r in enumerate(rows) if r["experiment"] == "baseline"), 0)


def print_key_findings(rows: List[Dict[str, object]]) -> None:
    a = _anchor(rows)
    anchor = rows[a]
    print("\nKEY FINDINGS (vs %s)" % anchor["experiment"])
    print("-" * 72)
    for i, row in enumerate(rows):
        if i == a:
            continue
        saved_h = float(anchor["training_time_hours"]) - float(row["training_time_hours"])
        dmem = float(row["peak_memory_gb"]) - float(anchor["peak_memory_gb"])
        print(f"{row['experiment']:>16}: {row['speedup']:.2f}x speedup, "
              f"{row['efficiency_percent']:.1f}% scaling efficiency, "
              f"{saved_h:.2f}h saved, {dmem:+.2f} GB peak memory/chip")


def create_plots(rows: List[Dict[str, object]],
                 output_path: str = "results/plots/training_comparison.png") -> str:
    """2x2 panel: time, speedup, peak memory per card, efficiency against
    the ideal. Needs matplotlib (raises ImportError without it)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def col(name):
        return [float(r[name]) for r in rows]

    fig, axes = plt.subplots(2, 2, figsize=(13, 9))
    names = [str(r["experiment"]) for r in rows]
    x = range(len(names))

    ax = axes[0][0]
    ax.bar(x, col("training_time_hours"), color="#4878cf")
    ax.set_title("Training time")
    ax.set_ylabel("hours")

    ax = axes[0][1]
    ax.bar(x, col("speedup"), color="#6acc65")
    ax.axhline(1.0, ls="--", c="gray", lw=1, label="baseline")
    ax.set_title("Speedup vs baseline")
    ax.set_ylabel("x")
    ax.legend()

    ax = axes[1][0]
    ax.bar(x, col("peak_memory_gb"), color="#d65f5f")
    ax.set_title("Peak memory per chip")
    ax.set_ylabel("GB")

    ax = axes[1][1]
    eff = sorted(rows, key=lambda r: float(r["num_gpus"]))
    ax.plot([float(r["num_gpus"]) for r in eff],
            [float(r["efficiency_percent"]) for r in eff], "o-", label="measured")
    ax.axhline(100.0, ls="--", c="gray", lw=1, label="ideal")
    ax.set_title("Scaling efficiency")
    ax.set_xlabel("chips")
    ax.set_ylabel("%")
    ax.legend()

    for ax in (axes[0][0], axes[0][1], axes[1][0]):
        ax.set_xticks(list(x))
        ax.set_xticklabels(names, rotation=30, ha="right", fontsize=8)

    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=300)
    plt.close(fig)
    return output_path


def compare(csv_path: str, plot_path: Optional[str] = None) -> List[Dict[str, object]]:
    """Load, print the table and the findings, and draw the plots when
    ``plot_path`` is given; returns the rows."""
    rows = load_and_calculate(csv_path)
    print_comparison_table(rows)
    print_key_findings(rows)
    if plot_path is not None:
        out = create_plots(rows, plot_path)
        print(f"\nplots -> {out}")
    return rows
