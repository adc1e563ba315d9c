"""Compare training runs: the port of ``scripts/compare_training.py``.
Reads the metrics CSV that ``cli.train`` appends one row to per run and
prints the comparison table and key findings (``analysis.compare``), and
draws the plots unless ``--no-plots`` (which need matplotlib).

    python -m dlti_tpu_torch.cli.compare_training --csv results/training_metrics.csv \\
        --no-plots
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="compare training runs (PyTorch port)",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--csv", default="results/training_metrics.csv")
    p.add_argument("--plot-out", default="results/plots/training_comparison.png")
    p.add_argument("--no-plots", action="store_true")
    args = p.parse_args(argv)
    if not os.path.isfile(args.csv):
        raise SystemExit(f"{args.csv} not found: run dlti_tpu_torch.cli.train first "
                         f"(it appends one row per run)")
    from dlti_tpu_torch.analysis import compare

    compare(args.csv, plot_path=None if args.no_plots else args.plot_out)


if __name__ == "__main__":
    main()
