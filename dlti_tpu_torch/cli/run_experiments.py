"""Experiment-matrix CLI: the port of ``scripts/run_experiments.py``.
Runs baseline + ZeRO-{1,2,3} over device counts as fresh launcher
subprocesses (``orchestration.run_matrix``), every run appending its row to
one metrics CSV, and ends with the comparison.

    # on the CPU: tiny model, 3 steps a cell, gloo ranks
    python -m dlti_tpu_torch.cli.run_experiments --device cpu \\
        --strategies baseline,zero1,zero3 --device-counts 1,2 \\
        --model llama_tiny --tokenizer byte --dataset-path data/synth \\
        --max-seq-len 64 --max-steps 3 --no-plots

    # one H100: the flagship model under baseline and ZeRO-3
    python -m dlti_tpu_torch.cli.run_experiments --model llama2_7b \\
        --strategies baseline,zero3 --device-counts 1 \\
        --tokenizer byte --dataset-path data/glaive_tokens --max-steps 2

    # sbatch scripts instead of runs
    python -m dlti_tpu_torch.cli.run_experiments --emit-slurm slurm/ ...

Flags are the reference's; ``--device cpu`` runs each rank on the CPU
(gloo), and each run may add ``--quantize-base int8``, ``--remat-policy``
and ``--steps-per-sync`` as ``cli.train`` takes them. ``--tensor N``
runs each cell on ``N`` times its device count of ranks; ``--sequence``
above 1 raises (not ported), as does
``--simulate-devices`` (the JAX package's virtual CPU mesh: the port runs
real processes instead).
"""

from __future__ import annotations

import argparse
import sys

from dlti_tpu_torch.cli.train import REMAT_CHOICES


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="experiment matrix (PyTorch port)",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--strategies", default="baseline,zero1,zero2,zero3")
    p.add_argument("--device-counts", default="1,2,4")
    p.add_argument("--tensor", type=int, default=1)
    p.add_argument("--sequence", type=int, default=1)
    p.add_argument("--model", default="llama2_7b")
    p.add_argument("--tokenizer", default="meta-llama/Llama-2-7b-hf")
    p.add_argument("--dataset-path", default="./data/glaive_code_full")
    p.add_argument("--max-steps", type=int, default=0)
    p.add_argument("--num-train-epochs", type=int, default=1)
    p.add_argument("--per-device-batch-size", type=int, default=1)
    p.add_argument("--gradient-accumulation-steps", type=int, default=16)
    p.add_argument("--max-seq-len", type=int, default=512)
    p.add_argument("--lora-r", type=int, default=16)
    p.add_argument("--quantize-base", default="", choices=["", "int8"])
    p.add_argument("--remat-policy", default=None, choices=REMAT_CHOICES)
    p.add_argument("--steps-per-sync", type=int, default=1)
    p.add_argument("--metrics-csv", default="results/training_metrics.csv")
    p.add_argument("--plot-out", default="results/plots/training_comparison.png",
                   help="where the post-matrix comparison plot is written")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--output-root", default="checkpoints")
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--simulate-devices", type=int, default=0,
                   help="not ported (the JAX package's virtual CPU mesh)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--dry-run", action="store_true",
                   help="print the commands without running")
    p.add_argument("--no-analyze", action="store_true")
    p.add_argument("--emit-slurm", default=None, metavar="DIR",
                   help="write sbatch scripts to DIR instead of running")
    p.add_argument("--hosts-per-pod", type=int, default=1)
    p.add_argument("--partition", default=None)
    p.add_argument("--time-limit", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.simulate_devices:
        raise NotImplementedError("--simulate-devices (the JAX package's virtual CPU "
                                  "mesh) is not ported; --device cpu runs real gloo "
                                  "ranks (see ROADMAP.md)")
    from dlti_tpu_torch.orchestration import emit_slurm, plan_matrix, run_matrix

    specs = plan_matrix([s.strip() for s in args.strategies.split(",") if s.strip()],
                        [int(n) for n in args.device_counts.split(",")],
                        tensor=args.tensor, sequence=args.sequence)
    train_args = {
        "model": args.model,
        "tokenizer": args.tokenizer,
        "dataset_path": args.dataset_path,
        "max_steps": args.max_steps,
        "num_train_epochs": args.num_train_epochs,
        "per_device_batch_size": args.per_device_batch_size,
        "gradient_accumulation_steps": args.gradient_accumulation_steps,
        "max_seq_len": args.max_seq_len,
        "lora_r": args.lora_r,
        "quantize_base": args.quantize_base or None,
        "remat_policy": args.remat_policy,
        "steps_per_sync": args.steps_per_sync if args.steps_per_sync != 1 else None,
        "device": args.device,
    }
    if args.emit_slurm:
        for path in emit_slurm(specs, train_args, out_dir=args.emit_slurm,
                               hosts_per_pod=args.hosts_per_pod,
                               partition=args.partition, time_limit=args.time_limit):
            print(path)
        return 0
    results = run_matrix(specs, train_args, metrics_csv=args.metrics_csv,
                         output_root=args.output_root, analyze=not args.no_analyze,
                         plot_path=None if args.no_plots else args.plot_out,
                         dry_run=args.dry_run, log_dir=args.log_dir)
    failures = [r for r in results if r["returncode"] not in (0, None)]
    if failures:
        print(f"{len(failures)}/{len(results)} runs failed: "
              + ", ".join(r["name"] for r in failures))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
