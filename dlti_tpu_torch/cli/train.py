"""Training CLI: the port of ``scripts/train.py`` for one device.

    python -m dlti_tpu_torch.cli.train --model llama2_7b --tokenizer byte \\
        --dataset-path data/corpus.jsonl --max-steps 100

    # on the CPU, at test scale
    python -m dlti_tpu_torch.cli.train --device cpu --model llama_tiny \\
        --tokenizer byte --dataset-path data/ --max-seq-len 64 \\
        --per-device-batch-size 2 --gradient-accumulation-steps 2 --max-steps 4

    # checkpoint every 2 steps, resume if a checkpoint is there, export
    python -m dlti_tpu_torch.cli.train --device cpu --model llama_tiny \
        --tokenizer byte --dataset-path data/ --max-seq-len 64 --max-steps 4 \
        --save-steps 2 --output-dir runs/tiny --export-dir exports/tiny

Flags keep the reference's names and defaults: like the reference it
checkpoints every 100 steps under ``./checkpoints/run`` and first resumes
from the newest checkpoint there that verifies (``--no-resume`` starts
afresh, ``--save-strategy no`` writes nothing). ``--export-dir`` writes the
merged model after training (``cli.serve --model-dir`` serves it).
``--dataset-path`` is a ``data.jsonl`` (one ``{"text": ...}`` per line), a
directory holding one, or a file of text lines. Weights are random, from
``--seed``. Prints one JSON line with the run's record at the end. The PEFT
and HF exports (``--export-peft``, ``--export-hf``) are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

from dlti_tpu_torch.config import (
    MODEL_PRESETS, CheckpointConfig, Config, DataConfig, LoRAConfig, OptimizerConfig,
    TrainConfig,
)

REMAT_CHOICES = ["none", "nothing_saveable", "dots_saveable",
                 "dots_with_no_batch_dims_saveable", "save_attn_out"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LoRA trainer (PyTorch port, one device)",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model", default="llama2_7b", choices=sorted(MODEL_PRESETS))
    p.add_argument("--dataset-path", "--dataset_path", default="./data/glaive_code_full",
                   help="data.jsonl with a `text` field (or a directory holding "
                        "one), or a file of text lines")
    p.add_argument("--output-dir", "--output_dir", default="./checkpoints/run")
    p.add_argument("--tokenizer", default="meta-llama/Llama-2-7b-hf",
                   help="'byte' or 'id[:vocab]' (hub tokenizers are not ported)")
    p.add_argument("--max-seq-len", type=int, default=512)
    p.add_argument("--pack", action="store_true",
                   help="pack sequences to fill seq_len (the reference pads)")
    p.add_argument("--per-device-batch-size", type=int, default=1)
    p.add_argument("--gradient-accumulation-steps", type=int, default=16)
    p.add_argument("--max-steps", type=int, default=0, help="0 = full epochs")
    p.add_argument("--num-train-epochs", type=int, default=1)
    p.add_argument("--learning-rate", type=float, default=2e-4)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--lora-r", type=int, default=16, help="0 disables LoRA (full fine-tune)")
    p.add_argument("--remat-policy", default=None, choices=REMAT_CHOICES,
                   help="'none' disables remat; the port has only "
                        "nothing_saveable (default: the preset's)")
    p.add_argument("--remat-stride", type=int, default=0,
                   help="keep every Nth block's activations (0 = preset)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--logging-steps", type=int, default=10)
    p.add_argument("--save-strategy", default="steps", choices=["steps", "epoch", "no"])
    p.add_argument("--save-steps", type=int, default=100)
    p.add_argument("--save-total-limit", type=int, default=3)
    p.add_argument("--no-resume", action="store_true",
                   help="skip the verified scan-latest-and-resume pass")
    p.add_argument("--export-dir", default=None,
                   help="write a consolidated merged-LoRA export here after training")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_texts(path: str) -> list:
    """``data.jsonl`` with a ``text`` field (or a directory holding one), or
    plain text lines."""
    if os.path.isdir(path):
        jsonl = os.path.join(path, "data.jsonl")
        if not os.path.isfile(jsonl):
            raise SystemExit(f"{path} holds no data.jsonl (datasets saved with "
                             f"save_to_disk are not read by the port)")
        path = jsonl
    with open(path) as f:
        first = f.readline()
        f.seek(0)
        if first.lstrip().startswith("{"):
            return [json.loads(line)["text"] for line in f if line.strip()]
        return [line.rstrip("\n") for line in f if line.strip()]


def build_config(args) -> Config:
    model = MODEL_PRESETS[args.model]
    if args.remat_policy == "none":
        model = dataclasses.replace(model, remat=False)
    elif args.remat_policy:
        model = dataclasses.replace(model, remat_policy=args.remat_policy)
    if args.remat_stride:
        model = dataclasses.replace(model, remat_stride=args.remat_stride)
    r = max(args.lora_r, 1)
    return Config(
        model=model,
        lora=LoRAConfig(enabled=args.lora_r > 0, r=r, alpha=2 * r),
        optimizer=OptimizerConfig(learning_rate=args.learning_rate,
                                  warmup_steps=args.warmup_steps),
        data=DataConfig(dataset_path=args.dataset_path, tokenizer=args.tokenizer,
                        max_seq_len=args.max_seq_len, pack_sequences=args.pack),
        checkpoint=CheckpointConfig(output_dir=args.output_dir,
                                    save_strategy=args.save_strategy,
                                    save_steps=args.save_steps,
                                    save_total_limit=args.save_total_limit,
                                    resume=not args.no_resume),
        train=TrainConfig(num_epochs=args.num_train_epochs, max_steps=args.max_steps,
                          micro_batch_size=args.per_device_batch_size,
                          grad_accum_steps=args.gradient_accumulation_steps,
                          logging_steps=args.logging_steps, seed=args.seed))


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = build_config(args)

    from dlti_tpu_torch.data import get_tokenizer, make_batches
    from dlti_tpu_torch.training import Trainer

    texts = load_texts(args.dataset_path)
    dataset = make_batches(texts, get_tokenizer(cfg.data.tokenizer),
                           seq_len=cfg.data.max_seq_len,
                           micro_batch_size=cfg.train.micro_batch_size,
                           grad_accum_steps=cfg.train.grad_accum_steps,
                           shuffle_seed=cfg.data.shuffle_seed,
                           pack=cfg.data.pack_sequences)
    if cfg.data.pack_sequences and dataset.sequences:
        longest = max(len(s) for s in dataset.sequences)
        if longest < cfg.data.max_seq_len:  # exact banded attention for packed rows
            cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, packed_attention_window=longest))
    print(f"dataset: {len(texts)} examples, {dataset.steps_per_epoch()} steps/epoch",
          flush=True)
    trainer = Trainer(cfg, device=args.device)
    state, record = trainer.train(dataset=dataset)
    if args.export_dir:
        from dlti_tpu_torch.checkpoint import export_merged_model, manifest_digest

        export_merged_model(args.export_dir, dict(state.model.named_parameters()), cfg)
        print(f"merged export -> {args.export_dir}", flush=True)
        print(f"manifest sha256: {manifest_digest(os.path.join(args.export_dir, 'model'))}",
              flush=True)
    summary = {k: v for k, v in dataclasses.asdict(record).items()
               if k not in ("losses", "grad_norms", "step_times_s", "save_stall_s")}
    summary["final_loss"] = record.final_loss
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
