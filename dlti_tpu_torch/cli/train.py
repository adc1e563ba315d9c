"""Training CLI: the port of ``scripts/train.py``, on one device or data
parallel (``--preset baseline|zero1|zero2|zero3`` under the launcher).

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

    # fp16: a float16 model under the dynamic loss scaler (export with
    # cli.export --fp16, serve with --kv-cache-dtype float16)
    python -m dlti_tpu_torch.cli.train --device cpu --model llama_tiny \
        --tokenizer byte --dataset-path data/ --max-seq-len 64 --max-steps 4 \
        --fp16 --save-steps 2 --output-dir runs/fp16

    # ZeRO-3 over 2 processes (gloo on the CPU; drop --device cpu for one
    # process per card over NCCL), host offload of the moments
    python -m dlti_tpu_torch.launcher --num-processes 2 -- \
        python -m dlti_tpu_torch.cli.train --device cpu --preset zero3 \
        --model llama_tiny --tokenizer byte --dataset-path data/ \
        --max-seq-len 64 --max-steps 4 --offload-optimizer --save-strategy no

    # the Quickstart's 7B recipe on a token store (cli.prepare_dataset
    # --write-token-store): an int8 frozen base, no remat, 10 steps a sync,
    # the run's row appended to a metrics CSV and a per-step JSONL log
    python -m dlti_tpu_torch.cli.train --model llama2_7b --preset baseline \
        --dataset-path data/glaive_tokens --tokenizer byte --lora-r 16 \
        --quantize-base int8 --remat-policy none --steps-per-sync 10 \
        --max-steps 300 --metrics-csv results/training_metrics.csv \
        --step-log runs/steps.jsonl --export-dir exports/glaive_int8

    # from a Hugging Face checkpoint directory (config.json + safetensors):
    # its config sets the architecture, LoRA factors start fresh; after
    # training, the adapter in PEFT layout and the merged model in HF layout
    python -m dlti_tpu_torch.cli.train --device cpu --tokenizer byte \
        --dataset-path data/ --max-seq-len 64 --max-steps 4 --lora-r 4 \
        --init-from-hf hf/tiny --export-peft out/peft --export-hf out/hf \
        --save-strategy no

    # 4 steps a host sync, the chunked loss, an eval every 4 steps
    python -m dlti_tpu_torch.cli.train --device cpu --model llama_tiny \
        --tokenizer byte --dataset-path data/ --max-seq-len 64 --max-steps 8 \
        --steps-per-sync 4 --loss-chunk 32 --eval-dataset held_out/ \
        --eval-steps 4 --save-strategy no

Flags keep the reference's names and defaults: like the reference it
checkpoints every 100 steps under ``./checkpoints/run`` and first resumes
from the newest checkpoint there that verifies (``--no-resume`` starts
afresh, ``--save-strategy no`` writes nothing). ``--export-dir`` writes the
merged model after training (``cli.serve --model-dir`` serves it).
``--init-from-hf DIR`` starts from an HF checkpoint directory
(``models.hf_interop.load_hf_checkpoint``): its ``config.json`` sets the
architecture, overriding ``--model``'s, while the preset keeps the
performance fields (dtypes, remat, attention implementation), and the
base is grafted under freshly initialized LoRA factors, then goes the way a
seeded base goes (``--quantize-base``, ZeRO, offload). After training,
``--export-peft DIR`` writes the LoRA factors as a PEFT adapter and
``--export-hf DIR`` the merged model as an HF checkpoint (rank 0).
``--dataset-path`` and ``--eval-dataset`` are a ``data.jsonl`` (one
``{"text": ...}`` per line), a directory holding one, a file of text
lines, or a memory-mapped token store (a directory with ``meta.json``,
``data.streaming``; its tokenizer and ``--max-seq-len`` must be the run's).
``--quantize-base int8`` keeps the frozen base as int8 weights with
per-channel scales (LoRA only; export with ``cli.export --quantize-base
int8``). ``--metrics-csv`` is where rank 0 appends the run's row of the
reference's metrics CSV (``cli.compare_training`` reads it), ``--step-log``
a per-step JSONL stream. ``--steps-per-sync`` runs that
many optimizer steps a host synchronisation (on the card one CUDA graph of
the step, replayed); eval and saves land at window boundaries. ``--fp16``
runs the model in float16 (compute and base weights) under the dynamic loss
scaler, as the reference's ``--fp16`` does. Weights are random, from
``--seed``. Prints the reference's metrics summary, then one JSON line with
the run's record (and the flash kernels' launches in the process) at the
end.

``--preset`` picks the strategy (the reference's semantics): ``baseline``
(replicated data parallelism), ``zero1``/``zero2`` (sharded optimizer
state, then reduce-scattered gradients, over ``data``) or ``zero3``
(sharded parameters over ``fsdp``); ``--num-devices`` is the extent (0 = the
launcher's world), and ``--per-device-batch-size`` times it is the global
microbatch. ``--offload-optimizer`` and ``--offload-params`` keep the
optimizer moments and the frozen base in pinned host memory. Under the
launcher rank 0 alone logs, writes checkpoints (consolidated) and the
export, and prints the summary. ``--tensor N`` splits heads, MLP hidden
units and the vocabulary over N ranks (``parallel.tensor``). ``--expert N``
splits a mixture of experts' experts over N ranks (``--model
mixtral_tiny``, ``mixtral_8x7b``). ``--sequence N`` splits every row's
tokens over N ranks, attention running the ring
(``parallel.ring_attention``). Without ``--pipe`` the batch extent (``data``,
or ``fsdp`` under ``zero3``) is ``--num-devices``, 0 meaning the world over
``--tensor * --sequence * --expert``, as the reference's
``scripts/train.py`` sizes it. ``--pipe P`` splits the layers into P GPipe
stages (``parallel.pipeline``), the microbatches being
``--gradient-accumulation-steps``; under it ``--data D`` is the batch-row
extent (``fsdp`` under ``zero3``, which then needs D above 1, as in the
reference) and ``--num-devices``, when given, must equal ``P * tensor *
sequence * expert * D``; ``--data`` without ``--pipe`` raises, as in the
reference. ``zero3`` shards each leaf over its own ``fsdp`` axis, on a dim
the tensor and expert axes leave free (``parallel.sharding.strategy_axes``),
so it composes with every model axis; at an ``fsdp`` extent of 1 nothing is
sharded. Not ported, each raising by name: offload with ``--tensor``,
``--sequence`` or ``--pipe``; ``--tensor`` with ``--expert``; ``--pipe``
with ``--sequence``; ``--sequence`` with a mixture of experts.

    # sequence parallelism over 2 ranks, then a pipeline of 2 stages (gloo
    # on the CPU; on one card drop --device cpu and give the launcher
    # --one-device: gloo there too, and the steps run eagerly, since the
    # step graph captures NCCL collectives only)
    python -m dlti_tpu_torch.launcher --num-processes 2 -- \\
        python -m dlti_tpu_torch.cli.train --device cpu --model llama_tiny \\
        --sequence 2 --tokenizer byte --dataset-path data/ --max-seq-len 64 \\
        --max-steps 4 --save-strategy no
    python -m dlti_tpu_torch.launcher --num-processes 2 -- \\
        python -m dlti_tpu_torch.cli.train --device cpu --model llama_tiny \\
        --pipe 2 --data 1 --tokenizer byte --dataset-path data/ --max-seq-len 64 \\
        --gradient-accumulation-steps 4 --max-steps 4 --save-strategy no
    # ZeRO-3 over fsdp 2 beside tensor 2 (the README's --preset zero3
    # --tensor 2), and over fsdp 2 under pipe 2
    python -m dlti_tpu_torch.launcher --num-processes 4 -- \\
        python -m dlti_tpu_torch.cli.train --device cpu --model llama_tiny \\
        --preset zero3 --tensor 2 --tokenizer byte --dataset-path data/ \\
        --max-seq-len 64 --max-steps 4 --save-strategy no
    python -m dlti_tpu_torch.launcher --num-processes 4 -- \\
        python -m dlti_tpu_torch.cli.train --device cpu --model llama_tiny \\
        --preset zero3 --pipe 2 --data 2 --tokenizer byte --dataset-path data/ \\
        --max-seq-len 64 --gradient-accumulation-steps 4 --max-steps 4 \\
        --save-strategy no
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

from dlti_tpu_torch.config import (
    MODEL_PRESETS, CheckpointConfig, DataConfig, LoRAConfig, OptimizerConfig,
    ParallelConfig, TrainConfig, ZeROStage, preset,
)

REMAT_CHOICES = ["none", "nothing_saveable", "dots_saveable",
                 "dots_with_no_batch_dims_saveable", "save_attn_out"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LoRA trainer (PyTorch port)",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--preset", default="baseline",
                   help="strategy: baseline | zero1 | zero2 | zero3")
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
    p.add_argument("--loss-chunk", type=int, default=0,
                   help="sequence-chunked cross-entropy: LM head + CE this many "
                        "positions at a time, so full float32 logits never sit "
                        "in device memory (0 = off)")
    p.add_argument("--steps-per-sync", type=int, default=1,
                   help="optimizer steps per host synchronisation (same "
                        "trajectory as 1, metrics stay per-step, eval/saves "
                        "land at window boundaries)")
    p.add_argument("--quantize-base", default="", choices=["", "int8"],
                   help="store the frozen base params weight-only quantized "
                        "(int8 + per-channel scales; requires LoRA)")
    p.add_argument("--metrics-csv", default="results/training_metrics.csv",
                   help="append the run's row of the reference's metrics CSV here")
    p.add_argument("--step-log", default="",
                   help="per-step JSONL stream (rank 0): step, loss, grad_norm, lr, "
                        "tok/s/card, MFU, peak memory; a superset of the CSV columns")
    p.add_argument("--fp16", action="store_true",
                   help="fp16 + dynamic loss scaling parity mode (the model in "
                        "float16, the reference's DeepSpeed fp16 block)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--logging-steps", type=int, default=10)
    p.add_argument("--save-strategy", default="steps", choices=["steps", "epoch", "no"])
    p.add_argument("--save-steps", type=int, default=100)
    p.add_argument("--save-total-limit", type=int, default=3)
    p.add_argument("--no-resume", action="store_true",
                   help="skip the verified scan-latest-and-resume pass")
    p.add_argument("--export-dir", default=None,
                   help="write a consolidated merged-LoRA export here after training")
    p.add_argument("--init-from-hf", default=None, metavar="DIR",
                   help="initialize base weights from an HF Llama checkpoint dir "
                        "(config.json + safetensors); overrides --model's arch")
    p.add_argument("--export-hf", default=None, metavar="DIR",
                   help="write the merged model as an HF-layout checkpoint after training")
    p.add_argument("--export-peft", default=None, metavar="DIR",
                   help="write the LoRA factors as a PEFT adapter after training")
    p.add_argument("--eval-dataset", default=None, metavar="PATH",
                   help="held-out dataset (same formats as --dataset-path); "
                        "evaluated every --eval-steps optimizer steps")
    p.add_argument("--eval-steps", type=int, default=0,
                   help="eval cadence in steps (0 = never; requires --eval-dataset)")
    p.add_argument("--num-devices", type=int, default=0,
                   help="DP/FSDP extent; 0 = the launcher's world (1 without it)")
    p.add_argument("--tensor", type=int, default=1, help="tensor-parallel extent")
    p.add_argument("--sequence", type=int, default=1,
                   help="sequence-parallel (ring attention) extent")
    p.add_argument("--pipe", type=int, default=1,
                   help="pipeline-parallel stages (GPipe schedule; microbatches = "
                        "--gradient-accumulation-steps); under --pipe, --data sets the "
                        "batch-row extent")
    p.add_argument("--expert", type=int, default=1,
                   help="expert-parallel extent: a mixture of experts' experts split "
                        "over this many ranks")
    p.add_argument("--data", type=int, default=None,
                   help="batch-row (DP) extent under --pipe; default: the preset's "
                        "own extent. Rejected without --pipe (use --num-devices there)")
    p.add_argument("--offload-optimizer", action="store_true",
                   help="optimizer moments in pinned host memory "
                        "(ds_config_zero3.json:19-23)")
    p.add_argument("--offload-params", action="store_true",
                   help="the frozen base in pinned host memory, streamed into the "
                        "step a block ahead (ds_config_zero3.json:24-27)")
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


def build_parallel(args, preset_parallel: ParallelConfig) -> ParallelConfig:
    """The reference's mesh rules (``scripts/train.py:300-362``). Under
    ``--pipe`` the batch-row extent is ``--data`` (default: the preset's own
    extent), on ``fsdp`` under ZeRO-3, and ``--num-devices``, when given,
    must equal ``pipe * tensor * sequence * expert * data``. Without it
    ``--data`` is refused, and the batch extent is ``--num-devices`` (0: the
    process group's world over ``--tensor * --sequence * --expert``).
    The model axes keep their extents; ``build_mesh`` then checks the
    product against the world."""
    for axis in ("tensor", "sequence", "pipe", "expert"):
        if getattr(args, axis) < 1:
            raise SystemExit(f"--{axis} {getattr(args, axis)}: the extent must be at "
                             "least 1")
    zero_stage = ZeROStage(preset_parallel.zero_stage)
    kw = dict(zero_stage=zero_stage, offload_optimizer=args.offload_optimizer,
              offload_params=args.offload_params, expert=args.expert, tensor=args.tensor,
              sequence=args.sequence, pipe=args.pipe)
    model_axes = args.tensor * args.sequence * args.expert
    if args.pipe > 1:
        preset_rows = (preset_parallel.fsdp if zero_stage == ZeROStage.ZERO3
                       else preset_parallel.data)
        rows = args.data if args.data is not None else max(preset_rows, 1)
        if rows < 1:
            raise SystemExit(f"--data {rows} must be >= 1")
        if zero_stage == ZeROStage.ZERO3 and rows == 1:
            raise SystemExit(
                "--preset zero3 with --pipe needs a batch-row extent for the FSDP axis: "
                "pass --data N or use a zero3_Ndev preset (fsdp=1 would silently "
                "disable ZeRO-3 param sharding)")
        mesh_n = args.pipe * model_axes * rows
        if args.num_devices and args.num_devices != mesh_n:
            raise SystemExit(
                f"--num-devices {args.num_devices} conflicts with --pipe {args.pipe} (the "
                f"pipe mesh uses exactly pipe*tensor*sequence*expert*data = {mesh_n} "
                "devices; drop --num-devices or fix --data)")
        if zero_stage == ZeROStage.ZERO3:
            return ParallelConfig(fsdp=rows, **kw)
        return ParallelConfig(data=rows, **kw)
    if args.data is not None:
        # A mesh flag is never silently dropped.
        raise SystemExit(f"--data {args.data} only applies under --pipe; without it use "
                         "--num-devices to set the DP/FSDP extent")
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    n = args.num_devices or max(world // model_axes, 1)
    if zero_stage == ZeROStage.ZERO3:
        return ParallelConfig(fsdp=n, **kw)
    return ParallelConfig(data=n, **kw)


def build_config(args):
    cfg = preset(args.preset, model=args.model)
    par = build_parallel(args, cfg.parallel)
    model = cfg.model
    if args.fp16:
        # compute and store in float16; the scaler handles overflow
        model = dataclasses.replace(model, dtype="float16", param_dtype="float16")
    if args.remat_policy == "none":
        model = dataclasses.replace(model, remat=False)
    elif args.remat_policy:
        model = dataclasses.replace(model, remat_policy=args.remat_policy)
    if args.remat_stride:
        model = dataclasses.replace(model, remat_stride=args.remat_stride)
    r = max(args.lora_r, 1)
    from dlti_tpu_torch.utils.experiment import create_experiment_name

    return cfg.replace(
        model=model,
        parallel=par,
        experiment_name=create_experiment_name(par.num_devices, int(par.zero_stage)),
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
                          micro_batch_size=args.per_device_batch_size * par.dp_like_size,
                          grad_accum_steps=args.gradient_accumulation_steps,
                          logging_steps=args.logging_steps, seed=args.seed,
                          eval_steps=args.eval_steps, loss_chunk=args.loss_chunk,
                          steps_per_sync=args.steps_per_sync, fp16=args.fp16,
                          quantize_frozen_base=args.quantize_base,
                          metrics_csv=args.metrics_csv, step_log_path=args.step_log))


def open_token_store(path: str, cfg, accum: int, shuffle_seed):
    """A token store as the run's dataset, refusing one written with
    another tokenizer or ``seq_len``."""
    from dlti_tpu_torch.data.streaming import StreamingTokenDataset

    try:
        ds = StreamingTokenDataset(path, micro_batch_size=cfg.train.micro_batch_size,
                                   grad_accum_steps=accum, shuffle_seed=shuffle_seed,
                                   expect_tokenizer=cfg.data.tokenizer)
    except ValueError as e:
        raise SystemExit(str(e))
    if ds.seq_len != cfg.data.max_seq_len:
        raise SystemExit(f"token store {path} was written with seq_len={ds.seq_len}, "
                         f"but --max-seq-len is {cfg.data.max_seq_len}; re-prepare "
                         f"or pass the matching --max-seq-len")
    return ds


def with_packed_window(cfg, longest: int):
    """Exact banded attention for packed rows whose documents are all
    shorter than ``max_seq_len``."""
    if longest and longest < cfg.data.max_seq_len:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    packed_attention_window=longest))
    return cfg


# The fields an HF config.json does not decide: the preset's (an fp32
# checkpoint must not quietly turn training to fp32).
PERF_FIELDS = ("dtype", "param_dtype", "remat", "remat_policy", "remat_stride",
               "attention_impl", "flash_block_q", "flash_block_kv")


def hf_base(directory: str, cfg, device):
    """``(base params, cfg)``: the HF checkpoint's weights on ``device`` and
    the config with its architecture and the preset's performance fields."""
    from dlti_tpu_torch.models.hf_interop import load_hf_checkpoint

    base, model = load_hf_checkpoint(
        directory, device=device,
        **{f: getattr(cfg.model, f) for f in PERF_FIELDS})
    if model != cfg.model:
        print(f"model arch from {directory}/config.json (overrides --model)", flush=True)
        cfg = cfg.replace(model=model)
    return base, cfg


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    import torch.distributed as dist

    from dlti_tpu_torch.launcher import init_group_of_one, maybe_initialize_from_env

    maybe_initialize_from_env(args.device)  # before anything lands on a card
    if not dist.is_initialized() and preset(args.preset).parallel.zero_stage != ZeROStage.NONE:
        from dlti_tpu_torch.utils.device import resolve_device

        # A ZeRO strategy without the launcher: its collectives in a group of one.
        init_group_of_one(resolve_device(args.device))
    cfg = build_config(args)
    params = None
    if args.init_from_hf:
        from dlti_tpu_torch.models.hf_interop import graft_base_params
        from dlti_tpu_torch.models.interop import init_params
        from dlti_tpu_torch.utils.device import resolve_device

        device = resolve_device(args.device)
        base, cfg = hf_base(args.init_from_hf, cfg, device)
        # A seeded tree, whose LoRA factors stay and whose base leaves the
        # checkpoint's replace one by one.
        params = graft_base_params(
            init_params(cfg.model, seed=cfg.train.seed, device=device,
                        lora=cfg.lora if cfg.lora.enabled else None), base)
        del base

    from dlti_tpu_torch.data import get_tokenizer, make_batches
    from dlti_tpu_torch.training import Trainer, whole_params

    writer = not dist.is_initialized() or dist.get_rank() == 0

    from dlti_tpu_torch.data.streaming import is_token_store

    if is_token_store(args.dataset_path):
        dataset = open_token_store(args.dataset_path, cfg, cfg.train.grad_accum_steps,
                                   cfg.data.shuffle_seed)
        if dataset.packed:
            cfg = with_packed_window(cfg, dataset.max_doc_len)
        described = (f"memory-mapped token store {args.dataset_path} ({dataset._n_rows} "
                     f"rows x {dataset.seq_len}, packed={dataset.packed})")
    else:
        texts = load_texts(args.dataset_path)
        dataset = make_batches(texts, get_tokenizer(cfg.data.tokenizer),
                               seq_len=cfg.data.max_seq_len,
                               micro_batch_size=cfg.train.micro_batch_size,
                               grad_accum_steps=cfg.train.grad_accum_steps,
                               shuffle_seed=cfg.data.shuffle_seed,
                               pack=cfg.data.pack_sequences)
        if cfg.data.pack_sequences and dataset.sequences:
            cfg = with_packed_window(cfg, max(len(s) for s in dataset.sequences))
        described = f"{len(texts)} examples"
    if writer:
        print(f"dataset: {described}, {dataset.steps_per_epoch()} steps/epoch",
              flush=True)
    eval_dataset = None
    if args.eval_dataset:
        if not cfg.train.eval_steps:
            raise SystemExit("--eval-dataset needs --eval-steps > 0")
        if is_token_store(args.eval_dataset):
            # fixed order: comparable losses
            eval_dataset = open_token_store(args.eval_dataset, cfg, 1, None)
            window = cfg.model.packed_attention_window
            if eval_dataset.packed and window and eval_dataset.max_doc_len > window:
                # The band is exact only if it covers the eval split's longest
                # document too (a window of 0 turns it off).
                cfg = cfg.replace(model=dataclasses.replace(
                    cfg.model, packed_attention_window=(
                        0 if eval_dataset.max_doc_len >= cfg.data.max_seq_len
                        else eval_dataset.max_doc_len)))
            described = f"token store {args.eval_dataset}"
        else:
            eval_texts = load_texts(args.eval_dataset)
            eval_dataset = make_batches(eval_texts, get_tokenizer(cfg.data.tokenizer),
                                        seq_len=cfg.data.max_seq_len,
                                        micro_batch_size=cfg.train.micro_batch_size,
                                        grad_accum_steps=1,
                                        shuffle_seed=None)  # fixed order: comparable losses
            described = f"{len(eval_texts)} examples from {args.eval_dataset}"
        if writer:
            print(f"eval dataset: {described}", flush=True)
        if eval_dataset.steps_per_epoch() == 0:
            raise SystemExit(
                f"eval dataset yields zero batches: it has fewer rows than one "
                f"batch ({cfg.train.micro_batch_size}); shrink "
                f"--per-device-batch-size or grow the eval split")
    from dlti_tpu_torch.utils.device import resolve_device

    graphs = True
    if (dist.is_initialized() and dist.get_backend() == "gloo"
            and resolve_device(args.device).type == "cuda"):
        graphs = False
        if writer:
            print("training eagerly: the train-step graph captures the step's collectives, "
                  "which needs NCCL, and this group runs gloo (launcher --one-device)",
                  flush=True)
    trainer = Trainer(cfg, params, device=args.device, cuda_graphs=graphs)
    del params
    state, record = trainer.train(dataset=dataset, eval_dataset=eval_dataset)
    if writer:
        from dlti_tpu_torch.utils.metrics import print_metrics_summary

        print_metrics_summary(record.metrics)
    if args.export_dir:
        from dlti_tpu_torch.checkpoint import export_merged_model, manifest_digest

        # Every rank gathers; an offloaded base is merged where it rests, on the host.
        params = whole_params(state)
        if writer:
            export_merged_model(args.export_dir, params, cfg)
            print(f"merged export -> {args.export_dir}", flush=True)
            print(f"manifest sha256: "
                  f"{manifest_digest(os.path.join(args.export_dir, 'model'))}", flush=True)
        del params
    if args.export_peft or args.export_hf:
        params = whole_params(state)
        if writer and args.export_peft:
            from dlti_tpu_torch.models.hf_interop import save_peft_adapter

            save_peft_adapter(args.export_peft, params, cfg.lora)
            print(f"PEFT adapter -> {args.export_peft}", flush=True)
        if writer and args.export_hf:
            from dlti_tpu_torch.models import merge_lora_params
            from dlti_tpu_torch.models.hf_interop import save_hf_checkpoint

            save_hf_checkpoint(args.export_hf,
                               merge_lora_params(params, alpha=cfg.lora.alpha),
                               cfg.model)
            print(f"HF checkpoint -> {args.export_hf}", flush=True)
        del params
    if dist.is_initialized():
        dist.destroy_process_group()
    if not writer:
        return
    summary = {k: v for k, v in dataclasses.asdict(record).items()
               if k not in ("losses", "grad_norms", "loss_scales", "aux_losses",
                            "step_times_s", "save_stall_s")}
    summary["final_loss"] = record.final_loss
    if record.loss_scales:
        summary["final_loss_scale"] = record.loss_scales[-1]
    if record.aux_losses:
        summary["final_aux_loss"] = record.aux_losses[-1]
    summary["host_syncs_per_step"] = record.host_syncs_per_step
    from dlti_tpu_torch.ops import flash_attention

    # The flash kernels' launches in this process (a captured step's
    # replays are credited with what its capture counted).
    summary["flash_launches"] = {"fwd": flash_attention.fwd_launches,
                                 "dq": flash_attention.dq_launches,
                                 "dkv": flash_attention.dkv_launches}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
