"""Offline consolidated export: the port of
``scripts/export_from_checkpoint.py``. A train-state checkpoint (either
package's) becomes a merged export that ``cli.serve --model-dir`` loads.

    python -m dlti_tpu_torch.cli.export --checkpoint-dir runs/7b \\
        --model llama2_7b --lora-r 16 --out exports/merged_7b

    # on the CPU, at test scale
    python -m dlti_tpu_torch.cli.export --device cpu --checkpoint-dir runs/tiny \\
        --model llama_tiny --out exports/tiny

The restore template comes from ``--model`` and ``--lora-r`` (alpha = 2r,
as ``cli.train`` sets it) on the ``meta`` device, so no weights are made;
the checkpoint's leaves are read to ``--device`` (the card unless told
``cpu``), the LoRA pairs are merged there (``--keep-lora`` keeps them as
leaves), and the export is written. ``--step 0`` takes the newest step that
verifies (corrupt newer ones are quarantined). ``--fp16`` reads an
``cli.train --fp16`` run's checkpoint: its base is float16 and its state
carries the loss scaler's leaves, so the template has both (the JAX
package's script adds only the scaler and so refuses such a checkpoint's
float16 base). ``--quantize-base int8`` reads a ``cli.train --quantize-base
int8`` run's checkpoint: the template's frozen weights are ``{q, scale}``
pairs, and the export expands them to bf16 (merged or not), as the
reference's does. The last line on stdout is ``manifest sha256: <digest>``,
the export's content identity.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from dlti_tpu_torch.config import MODEL_PRESETS


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="checkpoint -> merged servable export (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--step", type=int, default=0, help="0 = latest verified")
    p.add_argument("--model", default="llama2_7b", choices=sorted(MODEL_PRESETS))
    p.add_argument("--lora-r", type=int, default=16, help="0 = a full fine-tune")
    p.add_argument("--quantize-base", default="", choices=["", "int8"],
                   help="checkpoint came from a --quantize-base run (int8 frozen "
                        "base leaves; the export is dequantized to bf16)")
    p.add_argument("--out", required=True)
    p.add_argument("--keep-lora", action="store_true",
                   help="export unmerged (adapter factors kept as leaves)")
    p.add_argument("--fp16", action="store_true",
                   help="checkpoint came from an --fp16 run (a float16 base, and "
                        "its state carries the dynamic loss scaler subtree)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def export(args) -> str:
    """Restore the checkpoint's params and write the export; returns its
    manifest SHA-256."""
    from dlti_tpu_torch.checkpoint import (
        export_merged_model, latest_verified_step, manifest_digest, restore_train_state,
    )
    from dlti_tpu_torch.config import Config, LoRAConfig, OptimizerConfig
    from dlti_tpu_torch.models.llama import LlamaForCausalLM
    from dlti_tpu_torch.models.quantization import install_quantized, should_quantize
    from dlti_tpu_torch.training import build_optimizer, create_train_state
    from dlti_tpu_torch.training.state import params_key, state_leaves
    from dlti_tpu_torch.utils.device import resolve_device

    r = max(args.lora_r, 1)
    model_cfg = MODEL_PRESETS[args.model]
    if args.fp16:  # as cli.train --fp16 sets it
        model_cfg = dataclasses.replace(model_cfg, dtype="float16", param_dtype="float16")
    cfg = Config(model=model_cfg,
                 lora=LoRAConfig(enabled=args.lora_r > 0, r=r, alpha=2 * r))
    device = resolve_device(args.device)
    model = LlamaForCausalLM(cfg.model, cfg.lora if cfg.lora.enabled else None,
                             device="meta")
    if args.quantize_base:  # the leaves cli.train --quantize-base int8 quantized
        install_quantized(model, [n for n, p in model.named_parameters()
                                  if should_quantize(n, p)])
    template = create_train_state(model, build_optimizer(OptimizerConfig()),
                                  lora_enabled=cfg.lora.enabled,
                                  fp16_initial_scale=2.0 ** 16 if args.fp16 else None)
    step = args.step or latest_verified_step(args.checkpoint_dir)
    if step is None:
        raise SystemExit(f"no verified checkpoints under {args.checkpoint_dir}")
    print(f"restoring step {step} from {args.checkpoint_dir} on {device}", flush=True)
    restored = dict(restore_train_state(args.checkpoint_dir, step,
                                        state_leaves(template), device=device))
    params = {n: restored[params_key(n)] for n, _ in model.named_parameters()}
    del restored
    out = export_merged_model(args.out, params, cfg, merge_lora=not args.keep_lora)
    digest = manifest_digest(os.path.join(out, "model"))
    print(f"export -> {out}", flush=True)
    print(f"manifest sha256: {digest}", flush=True)
    return digest


def main(argv=None) -> None:
    export(parse_args(argv))


if __name__ == "__main__":
    main()
