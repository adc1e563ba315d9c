"""Serving CLI: the port of ``scripts/serve.py`` on one engine.

    python -m dlti_tpu_torch.cli.serve --random-init llama2_7b --tokenizer byte \\
        --kv-cache-dtype int8

    # on the CPU, at test scale, on a port the system picks
    python -m dlti_tpu_torch.cli.serve --device cpu --random-init llama_tiny \\
        --tokenizer byte --port 0

Flags keep the reference's names and defaults (``--steps-per-sync``,
``--no-decode-state-cache`` included); the decode iteration's CUDA graph is
captured before the server binds. Weights are random, from
``init_params(seed=0)``; ``--model-dir`` (an export) is not ported yet. It
prints ``serving on http://HOST:PORT`` with the port it bound, and SIGTERM
or Ctrl-C stops it with exit code 0.
"""

from __future__ import annotations

import argparse
import time

from dlti_tpu_torch.config import MODEL_PRESETS

KV_CACHE_DTYPES = ["bfloat16", "float32", "int8"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="OpenAI-compatible LLM server "
                                            "(PyTorch port, one engine)",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model-dir", default=None,
                   help="consolidated export dir (not ported yet; see ROADMAP.md)")
    p.add_argument("--random-init", default=None, metavar="PRESET",
                   choices=sorted(MODEL_PRESETS),
                   help="serve a random-weight model preset")
    p.add_argument("--tokenizer", default="meta-llama/Llama-2-7b-hf",
                   help="'byte' or 'id[:vocab]' (hub tokenizers are not ported)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000, help="0 = a free port")
    p.add_argument("--max-seqs", type=int, default=8, help="decode batch slots")
    p.add_argument("--num-blocks", type=int, default=2048, help="KV pool blocks")
    p.add_argument("--block-size", type=int, default=16, help="tokens per KV block")
    p.add_argument("--max-model-len", type=int, default=2048)
    p.add_argument("--max-tokens-default", type=int, default=256)
    p.add_argument("--steps-per-sync", type=int, default=1,
                   help="decode iterations per host sync (multi-step "
                        "scheduling; amortizes host round-trips)")
    p.add_argument("--kv-cache-dtype", default="bfloat16", choices=KV_CACHE_DTYPES,
                   help="KV pool dtype; int8 stores per-row-scaled payloads at "
                        "half the bf16 bytes")
    p.add_argument("--no-decode-state-cache", action="store_true",
                   help="disable the device-resident decode-state cache "
                        "(per-slot dirty tracking; clean decode steps "
                        "upload no host state) and re-upload every row "
                        "each step; outputs are identical")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def build(args):
    """(engine, tokenizer, ServerConfig) from parsed arguments: what
    :func:`main` serves, and what an in-process caller can drive."""
    if args.model_dir:
        raise SystemExit("--model-dir needs the export format, which is not "
                         "ported yet (see ROADMAP.md, queue 1); use "
                         "--random-init PRESET")
    if not args.random_init:
        raise SystemExit("need --random-init PRESET")

    from dlti_tpu_torch.data import get_tokenizer
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.serving import (
        EngineConfig, InferenceEngine, SamplingParams, ServerConfig,
    )
    from dlti_tpu_torch.utils.device import resolve_device

    tok = get_tokenizer(args.tokenizer)
    device = resolve_device(args.device)
    model_cfg = MODEL_PRESETS[args.random_init]
    t0 = time.perf_counter()
    params = init_params(model_cfg, seed=0, device=device)
    print(f"random-initialized preset {args.random_init} on {device} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ec = EngineConfig(
        max_seqs=args.max_seqs, block_size=args.block_size,
        num_blocks=args.num_blocks, max_model_len=args.max_model_len,
        eos_token_id=tok.eos_id, cache_dtype=args.kv_cache_dtype,
        steps_per_sync=args.steps_per_sync,
        decode_state_cache=not args.no_decode_state_cache)
    engine = InferenceEngine(model_cfg, params, ec, device=device)
    sc = ServerConfig(host=args.host, port=args.port,
                      default_params=SamplingParams(max_tokens=args.max_tokens_default))
    return engine, tok, sc


def main(argv=None) -> None:
    args = parse_args(argv)
    engine, tok, sc = build(args)

    from dlti_tpu_torch.serving import serve

    print(f"KV pool: {args.num_blocks} blocks x {args.block_size} tokens, "
          f"{args.kv_cache_dtype}", flush=True)
    # Capture the decode graph before traffic: its first use would otherwise
    # stall the live decode loop.
    print("pre-compiling decode programs (single-step + multi-step ladder)...",
          flush=True)
    t0 = time.time()
    engine.warmup_decode_ladder()
    print(f"decode programs ready in {time.time() - t0:.0f}s", flush=True)
    serve(engine, tok, sc)


if __name__ == "__main__":
    main()
