"""Serving CLI: the port of ``scripts/serve.py`` on one engine.

    python -m dlti_tpu_torch.cli.serve --random-init llama2_7b --tokenizer byte \\
        --kv-cache-dtype int8

    # on the CPU, at test scale, on a port the system picks
    python -m dlti_tpu_torch.cli.serve --device cpu --random-init llama_tiny \\
        --tokenizer byte --port 0

    # an export (cli.train --export-dir, cli.export), an fp16 run's on a
    # float16 pool
    python -m dlti_tpu_torch.cli.serve --model-dir exports/fp16 \
        --tokenizer byte --kv-cache-dtype float16

    # the reference's documented configuration: int8 weights, int8 KV,
    # 28 slots, 64 decode steps a host sync
    python -m dlti_tpu_torch.cli.serve --model-dir exports/glaive_int8 \
        --tokenizer byte --quantization int8 --kv-cache-dtype int8 \
        --max-seqs 28 --steps-per-sync 64

    # the latency-bounded configuration with the engine features on
    python -m dlti_tpu_torch.cli.serve --random-init llama2_7b --tokenizer byte \
        --quantization int8 --kv-cache-dtype int8 --max-seqs 28 \
        --num-blocks 910 --steps-per-sync 32 --max-prefill-tokens 256 \
        --ragged-prefill --enable-prefix-caching --prefix-host-blocks 256 \
        --speculative ngram --num-draft-tokens 4

    # several LoRA adapters over one base (serving.adapters.save_adapter
    # directories, or load_peft_adapter -> save_adapter for a PEFT one);
    # a completion picks one with the X-Adapter header, and more register
    # live through POST /v1/adapters
    python -m dlti_tpu_torch.cli.serve --device cpu --random-init llama_tiny \
        --tokenizer byte --port 0 --adapter-slots 4 --adapter-rank 8 \
        --adapter A=adapters/a --adapter B=adapters/b

    # tensor parallelism: one process per card, rank 0 serves HTTP and the
    # others follow it (on one card for a check: launcher --one-device,
    # gloo, eager decode)
    python -m dlti_tpu_torch.launcher --num-processes 2 -- \
        python -m dlti_tpu_torch.cli.serve --random-init llama2_7b \
        --tokenizer byte --tensor 2

Flags keep the reference's names and defaults (``--steps-per-sync``,
``--no-decode-state-cache``, the prefix-cache and tier flags,
``--max-prefill-tokens``, ``--ragged-prefill`` and the ``--speculative``
family included); the decode iteration's CUDA graph, and with
``--speculative ngram`` one spec round's graph per draft length, are
captured before the server binds. ``--random-init`` weights come from
``init_params(seed=0)`` (with ``--quantization int8``, ``init_params_int8``:
drawn and quantized leaf by leaf, which is how Mixtral-8x7B's 46.7 GB of
int8 weights reach one card); ``--model-dir`` serves an export in the dtype
its ``config.json`` names, a mixture of experts' too. ``--quantization
int8`` keeps the weights as int8 with per-channel (per-expert for stacked
experts) scales, quantized leaf by leaf on the card (an export is read into
host memory first, so its bf16 tree never sits whole on the card). ``--adapter-slots`` sizes the multi-LoRA pool (0: none) at rank
``--adapter-rank`` over the q/k/v/o projections; each ``--adapter
NAME=DIR`` registers one at startup (it needs slots). ``--adapter-map``,
the gateway's tenant-to-adapter routing, is not ported and raises. It
prints ``serving on http://HOST:PORT`` with the port it bound, and SIGTERM
or Ctrl-C stops it with exit code 0. ``--tensor N`` (``scripts/serve.py``'s
flag) runs under the launcher's N processes: each builds its part of the
engine (``serving.engine``, random weights drawn whole and sliced as drawn,
an export sliced as it loads), rank 0 serves and the others follow it until
it stops; the adapter pool, ``--speculative`` and the prefix tiers raise
under it.
"""

from __future__ import annotations

import argparse
import time

import torch.distributed as dist

from dlti_tpu_torch.config import MODEL_PRESETS

KV_CACHE_DTYPES = ["bfloat16", "float16", "float32", "int8"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="OpenAI-compatible LLM server "
                                            "(PyTorch port, one engine)",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model-dir", default=None,
                   help="consolidated export dir (cli.train --export-dir or cli.export)")
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
    p.add_argument("--quantization", default="none", choices=["none", "int8"],
                   help="weight-only quantization (int8 + per-channel scales; "
                        "about half the weight memory)")
    p.add_argument("--no-decode-state-cache", action="store_true",
                   help="disable the device-resident decode-state cache "
                        "(per-slot dirty tracking; clean decode steps "
                        "upload no host state) and re-upload every row "
                        "each step; outputs are identical")
    p.add_argument("--enable-prefix-caching", action="store_true",
                   help="reuse KV blocks across requests sharing a prompt "
                        "prefix (content-addressed, LRU-evicted)")
    p.add_argument("--prefix-host-blocks", type=int, default=0,
                   help="host-RAM prefix tier budget in KV blocks: evicted "
                        "prefix blocks demote here instead of being "
                        "discarded, and restore with one host->device "
                        "scatter instead of a re-prefill (0 = tier off; "
                        "implies --enable-prefix-caching)")
    p.add_argument("--prefix-disk-dir", default="",
                   help="disk prefix tier directory: host-tier overflow "
                        "demotes to digest-verified block dirs here "
                        "(checkpoint-store manifest/SHA-256 format; corrupt "
                        "blocks quarantine to _quarantine/ and read as "
                        "misses)")
    p.add_argument("--prefix-disk-blocks", type=int, default=0,
                   help="disk prefix tier budget in block dirs (0 = disk "
                        "tier off; needs --prefix-disk-dir)")
    p.add_argument("--speculative", default="none", choices=["none", "ngram"],
                   help="n-gram prompt-lookup speculative decoding (exact "
                        "greedy outputs, multiple tokens per model call)")
    p.add_argument("--num-draft-tokens", type=int, default=4)
    p.add_argument("--max-prefill-tokens", type=int, default=0,
                   help="chunked prefill: cap prompt tokens prefilled per "
                        "engine step so decode never stalls a full prompt "
                        "length (latency mode; 0 = unbounded throughput "
                        "mode)")
    p.add_argument("--ngram-size", type=int, default=2,
                   help="trailing n-gram length matched for prompt lookup")
    p.add_argument("--spec-min-acceptance", type=float, default=0.25,
                   help="speculative gate: pause a slot's proposing when its "
                        "mean accepted tokens per lookup-hit round fall below "
                        "this (0 = always speculate)")
    p.add_argument("--spec-probe-window", type=int, default=64,
                   help="greedy slot-rounds measured before each gate "
                        "decision")
    p.add_argument("--spec-cooldown", type=int, default=32,
                   help="engine rounds the gate pauses a slot's proposing "
                        "for after a failed probe window")
    p.add_argument("--no-spec-adaptive", action="store_true",
                   help="pin the draft length at --num-draft-tokens "
                        "instead of picking it per round from live "
                        "per-slot acceptance (the pow2 draft-length "
                        "ladder; outputs are identical either way)")
    p.add_argument("--ragged-prefill", action="store_true",
                   help="pack prefill chunks from many admissions into "
                        "shared ragged calls (group width = widest member, "
                        "padding bounded) instead of one call per length "
                        "bucket; outputs are identical")
    p.add_argument("--adapter-slots", type=int, default=0,
                   help="device adapter-pool slots: one decode batch serves up "
                        "to this many distinct LoRA adapters over one shared "
                        "base (0 = off)")
    p.add_argument("--adapter-rank", type=int, default=16,
                   help="pool rank ceiling: registered adapters of rank <= this "
                        "zero-pad into a slot")
    p.add_argument("--adapter", action="append", default=[], metavar="NAME=DIR",
                   help="register adapter NAME from checkpoint-store DIR "
                        "(serving.adapters.save_adapter) at startup; repeatable. "
                        "More can register later via POST /v1/adapters")
    p.add_argument("--adapter-map", default="",
                   help="tenant->adapter routing (needs the gateway, not ported)")
    p.add_argument("--tensor", type=int, default=1,
                   help="tensor-parallel extent: weights and KV pools split over this "
                        "many ranks (run under python -m dlti_tpu_torch.launcher)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def build(args):
    """(engine, tokenizer, ServerConfig) from parsed arguments: what
    :func:`main` serves, and what an in-process caller can drive."""
    if not args.model_dir and not args.random_init:
        raise SystemExit("need --model-dir DIR or --random-init PRESET")
    if args.adapter_map:
        raise SystemExit("--adapter-map routes tenants through the admission "
                         "gateway, which is not ported yet (see ROADMAP.md); "
                         "name the adapter with the X-Adapter header instead")
    if args.adapter and args.adapter_slots <= 0:
        raise SystemExit("--adapter needs --adapter-slots > 0")
    specs = []
    for spec in args.adapter:
        name, sep, adir = spec.partition("=")
        if not sep or not name.strip() or not adir.strip():
            raise SystemExit(f"--adapter expects NAME=DIR, got {spec!r}")
        specs.append((name.strip(), adir.strip()))

    from dlti_tpu_torch.data import get_tokenizer
    from dlti_tpu_torch.models.interop import init_params, init_params_int8, params_from_jax
    from dlti_tpu_torch.serving import (
        EngineConfig, InferenceEngine, SamplingParams, ServerConfig,
    )
    from dlti_tpu_torch.serving.engine import EngineExecutor
    from dlti_tpu_torch.utils.device import resolve_device

    mesh = tensor_mesh(args)
    tok = get_tokenizer(args.tokenizer)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    lora_cfg = None
    if args.model_dir:
        from dlti_tpu_torch.checkpoint import load_exported_model

        # int8: the engine quantizes host leaves one at a time on the card.
        tree, cfg = load_exported_model(
            args.model_dir, device=None if args.quantization == "int8" else device)
        params = params_from_jax(tree)
        del tree
        model_cfg = cfg.model
        lora_cfg = cfg.lora if cfg.lora.enabled else None
        print(f"loaded export {args.model_dir} (layers={model_cfg.num_layers}, "
              f"hidden={model_cfg.hidden_size}) on {device} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    else:
        model_cfg = MODEL_PRESETS[args.random_init]
        if args.quantization == "int8":
            # Drawn and quantized leaf by leaf: Mixtral-8x7B's bf16 tree
            # (93 GB) never exists.
            params = init_params_int8(model_cfg, seed=0, device=device, mesh=mesh)
        else:
            params = init_params(model_cfg, seed=0, device=device, mesh=mesh)
        print(f"random-initialized preset {args.random_init} on {device} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    tiered = args.prefix_host_blocks > 0 or (
        args.prefix_disk_blocks > 0 and args.prefix_disk_dir)
    ec = EngineConfig(
        max_seqs=args.max_seqs, block_size=args.block_size,
        num_blocks=args.num_blocks, max_model_len=args.max_model_len,
        eos_token_id=tok.eos_id, cache_dtype=args.kv_cache_dtype,
        enable_prefix_caching=args.enable_prefix_caching or bool(tiered),
        prefix_host_blocks=args.prefix_host_blocks,
        prefix_disk_dir=args.prefix_disk_dir,
        prefix_disk_blocks=args.prefix_disk_blocks,
        steps_per_sync=args.steps_per_sync,
        speculative=args.speculative,
        num_draft_tokens=args.num_draft_tokens,
        ngram_size=args.ngram_size,
        spec_min_acceptance=args.spec_min_acceptance,
        spec_probe_window=args.spec_probe_window,
        spec_cooldown=args.spec_cooldown,
        spec_adaptive=not args.no_spec_adaptive,
        max_prefill_tokens_per_step=args.max_prefill_tokens,
        ragged_prefill=args.ragged_prefill,
        decode_state_cache=not args.no_decode_state_cache,
        quantization=args.quantization,
        adapter_slots=args.adapter_slots,
        adapter_rank=args.adapter_rank)
    executor = None
    if mesh is not None and device.type == "cuda" and dist.get_backend() == "gloo":
        print("decoding eagerly: the decode graph captures the tensor collectives, "
              "which needs NCCL, and this group runs gloo (launcher --one-device)",
              flush=True)
        executor = EngineExecutor(model_cfg, params, ec, lora_cfg, device,
                                  cuda_graphs=False, donate_params=True, mesh=mesh)
    engine = InferenceEngine(model_cfg, params, ec, lora_cfg=lora_cfg, device=device,
                             donate_params=True, mesh=mesh, executor=executor)
    del params
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in engine.executor.model.parameters())
    print(f"weights on {device}: {weight_bytes / 1e9:.2f} GB "
          f"(quantization {args.quantization})", flush=True)
    if engine.adapter_pool is not None:
        from dlti_tpu_torch.serving.adapters import register_adapter

        for name, adir in specs:
            register_adapter(name, adir)
            print(f"registered adapter {name!r} from {adir}", flush=True)
        print(f"adapter pool: {args.adapter_slots} slots at rank {args.adapter_rank}, "
              f"{engine.adapter_pool.nbytes / 1e9:.3f} GB", flush=True)
    sc = ServerConfig(host=args.host, port=args.port,
                      default_params=SamplingParams(max_tokens=args.max_tokens_default))
    return engine, tok, sc


def tensor_mesh(args):
    """The tensor-parallel mesh of ``--tensor`` (None at 1): joins the
    launcher's process group first, whose world must be the extent."""
    if args.tensor == 1:
        return None
    if args.tensor < 1:
        raise SystemExit(f"--tensor {args.tensor}: the extent must be at least 1")
    from dlti_tpu_torch.config import ParallelConfig
    from dlti_tpu_torch.launcher import maybe_initialize_from_env
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.utils.device import resolve_device

    maybe_initialize_from_env(args.device)  # before anything lands on a card
    if not dist.is_initialized() or dist.get_world_size() != args.tensor:
        raise SystemExit(f"--tensor {args.tensor} runs under python -m "
                         f"dlti_tpu_torch.launcher --num-processes {args.tensor}")
    return build_mesh(ParallelConfig(tensor=args.tensor), resolve_device(args.device))


def main(argv=None) -> None:
    args = parse_args(argv)
    engine, tok, sc = build(args)
    if engine.follower:
        print(f"tensor rank {engine.executor.mesh.tensor.rank}: following rank 0",
              flush=True)
        engine.follow()
        return

    from dlti_tpu_torch.serving import serve

    print(f"KV pool: {args.num_blocks} blocks x {args.block_size} tokens, "
          f"{args.kv_cache_dtype}", flush=True)
    # Capture the decode graph before traffic: its first use would otherwise
    # stall the live decode loop.
    print("pre-compiling decode programs (single-step + multi-step ladder)...",
          flush=True)
    t0 = time.time()
    engine.warmup_decode_ladder()
    pool = engine.executor.graph_pool_bytes
    print(f"decode programs ready in {time.time() - t0:.0f}s"
          + (f" (graph pool {pool / 1e9:.2f} GB)" if pool else ""), flush=True)
    serve(engine, tok, sc)


if __name__ == "__main__":
    main()
