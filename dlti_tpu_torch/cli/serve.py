"""Serving CLI: the port of ``scripts/serve.py``, on one engine or a
replica fleet behind the admission gateway.

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

    # data-parallel replicas, one a card, behind the admission gateway, with
    # self-healing (on the CPU: --device cpu, every replica on the CPU)
    python -m dlti_tpu_torch.cli.serve --random-init llama2_7b --tokenizer byte \
        --quantization int8 --kv-cache-dtype int8 --max-seqs 28 \
        --replicas 2 --gateway --max-queued-requests 64 --self-heal

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
NAME=DIR`` registers one at startup (it needs slots); ``--adapter-map``
routes a gateway tenant to one. ``--replicas N`` serves N engines, one a
visible card (all on the device ``--device cpu`` or ``--device cuda:I``
names), dispatched
least-loaded (``--affinity``: sticky by session or prompt prefix), with
failover, live KV migration and, under ``--self-heal``, quarantine,
rebuild and canary (``serving.replicas``); a sole replica gets that
lifecycle too under ``--self-heal`` or ``--reload-checkpoint``. ``--gateway``
puts the admission gateway in front (``serving.gateway``: queue bounds,
rate limits, priorities, tenants, SIGTERM drain). ``--trace-dir`` turns the
span tracer on (ring of ``--trace-capacity`` events; Chrome trace
``trace_serve_<pid>.json`` written there at exit; ``POST /debug/profile``
captures under it), ``--slow-log-k`` sizes ``/debug/slow``, the memory
ledger (off with ``--no-memory-ledger``) backs ``/debug/memory`` and, with
``--admit-min-headroom-frac``, defers admission under low headroom
(``--hbm-budget-bytes`` is the capacity where the device reports none), and
``--guard-token-storm N`` faults a round after N all-slots-equal steps.
The reference's flags of subsystems the port lacks (the multi-process
fleet, disaggregation, the deploy controller, the watchdog, SLO engine and
flight recorder) are accepted by name and refused, naming ROADMAP.md, as is
``--replicas`` with ``--tensor`` above 1. It prints ``serving on http://HOST:PORT`` with the port it bound, and SIGTERM
or Ctrl-C stops it with exit code 0. ``--tensor N`` (``scripts/serve.py``'s
flag) runs under the launcher's N processes: each builds its part of the
engine (``serving.engine``, random weights drawn whole and sliced as drawn,
an export sliced as it loads), rank 0 serves and the others follow it until
it stops; the adapter pool, ``--speculative`` and the prefix tiers raise
under it.
"""

from __future__ import annotations

import argparse
import os
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
                   help="tenant->adapter routing, e.g. 'teamA:ad1,teamB:ad2': requests "
                        "without an X-Adapter header get their tenant's adapter (needs "
                        "--gateway; X-Adapter always works)")
    p.add_argument("--tensor", type=int, default=1,
                   help="tensor-parallel extent: weights and KV pools split over this "
                        "many ranks (run under python -m dlti_tpu_torch.launcher)")
    p.add_argument("--replicas", type=int, default=1,
                   help="data-parallel engine replicas, one a visible card (all on the "
                        "device --device cpu or --device cuda:I names); a replica whose "
                        "step faults is excluded and its requests fail over to survivors")
    p.add_argument("--no-numeric-guard", action="store_true",
                   help="disable the nonfinite decode-output guard (NumericFault -> "
                        "replica quarantine)")
    p.add_argument("--guard-token-storm", type=int, default=0,
                   help="quarantine a replica after N consecutive decode steps where "
                        "every active slot sampled the same token (degenerate-output "
                        "storm; 0 = off)")
    # -- observation (telemetry) ----------------------------------------
    p.add_argument("--no-memory-ledger", action="store_true",
                   help="disable the device-memory ledger: no per-owner attribution, "
                        "/debug/memory or hbm_* gauges")
    p.add_argument("--hbm-budget-bytes", type=int, default=0,
                   help="device capacity for headroom accounting where the device "
                        "reports none (the CPU); a card's own total wins (0 = none)")
    p.add_argument("--admit-min-headroom-frac", type=float, default=0.0,
                   help="defer admitting new requests while ledger headroom is below "
                        "this fraction of capacity (0 = off; deferred requests stay "
                        "queued: latency, never a client error)")
    p.add_argument("--trace-dir", default="",
                   help="enable the host-side span tracer (request lifecycle, engine "
                        "step phases, gateway) and write its Chrome-trace JSON here at "
                        "exit (trace_serve_<pid>.json); GET /debug/trace serves it live "
                        "and POST /debug/profile captures into <dir>/serve_profile")
    p.add_argument("--trace-capacity", type=int, default=65536,
                   help="span ring capacity (the most recent events are kept)")
    p.add_argument("--slow-log-k", type=int, default=32,
                   help="worst-latency requests retained with their critical-path "
                        "timelines for GET /debug/slow")
    # -- admission gateway (serving.gateway) ----------------------------
    p.add_argument("--gateway", action="store_true",
                   help="enable the admission gateway: bounded queue with 429 overflow, "
                        "per-tenant rate limits, interactive>batch priority, deadline "
                        "shed, graceful SIGTERM drain")
    p.add_argument("--max-queued-requests", type=int, default=256,
                   help="gateway queue bound (requests); overflow -> 429 + Retry-After")
    p.add_argument("--max-queued-tokens", type=int, default=0,
                   help="gateway queue bound (total queued prompt tokens); 0 = request "
                        "bound only")
    p.add_argument("--rate-limit-rps", type=float, default=0.0,
                   help="per-tenant sustained admission rate (req/s); 0 = off")
    p.add_argument("--rate-limit-burst", type=float, default=0.0,
                   help="per-tenant token-bucket burst capacity; 0 derives max(1, 2*rps)")
    p.add_argument("--tenant-weights", default="",
                   help="weighted fair dequeue, e.g. 'teamA:4,teamB:1' (unlisted "
                        "tenants weigh 1)")
    p.add_argument("--drain-grace", type=float, default=30.0,
                   help="seconds SIGTERM waits for in-flight requests before exiting "
                        "anyway")
    p.add_argument("--max-retries", type=int, default=2,
                   help="failover resubmissions per request after a replica step fault")
    p.add_argument("--fault-inject-step", default="",
                   help="chaos hook 'REPLICA:STEP[:MODE]': fail that replica on its "
                        "STEP-th step; MODE 'raise' (default), 'nan-logits' (poisons its "
                        "weights so the numeric guard trips) or 'preempt' (drain by live "
                        "KV migration, then quarantine) (also env "
                        "DLTI_GATEWAY_FAULT_INJECT)")
    p.add_argument("--self-heal", action="store_true",
                   help="replica lifecycle healing: a faulted replica is quarantined, "
                        "rebuilt from known-good weights, and reinstated after a "
                        "passing canary probe (default: a faulted replica stays dead)")
    p.add_argument("--probation", type=float, default=2.0,
                   help="seconds before a quarantined replica's first reinstate probe "
                        "(doubles per failed probe, capped at 60s)")
    p.add_argument("--flap-window", type=float, default=300.0,
                   help="flap-breaker window: more than --flap-max-cycles quarantines "
                        "inside this many seconds evict the replica permanently")
    p.add_argument("--flap-max-cycles", type=int, default=3,
                   help="quarantine/reinstate cycles tolerated inside --flap-window "
                        "before permanent eviction")
    p.add_argument("--reload-checkpoint", default="",
                   help="start a rolling weight reload at startup from this "
                        "checkpoint-store params export (the artifact POST /v1/reload "
                        "takes), loaded digest-verified")
    p.add_argument("--affinity", action="store_true",
                   help="cache-affinity routing: sticky rendezvous-hash a session key "
                        "(X-Session header, else the hashed prompt prefix) to a replica; "
                        "spills least-loaded past the backlog threshold (needs --gateway)")
    p.add_argument("--affinity-spill-threshold", type=int, default=4,
                   help="spill to least-loaded when the sticky replica's backlog exceeds "
                        "its decode slots by more than this many requests")
    p.add_argument("--affinity-prefix-tokens", type=int, default=32,
                   help="prompt tokens hashed into the affinity key when no X-Session "
                        "header is present")
    # The reference's flags of subsystems the port has not reached: each is
    # accepted by name and refused in build().
    for flag in REFUSED_FLAGS:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help="not ported yet (see ROADMAP.md)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


# scripts/serve.py's flags whose subsystems the port has not reached, by
# subsystem (ROADMAP.md, queue 1).
REFUSED_FLAGS = {
    "--fleet-workers": "the multi-process fleet",
    "--fleet-runtime-dir": "the multi-process fleet",
    "--fleet-respawn-backoff": "the multi-process fleet",
    "--fleet-restart-budget": "the multi-process fleet",
    "--disagg": "prefill/decode disaggregation",
    "--prefill-replicas": "prefill/decode disaggregation",
    "--decode-replicas": "prefill/decode disaggregation",
    "--handoff-queue-depth": "prefill/decode disaggregation",
    "--handoff-deadline-s": "prefill/decode disaggregation",
    "--deploy-watch": "the deploy controller",
    "--watchdog": "the anomaly watchdog",
    "--watchdog-action": "the anomaly watchdog",
    "--watchdog-queue-depth": "the anomaly watchdog",
    "--watchdog-shed-rate": "the anomaly watchdog",
    "--slo": "the SLO engine",
    "--slo-window": "the SLO engine",
    "--slo-burn-tiers": "the SLO engine",
    "--slo-ttft-s": "the SLO engine",
    "--slo-ttft-target": "the SLO engine",
    "--slo-tpot-s": "the SLO engine",
    "--slo-tpot-target": "the SLO engine",
    "--slo-queue-s": "the SLO engine",
    "--slo-queue-target": "the SLO engine",
    "--slo-availability-target": "the SLO engine",
    "--flight-dir": "the flight recorder",
}


def build(args):
    """(engine, tokenizer, ServerConfig) from parsed arguments: what
    :func:`main` serves, and what an in-process caller can drive."""
    if not args.model_dir and not args.random_init:
        raise SystemExit("need --model-dir DIR or --random-init PRESET")
    for flag, what in REFUSED_FLAGS.items():
        if getattr(args, flag.lstrip("-").replace("-", "_")) is not None:
            raise SystemExit(f"{flag}: {what} is not ported yet (see ROADMAP.md)")
    fleet = args.replicas > 1 or args.self_heal or bool(args.reload_checkpoint)
    if args.replicas < 1:
        raise SystemExit(f"--replicas {args.replicas}: need at least 1")
    if fleet and args.tensor > 1:
        raise SystemExit(f"--replicas/--self-heal/--reload-checkpoint with --tensor "
                         f"{args.tensor}: a fleet of tensor-parallel replicas is not ported "
                         "yet (see ROADMAP.md)")
    if args.adapter_map and not args.gateway:
        raise SystemExit("--adapter-map routes tenants through the admission gateway: "
                         "add --gateway")
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

    if args.trace_dir:
        from dlti_tpu_torch.telemetry import configure_tracer

        # On before the engine is built: its spans see it from the start.
        configure_tracer(enabled=True, capacity=args.trace_capacity)
    mesh = tensor_mesh(args)
    tok = get_tokenizer(args.tokenizer)
    device = resolve_device(args.device)
    # A fleet's replicas: one a visible card, or all on the device --device
    # names (cpu, or an indexed card: two replicas on one card is how one
    # card checks a fleet). The weights are made on the first replica's.
    devices = None
    if fleet:
        from dlti_tpu_torch.serving.replicas import fleet_devices

        named = args.device is not None and (device.type == "cpu" or ":" in args.device)
        devices = fleet_devices(args.replicas, device=device if named else None)
        device = devices[0]
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
        guard_nonfinite=not args.no_numeric_guard,
        guard_token_storm=args.guard_token_storm,
        memory_ledger=not args.no_memory_ledger,
        hbm_budget_bytes=args.hbm_budget_bytes,
        admit_min_headroom_frac=args.admit_min_headroom_frac,
        adapter_slots=args.adapter_slots,
        adapter_rank=args.adapter_rank)
    if fleet:
        from dlti_tpu_torch.config import ReplicaLifecycleConfig
        from dlti_tpu_torch.serving import ReplicatedEngine

        # A sole replica gets the lifecycle too under --self-heal or
        # --reload-checkpoint (drains then wait for its work: no survivor).
        engine = ReplicatedEngine(
            model_cfg, params, ec, lora_cfg, replicas=args.replicas, devices=devices,
            max_retries=args.max_retries, fault_inject_step=args.fault_inject_step,
            affinity_spill_threshold=args.affinity_spill_threshold,
            lifecycle_cfg=ReplicaLifecycleConfig(
                enabled=args.self_heal, probation_initial_s=args.probation,
                flap_window_s=args.flap_window, flap_max_cycles=args.flap_max_cycles),
            donate_params=True)
        del params
        print(f"replica fleet: {args.replicas} replica(s) on "
              f"{', '.join(str(d) for d in devices)}"
              + (" (self-healing)" if args.self_heal else ""), flush=True)
        return _finish_build(args, engine, tok, specs)
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
    return _finish_build(args, engine, tok, specs)


def _finish_build(args, engine, tok, specs):
    """Register the startup adapters, size the slow log and make the
    server's configuration (with the gateway's, under ``--gateway``)."""
    from dlti_tpu_torch.config import GatewayConfig, TelemetryConfig
    from dlti_tpu_torch.serving import SamplingParams, ServerConfig

    # One slow log for the engine, or the whole fleet (one telemetry).
    engine.telemetry.critical_path.slow.k = max(1, args.slow_log_k)

    if engine.adapter_pool is not None:
        from dlti_tpu_torch.serving.adapters import register_adapter

        for name, adir in specs:
            register_adapter(name, adir)
            print(f"registered adapter {name!r} from {adir}", flush=True)
        print(f"adapter pool: {args.adapter_slots} slots at rank {args.adapter_rank}, "
              f"{engine.adapter_pool.nbytes / 1e9:.3f} GB", flush=True)
    gw_cfg = None
    if args.gateway:
        gw_cfg = GatewayConfig(
            enabled=True, max_queued_requests=args.max_queued_requests,
            max_queued_tokens=args.max_queued_tokens, rate_limit_rps=args.rate_limit_rps,
            rate_limit_burst=args.rate_limit_burst, tenant_weights=args.tenant_weights,
            drain_grace_s=args.drain_grace, max_retries=args.max_retries,
            fault_inject_step=args.fault_inject_step, affinity=args.affinity,
            affinity_spill_threshold=args.affinity_spill_threshold,
            affinity_prefix_tokens=args.affinity_prefix_tokens,
            adapter_map=args.adapter_map)
    sc = ServerConfig(host=args.host, port=args.port,
                      default_params=SamplingParams(max_tokens=args.max_tokens_default),
                      gateway=gw_cfg,
                      telemetry=TelemetryConfig(trace_dir=args.trace_dir,
                                                trace_capacity=args.trace_capacity))
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
    if getattr(engine, "follower", False):
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
    pool = sum(e.executor.graph_pool_bytes for e in getattr(engine, "engines", [engine]))
    print(f"decode programs ready in {time.time() - t0:.0f}s"
          + (f" (graph pool {pool / 1e9:.2f} GB)" if pool else ""), flush=True)
    if args.reload_checkpoint:
        # The same verified load POST /v1/reload runs.
        from dlti_tpu_torch.checkpoint.store import load_pytree
        from dlti_tpu_torch.models.interop import params_from_jax

        rdir = args.reload_checkpoint
        engine.request_reload(lambda: params_from_jax(load_pytree(rdir, verify=True)))
        print(f"rolling weight reload from {rdir}: "
              + ("failed to load" if engine.last_reload_ok is False else "loaded, queued"),
              flush=True)
    print("live dashboard: /dashboard (JSON: /debug/vars; profiler: POST "
          "/debug/profile)", flush=True)
    try:
        serve(engine, tok, sc)
    finally:
        if args.trace_dir:
            from dlti_tpu_torch.telemetry import get_tracer

            path = get_tracer().export(os.path.join(
                args.trace_dir, f"trace_serve_{os.getpid()}.json"))
            print(f"telemetry trace -> {path} (open in ui.perfetto.dev)", flush=True)


if __name__ == "__main__":
    main()
