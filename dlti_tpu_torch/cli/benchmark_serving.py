"""Serving load-test CLI: the port of ``scripts/benchmark_serving.py``,
with the same flags and the same ``--json-out`` report. It drives
:mod:`dlti_tpu_torch.benchmarks.loadgen` against any OpenAI-compatible
endpoint (the port's ``cli.serve``, or the JAX server) and reports
throughput and latency percentiles (TTFT/TPOT when streaming), the server's
prefix-cache hit rate in ``--sessions`` mode and, with
``--scrape-server-metrics``, the engine's histograms and ``dlti_spec_*``
series.

Usage (the README Quickstart's step 5):
    python -m dlti_tpu_torch.cli.benchmark_serving --port 8000 \
        --num-requests 112 --concurrency 56 --max-tokens 256
    python -m dlti_tpu_torch.cli.benchmark_serving --qps 10 --no-stream \
        --json-out results/serving.json
"""

from __future__ import annotations

import argparse
import json
import os

from dlti_tpu_torch.benchmarks import LoadGenConfig, run_load_test


def main() -> None:
    p = argparse.ArgumentParser(description="async load generator",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--num-requests", type=int, default=64)
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--qps", type=float, default=None,
                   help="open-loop Poisson arrival rate (default: closed loop)")
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--prompt", default="Write a function that reverses a linked list.")
    p.add_argument("--prompt-file", default=None,
                   help="file with one prompt per line: requests draw from "
                        "this pool (seeded), exercising varied prefill "
                        "lengths instead of one fixed prompt")
    p.add_argument("--chat", action="store_true", help="use /v1/chat/completions")
    p.add_argument("--tenants", type=int, default=0,
                   help="spread requests over N synthetic tenants via the "
                        "X-Tenant header (exercises the admission "
                        "gateway's per-tenant limits and fair dequeue)")
    p.add_argument("--priority-mix", default="",
                   help="priority class mix, e.g. 'interactive:0.8,"
                        "batch:0.2'; the report then includes per-class "
                        "TTFT/TPOT percentiles and shed counts")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="per-request queued-deadline seconds (body "
                        "deadline_s; a gateway sheds expired queued "
                        "requests with 503)")
    p.add_argument("--sessions", type=int, default=0,
                   help="recurring-session (chat-shaped) mode: N concurrent "
                        "sessions each replaying a shared system prompt + "
                        "growing history with an X-Session header; the "
                        "report splits cold vs warm TTFT percentiles and "
                        "scrapes the server's prefix-cache hit rate "
                        "(num-requests is ignored: sessions x turns)")
    p.add_argument("--turns", type=int, default=4,
                   help="requests per session in --sessions mode")
    p.add_argument("--reuse-frac", type=float, default=1.0,
                   help="fraction of non-first turns that revisit their "
                        "session; the rest issue unrelated cold one-offs")
    p.add_argument("--long-prompt-frac", type=float, default=0.0,
                   help="mixed-interference mode: this fraction of "
                        "requests carries a synthetic ~long-prompt-tokens "
                        "prompt; the report splits short-request decode "
                        "TPOT p99 by concurrent-long-prefill overlap (the "
                        "disaggregation stressor)")
    p.add_argument("--long-prompt-tokens", type=int, default=512,
                   help="synthetic long-prompt length in tokens (exact "
                        "under the byte tokenizer)")
    p.add_argument("--adapters", type=int, default=0,
                   help="multi-LoRA mode: tag requests with an X-Adapter "
                        "header drawn from N names 'adapter-0'..'adapter-"
                        "N-1' (register them server-side first); the "
                        "report adds per-adapter TTFT/TPOT percentiles "
                        "and the scraped adapter-pool hit rate")
    p.add_argument("--adapter-mix", default="zipf",
                   choices=["zipf", "uniform"],
                   help="adapter draw: zipf (1/(i+1) skew — hot adapters "
                        "stay pool-resident, the tail exercises eviction) "
                        "or uniform")
    p.add_argument("--trace", default="",
                   help="replay a dlti-trace/1 JSONL workload trace "
                        "(benchmarks.traces): each event fires at its "
                        "recorded arrival offset with its own tenant / "
                        "priority / session / adapter / lengths / "
                        "deadline; num-requests, qps, tenants and "
                        "priority-mix are ignored")
    p.add_argument("--record-trace", default="",
                   help="write every request this run submits back out "
                        "as a dlti-trace/1 JSONL file, making the run a "
                        "replayable fixture (works in any drive mode, "
                        "replay included)")
    p.add_argument("--scrape-server-metrics", action="store_true",
                   help="attach the server's on-engine histogram "
                        "summaries (/metrics) to the report")
    p.add_argument("--no-stream", action="store_true",
                   help="non-streaming (usage-accurate token counts, no TTFT)")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json-out", default=None, help="also write the report as JSON")
    args = p.parse_args()

    prompts = ()
    if args.prompt_file:
        with open(args.prompt_file) as f:
            prompts = tuple(line.rstrip("\r\n") for line in f if line.strip())
    cfg = LoadGenConfig(
        host=args.host, port=args.port, num_requests=args.num_requests,
        concurrency=args.concurrency, qps=args.qps, stream=not args.no_stream,
        max_tokens=args.max_tokens, temperature=args.temperature,
        prompt=args.prompt, prompts=prompts, chat=args.chat,
        timeout_s=args.timeout, seed=args.seed,
        tenants=args.tenants, priority_mix=args.priority_mix,
        deadline_s=args.deadline,
        scrape_server_metrics=args.scrape_server_metrics,
        sessions=args.sessions, turns=args.turns,
        reuse_frac=args.reuse_frac,
        long_prompt_frac=args.long_prompt_frac,
        long_prompt_tokens=args.long_prompt_tokens,
        adapters=args.adapters, adapter_mix=args.adapter_mix,
        trace=args.trace, record_trace=args.record_trace,
    )
    report = run_load_test(cfg)
    d = report.to_dict()
    print(json.dumps(d, indent=2))
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(d, f, indent=2)
        print(f"report -> {args.json_out}")


if __name__ == "__main__":
    main()
