"""Replayable JSONL traffic traces: capture, synthesis, and the schema.

The port's copy of ``dlti_tpu/benchmarks/traces.py`` (the same format,
generators and bytes; the port imports nothing of the JAX package).

SLO drills are only regression tests if the traffic is reproducible.
This module defines the trace format loadgen replays (``--trace FILE``)
and records (``--record-trace FILE``), plus seeded synthetic generators
for the shapes production traffic actually takes — diurnal load curves,
flash crowds, heavy-tailed prompt/output mixtures, zipf-skewed tenants.

**Trace JSONL schema** (``dlti-trace/1``): line 1 is a header object,
every following line one arrival event; all objects are sorted-key
compact JSON, offsets rounded to microseconds, so a fixed seed yields a
byte-identical file (pinned in tests/test_traces.py and, across the two packages, in
tests/test_torch_loadgen.py).

Header::

    {"duration_s": 60.0, "format": "dlti-trace/1", "generator":
     "flash_crowd", "num_events": 240, "seed": 7}

Event (offsets ascending; ``offset_s`` is seconds since replay start)::

    {"adapter": "", "deadline_s": 0.0, "max_tokens": 48, "offset_s":
     1.25, "priority": "interactive", "prompt_tokens": 96,
     "session": "t0/s3", "tenant": "t0"}

``deadline_s`` (0 = none) is carried for deadline-aware schedulers;
``session`` keys co-route multi-turn traffic; ``adapter`` names a LoRA
slot. Unknown keys are ignored on read, so the format can grow.

Generators thin a homogeneous Poisson process at the ceiling rate
against the instantaneous rate curve — the standard exact sampler for
inhomogeneous arrivals — and draw lengths from clamped lognormals
(heavy-tailed: a p99 prompt is many times the median, as in real
mixtures).
"""

from __future__ import annotations

import argparse
import json
import math
import random
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

TRACE_FORMAT = "dlti-trace/1"

GENERATORS = ("poisson", "diurnal", "flash_crowd")


@dataclass
class TraceEvent:
    """One arrival in a traffic trace."""

    offset_s: float
    prompt_tokens: int
    max_tokens: int
    tenant: str = "t0"
    priority: str = "interactive"
    session: str = ""
    adapter: str = ""
    deadline_s: float = 0.0

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEvent":
        known = {f: d[f] for f in cls.__dataclass_fields__ if f in d}
        return cls(**known)


def _dumps(obj: dict) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def write_trace(path: str, events: Sequence[TraceEvent],
                meta: Optional[dict] = None) -> None:
    """Write header + events as deterministic JSONL (events re-sorted by
    offset; offsets rounded to 1 µs so replays and diffs are stable)."""
    events = sorted(events, key=lambda e: e.offset_s)
    header = {"format": TRACE_FORMAT, "num_events": len(events)}
    header.update(meta or {})
    with open(path, "w") as f:
        f.write(_dumps(header) + "\n")
        for e in events:
            d = asdict(e)
            d["offset_s"] = round(d["offset_s"], 6)
            d["deadline_s"] = round(d["deadline_s"], 6)
            f.write(_dumps(d) + "\n")


def read_trace(path: str) -> Tuple[dict, List[TraceEvent]]:
    """(header, events). A headerless file (first line is an event) gets
    a synthesized header; events come back offset-sorted."""
    header: dict = {"format": TRACE_FORMAT}
    events: List[TraceEvent] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if i == 0 and "format" in d:
                header = d
                continue
            events.append(TraceEvent.from_dict(d))
    events.sort(key=lambda e: e.offset_s)
    header.setdefault("num_events", len(events))
    return header, events


# ----------------------------------------------------------------------
# Synthesis
# ----------------------------------------------------------------------

def _zipf_weights(n: int, alpha: float) -> List[float]:
    w = [1.0 / (i + 1) ** alpha for i in range(n)]
    s = sum(w)
    return [x / s for x in w]


def _lognormal_tokens(rng: random.Random, mean: int, sigma: float,
                      cap: int) -> int:
    v = int(round(rng.lognormvariate(math.log(max(1, mean)), sigma)))
    return max(1, min(cap, v))


def synthesize(generator: str = "poisson", *,
               duration_s: float = 60.0, rate: float = 4.0, seed: int = 0,
               tenants: int = 4, zipf_alpha: float = 1.1,
               interactive_frac: float = 0.8, session_frac: float = 0.0,
               sessions_per_tenant: int = 4,
               adapters: Sequence[str] = (), adapter_frac: float = 0.0,
               prompt_mean_tokens: int = 96, prompt_sigma: float = 0.6,
               prompt_max_tokens: int = 2048,
               output_mean_tokens: int = 48, output_sigma: float = 0.6,
               output_max_tokens: int = 512,
               deadline_s: float = 0.0,
               diurnal_period_s: float = 60.0,
               diurnal_amplitude: float = 0.8,
               flash_at_s: Optional[float] = None,
               flash_duration_s: Optional[float] = None,
               flash_factor: float = 8.0,
               ) -> Tuple[dict, List[TraceEvent]]:
    """Seeded synthetic trace → (header-meta, events).

    ``rate`` is the *baseline* arrivals/s; the generator shapes it:
    ``poisson`` holds it constant, ``diurnal`` modulates it by
    ``1 + amplitude·sin(2πt/period)``, ``flash_crowd`` multiplies it by
    ``flash_factor`` inside the burst window (default: the middle sixth
    of the trace). Same seed → identical events."""
    if generator not in GENERATORS:
        raise ValueError(f"unknown generator {generator!r} "
                         f"(want one of {GENERATORS})")
    rng = random.Random(seed)
    if flash_at_s is None:
        flash_at_s = duration_s / 3.0
    if flash_duration_s is None:
        flash_duration_s = duration_s / 6.0

    def rate_at(t: float) -> float:
        if generator == "diurnal":
            return rate * max(
                0.0, 1.0 + diurnal_amplitude *
                math.sin(2.0 * math.pi * t / diurnal_period_s))
        if generator == "flash_crowd":
            in_burst = flash_at_s <= t < flash_at_s + flash_duration_s
            return rate * (flash_factor if in_burst else 1.0)
        return rate

    ceiling = rate * max(
        1.0,
        (1.0 + abs(diurnal_amplitude)) if generator == "diurnal"
        else (flash_factor if generator == "flash_crowd" else 1.0))
    weights = _zipf_weights(max(1, tenants), zipf_alpha)
    tenant_names = [f"t{i}" for i in range(max(1, tenants))]
    events: List[TraceEvent] = []
    t = 0.0
    while True:
        t += rng.expovariate(ceiling)
        if t >= duration_s:
            break
        if rng.random() * ceiling > rate_at(t):
            continue                      # thinned out of the curve
        tenant = rng.choices(tenant_names, weights=weights)[0]
        session = ""
        if session_frac > 0 and rng.random() < session_frac:
            session = f"{tenant}/s{rng.randrange(max(1, sessions_per_tenant))}"
        adapter = ""
        if adapters and adapter_frac > 0 and rng.random() < adapter_frac:
            adapter = adapters[rng.randrange(len(adapters))]
        events.append(TraceEvent(
            offset_s=round(t, 6),
            prompt_tokens=_lognormal_tokens(
                rng, prompt_mean_tokens, prompt_sigma, prompt_max_tokens),
            max_tokens=_lognormal_tokens(
                rng, output_mean_tokens, output_sigma, output_max_tokens),
            tenant=tenant,
            priority=("interactive" if rng.random() < interactive_frac
                      else "batch"),
            session=session,
            adapter=adapter,
            deadline_s=round(deadline_s, 6),
        ))
    meta = {
        "generator": generator, "seed": int(seed),
        "duration_s": round(float(duration_s), 6),
        "rate": round(float(rate), 6),
        "tenants": int(tenants), "zipf_alpha": round(float(zipf_alpha), 6),
    }
    if generator == "flash_crowd":
        meta.update(flash_at_s=round(float(flash_at_s), 6),
                    flash_duration_s=round(float(flash_duration_s), 6),
                    flash_factor=round(float(flash_factor), 6))
    if generator == "diurnal":
        meta.update(diurnal_period_s=round(float(diurnal_period_s), 6),
                    diurnal_amplitude=round(float(diurnal_amplitude), 6))
    return meta, events


def trace_summary(events: Sequence[TraceEvent]) -> Dict[str, float]:
    """Cheap shape check for a trace (tests + CLI)."""
    if not events:
        return {"num_events": 0}
    by_tenant: Dict[str, int] = {}
    for e in events:
        by_tenant[e.tenant] = by_tenant.get(e.tenant, 0) + 1
    dur = events[-1].offset_s or 1.0
    return {
        "num_events": len(events),
        "duration_s": round(events[-1].offset_s, 3),
        "mean_rate": round(len(events) / dur, 3),
        "interactive_frac": round(
            sum(1 for e in events if e.priority == "interactive")
            / len(events), 3),
        "mean_prompt_tokens": round(
            sum(e.prompt_tokens for e in events) / len(events), 1),
        "mean_max_tokens": round(
            sum(e.max_tokens for e in events) / len(events), 1),
        "tenants": len(by_tenant),
        "top_tenant_frac": round(max(by_tenant.values()) / len(events), 3),
    }


def main() -> None:
    p = argparse.ArgumentParser(
        description="synthesize a replayable JSONL traffic trace")
    p.add_argument("--out", required=True)
    p.add_argument("--generator", default="poisson", choices=GENERATORS)
    p.add_argument("--duration-s", type=float, default=60.0)
    p.add_argument("--rate", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tenants", type=int, default=4)
    p.add_argument("--zipf-alpha", type=float, default=1.1)
    p.add_argument("--interactive-frac", type=float, default=0.8)
    p.add_argument("--session-frac", type=float, default=0.0)
    p.add_argument("--prompt-mean-tokens", type=int, default=96)
    p.add_argument("--output-mean-tokens", type=int, default=48)
    p.add_argument("--deadline-s", type=float, default=0.0)
    p.add_argument("--flash-factor", type=float, default=8.0)
    p.add_argument("--flash-at-s", type=float, default=None)
    p.add_argument("--flash-duration-s", type=float, default=None)
    args = p.parse_args()
    meta, events = synthesize(
        args.generator, duration_s=args.duration_s, rate=args.rate,
        seed=args.seed, tenants=args.tenants, zipf_alpha=args.zipf_alpha,
        interactive_frac=args.interactive_frac,
        session_frac=args.session_frac,
        prompt_mean_tokens=args.prompt_mean_tokens,
        output_mean_tokens=args.output_mean_tokens,
        deadline_s=args.deadline_s, flash_factor=args.flash_factor,
        flash_at_s=args.flash_at_s, flash_duration_s=args.flash_duration_s)
    write_trace(args.out, events, meta)
    print(json.dumps({"out": args.out, **trace_summary(events)}, indent=2))


if __name__ == "__main__":
    main()
