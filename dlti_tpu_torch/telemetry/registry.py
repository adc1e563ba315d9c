"""Metrics registry: counters, gauges, histograms and scalar sources +
Prometheus text exposition. The part of ``dlti_tpu/telemetry/registry.py``
(standard library only) that the port uses: the backing store of the
server's ``/stats`` and ``/metrics``, and the checkpoint store's counters
and gauges.

1. **Name stability.** The ``/metrics`` names (``dlti_requests``,
   ``dlti_free_blocks``, ...) are the reference server's; the scalar
   exposition renders them the same way (``# TYPE`` line + ``name value``
   line, sorted by name). Engine counters stay owned by the engine (its
   ``stats`` dict is the source of truth, registered here as a *scalar
   source* callback) so the decode path never takes a registry lock.
2. **Histograms for request-lifecycle latencies.** TTFT / TPOT /
   queue-time distributions are observed on-engine and exposed in the
   standard Prometheus histogram format (``_bucket{le=...}`` cumulative
   counts + ``_sum`` + ``_count``).
3. **Thread safety.** ``observe`` is called from the engine stepper
   thread while HTTP handler threads render; every mutation and snapshot
   is lock-protected (one lock per metric).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# Latency buckets (seconds) sized for LLM serving: sub-ms host paths up to
# multi-minute stragglers. Used for TTFT and queue time.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
# Per-output-token latency: decode steps are ms-scale on-chip, seconds
# over a relay link.
TPOT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0)
# Host-side prep work per dispatch (batch assembly, decode-state sync):
# tens of microseconds when clean, low milliseconds when rebuilding.
HOST_PREP_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 0.001,
                     0.0025, 0.005, 0.01, 0.025, 0.05, 0.1)


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class _Metric:
    """Shared label-child machinery: ``.labels(k=v)`` returns (creating on
    first use) the child for that label set. A metric declared without
    ``labelnames`` has its unlabelled child from the start, so it renders
    at 0; a labelled one renders only the children it has."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[Tuple[str, str], ...], object] = {}
        if not self.labelnames:
            self._default()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labels: str):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _default(self):
        return self.labels()

    def samples(self) -> List[Tuple[str, str, object]]:
        """[(name, labels_str, child)] under lock, sorted by labels."""
        with self._lock:
            return [(self.name, _fmt_labels(key), child)
                    for key, child in sorted(self._children.items())]


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Counter(_Metric):
    """A monotonic counter, with optional label children (``tier="hbm"``)."""

    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class _GaugeChild(_CounterChild):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().inc(-amount)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram:
    """Fixed-bucket histogram (Prometheus semantics: ``le`` upper bounds,
    cumulative on exposition). Unlabeled — one instance per series is all
    the engine needs, and it keeps ``observe()`` a couple of adds."""

    kind = "histogram"

    def __init__(self, name: str, buckets: Sequence[float] = LATENCY_BUCKETS,
                 help: str = "", stats_key: Optional[str] = None):
        self.name = name
        self.help = help
        # ``/stats`` key for the summary dict (default: the metric name).
        self.stats_key = stats_key or name
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # [+Inf] is last
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = 0
        for b in self.buckets:  # tiny linear scan beats bisect at n<=16
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    def percentile(self, p: float) -> float:
        """Bucket-interpolated percentile estimate (p in [0, 100])."""
        counts, _, total = self.snapshot()
        if total == 0:
            return 0.0
        target = (p / 100.0) * total
        cum = 0
        lo = 0.0
        for i, c in enumerate(counts):
            prev = cum
            cum += c
            if cum >= target:
                hi = self.buckets[i] if i < len(self.buckets) else lo
                if c == 0 or hi <= lo:
                    return hi
                return lo + (hi - lo) * (target - prev) / c
            lo = self.buckets[i] if i < len(self.buckets) else lo
        return self.buckets[-1] if self.buckets else 0.0

    def summary(self) -> dict:
        """Compact ``/stats`` view of the distribution."""
        _, s, n = self.snapshot()
        return {
            "count": n,
            "sum": round(s, 6),
            "mean": round(s / n, 6) if n else 0.0,
            "p50": round(self.percentile(50), 6),
            "p90": round(self.percentile(90), 6),
            "p99": round(self.percentile(99), 6),
        }

    def render(self) -> List[str]:
        counts, s, n = self.snapshot()
        lines = [f"# TYPE {self.name} {self.kind}"]
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            le = format(b, "g")
            lines.append(f'{self.name}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {n}')
        lines.append(f"{self.name}_sum {s}")
        lines.append(f"{self.name}_count {n}")
        return lines


class _ScalarSource:
    """A callback yielding a dict of raw scalars (e.g. the engine's
    ``stats`` dict plus derived gauges), exposed under ``prefix``."""

    def __init__(self, fn: Callable[[], dict], gauge_keys: Sequence[str],
                 prefix: str):
        self.fn = fn
        self.gauge_keys = frozenset(gauge_keys)
        self.prefix = prefix


class MetricsRegistry:
    """Registry of histograms + scalar sources; renders Prometheus text and a
    raw ``/stats`` dict from one shared store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        self._sources: List[_ScalarSource] = []

    # -- registration ---------------------------------------------------
    def register(self, metric) -> None:
        """Attach an externally created metric (e.g. the engine's
        request-lifecycle histograms) for exposition."""
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and existing is not metric:
                raise ValueError(f"metric {metric.name!r} already registered")
            self._metrics[metric.name] = metric

    def add_scalar_source(self, fn: Callable[[], dict],
                          gauge_keys: Sequence[str] = (),
                          prefix: str = "") -> None:
        """Register a callback producing ``{key: number}``; keys in
        ``gauge_keys`` expose as gauges, the rest as counters. Non-numeric
        and bool values are skipped on exposition (kept verbatim in
        :meth:`stats_dict`)."""
        self._sources.append(_ScalarSource(fn, gauge_keys, prefix))

    # -- collection -----------------------------------------------------
    def _scalar_samples(self) -> List[Tuple[str, str, float]]:
        """[(exposition_name, kind, value)] from every scalar source."""
        out = []
        for src in self._sources:
            for k, v in src.fn().items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                kind = "gauge" if k in src.gauge_keys else "counter"
                out.append((f"{src.prefix}{k}", kind, v))
        return out

    def stats_dict(self) -> dict:
        """Raw (unprefixed) scalars + per-histogram summaries — the
        ``/stats`` payload."""
        out: dict = {}
        for src in self._sources:
            for k, v in src.fn().items():
                out[k] = v
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, Histogram):
                if m.stats_key not in out:
                    out[m.stats_key] = m.summary()
            else:
                for name, labels, child in m.samples():
                    out.setdefault(name + labels, child.value)
        return out

    def render_prometheus(self) -> str:
        """Full text exposition (version 0.0.4), sorted by metric name.

        Scalar-source lines reproduce the legacy inline exposition
        byte-for-byte: ``# TYPE <name> <kind>`` then ``<name> <value>``
        with Python's default int/float formatting."""
        blocks: List[Tuple[str, List[str]]] = []
        for name, kind, v in self._scalar_samples():
            blocks.append((name, [f"# TYPE {name} {kind}", f"{name} {v}"]))
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, Histogram):
                blocks.append((m.name, m.render()))
                continue
            lines = [f"# TYPE {m.name} {m.kind}"]
            lines += [f"{name}{labels} {child.value}"
                      for name, labels, child in m.samples()]
            if len(lines) > 1:
                blocks.append((m.name, lines))
        blocks.sort(key=lambda b: b[0])
        lines = [line for _, blk in blocks for line in blk]
        return "\n".join(lines) + "\n"
