"""Telemetry: the metrics registry behind ``/stats`` and ``/metrics`` (with
the checkpoint store's counters and gauges), the span tracer and its
distributed-trace helpers, the engine's request-lifecycle histograms and
spans, the critical-path ledger behind ``/debug/slow``, the device-memory
ledger behind ``/debug/memory`` and headroom-aware admission, and the
time-series ring behind ``/debug/vars`` and ``/dashboard``."""

from dlti_tpu_torch.telemetry.lifecycle import RequestTelemetry  # noqa: F401
from dlti_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry,
)
from dlti_tpu_torch.telemetry.tracer import (  # noqa: F401
    SpanTracer, configure_tracer, get_tracer,
)
from dlti_tpu_torch.telemetry.timeseries import (  # noqa: F401
    TimeSeriesSampler, render_dashboard_html,
)
from dlti_tpu_torch.telemetry.ledger import (  # noqa: F401
    CriticalPathTracker, GOODPUT_BUCKETS, GoodputLedger, LEDGER_METRIC_NAMES,
    REQUEST_PHASE_METRIC_NAMES, REQUEST_PHASES, request_breakdown, stitch_ledgers,
)
from dlti_tpu_torch.telemetry.memledger import (  # noqa: F401
    MEMLEDGER_METRIC_NAMES, MEMORY_OWNERS, MemoryBalloon, MemoryLedger,
    is_oom_error, tree_nbytes,
)
