"""Telemetry: the metrics registry behind ``/stats`` and ``/metrics`` (with
the checkpoint store's counters and gauges), and the engine's
request-lifecycle histograms."""

from dlti_tpu_torch.telemetry.lifecycle import RequestTelemetry  # noqa: F401
from dlti_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry,
)
