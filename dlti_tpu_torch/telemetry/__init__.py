"""Serving telemetry: the metrics registry behind ``/stats`` and
``/metrics``, and the engine's request-lifecycle histograms."""

from dlti_tpu_torch.telemetry.lifecycle import RequestTelemetry  # noqa: F401
from dlti_tpu_torch.telemetry.registry import (  # noqa: F401
    Histogram, MetricsRegistry,
)
