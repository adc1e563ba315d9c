"""Request-lifecycle histograms for the serving engine: the port of
``dlti_tpu/telemetry/lifecycle.py``'s ``RequestTelemetry``, its histograms
and the halves of its hooks that observe them.

    submitted -> admitted       queue-time histogram
    arrival   -> first token    TTFT histogram
    first tok -> finished       TPOT histogram (mean per output token)
    per decode dispatch         host-prep histogram

The engine calls the hooks where the reference's engine does; they read
the monotonic timestamps the engine already keeps on each request. The
reference's tracer spans and critical-path attribution (``ledger.py``) are
not ported (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import time

from dlti_tpu_torch.telemetry.registry import (
    HOST_PREP_BUCKETS, LATENCY_BUCKETS, TPOT_BUCKETS, Histogram,
)


class RequestTelemetry:
    """The engine's request-latency histograms."""

    def __init__(self):
        self.ttft = Histogram(
            "dlti_request_ttft_seconds", LATENCY_BUCKETS,
            help="time from request arrival to first generated token",
            stats_key="request_ttft_seconds")
        self.tpot = Histogram(
            "dlti_request_tpot_seconds", TPOT_BUCKETS,
            help="mean per-output-token latency after the first token",
            stats_key="request_tpot_seconds")
        self.queue_time = Histogram(
            "dlti_request_queue_time_seconds", LATENCY_BUCKETS,
            help="time from request arrival to slot admission",
            stats_key="request_queue_time_seconds")
        self.host_prep = Histogram(
            "dlti_decode_host_prep_seconds", HOST_PREP_BUCKETS,
            help="host-side prep time per decode dispatch "
                 "(batch assembly + decode-state sync)",
            stats_key="decode_host_prep_seconds")

    def histograms(self):
        return (self.ttft, self.tpot, self.queue_time, self.host_prep)

    def on_admitted(self, req) -> None:
        """First admission observes queue time; a re-admission after
        preemption keeps the original sample (the request queued once)."""
        if req.admitted_time is None:
            req.admitted_time = time.monotonic()
            self.queue_time.observe(req.admitted_time - req.arrival_time)

    def on_first_token(self, req) -> None:
        self.ttft.observe(req.first_token_time - req.arrival_time)

    def on_finished(self, req) -> None:
        n_out = len(req.output_token_ids)
        first = req.first_token_time
        finish = req.finish_time if req.finish_time is not None \
            else time.monotonic()
        if first is not None and n_out > 1:
            self.tpot.observe((finish - first) / (n_out - 1))
