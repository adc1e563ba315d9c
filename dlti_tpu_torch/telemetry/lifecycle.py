"""Request-lifecycle telemetry for the serving engine: the port of
``dlti_tpu/telemetry/lifecycle.py``. One instance per engine (or shared
across a fleet's replicas: the histograms aggregate) holds the latency
histograms and turns the timestamps the engine keeps on each request into
Chrome-trace spans:

    submitted -> admitted       ``request/queued``   (queue-time histogram)
    admitted  -> first token    ``request/prefill``  (TTFT histogram, from
                                                      arrival)
    first tok -> finished       ``request/decode``   (TPOT histogram)
    per decode dispatch         host-prep histogram

With the admission gateway in front, its own phase precedes these on the
same timeline under the ``gateway`` category (``serving.gateway``).

Spans are emitted after the fact from recorded timestamps
(:meth:`SpanTracer.complete`), so the engine's hot path only touches
monotonic-clock floats it already records; each carries the request's id
and ``trace_id``, and a request's spans share a ``tid`` derived from its
id (one Perfetto track a request). Every finished request's phase
breakdown folds into the critical path (``telemetry.ledger``).
"""

from __future__ import annotations

import time
import zlib
from typing import Optional

from dlti_tpu_torch.telemetry.ledger import (
    CriticalPathTracker, note_readmitted, note_requeue,
)
from dlti_tpu_torch.telemetry.registry import (
    HOST_PREP_BUCKETS, LATENCY_BUCKETS, TPOT_BUCKETS, Histogram,
)
from dlti_tpu_torch.telemetry.tracer import SpanTracer, get_tracer


def _req_tid(request_id: str) -> int:
    # A stable Perfetto track a request, in a compact id range.
    return 1_000_000 + (zlib.crc32(request_id.encode()) % 1_000_000)


class RequestTelemetry:
    """The engine's request-latency histograms, lifecycle spans and
    critical-path tracker (``slow_k`` worst requests kept for
    ``GET /debug/slow``)."""

    def __init__(self, tracer: Optional[SpanTracer] = None, slow_k: int = 32):
        self.tracer = tracer if tracer is not None else get_tracer()
        self.critical_path = CriticalPathTracker(slow_k=slow_k)
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

    def on_submitted(self, req) -> None:
        self.tracer.instant("request/submitted", cat="request",
                            tid=_req_tid(req.request_id), id=req.request_id,
                            trace=req.trace_id)

    def on_admitted(self, req) -> None:
        """First admission observes queue time; a re-admission after
        preemption or failover keeps the original sample (the request
        queued once) and only marks the trace. Either closes an open
        requeue mark."""
        now = time.monotonic()
        note_readmitted(req)
        if req.admitted_time is None:
            req.admitted_time = now
            self.queue_time.observe(now - req.arrival_time)
            self.tracer.complete(
                "request/queued", req.arrival_time, now, cat="request",
                tid=_req_tid(req.request_id), id=req.request_id,
                trace=req.trace_id)
        else:
            self.tracer.instant("request/readmitted", cat="request",
                                tid=_req_tid(req.request_id), id=req.request_id,
                                preemptions=req.num_preemptions)

    def on_first_token(self, req) -> None:
        self.ttft.observe(req.first_token_time - req.arrival_time)
        start = (req.admitted_time if req.admitted_time is not None
                 else req.arrival_time)
        self.tracer.complete(
            "request/prefill", start, req.first_token_time, cat="request",
            tid=_req_tid(req.request_id), id=req.request_id, trace=req.trace_id,
            prompt_tokens=len(req.prompt_token_ids))

    def on_finished(self, req) -> None:
        n_out = len(req.output_token_ids)
        first = req.first_token_time
        finish = req.finish_time if req.finish_time is not None \
            else time.monotonic()
        if first is not None and n_out > 1:
            self.tpot.observe((finish - first) / (n_out - 1))
        self.tracer.complete(
            "request/decode", first if first is not None else req.arrival_time,
            finish, cat="request", tid=_req_tid(req.request_id),
            id=req.request_id, trace=req.trace_id, output_tokens=n_out,
            finish_reason=req.finish_reason, preemptions=req.num_preemptions)
        # Last: the breakdown reads the timestamps the spans came from.
        self.critical_path.observe(req)

    def on_preempted(self, req) -> None:
        note_requeue(req, "preempt")
        self.tracer.instant("request/preempted", cat="request",
                            tid=_req_tid(req.request_id), id=req.request_id)
