"""The port's span tracer, distributed-trace helpers and time-series ring
against the JAX package's (``dlti_tpu.telemetry.{tracer,distributed_trace,
timeseries}``), and the spans the port's engine and gateway emit against
the JAX engine's and gateway's on the same inputs (``llama_tiny``,
float32, CPU).

Host-only pieces are compared for equal outputs on the same calls, with the
clocks injected (each module's ``time`` replaced by one fake clock), so no
tolerance is needed: the outputs are equal dicts. The dashboard page must
be byte-equal. Engine and gateway spans are compared by their ordered
``(name, cat, arg keys)``; times are the run's own.
"""

import ast
import importlib.util
import os
import re
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

import dlti_tpu.config as jc
import dlti_tpu_torch.config as tc
from dlti_tpu.config import MODEL_PRESETS as JAX_PRESETS
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu.serving import adapters as jad
from dlti_tpu.serving import gateway as jgw
from dlti_tpu.serving.engine import Request as JaxRequest
from dlti_tpu.telemetry import distributed_trace as jdt
from dlti_tpu.telemetry import timeseries as jts
from dlti_tpu.telemetry import tracer as jtr
from dlti_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams
from dlti_tpu_torch.serving import adapters as tad
from dlti_tpu_torch.serving import gateway as tgw
from dlti_tpu_torch.serving.engine import Request
from dlti_tpu_torch.telemetry import distributed_trace as tdt
from dlti_tpu_torch.telemetry import timeseries as tts
from dlti_tpu_torch.telemetry import tracer as ttr
from dlti_tpu_torch.telemetry.registry import MetricsRegistry
from torch_adapter_cells import NAMES, R, setup  # noqa: F401 (fixture)
from torch_fleet_cells import seeded_params

ROOT = Path(__file__).resolve().parents[1]


class FakeClock:
    """A module's ``time``: monotonic and wall clocks that advance a fixed
    step a read, so two runs read the same values."""

    def __init__(self, t=100.0, step=0.001):
        self.t, self.step = t, step

    def monotonic(self):
        self.t += self.step
        return self.t

    def time(self):
        return 1.7e9 + self.monotonic()

    def sleep(self, s):
        self.t += s


# ----------------------------------------------------------------------
# SpanTracer
# ----------------------------------------------------------------------

def _drive_tracer(mod, monkeypatch):
    monkeypatch.setattr(mod, "time", FakeClock())
    off = mod.SpanTracer(capacity=4)
    null = off.span("engine/admit") is mod._NULL_SPAN
    off.complete("request/queued", 1.0, 2.0)
    off.instant("request/submitted")
    tr = mod.SpanTracer(capacity=5, enabled=True)
    with tr.span("engine/admit", cat="engine", n=1):
        pass
    tr.complete("request/queued", 1.0, 2.5, cat="request", tid=7, id="r0", trace="t0")
    tr.complete("request/decode", 3.0, 2.0, cat="request", tid=7)  # negative: dur 0
    tr.instant("request/submitted", cat="request", tid=9, id="r1", trace="t1")
    first = tr.events_since(0, limit=2)
    for i in range(4):  # overflows the ring of 5 by 3
        tr.instant("gateway/enqueued", cat="gateway", tid=i, id=f"g{i}")
    tail = tr.events_since(first[2], limit=10)
    tr.process_label = "server"
    out = (null, len(off), off.dropped_events, tr.to_dict(), first, tail, len(tr),
           tr.total_events, tr.dropped_events)
    tr.clear()
    return out + (len(tr), tr.dropped_events, tr.to_dict())


def test_span_tracer_equals_jax_on_the_same_calls(monkeypatch):
    want = _drive_tracer(jtr, monkeypatch)
    got = _drive_tracer(ttr, monkeypatch)
    assert got == want
    assert got[0] and got[8] == 3 and got[3]["traceEvents"][0]["ph"] == "M"


def _drive_configure(mod, monkeypatch):
    monkeypatch.setattr(mod, "_GLOBAL", mod.SpanTracer())
    t = mod.configure_tracer(enabled=True, capacity=6)
    for i in range(5):
        t.complete("request/queued", float(i), float(i) + 0.5, tid=1, id=f"r{i}")
    mod.configure_tracer(capacity=3)
    shrunk = (t.capacity, len(t), t.dropped_events, [e["args"]["id"] for e in t.events()])
    mod.configure_tracer(enabled=False)
    return shrunk, t.enabled, mod.get_tracer() is t, t.span("x/y") is mod._NULL_SPAN


def test_configure_tracer_resizes_and_toggles_as_jax(monkeypatch):
    assert _drive_configure(ttr, monkeypatch) == _drive_configure(jtr, monkeypatch)


def test_tracer_export_writes_the_same_chrome_trace(monkeypatch, tmp_path):
    docs = []
    for mod in (jtr, ttr):
        monkeypatch.setattr(mod, "time", FakeClock())
        tr = mod.SpanTracer(enabled=True)
        with tr.span("engine/decode_sync", cat="engine"):
            tr.instant("request/preempted", cat="request", tid=3, id="r")
        path = tr.export(str(tmp_path / mod.__name__ / "trace.json"))
        docs.append(open(path).read())
    assert docs[0] == docs[1]


# ----------------------------------------------------------------------
# distributed_trace: ids, timelines, clock offsets, federation, dumps
# ----------------------------------------------------------------------

def test_mint_trace_id_is_16_hex_and_unique():
    ids = {tdt.mint_trace_id() for _ in range(1000)}
    assert len(ids) == 1000
    assert all(re.fullmatch(r"[0-9a-f]{16}", i) for i in ids)
    assert len(jdt.mint_trace_id()) == 16


EVENTS = [
    {"ph": "i", "name": "gateway/enqueued", "ts": 0.0, "pid": 1, "tid": 1,
     "args": {"id": "r1", "trace": "tA"}},
    {"ph": "X", "name": "gateway/queued", "ts": 0.0, "dur": 2000.0, "pid": 1, "tid": 1,
     "args": {"id": "r1", "trace": "tA"}},
    {"ph": "X", "name": "request/queued", "ts": 2000.0, "dur": 1000.0, "pid": 1, "tid": 5,
     "args": {"id": "r1", "trace": "tA"}},
    {"ph": "X", "name": "request/queued", "ts": 2100.0, "dur": 900.0, "pid": 2, "tid": 5,
     "args": {"id": "r1", "trace": "tA"}},
    {"ph": "X", "name": "request/prefill", "ts": 3000.0, "dur": 4000.0, "pid": 2, "tid": 5,
     "args": {"trace": "tA"}},
    {"ph": "X", "name": "engine/tier_restore", "ts": 3500.0, "dur": 500.0, "pid": 2,
     "tid": 6, "args": {"id": "r1", "blocks": 2}},
    {"ph": "X", "name": "request/decode", "ts": 7000.0, "dur": 9000.0, "pid": 1, "tid": 5,
     "args": {"id": "r1", "trace": "tA"}},
    {"ph": "X", "name": "request/decode", "ts": 1000.0, "dur": 50.0, "pid": 1, "tid": 8,
     "args": {"id": "r2", "trace": "tB"}},
    {"ph": "M", "name": "process_name", "ts": 0.0, "pid": 1, "tid": 0,
     "args": {"name": "server"}},
    {"ph": "X", "name": "engine/admit", "ts": 10.0, "dur": 5.0, "pid": 1, "tid": 2},
]


@pytest.mark.parametrize("case", [
    dict(request_id="r1"), dict(request_id="r1", client_latency_s=0.02),
    dict(request_id="", trace_id="tA"), dict(request_id="r2", client_latency_s=0.001),
    dict(request_id="nope")])
def test_request_timeline_equals_jax(case):
    rid = case.pop("request_id")
    got = tdt.request_timeline(iter(EVENTS), rid, **case)
    want = jdt.request_timeline(iter(EVENTS), rid, **case)
    assert got == want
    if rid == "r1":
        assert got["trace_id"] == "tA" and got["processes"] == [1, 2]
        assert got["legs"]["request/queued"]["count"] == 2


def test_union_of_intervals_equals_jax():
    cases = [[], [(0.0, 1e6)], [(0.0, 2e6), (1e6, 3e6), (5e6, 6e6)], [(3.0, 4.0), (0.0, 1.0)]]
    for iv in cases:
        assert tdt._union_s(list(iv)) == jdt._union_s(list(iv))


def _drive_federation(mod, tracer_mod, monkeypatch):
    monkeypatch.setattr(tracer_mod, "time", FakeClock())
    est = mod.ClockOffsetEstimator(alpha=0.5)
    est.sample(2.0, 1.0, 5.0)  # backwards: skipped
    for t0, t1, tw in [(10.0, 10.2, 4.9), (11.0, 11.1, 6.0), (12.0, 12.4, 7.3)]:
        est.sample(t0, t1, tw)
    fed = mod.TraceFederator(capacity=4)
    fed.source(0, pid=4242, label="worker0")
    fed.observe_rpc(0, 1.0, 1.2, 0.5)
    fed.observe_rpc(0, 2.0, 2.1, "bad")
    fed.observe_rpc(1, 1.0, 1.4, 0.2)
    n0 = fed.ingest(0, EVENTS[:3] + ["junk"], remote_dropped=2)
    n1 = fed.ingest(1, EVENTS[4:7])
    n2 = fed.ingest(1, [])
    local = tracer_mod.SpanTracer(enabled=True)
    local.complete("request/decode", 1.0, 2.0, tid=3, id="r9", trace="t9")
    merged = fed.merged_dict(local, local_label="server")
    for ev in merged["traceEvents"]:  # the local process's own pid
        if ev["pid"] == os.getpid():
            ev["pid"] = "local"
    return (est.to_dict(), est.rebase(1.0), n0, n1, n2, len(fed), fed.dropped_events,
            fed.offsets(), fed.metadata_events(), merged, fed.events())


def test_clock_offsets_and_federation_equal_jax(monkeypatch):
    want = _drive_federation(jdt, jtr, monkeypatch)
    got = _drive_federation(tdt, ttr, monkeypatch)
    assert got == want
    assert got[6] == 2 + 2  # the ring of 4 evicted 2, the worker dropped 2


def test_merge_dump_tails_equals_jax():
    dumps = [{"label": "worker1", "pid": 0, "offset_s": 0.5, "uncertainty_s": 0.002,
              "events": EVENTS[:4] + [None], "dropped": 3},
             {"label": "supervisor", "pid": 77, "offset_s": None, "events": EVENTS[4:]},
             {"events": EVENTS[2:5]}]
    assert tdt.merge_dump_tails(dumps) == jdt.merge_dump_tails(dumps)


# ----------------------------------------------------------------------
# TimeSeriesSampler and the dashboard
# ----------------------------------------------------------------------

def _drive_sampler(mod, monkeypatch):
    monkeypatch.setattr(mod, "time", FakeClock(step=0.25))
    state = {"n": 0}

    def source():
        state["n"] += 3
        return {"requests": state["n"], "ok": True, "name": "x",
                "hist": {"p50": 0.5 * state["n"], "count": state["n"]}, "lst": [1, 2]}

    def broken():
        raise RuntimeError("boom")

    reg = types.SimpleNamespace(stats_dict=lambda: {"free_blocks": 7, "nested": {"a": 1}})
    s = mod.TimeSeriesSampler(interval_s=0.01, capacity=4, registry=reg)
    s.add_source(source)
    s.add_source(broken)
    for _ in range(6):
        s.sample_now()
    return (s.interval_s, s.capacity, len(s), s.source_errors, s.tail(2), s.latest(),
            s.series("requests"), s.rate("requests"), s.rate("requests", window_s=0.6),
            s.rate("missing"), s.peak("hist.p50"), s.peak("missing"), s.snapshot(),
            s.snapshot(tail=2), mod.flatten_numeric({"a": 1, "b": {"c": 2.5, "d": False}}))


def test_time_series_sampler_equals_jax(monkeypatch):
    want = _drive_sampler(jts, monkeypatch)
    got = _drive_sampler(tts, monkeypatch)
    assert got == want
    assert got[2] == 4 and got[3] == 6


def test_sampler_thread_starts_and_stops():
    s = tts.TimeSeriesSampler(interval_s=0.05, registry=None)
    s.add_source(lambda: {"x": 1})
    s.start()
    s.start()  # idempotent
    try:
        deadline = time.monotonic() + 5
        while len(s) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(s) >= 2
    finally:
        s.stop()
    assert s._thread is None


def test_dashboard_html_is_byte_equal():
    assert tts.render_dashboard_html() == jts.render_dashboard_html()
    assert tts.render_dashboard_html().startswith("<!")


# ----------------------------------------------------------------------
# Engine spans against the JAX engine's
# ----------------------------------------------------------------------

JCFG = JAX_PRESETS["llama_tiny"]
CFG = MODEL_PRESETS["llama_tiny"]
PROMPT_A = list(range(1, 25))


@pytest.fixture(scope="module")
def params():
    return seeded_params()


@pytest.fixture()
def tracers():
    """Both packages' process-global tracers on, empty and wide for one
    test, then as they were (xdist runs many files in one process)."""
    saved = [(t.enabled, t.capacity) for t in (jtr.get_tracer(), ttr.get_tracer())]
    pair = (jtr.configure_tracer(enabled=True, capacity=65536),
            ttr.configure_tracer(enabled=True, capacity=65536))
    for t in pair:
        t.clear()
    yield pair
    for mod, t, (enabled, capacity) in zip((jtr, ttr), pair, saved):
        mod.configure_tracer(enabled=enabled, capacity=capacity)
        t.clear()


def _tier_run(engine, sp):
    """A tier restore (A's blocks demoted to the host tier, then A again)
    and a preemption (the pool of 11 usable blocks runs out)."""
    engine.generate([PROMPT_A], sp)
    engine.generate([list(range(100, 124)), list(range(200, 216)), list(range(300, 316))], sp)
    engine.generate([PROMPT_A, list(range(400, 410))], sp)
    return engine.stats


def _adapter_run(engine, sp):
    """Four requests over two adapters and the base through a pool of one
    row: each adapter change is a load on the admitting request's path."""
    reqs = [engine.submit([3, 1, 4, 1, 5], sp, adapter="ad-a"),
            engine.submit([2, 7, 1, 8], sp, adapter="ad-b"),
            engine.submit([5, 5, 5], sp),
            engine.submit([9, 8, 7, 6], sp, adapter="ad-a")]
    while engine.has_work:
        engine.step()
    return reqs


def _by_request(events):
    """request id -> ordered (name, cat, sorted arg keys); and the ordered
    engine/* names of the steps (spans without a request id)."""
    out, steps = {}, []
    for ev in events:
        args = ev.get("args", {})
        key = (ev["name"], ev.get("cat"), tuple(sorted(args)))
        if "id" in args:
            out.setdefault(args["id"], []).append(key)
        elif ev["name"].startswith("engine/"):
            steps.append(ev["name"])
    return out, steps


def _check_trace_ids(events):
    ids = {}
    for ev in events:
        args = ev.get("args", {})
        if ev["name"] == "request/submitted" or (ev["name"].startswith("request/")
                                                 and ev["ph"] == "X"):
            assert re.fullmatch(r"[0-9a-f]{16}", args["trace"]), ev
            assert ids.setdefault(args["id"], args["trace"]) == args["trace"], ev
    return ids


@pytest.mark.parametrize("k", [1, 4])
def test_engine_spans_with_preemption_and_a_tier_restore_equal_jax(params, tracers, k):
    jtracer, ttracer = tracers
    ec = dict(max_seqs=3, block_size=8, num_blocks=12, max_model_len=64,
              cache_dtype="float32", eos_token_id=-1, steps_per_sync=k,
              enable_prefix_caching=True, prefix_host_blocks=16)
    jeng = JaxEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, params), JaxEngineConfig(**ec))
    teng = InferenceEngine(CFG, params_from_jax(params), EngineConfig(**ec), device="cpu")
    jstats = _tier_run(jeng, JaxSamplingParams(temperature=0.0, max_tokens=20))
    tstats = _tier_run(teng, SamplingParams(temperature=0.0, max_tokens=20))
    assert tstats["preemptions"] == jstats["preemptions"] >= 1
    assert tstats["prefix_restored_tokens"] == jstats["prefix_restored_tokens"] > 0
    want, want_steps = _by_request(jtracer.events())
    got, got_steps = _by_request(ttracer.events())
    assert got == want
    assert got_steps == want_steps
    names = {n for spans in got.values() for n, *_ in spans}
    assert {"request/preempted", "request/readmitted", "engine/tier_restore"} <= names
    assert {"engine/decode_dispatch", "engine/admit", "engine/decode_sync"} <= set(got_steps)
    assert len(_check_trace_ids(ttracer.events())) == 6


@pytest.mark.parametrize("k", [1, 4])
def test_engine_spans_with_adapter_loads_equal_jax(setup, tracers, k):  # noqa: F811
    jtracer, ttracer = tracers
    for cat in (tad.get_catalog(), jad.get_catalog()):
        cat.clear()
    try:
        for name in NAMES[:2]:
            tad.register_adapter(name, setup.dirs[name])
            jad.register_adapter(name, setup.dirs[name])
        ec = dict(max_seqs=2, block_size=8, num_blocks=32, max_model_len=64,
                  cache_dtype="float32", eos_token_id=-1, steps_per_sync=k,
                  adapter_slots=1, adapter_rank=R)
        jeng = JaxEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, setup.jbase),
                         JaxEngineConfig(**ec))
        teng = InferenceEngine(CFG, setup.base, EngineConfig(**ec), device="cpu")
        jreqs = _adapter_run(jeng, JaxSamplingParams(temperature=0.0, max_tokens=6))
        treqs = _adapter_run(teng, SamplingParams(temperature=0.0, max_tokens=6))
    finally:
        for cat in (tad.get_catalog(), jad.get_catalog()):
            cat.clear()
    assert [r.output_token_ids for r in treqs] == [r.output_token_ids for r in jreqs]
    want, want_steps = _by_request(jtracer.events())
    got, got_steps = _by_request(ttracer.events())
    assert got == want and got_steps == want_steps
    loads = [n for spans in got.values() for n, *_ in spans if n == "engine/adapter_load"]
    assert len(loads) >= 2
    assert all(r.restore_s > 0 for r in treqs[:2])
    _check_trace_ids(ttracer.events())


# ----------------------------------------------------------------------
# Gateway spans on a burst, against the JAX gateway's
# ----------------------------------------------------------------------

class _GwClock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += s


class _FakeAsyncEngine:
    """Records dispatches; its room gates the dispatcher; its telemetry
    holds one package's tracer."""

    def __init__(self, jax_side, tracer):
        self.engine = types.SimpleNamespace(
            cfg=types.SimpleNamespace(max_seqs=0), num_active=0, waiting=[],
            has_work=False, telemetry=types.SimpleNamespace(tracer=tracer), stats={},
            num_free_blocks=0)
        self.jax_side = jax_side
        self.submitted = []

    def submit(self, prompt_ids, params, request_id=None, q=None, trace_id="", **kw):
        cls = JaxRequest if self.jax_side else Request
        req = cls(request_id=request_id, prompt_token_ids=list(prompt_ids), trace_id=trace_id)
        self.submitted.append(req)
        return req, q


def _burst(mod, cfg_mod, tracer_mod, sp, registry, jax_side, monkeypatch):
    """A burst past the queue bound (429s), a bad adapter, a shed deadline,
    then room for the rest: every gateway span kind."""
    clock = _GwClock()
    monkeypatch.setattr(mod, "time", clock)
    tracer = tracer_mod.SpanTracer(enabled=True)
    fake = _FakeAsyncEngine(jax_side, tracer)
    gw = mod.AdmissionGateway(fake, cfg_mod.GatewayConfig(
        enabled=True, max_queued_requests=4, rate_limit_rps=0.0), registry)
    refused = []
    try:
        gw.submit([1, 2], sp, "shed", deadline_s=1.0)
        for i in range(5):
            try:
                gw.submit([1] * (i + 1), sp, f"r{i}", tenant=f"t{i % 2}",
                          priority="batch" if i == 2 else "interactive")
            except Exception as e:  # noqa: BLE001 - the refusals under test
                refused.append((f"r{i}", e.status))
        try:
            gw.submit([1], sp, "ad", adapter="ghost")
        except Exception as e:  # noqa: BLE001
            refused.append(("ad", e.status))
        clock.t += 2.0
        deadline = time.monotonic() + 10
        while not any(ev["name"] == "gateway/shed" for ev in tracer.events()):
            assert time.monotonic() < deadline, "no shed"
            time.sleep(0.002)
        fake.engine.cfg.max_seqs = 10
        while len(fake.submitted) < 3:
            assert time.monotonic() < deadline, "no dispatch"
            time.sleep(0.002)
    finally:
        gw.shutdown()
    # Arg values but the minted trace ids and the shed's queued seconds (an
    # entry's enqueue time reads the real clock in both packages).
    spans = [(ev["name"], ev["cat"], ev["ph"],
              {k: (v if k != "queued_s" else None) for k, v in ev.get("args", {}).items()
               if k != "trace"})
             for ev in tracer.events()]
    traces = {}
    for ev in tracer.events():
        args = ev.get("args", {})
        if "trace" in args:
            traces.setdefault(args["id"], set()).add(args["trace"])
    reqs = {r.request_id: r for r in fake.submitted}
    return spans, refused, traces, reqs


def test_gateway_spans_on_a_burst_equal_jax(monkeypatch):
    want, wref, wtraces, _ = _burst(jgw, jc, jtr, JaxSamplingParams(), JaxRegistry(),
                                    True, monkeypatch)
    got, gref, gtraces, reqs = _burst(tgw, tc, ttr, SamplingParams(), MetricsRegistry(),
                                      False, monkeypatch)
    assert got == want and gref == wref
    names = {n for n, *_ in got}
    assert names == {"gateway/enqueued", "gateway/queued", "gateway/rejected",
                     "gateway/shed"}
    # One trace id a request across its gateway spans, carried into the engine
    # request with the client's t0.
    assert all(len(t) == 1 for t in gtraces.values()) and len(gtraces) == len(wtraces)
    for rid, req in reqs.items():
        assert req.trace_id == next(iter(gtraces[rid]))
        assert isinstance(req.gateway_enqueue_time, float) and req.tenant in ("t0", "t1")


# ----------------------------------------------------------------------
# Naming contracts
# ----------------------------------------------------------------------

def _span_catalog():
    spec = importlib.util.spec_from_file_location(
        "_span_naming", ROOT / "tests" / "test_span_naming.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SPAN_NAME_CATALOG


def _port_span_names():
    found = {}
    for path in sorted((ROOT / "dlti_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("span", "complete", "instant") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str) and "/" in node.args[0].value):
                found.setdefault(node.args[0].value, []).append(
                    f"{path.relative_to(ROOT)}:{node.lineno}")
    return found


def test_port_span_names_are_the_reference_catalogs():
    catalog = _span_catalog()
    found = _port_span_names()
    assert set(found) <= catalog, set(found) - catalog
    serving = {n for n in catalog if n.split("/")[0] in ("engine", "request", "gateway")}
    # engine/kv_handoff comes with disaggregation, which the port lacks.
    assert serving - {"engine/kv_handoff"} <= set(found), serving - set(found)


def test_new_metric_names_follow_the_convention():
    from dlti_tpu_torch.telemetry import ledger, memledger

    name_re = re.compile(r"^dlti_[a-z0-9]+(_[a-z0-9]+)*$")
    names = (list(tdt.TRACE_METRIC_NAMES) + list(ledger.LEDGER_METRIC_NAMES)
             + list(ledger.REQUEST_PHASE_METRIC_NAMES)
             + list(memledger.MEMLEDGER_METRIC_NAMES)
             + [m.name for m in (tdt.federated_spans_total, tdt.unparented_spans_total,
                                 tdt.clock_offset_gauge, ledger.phase_seconds_total,
                                 ledger.phase_requests_total, memledger.hbm_bytes_gauge,
                                 memledger.hbm_headroom_gauge)])
    assert all(name_re.fullmatch(n) for n in names), names
    assert names[:3] == list(jdt.TRACE_METRIC_NAMES)
