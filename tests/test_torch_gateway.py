"""The port's admission gateway (``serving.gateway``) and its server path
against the JAX package's.

* **Over one fake engine**: both gateways get the same script on one fake
  clock (each module's ``time`` is replaced in the test; the reference
  reads ``time.monotonic`` directly) and give the same admit, 429, 503 and
  400 decisions, the same Retry-After values (rate-limit ones exactly), the
  same dequeue order under weights and priorities, the same queued-deadline
  sheds, mid-decode cancels, cancels while queued and drain refusals.
* **Over HTTP** (``llama_tiny``, CPU, byte tokenizer): both servers answer a
  queue overflow, a bad priority or deadline, an unknown mapped adapter, a
  drain with ``/health``, and ``/v1/reload`` (400 on one engine; 200, then
  409 while the roll is in flight, on a 2-replica fleet) with the same
  statuses, ``Retry-After`` headers and bodies.
* **The CLI**: ``cli.serve --replicas 2 --gateway`` answers HTTP as a
  subprocess and drains on SIGTERM; every flag of a subsystem the port
  lacks is refused by name, naming ROADMAP.md.
"""

import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

import dlti_tpu.config as jc
import dlti_tpu.serving.gateway as jgw
from dlti_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import ReplicatedEngine as JaxReplicated
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu.serving import server as jserver
from dlti_tpu.serving.engine import Request as JaxRequest
from dlti_tpu.telemetry import MetricsRegistry as JaxRegistry
from dlti_tpu.telemetry import RequestTelemetry as JaxTelemetry
import dlti_tpu_torch.cli.serve as cli
import dlti_tpu_torch.config as tc
import dlti_tpu_torch.serving.gateway as tgw
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.data import ByteTokenizer
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, ReplicatedEngine
from dlti_tpu_torch.serving import SamplingParams
from dlti_tpu_torch.serving import server as tserver
from dlti_tpu_torch.serving.engine import Request
from dlti_tpu_torch.telemetry.registry import MetricsRegistry
from torch_fleet_cells import EC, seeded_params

ROOT = Path(__file__).resolve().parents[1]


# ----------------------------------------------------------------------
# Both gateways over one fake engine, on one fake clock
# ----------------------------------------------------------------------

class _FakeTime:
    """The gateway modules' ``time`` in these tests: a clock the test moves."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def sleep(self, s):
        time.sleep(min(s, 0.002))
        self.t += s


class _FakeAsyncEngine:
    """An ``AsyncEngine`` stand-in that records the dispatch order; its
    ``room`` gates the dispatcher."""

    def __init__(self, jax_side: bool):
        self.engine = types.SimpleNamespace(
            cfg=types.SimpleNamespace(max_seqs=0), num_active=0, waiting=[],
            has_work=False, telemetry=JaxTelemetry(), stats={}, num_free_blocks=0)
        self.jax_side = jax_side
        self.submitted = []

    def set_room(self, n):
        self.engine.cfg.max_seqs = n

    def submit(self, prompt_ids, params, request_id=None, q=None, trace_id="", **kw):
        cls = JaxRequest if self.jax_side else Request
        extra = {"trace_id": trace_id} if self.jax_side else {}
        req = cls(request_id=request_id, prompt_token_ids=list(prompt_ids), **extra)
        self.submitted.append(req)
        return req, q


def _wait_for(cond, msg, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {msg}")


def _try(gw, sp, prompt, rid, **kw):
    """(admitted, status, retry_after, message) of one submit."""
    try:
        gw.submit(prompt, sp, rid, **kw)
        return (True, None, None, None)
    except Exception as e:
        return (False, e.status, e.retry_after, e.message)


def _queue_bounds(gw, fake, clock, sp):
    out = [_try(gw, sp, [1, 2], f"r{i}") for i in range(5)]
    out += [_try(gw, sp, [0] * 6, f"t{i}") for i in range(3)]
    return out


def _rate_limit(gw, fake, clock, sp):
    out = []
    for dt in (0.0, 0.0, 0.0, 0.25, 0.1, 0.25, 0.0, 3.0, 0.0, 0.0, 0.0, 0.0, 0.0):
        clock.t += dt
        out.append(_try(gw, sp, [1], f"a{len(out)}", tenant="A"))
        out.append(_try(gw, sp, [1], f"b{len(out)}", tenant="B"))
    return out


def _dequeue_order(gw, fake, clock, sp):
    out = []
    for i in range(6):
        out.append(_try(gw, sp, [1], f"a{i}", tenant="A"))
    for i in range(3):
        out.append(_try(gw, sp, [1], f"b{i}", tenant="B"))
        out.append(_try(gw, sp, [1], f"c{i}", tenant="C", priority="batch"))
    out.append(_try(gw, sp, [1], "d0", tenant="D", priority="interactive"))
    out.append(_try(gw, sp, [1], "u0", priority="urgent"))
    fake.set_room(100)
    _wait_for(lambda: len(fake.submitted) == 13, "13 dispatches")
    return out + [r.request_id for r in fake.submitted]


def _deadlines(gw, fake, clock, sp):
    _, q0 = gw.submit([1, 2, 3], sp, "shed", deadline_s=1.0)
    h1, q1 = gw.submit([1], sp, "cancelled")
    h1.cancel_requested = True
    clock.t += 2.0
    ev0 = q0.get(timeout=10)
    fake.set_room(4)
    ev1 = q1.get(timeout=10)
    h2, _ = gw.submit([1, 2], sp, "late", deadline_s=1.0)
    _wait_for(lambda: len(fake.submitted) == 1, "a dispatch")
    req = fake.submitted[0]
    before = req.cancel_requested
    clock.t += 2.0
    _wait_for(lambda: req.cancel_requested, "a mid-decode cancel")
    return [ev0, ev1, before, h2.cancel_requested, [r.request_id for r in fake.submitted]]


def _drain(gw, fake, clock, sp):
    out = [_try(gw, sp, [1], "r0")]
    gw.drain()
    clock.t += 5.0
    out += [gw.draining, _try(gw, sp, [1], "r1")]
    clock.t += 40.0
    out.append(_try(gw, sp, [1], "r2"))
    fake.set_room(10)
    _wait_for(lambda: len(fake.submitted) == 1, "the queued request's dispatch")
    out.append(gw.wait_idle(1.0))
    return out


def _adapters(gw, fake, clock, sp):
    return [_try(gw, sp, [1], "m0", tenant="teamA"), _try(gw, sp, [1], "m1", tenant="other"),
            _try(gw, sp, [1], "m2", adapter="ghost2"), gw.adapter_for("teamA")]


SCENARIOS = {
    "queue_bounds": (_queue_bounds, dict(max_queued_requests=6, max_queued_tokens=16,
                                         retry_after_s=3.0)),
    "rate_limit": (_rate_limit, dict(max_queued_requests=100, rate_limit_rps=2.0,
                                     rate_limit_burst=2.0)),
    "rate_limit_derived_burst": (_rate_limit, dict(max_queued_requests=100,
                                                   rate_limit_rps=1.5)),
    "weighted_priority_dequeue": (_dequeue_order, dict(max_queued_requests=100,
                                                       tenant_weights="A:3,B:1,C:2")),
    "deadlines_and_cancels": (_deadlines, dict(max_queued_requests=100)),
    "drain": (_drain, dict(max_queued_requests=100, drain_grace_s=30.0)),
    "adapter_map": (_adapters, dict(adapter_map="teamA:ghost")),
}


def _scenario(mod, cfg_mod, sp, registry, jax_side, name, monkeypatch):
    fn, cfg = SCENARIOS[name]
    clock = _FakeTime()
    monkeypatch.setattr(mod, "time", clock)
    fake = _FakeAsyncEngine(jax_side)
    gw = mod.AdmissionGateway(fake, cfg_mod.GatewayConfig(enabled=True, **cfg), registry)
    try:
        out = fn(gw, fake, clock, sp)
    finally:
        gw.shutdown()
    series = sorted((line.rsplit(" ", 1)[0], float(line.rsplit(" ", 1)[1]))
                    for line in registry.render_prometheus().splitlines()
                    if line.startswith("dlti_gateway_"))
    return out, series


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gateway_decisions_match_jax(name, monkeypatch):
    want = _scenario(jgw, jc, JaxSamplingParams(), JaxRegistry(), True, name, monkeypatch)
    got = _scenario(tgw, tc, SamplingParams(), MetricsRegistry(), False, name, monkeypatch)
    assert got == want


def test_scenarios_exercise_what_they_name(monkeypatch):
    """The parity above is not vacuous: refusals, sheds and orders happen."""
    out, series = _scenario(tgw, tc, SamplingParams(), MetricsRegistry(), False,
                            "rate_limit", monkeypatch)
    waits = [r for _, _, r, _ in out if r is not None]
    assert waits and min(waits) < 1.0 and any(ok for ok, *_ in out)
    out, _ = _scenario(tgw, tc, SamplingParams(), MetricsRegistry(), False,
                       "weighted_priority_dequeue", monkeypatch)
    order = out[-13:]
    # Stride scheduling interleaves A's burst with the other tenants.
    assert order[:4] == ["a0", "b0", "d0", "a1"]
    assert all(r.startswith("c") for r in order[10:])  # batch after interactive
    assert not any(r.startswith("c") for r in order[:10])
    out, series = _scenario(tgw, tc, SamplingParams(), MetricsRegistry(), False,
                            "deadlines_and_cancels", monkeypatch)
    assert out[0][:2] == ("reject", 503) and out[1] == ("done", "stop") and out[3]
    assert ('dlti_gateway_shed_total{priority="interactive"}', 1.0) in series


def test_gateway_imports_no_clock_knob():
    """The port's gateway takes the reference's arguments, no clock."""
    import inspect

    assert list(inspect.signature(tgw.AdmissionGateway).parameters) == \
        list(inspect.signature(jgw.AdmissionGateway).parameters)


@pytest.mark.parametrize("headers", [{"X-Tenant": " t1 "}, {"Authorization": "Bearer k"},
                                     {}, None])
def test_tenant_and_affinity_keys_match_jax(headers):
    assert tgw.tenant_from_headers(headers) == jgw.tenant_from_headers(headers)
    for adapter in ("", "ad1"):
        for h in (headers, {"X-Session": "s9"}):
            assert tgw.affinity_key_from(h, list(range(40)), 32, adapter) == \
                jgw.affinity_key_from(h, list(range(40)), 32, adapter)


@pytest.mark.parametrize("spec", ["a:4,b:1", "", "a,b:2.5", "a:0", "a:x"])
def test_tenant_weights_and_adapter_map_parse_as_jax(spec):
    for fn in ("parse_tenant_weights", "parse_adapter_map"):
        try:
            want = getattr(jgw, fn)(spec)
        except ValueError:
            with pytest.raises(ValueError):
                getattr(tgw, fn)(spec)
        else:
            assert getattr(tgw, fn)(spec) == want


# ----------------------------------------------------------------------
# HTTP: both servers on the same weights
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return seeded_params()


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return "127.0.0.1", httpd.server_address[1]


def _request(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    data = resp.read()
    out = (resp.status, json.loads(data) if data.startswith(b"{") else data,
           resp.getheader("Retry-After"))
    conn.close()
    return out


def _comparable(resp):
    """A response without what differs by design: the reference's keys that
    wait for the telemetry port, the request id and the clock."""
    status, body, retry = resp
    if isinstance(body, dict):
        body = {k: v for k, v in body.items()
                if k not in ("phases", "trace_id", "id", "created")}
    return status, body, retry


@pytest.fixture(scope="module")
def servers(params):
    """{name: (jax address, port address, jax httpd, port httpd)}."""
    ec = dict(EC, cache_dtype="float32")
    gw = dict(max_queued_requests=8, adapter_map="teamA:ghost", drain_grace_s=30.0)
    kinds = {"full": (dict(enabled=True, max_queued_requests=0), 1),
             "gateway": (dict(enabled=True, **gw), 1),
             "fleet": (dict(enabled=True, **gw), 2)}
    out, stops = {}, []
    for name, (gcfg, n) in kinds.items():
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        if n == 1:
            jeng = JaxEngine(jc.MODEL_PRESETS["llama_tiny"], jp, JaxEngineConfig(**ec))
            teng = InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                                   EngineConfig(**ec), device="cpu")
        else:
            jeng = JaxReplicated(jc.MODEL_PRESETS["llama_tiny"], jp, JaxEngineConfig(**ec),
                                 replicas=n, tensor=1, devices=jax.devices()[:n])
            teng = ReplicatedEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                                    EngineConfig(**ec), replicas=n, device="cpu")
        jhttpd, jasync = jserver.make_server(jeng, JaxByteTokenizer(), jserver.ServerConfig(
            host="127.0.0.1", port=0, default_params=JaxSamplingParams(max_tokens=8),
            gateway=jc.GatewayConfig(**gcfg)))
        thttpd, tasync = tserver.make_server(teng, ByteTokenizer(), tserver.ServerConfig(
            host="127.0.0.1", port=0, default_params=SamplingParams(max_tokens=8),
            gateway=tc.GatewayConfig(**gcfg)))
        out[name] = (_start(jhttpd), _start(thttpd), jhttpd, thttpd)
        stops += [(jhttpd, jasync), (thttpd, tasync)]
    yield out
    for httpd, async_engine in stops:
        httpd.shutdown()
        if httpd.gateway is not None:
            httpd.gateway.shutdown()
        async_engine.shutdown()
        httpd.server_close()
        sampler = getattr(httpd, "sampler", None)
        if sampler is not None:
            sampler.stop()


def _both(servers, name, method, path, body=None, headers=None):
    jaddr, taddr = servers[name][:2]
    return (_comparable(_request(jaddr, method, path, body, headers)),
            _comparable(_request(taddr, method, path, body, headers)))


def test_http_queue_overflow_answers_as_jax(servers):
    want, got = _both(servers, "full", "POST", "/v1/completions",
                      {"prompt": "hello", "max_tokens": 4})
    assert got == want and got[0] == 429 and got[2] == "1"


@pytest.mark.parametrize("case", ["bad_priority", "header_priority", "bad_deadline",
                                  "unknown_mapped_adapter", "served"])
def test_http_admission_answers_as_jax(servers, case):
    body = {"prompt": "hello", "max_tokens": 4, "temperature": 0.0}
    headers = None
    if case == "bad_priority":
        body["priority"] = "urgent"
    elif case == "header_priority":
        headers = {"X-Priority": "later"}
    elif case == "bad_deadline":
        body["deadline_s"] = "soon"
    elif case == "unknown_mapped_adapter":
        headers = {"X-Tenant": "teamA"}
    else:
        body["priority"] = "batch"
    want, got = _both(servers, "gateway", "POST", "/v1/completions", body, headers)
    assert got == want
    assert got[0] == {"bad_priority": 400, "header_priority": 400, "bad_deadline": 400,
                      "unknown_mapped_adapter": 404, "served": 200}[case]


def test_http_reload_answers_400_on_one_engine_as_jax(servers, params, tmp_path):
    from dlti_tpu.checkpoint.store import save_pytree

    save_pytree(str(tmp_path / "w"), params)
    for body in ({}, {"directory": str(tmp_path)}, {"directory": str(tmp_path / "w")}):
        want, got = _both(servers, "gateway", "POST", "/v1/reload", body)
        assert got == want and got[0] == 400


def test_http_fleet_reload_then_409_then_serves_as_jax(servers, params, tmp_path):
    from dlti_tpu.checkpoint.store import save_pytree

    d = str(tmp_path / "w")
    save_pytree(d, params)
    jaddr, taddr, jhttpd, thttpd = servers["fleet"]
    before = _both(servers, "fleet", "POST", "/v1/completions",
                   {"prompt": "abc", "max_tokens": 6, "temperature": 0.0})
    assert before[0] == before[1] and before[1][0] == 200
    got = [_request(addr, "POST", "/v1/reload", {"directory": d}) for addr in (taddr, taddr)]
    want = [_request(addr, "POST", "/v1/reload", {"directory": d}) for addr in (jaddr, jaddr)]
    assert got == want and [r[0] for r in got] == [200, 409]
    for httpd in (jhttpd, thttpd):
        eng = httpd.RequestHandlerClass.async_engine.engine
        _wait_for(lambda: eng._reload is None, "the roll", timeout=120)
        assert eng.last_reload_ok is True
    after = _both(servers, "fleet", "POST", "/v1/completions",
                  {"prompt": "abc", "max_tokens": 6, "temperature": 0.0})
    assert after == before
    want, got = _both(servers, "fleet", "GET", "/health")
    assert got == want == (200, {"status": "ok", "live": 2, "quarantined": 0,
                                 "draining": 0, "dead": 0}, None)


def test_http_drain_answers_503_and_health_draining_as_jax(servers):
    """Last on the module's servers: a drain is for good."""
    body = {"prompt": "hello", "max_tokens": 4}
    for name in ("gateway", "fleet"):
        _, _, jhttpd, thttpd = servers[name]
        jhttpd.gateway.drain()
        thttpd.gateway.drain()
        want, got = _both(servers, name, "POST", "/v1/completions", body)
        assert got == want and got[0] == 503 and got[2] == "30"
        want, got = _both(servers, name, "GET", "/health")
        assert got == want and got[0] == 503 and got[1]["status"] == "draining"


# ----------------------------------------------------------------------
# The serve CLI
# ----------------------------------------------------------------------

@pytest.mark.parametrize("flag", sorted(cli.REFUSED_FLAGS))
def test_cli_refuses_unported_flags_naming_the_roadmap(flag):
    args = cli.parse_args(["--device", "cpu", "--random-init", "llama_tiny", flag])
    with pytest.raises(SystemExit, match=f"{re.escape(flag)}.*ROADMAP.md"):
        cli.build(args)


@pytest.mark.parametrize("extra", [["--replicas", "2", "--tensor", "2"],
                                   ["--self-heal", "--tensor", "2"]])
def test_cli_refuses_a_fleet_of_tensor_replicas(extra):
    args = cli.parse_args(["--device", "cpu", "--random-init", "llama_tiny"] + extra)
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        cli.build(args)


def test_cli_flags_reach_the_fleet_and_the_gateway():
    args = cli.parse_args([
        "--device", "cpu", "--random-init", "llama_tiny", "--tokenizer", "byte",
        "--max-model-len", "64", "--num-blocks", "32", "--replicas", "2", "--gateway",
        "--max-queued-requests", "5", "--max-queued-tokens", "99", "--rate-limit-rps", "2",
        "--rate-limit-burst", "3", "--tenant-weights", "a:2", "--drain-grace", "7",
        "--max-retries", "1", "--fault-inject-step", "1:9:preempt", "--self-heal",
        "--probation", "0.5", "--flap-window", "60", "--flap-max-cycles", "2",
        "--affinity", "--affinity-spill-threshold", "3", "--affinity-prefix-tokens", "16",
        "--adapter-map", "t:ad", "--no-numeric-guard"])
    engine, _, sc = cli.build(args)
    assert isinstance(engine, ReplicatedEngine) and len(engine.engines) == 2
    assert engine.max_retries == 1 and engine._fault_inject == (1, 9, "preempt")
    assert engine.affinity_spill_threshold == 3 and not engine.cfg.guard_nonfinite
    assert engine.lifecycle_cfg == tc.ReplicaLifecycleConfig(
        enabled=True, probation_initial_s=0.5, flap_window_s=60.0, flap_max_cycles=2)
    assert sc.gateway == tc.GatewayConfig(
        enabled=True, max_queued_requests=5, max_queued_tokens=99, rate_limit_rps=2.0,
        rate_limit_burst=3.0, tenant_weights="a:2", drain_grace_s=7.0, max_retries=1,
        fault_inject_step="1:9:preempt", affinity=True, affinity_spill_threshold=3,
        affinity_prefix_tokens=16, adapter_map="t:ad")


def test_serve_cli_replicas_with_gateway_answers_and_drains_on_sigterm():
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlti_tpu_torch.cli.serve", "--device", "cpu",
         "--random-init", "llama_tiny", "--tokenizer", "byte", "--port", "0",
         "--max-model-len", "64", "--num-blocks", "32", "--kv-cache-dtype", "int8",
         "--replicas", "2", "--gateway", "--self-heal", "--probation", "0",
         "--fault-inject-step", "1:2:preempt"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"})
    try:
        port, lines = None, []
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port is not None, "".join(lines)
        addr = ("127.0.0.1", port)
        results = []

        def go(i):
            results.append(_request(addr, "POST", "/v1/completions",
                                    {"prompt": f"hi {i}", "max_tokens": 8, "temperature": 0}))

        threads = [threading.Thread(target=go, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(s == 200 and b["usage"]["completion_tokens"] == 8 for s, b, _ in results), \
            results
        assert sum(b["migrations"] for _, b, _ in results) >= 1
        _wait_for(lambda: _request(addr, "GET", "/health")[1].get("live") == 2, "the heal")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "gateway draining" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
