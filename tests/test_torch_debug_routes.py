"""The port server's observation routes against the JAX ``make_server``'s on
the same weights (``llama_tiny``, float32, CPU, ephemeral ports):
``/debug/vars``, ``/debug/slow``, ``/debug/trace``, ``/debug/memory``,
``/dashboard`` and ``POST /debug/profile``: the same status codes and
error messages for the same requests, the same payload keys (the memory
map's by its owners and buckets: PyTorch has no ``live_arrays``), a byte-equal
dashboard; then the response ``phases`` against the client's own clock,
the sampler's lifetime, a CPU ``torch.profiler`` capture, and the serve
CLI's seven flags.
"""

import dataclasses
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from dlti_tpu.config import MODEL_PRESETS as JAX_PRESETS
from dlti_tpu.config import TelemetryConfig as JaxTelemetryConfig
from dlti_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import server as jserver
from dlti_tpu.telemetry import tracer as jtr
from dlti_tpu_torch.cli import serve as cli
from dlti_tpu_torch.config import MODEL_PRESETS, TelemetryConfig
from dlti_tpu_torch.data import ByteTokenizer
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine
from dlti_tpu_torch.serving import server as tserver
from dlti_tpu_torch.telemetry import tracer as ttr
from dlti_tpu_torch.telemetry.ledger import REQUEST_PHASES
from torch_fleet_cells import seeded_params

ROOT = Path(__file__).resolve().parents[1]
EC = dict(max_seqs=4, block_size=8, num_blocks=64, max_model_len=128, eos_token_id=-1)


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return "127.0.0.1", httpd.server_address[1]


def _call(addr, method, path, body=None, timeout=120):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _err(data):
    return json.loads(data)["error"]["message"]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(JAX address, port address, JAX httpd, port httpd, port AsyncEngine)
    with a trace dir each, and three greedy requests served by both."""
    params = seeded_params()
    root = tmp_path_factory.mktemp("debug")
    jeng = JaxEngine(JAX_PRESETS["llama_tiny"], jax.tree_util.tree_map(jnp.asarray, params),
                     JaxEngineConfig(cache_dtype="float32", **EC))
    teng = InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                           EngineConfig(cache_dtype="float32", **EC), device="cpu")
    jhttpd, jasync = jserver.make_server(jeng, JaxByteTokenizer(), jserver.ServerConfig(
        host="127.0.0.1", port=0,
        telemetry=JaxTelemetryConfig(trace_dir=str(root / "jax"))))
    thttpd, tasync = tserver.make_server(teng, ByteTokenizer(), tserver.ServerConfig(
        host="127.0.0.1", port=0, telemetry=TelemetryConfig(trace_dir=str(root / "torch"))))
    jaddr, taddr = _start(jhttpd), _start(thttpd)
    for prompt in ("hello there", "ab", "The quick brown fox"):
        for addr in (jaddr, taddr):
            status, _, _ = _call(addr, "POST", "/v1/completions",
                                 {"prompt": prompt, "max_tokens": 5, "temperature": 0.0})
            assert status == 200
    yield jaddr, taddr, jhttpd, thttpd, tasync
    for httpd, aeng in ((jhttpd, jasync), (thttpd, tasync)):
        httpd.shutdown()
        aeng.shutdown()
        httpd.server_close()
    jhttpd.sampler.stop()


def _both(servers, method, path, body=None):
    jaddr, taddr = servers[:2]
    return _call(jaddr, method, path, body), _call(taddr, method, path, body)


@pytest.mark.parametrize("method,path,body", [
    ("GET", "/debug/vars?tail=x", None), ("GET", "/debug/slow?n=abc", None),
    ("GET", "/debug/trace", None), ("GET", "/debug/trace?request_id=cmpl-1", None),
    ("GET", "/debug/nothing", None), ("POST", "/debug/profile", {"seconds": "x"}),
    ("POST", "/debug/profile", {"seconds": 0}), ("POST", "/debug/profile", {"seconds": 500}),
])
def test_error_answers_equal_jax(servers, method, path, body):
    """400 on a bad tail, n or seconds; 404 while tracing is off and on an
    unknown route; the same messages."""
    tracers = (jtr.get_tracer(), ttr.get_tracer())
    saved = [t.enabled for t in tracers]
    for t in tracers:
        t.enabled = False
    try:
        (js, jdata, _), (ts, tdata, _) = _both(servers, method, path, body)
    finally:
        for t, enabled in zip(tracers, saved):
            t.enabled = enabled
    assert ts == js and ts in (400, 404), (ts, tdata)
    assert _err(tdata) == _err(jdata)


def test_profile_needs_a_trace_dir_as_jax(servers):
    out = []
    for httpd, addr in ((servers[2], servers[0]), (servers[3], servers[1])):
        handler = httpd.RequestHandlerClass
        cfg = handler.cfg
        handler.cfg = dataclasses.replace(cfg, telemetry=None)
        try:
            status, data, _ = _call(addr, "POST", "/debug/profile", {"seconds": 1})
        finally:
            handler.cfg = cfg
        out.append((status, _err(data)))
    assert out[1] == out[0] and out[1][0] == 400


def test_debug_vars_and_dashboard_equal_jax(servers):
    (js, jdata, jh), (ts, tdata, th) = _both(servers, "GET", "/debug/vars")
    want, got = json.loads(jdata), json.loads(tdata)
    assert ts == js == 200 and sorted(got) == sorted(want)
    assert got["num_samples"] >= 1 and "requests" in got["latest"]
    assert "hbm_bytes_in_use" in got["latest"] and "hbm_bytes_in_use" in want["latest"]
    tail = json.loads(_call(servers[1], "GET", "/debug/vars?tail=1")[1])
    assert tail["num_samples"] == 1
    (js, jdata, jh), (ts, tdata, th) = _both(servers, "GET", "/dashboard")
    assert ts == js == 200 and tdata == jdata
    assert th["Content-Type"] == jh["Content-Type"] == "text/html; charset=utf-8"


def test_debug_slow_equals_jax(servers):
    (js, jdata, _), (ts, tdata, _) = _both(servers, "GET", "/debug/slow")
    want, got = json.loads(jdata), json.loads(tdata)
    assert ts == js == 200
    assert sorted(got) == sorted(want) and got["phases"] == want["phases"] == list(REQUEST_PHASES)
    assert got["k"] == want["k"] == 32 and got["retained"] == want["retained"] >= 3
    assert [sorted(e) for e in got["worst"]] == [sorted(e) for e in want["worst"]]
    assert [e["output_tokens"] for e in got["worst"]] == [5] * len(got["worst"])
    one = json.loads(_call(servers[1], "GET", "/debug/slow?n=1")[1])
    assert len(one["worst"]) == 1 and one["worst"][0] == got["worst"][0]


@pytest.fixture()
def tracing():
    """Both packages' process-global tracers on, empty and wide for one
    test, then as they were (xdist runs many files in one process)."""
    saved = [(t.enabled, t.capacity) for t in (jtr.get_tracer(), ttr.get_tracer())]
    pair = (jtr.configure_tracer(enabled=True, capacity=65536),
            ttr.configure_tracer(enabled=True, capacity=65536))
    for t in pair:
        t.clear()
    yield
    for mod, t, (enabled, capacity) in zip((jtr, ttr), pair, saved):
        mod.configure_tracer(enabled=enabled, capacity=capacity)
        t.clear()


def test_debug_trace_and_one_requests_timeline_equal_jax(servers, tracing):
    ids = []
    for addr in servers[:2]:
        t0 = time.monotonic()
        status, data, _ = _call(addr, "POST", "/v1/completions",
                                {"prompt": "trace me", "max_tokens": 4, "temperature": 0.0})
        latency = time.monotonic() - t0
        assert status == 200
        body = json.loads(data)
        ids.append((body["id"], body["trace_id"], latency))
    (js, jdata, _), (ts, tdata, _) = _both(servers, "GET", "/debug/trace")
    want, got = json.loads(jdata), json.loads(tdata)
    assert ts == js == 200 and sorted(got) == sorted(want)
    assert got["traceEvents"][0]["args"] == {"name": "server"}
    out = []
    for addr, (rid, trace_id, latency) in zip(servers[:2], ids):
        status, data, _ = _call(addr, "GET",
                                f"/debug/trace?request_id={rid}&latency_s={latency}")
        tl = json.loads(data)
        assert status == 200 and tl["trace_id"] == trace_id
        assert {ev["args"].get("trace") for ev in tl["spans"]
                if "trace" in ev["args"]} == {trace_id}
        assert tl["client_latency_s"] == latency and tl["residual_s"] >= -1e-6
        out.append((sorted(tl), [(ev["name"], ev["ph"]) for ev in tl["spans"]],
                    tl["sequential_legs"]))
    assert out[1] == out[0]
    assert out[1][2] == ["request/queued", "request/prefill", "request/decode"]
    status, data, _ = _call(servers[1], "GET", f"/debug/trace?request_id={ids[1][0]}"
                                               "&latency_s=slow")
    assert status == 400 and _err(data) == "latency_s must be a float"
    (js, jdata, _), (ts, tdata, _) = _both(servers, "GET", "/debug/trace?request_id=nope")
    assert ts == js == 404 and _err(tdata) == _err(jdata)


def test_debug_memory_maps_the_same_owners_as_jax(servers):
    (js, jdata, _), (ts, tdata, _) = _both(servers, "GET", "/debug/memory")
    want, got = json.loads(jdata), json.loads(tdata)
    assert ts == js == 200
    assert sorted(got["owners"]) == sorted(want["owners"])
    assert sorted(got["buckets"]) == sorted(want["buckets"])
    assert sum(got["buckets"].values()) == got["bytes_in_use"]
    for owner in ("params", "kv_block_pool", "decode_state_cache"):
        assert got["owners"][owner]["bytes"] == want["owners"][owner]["bytes"], owner
    # The reference's keys but its live-array ones (JAX-only), plus the
    # ledger's device.
    assert (set(got) - {"top_untracked_tensors", "device"}
            == set(want) - {"top_untracked_arrays", "num_live_arrays"})
    out = []
    for httpd, addr in ((servers[2], servers[0]), (servers[3], servers[1])):
        led = httpd.RequestHandlerClass.async_engine.engine.memledger
        led.enabled = False
        try:
            status, data, _ = _call(addr, "GET", "/debug/memory")
        finally:
            led.enabled = True
        out.append((status, _err(data)))
    assert out[1] == out[0] == (404, "memory ledger disabled")


def test_concurrent_profile_gets_409_and_a_cpu_capture_writes_its_trace(servers):
    """While one capture runs a second is refused with 409, in both
    servers; the port's CPU capture is a Chrome trace under
    <trace_dir>/serve_profile."""
    for addr in servers[:2]:
        first = {}

        def run():
            first["r"] = _call(addr, "POST", "/debug/profile", {"seconds": 1.5})

        t = threading.Thread(target=run)
        t.start()
        time.sleep(0.5)
        status, data, _ = _call(addr, "POST", "/debug/profile", {"seconds": 1})
        t.join(timeout=120)
        assert status == 409 and _err(data) == "a profile capture is already running"
        assert first["r"][0] == 200
    body = json.loads(first["r"][1])
    assert body["status"] == "ok" and body["trace_dir"].endswith("serve_profile")
    assert 1.5 <= body["seconds"] < 60
    with open(body["trace"]) as f:
        assert "traceEvents" in json.load(f)


def test_response_phases_sum_to_the_clients_latency(servers):
    """The reference's bounds (tests/test_ledger.py): parts sum to total_s
    within 1e-6, total_s within [client - 0.25 s, client + 1 ms]."""
    for stream in (False, True):
        t0 = time.monotonic()
        status, data, _ = _call(servers[1], "POST", "/v1/completions",
                                {"prompt": "phases", "max_tokens": 4, "temperature": 0.0,
                                 "stream": stream})
        client = time.monotonic() - t0
        assert status == 200
        if stream:
            chunks = [json.loads(ln[6:]) for ln in data.decode().splitlines()
                      if ln.startswith("data: {")]
            body = chunks[-1]
        else:
            body = json.loads(data)
        phases = body["phases"]
        parts = {k: v for k, v in phases.items() if k not in ("total_s", "ttft_s")}
        assert set(parts) <= set(REQUEST_PHASES)
        assert sum(parts.values()) == pytest.approx(phases["total_s"], abs=1e-6)
        assert client - 0.25 <= phases["total_s"] <= client + 0.001
        assert re.fullmatch(r"[0-9a-f]{16}", body["trace_id"])


def test_the_sampler_stops_when_the_server_shuts_down():
    eng = InferenceEngine(MODEL_PRESETS["llama_tiny"], seeded_torch_params(),
                          EngineConfig(cache_dtype="float32", **EC), device="cpu")
    httpd, aeng = tserver.make_server(eng, ByteTokenizer(),
                                      tserver.ServerConfig(host="127.0.0.1", port=0))
    sampler = httpd.sampler
    assert sampler._thread is not None and sampler._thread.is_alive()
    aeng.shutdown()
    httpd.server_close()
    assert sampler._thread is None


def seeded_torch_params():
    return params_from_jax(seeded_params())


# ----------------------------------------------------------------------
# The serve CLI
# ----------------------------------------------------------------------

OBS_FLAGS = ["--trace-dir", "--trace-capacity", "--slow-log-k", "--no-memory-ledger",
             "--hbm-budget-bytes", "--admit-min-headroom-frac", "--guard-token-storm"]


def test_cli_takes_the_seven_flags_and_still_refuses_the_rest(tmp_path):
    assert not set(OBS_FLAGS) & set(cli.REFUSED_FLAGS)
    for still in ("--watchdog", "--slo", "--flight-dir", "--fleet-workers", "--disagg",
                  "--deploy-watch"):
        assert still in cli.REFUSED_FLAGS
    args = cli.parse_args(["--device", "cpu", "--random-init", "llama_tiny",
                           "--tokenizer", "byte", "--trace-dir", str(tmp_path),
                           "--trace-capacity", "128", "--slow-log-k", "3",
                           "--no-memory-ledger", "--hbm-budget-bytes", "1000000",
                           "--admit-min-headroom-frac", "0.05",
                           "--guard-token-storm", "7", "--max-model-len", "64",
                           "--num-blocks", "64"])
    tracer = ttr.get_tracer()
    saved = (tracer.enabled, tracer.capacity)
    try:
        engine, _, sc = cli.build(args)
        assert tracer.enabled and tracer.capacity == 128
    finally:
        ttr.configure_tracer(enabled=saved[0], capacity=saved[1])
        tracer.clear()
    ec = engine.cfg
    assert (ec.memory_ledger, ec.hbm_budget_bytes, ec.admit_min_headroom_frac,
            ec.guard_token_storm) == (False, 1000000, 0.05, 7)
    assert engine.telemetry.critical_path.slow.k == 3 and not engine.memledger.enabled
    assert sc.telemetry == TelemetryConfig(trace_dir=str(tmp_path), trace_capacity=128)
    defaults = cli.parse_args(["--random-init", "llama_tiny"])
    assert (defaults.trace_dir, defaults.trace_capacity, defaults.slow_log_k,
            defaults.no_memory_ledger, defaults.hbm_budget_bytes,
            defaults.admit_min_headroom_frac, defaults.guard_token_storm) == (
        "", 65536, 32, False, 0, 0.0, 0)


def test_cli_writes_its_trace_at_exit(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlti_tpu_torch.cli.serve", "--device", "cpu",
         "--random-init", "llama_tiny", "--tokenizer", "byte", "--port", "0",
         "--max-model-len", "64", "--num-blocks", "64", "--trace-dir", str(tmp_path)],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, lines = None, []
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port, "".join(lines)
        addr = ("127.0.0.1", port)
        status, data, _ = _call(addr, "POST", "/v1/completions",
                                {"prompt": "hi", "max_tokens": 3, "temperature": 0.0})
        assert status == 200
        status, data, _ = _call(addr, "GET", "/debug/trace")
        assert status == 200 and json.loads(data)["traceEvents"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    path = tmp_path / f"trace_serve_{proc.pid}.json"
    names = {ev["name"] for ev in json.loads(path.read_text())["traceEvents"]}
    assert {"request/queued", "request/decode", "engine/admit"} <= names
