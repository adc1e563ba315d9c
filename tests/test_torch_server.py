"""The port's OpenAI server against the JAX package's ``make_server`` on the
same weights (``llama_tiny``, CPU, byte tokenizer, ephemeral ports), on
float32 and int8 KV pools; then the port's own contracts from
``tests/test_server.py`` and its serve CLI as a subprocess.

Both servers get the same requests. Greedy texts, token ids, ``usage``,
``finish_reason`` and status codes must be equal; logprobs agree within
1e-4 (the two frameworks sum in different orders). Seeded sampling draws
different bits in the two frameworks by design, so seeded responses are
compared by shape only.
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
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dlti_tpu.config import MODEL_PRESETS as JAX_PRESETS
from dlti_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu.serving import server as jserver
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.data import ByteTokenizer
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams
from dlti_tpu_torch.serving import server as tserver

ROOT = Path(__file__).resolve().parents[1]
LOGPROB_ATOL = 1e-4
KV_DTYPES = ["float32", "int8"]
EC = dict(max_seqs=4, block_size=8, num_blocks=128, max_model_len=128,
          eos_token_id=-1)


@pytest.fixture(scope="module")
def params():
    """JAX init plus numpy noise, so no float32 near-tie decides a greedy
    token (as in tests/test_torch_engine.py)."""
    cfg = JAX_PRESETS["llama_tiny"]
    tree = JaxLlama(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def _start(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return "127.0.0.1", httpd.server_address[1]


@pytest.fixture(scope="module")
def servers(params):
    """{kv dtype: (jax (host, port), port's (host, port), port's AsyncEngine)}."""
    out, stops = {}, []
    for kv in KV_DTYPES:
        jeng = JaxEngine(JAX_PRESETS["llama_tiny"],
                         jax.tree_util.tree_map(jnp.asarray, params),
                         JaxEngineConfig(cache_dtype=kv, **EC))
        jhttpd, jasync = jserver.make_server(
            jeng, JaxByteTokenizer(),
            jserver.ServerConfig(host="127.0.0.1", port=0,
                                 default_params=JaxSamplingParams(max_tokens=8)))
        teng = InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                               EngineConfig(cache_dtype=kv, **EC), device="cpu")
        thttpd, tasync = tserver.make_server(
            teng, ByteTokenizer(),
            tserver.ServerConfig(host="127.0.0.1", port=0,
                                 default_params=SamplingParams(max_tokens=8)))
        out[kv] = (_start(jhttpd), _start(thttpd), tasync)
        stops += [(jhttpd, jasync), (thttpd, tasync)]
    yield out
    for httpd, async_engine in stops:
        httpd.shutdown()
        async_engine.shutdown()
        httpd.server_close()
        sampler = getattr(httpd, "sampler", None)
        if sampler is not None:
            sampler.stop()


def _request(addr, method, path, body=None, raw=None, timeout=120):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    data = raw if raw is not None else (json.dumps(body) if body is not None else None)
    conn.request(method, path, data, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    payload = resp.read()
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, payload, headers


def _post(addr, path, body):
    status, data, _ = _request(addr, "POST", path, body)
    return status, json.loads(data) if data.startswith(b"{") else data


def _get(addr, path):
    status, data, headers = _request(addr, "GET", path)
    return status, data, headers


def _stream(addr, path, body):
    """(deltas, final chunk) of an SSE response."""
    status, raw, headers = _request(addr, "POST", path, {**body, "stream": True})
    assert status == 200 and headers["Content-Type"].startswith("text/event-stream")
    events = [line[len("data: "):] for line in raw.decode().splitlines()
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert not any("error" in c for c in chunks), chunks
    deltas = []
    for c in chunks:
        ch = c["choices"][0]
        piece = ch["delta"].get("content", "") if "delta" in ch else ch.get("text", "")
        deltas.append(piece)
    return deltas, chunks[-1]


def _without_unported(obj):
    """The reference's response minus the keys that wait for the telemetry
    port (``phases``, ``trace_id``), and the per-request id and clock."""
    return {k: v for k, v in obj.items()
            if k not in ("phases", "trace_id", "id", "created")}


PROMPTS = ["hello", "The quick brown fox", "abc" * 9, "x"]


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_greedy_completions_and_chat_match_jax(servers, kv):
    jaddr, taddr, _ = servers[kv]
    bodies = [("/v1/completions", {"prompt": p, "max_tokens": 10, "temperature": 0.0,
                                   "logprobs": True}) for p in PROMPTS]
    bodies.append(("/v1/chat/completions", {
        "messages": [{"role": "system", "content": "Be brief."},
                     {"role": "user", "content": "hi"}],
        "max_tokens": 6, "temperature": 0.0, "logprobs": True}))
    for path, body in bodies:
        js, want = _post(jaddr, path, body)
        ts, got = _post(taddr, path, body)
        assert js == ts == 200, (want, got)
        w, g = _without_unported(want), _without_unported(got)
        wl = w["choices"][0].pop("logprobs")
        gl = g["choices"][0].pop("logprobs")
        assert g == w, (path, body)
        assert gl["tokens"] == wl["tokens"]
        np.testing.assert_allclose(gl["token_logprobs"], wl["token_logprobs"],
                                   atol=LOGPROB_ATOL, rtol=0)
        assert got["id"].startswith("chatcmpl-" if "chat" in path else "cmpl-")
        assert got["migrations"] == got["retries"] == 0


STREAM_BODIES = [
    ("/v1/completions", {"prompt": "stream me", "max_tokens": 12, "temperature": 0.0}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "yo"}],
                              "max_tokens": 7, "temperature": 0.0}),
]


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_streamed_deltas_match_jax(servers, kv):
    """Delta for delta, the port streams what the reference streams, with
    the same final chunk."""
    jaddr, taddr, _ = servers[kv]
    for path, body in STREAM_BODIES:
        _, full = _post(taddr, path, body)
        deltas, final = _stream(taddr, path, body)
        jdeltas, jfinal = _stream(jaddr, path, body)
        assert deltas == jdeltas
        assert final["choices"][0]["finish_reason"] == "length"
        assert final["usage"] == jfinal["usage"] == full["usage"]
        assert sorted(_without_unported(final)) == sorted(_without_unported(jfinal))
        if "chat" in path:
            assert final["object"] == "chat.completion.chunk"


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_streamed_deltas_concatenate_to_the_full_text(params, kv):
    """With a tokenizer that renders every id (a random model's bytes are
    often not valid UTF-8, and a streamed replacement character cannot be
    taken back), the deltas concatenate to the non-streamed text."""
    from dlti_tpu_torch.data import IdTokenizer

    eng = InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                          EngineConfig(cache_dtype=kv, **EC), device="cpu")
    httpd, aeng = tserver.make_server(
        eng, IdTokenizer(vocab_size=512), tserver.ServerConfig(host="127.0.0.1", port=0))
    addr = _start(httpd)
    try:
        for path, body in STREAM_BODIES:
            _, full = _post(addr, path, body)
            deltas, _ = _stream(addr, path, body)
            text = (full["choices"][0]["message"]["content"] if "chat" in path
                    else full["choices"][0]["text"])
            assert len(deltas) >= 3 and "".join(deltas) == text
    finally:
        httpd.shutdown()
        aeng.shutdown()
        httpd.server_close()


def _pick_stop(addr):
    """A greedy completion and an inner 2-gram whose first occurrence is
    past index 0, so the cut is not trivial."""
    base = {"prompt": "abcdefgh", "max_tokens": 24, "temperature": 0.0}
    _, d = _post(addr, "/v1/completions", base)
    full = d["choices"][0]["text"]
    assert len(full) >= 3, f"output too short to test stops: {full!r}"
    stop = full[0:2]
    for i in range(1, len(full) - 1):
        if full.find(full[i:i + 2]) == i:
            stop = full[i:i + 2]
            break
    return full, stop, base


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_stop_strings_match_jax_full_and_streamed(servers, kv):
    jaddr, taddr, tasync = servers[kv]
    full, stop, base = _pick_stop(taddr)
    assert _pick_stop(jaddr)[0] == full
    _, got = _post(taddr, "/v1/completions", {**base, "stop": stop})
    _, want = _post(jaddr, "/v1/completions", {**base, "stop": stop})
    assert got["choices"][0]["text"] == want["choices"][0]["text"] == full[:full.find(stop)]
    assert got["choices"][0]["finish_reason"] == want["choices"][0]["finish_reason"] == "stop"
    # The stop cancelled the request early: fewer than max_tokens decoded.
    assert got["usage"]["completion_tokens"] < base["max_tokens"]
    deltas, final = _stream(taddr, "/v1/completions", {**base, "stop": stop})
    jdeltas, _ = _stream(jaddr, "/v1/completions", {**base, "stop": stop})
    assert "".join(deltas) == "".join(jdeltas) == full[:full.find(stop)]
    assert all(stop not in d for d in deltas)
    assert final["choices"][0]["finish_reason"] == "stop"
    # A stop whose prefix ends the output but never matches: the held-back
    # tail is flushed at the end.
    tail_stop = full[-1] + "\x00"
    deltas, final = _stream(taddr, "/v1/completions", {**base, "stop": tail_stop})
    jdeltas, _ = _stream(jaddr, "/v1/completions", {**base, "stop": tail_stop})
    assert "".join(deltas) == "".join(jdeltas) == full
    assert final["choices"][0]["finish_reason"] == "length"
    assert not tasync.engine.has_work


def test_seeded_n_choices_shape(servers):
    jaddr, taddr, _ = servers["float32"]
    body = {"prompt": "abcdef", "max_tokens": 6, "temperature": 1.0, "seed": 3, "n": 2}
    _, got = _post(taddr, "/v1/completions", body)
    _, want = _post(jaddr, "/v1/completions", body)
    assert sorted(got) == sorted(k for k in want if k not in ("phases", "trace_id"))
    assert [c["index"] for c in got["choices"]] == [0, 1]
    assert [sorted(c) for c in got["choices"]] == [sorted(c) for c in want["choices"]]
    assert got["usage"]["completion_tokens"] == want["usage"]["completion_tokens"] == 12
    assert got["id"].startswith("cmpl-")
    # The port reproduces its own seeded response.
    _, again = _post(taddr, "/v1/completions", body)
    assert [c["text"] for c in again["choices"]] == [c["text"] for c in got["choices"]]


ERROR_REQUESTS = [
    ("POST", "/v1/completions", {"prompt": ""}),
    ("POST", "/v1/completions", {"prompt": 7}),
    ("POST", "/v1/chat/completions", {"messages": []}),
    ("POST", "/nope", {}),
    ("GET", "/nope", None),
    ("POST", "/v1/completions", {"prompt": "z" * 500, "max_tokens": 2}),
    ("POST", "/v1/completions", {"prompt": "hi", "seed": "abc"}),
    ("POST", "/v1/completions", {"prompt": "hi", "temperature": "hot"}),
    ("POST", "/v1/completions", {"prompt": "hi", "top_k": [1]}),
    ("POST", "/v1/completions", {"prompt": "hi", "stop": ["a", "b", "c", "d", "e"]}),
    ("POST", "/v1/completions", {"prompt": "hi", "stop": ""}),
    ("POST", "/v1/completions", {"prompt": "hi", "n": 0}),
    ("POST", "/v1/completions", {"prompt": "hi", "n": 9}),
    ("POST", "/v1/completions", {"prompt": "hi", "n": "two"}),
    ("POST", "/v1/completions", {"prompt": "hi", "n": 2, "stream": True}),
    ("POST", "/v1/completions", {"prompt": "hi", "n": 2, "temperature": 0.0}),
    ("POST", "/v1/completions", "{not json"),
]


def test_error_status_codes_match_jax(servers):
    jaddr, taddr, tasync = servers["int8"]
    for method, path, body in ERROR_REQUESTS:
        kw = dict(raw=body) if isinstance(body, str) else dict(body=body)
        js, jdata, _ = _request(jaddr, method, path, **kw)
        ts, tdata, _ = _request(taddr, method, path, **kw)
        assert ts == js and ts >= 400, (method, path, body, ts, js)
        terr, jerr = json.loads(tdata)["error"], json.loads(jdata)["error"]
        assert terr["type"] == jerr["type"], (path, body)
    assert b"max_model_len" in _request(taddr, "POST", "/v1/completions",
                                        {"prompt": "z" * 500})[1]
    # Still healthy and serving after the bad requests.
    assert _post(taddr, "/v1/completions", {"prompt": "hi", "max_tokens": 2})[0] == 200
    assert not tasync.dead


def test_health_models_stats_and_metrics(servers):
    jaddr, taddr, _ = servers["float32"]
    _post(taddr, "/v1/completions", {"prompt": "warm", "max_tokens": 3})
    for path in ("/health", "/v1/models"):
        js, jdata, _ = _get(jaddr, path)
        ts, tdata, _ = _get(taddr, path)
        assert (ts, json.loads(tdata)) == (js, json.loads(jdata))
    assert json.loads(_get(taddr, "/health")[1]) == {"status": "ok"}

    tstats = json.loads(_get(taddr, "/stats")[1])
    jstats = json.loads(_get(jaddr, "/stats")[1])
    assert set(tstats) <= set(jstats), set(tstats) - set(jstats)
    for key in ("requests", "generated_tokens", "decode_steps", "free_blocks",
                "active_seqs", "waiting", "request_ttft_seconds",
                "request_tpot_seconds", "request_queue_time_seconds"):
        assert key in tstats
    assert sorted(tstats["request_ttft_seconds"]) == sorted(jstats["request_ttft_seconds"])
    assert tstats["request_ttft_seconds"]["count"] >= 1

    status, text, headers = _get(taddr, "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    jtext = _get(jaddr, "/metrics")[1].decode()
    types = lambda t: {ln for ln in t.splitlines() if ln.startswith("# TYPE")}  # noqa: E731
    assert types(text.decode()) <= types(jtext), types(text.decode()) - types(jtext)
    for must in ("# TYPE dlti_free_blocks gauge", "# TYPE dlti_requests counter",
                 "# TYPE dlti_request_ttft_seconds histogram"):
        assert must in text.decode()
    for line in text.decode().strip().splitlines():
        if not line.startswith("#"):
            name, value = line.split()
            assert name.startswith("dlti_")
            float(value)


def test_unported_routes_answer_404_naming_roadmap(servers):
    _, taddr, _ = servers["float32"]
    for method, path in [("GET", "/debug/vars"), ("GET", "/debug/trace"),
                         ("GET", "/dashboard"), ("GET", "/v1/adapters"),
                         ("POST", "/v1/adapters"), ("POST", "/v1/reload"),
                         ("GET", "/v1/deploy"), ("POST", "/debug/profile")]:
        status, data, _ = _request(taddr, method, path, {})
        assert status == 404 and b"ROADMAP" in data, (method, path, data)
    conn = http.client.HTTPConnection(*taddr, timeout=30)
    conn.request("POST", "/v1/completions", json.dumps({"prompt": "hi"}),
                 {"Content-Type": "application/json", "X-Adapter": "a"})
    resp = conn.getresponse()
    assert resp.status == 404 and b"ROADMAP" in resp.read()
    conn.close()


_messages = st.lists(st.fixed_dictionaries({
    "role": st.sampled_from(["system", "user", "assistant", "tool"]),
    "content": st.text(max_size=12)}), max_size=6)


@settings(max_examples=200, deadline=None)
@given(_messages)
def test_llama2_chat_prompt_matches_jax(messages):
    assert tserver.llama2_chat_prompt(messages) == jserver.llama2_chat_prompt(messages)


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet="abcé", max_size=30),
       st.lists(st.text(alphabet="abcé", min_size=1, max_size=3), max_size=4),
       st.integers(-5, 35))
def test_scan_stops_matches_jax(text, stops, start):
    stops = tuple(stops)
    assert tserver._Handler._scan_stops(text, stops, start) == \
        jserver._Handler._scan_stops(text, stops, start)
    tm, jm = tserver._Handler._StopMatcher(stops), jserver._Handler._StopMatcher(stops)
    for i in range(0, len(text) + 1, 3):
        assert tm.feed(text[:i]) == jm.feed(text[:i])


def test_n_choices_submit_fault_cancels_submitted(servers, monkeypatch):
    """A submit failing mid-loop for n > 1 answers 503 and cancels every
    choice already submitted."""
    _, taddr, _ = servers["float32"]
    orig_submit = tserver.AsyncEngine.submit
    state = {"calls": 0, "submitted": []}

    def flaky_submit(self, prompt_ids, params, request_id=None):
        state["calls"] += 1
        if state["calls"] == 2:
            raise RuntimeError("injected: stepper parked mid-loop")
        req, q = orig_submit(self, prompt_ids, params, request_id)
        state["submitted"].append(req)
        return req, q

    monkeypatch.setattr(tserver.AsyncEngine, "submit", flaky_submit)
    status, _ = _post(taddr, "/v1/completions", {"prompt": "abcdef", "max_tokens": 64,
                                                 "temperature": 1.0, "n": 3})
    assert status == 503
    assert len(state["submitted"]) == 1 and state["submitted"][0].cancel_requested


def _tiny_engine(params, **kw):
    ec = dict(max_seqs=2, block_size=8, num_blocks=32, max_model_len=32,
              cache_dtype="float32", eos_token_id=-1)
    ec.update(kw)
    return InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                           EngineConfig(**ec), device="cpu")


def test_stepper_fault_aborts_cleanly(params):
    """A faulted ``engine.step()`` errors exactly the in-flight consumers and
    leaves the engine empty; the stepper parks instead of retrying, and
    serves again once the fault is gone."""
    eng = _tiny_engine(params)
    boom = {"n": 0}
    real_step = eng.step

    def flaky_step():
        boom["n"] += 1
        raise RuntimeError("injected device fault")

    eng.step = flaky_step
    aeng = tserver.AsyncEngine(eng)
    try:
        _, q = aeng.submit([3, 1, 4, 1, 5], SamplingParams(max_tokens=4))
        kind, payload = q.get(timeout=30)[:2]
        assert kind == "error" and "injected device fault" in payload
        assert not eng.has_work
        assert all(s.free for s in eng.slots) and not eng.waiting
        n_after_error = boom["n"]
        time.sleep(0.5)
        assert boom["n"] == n_after_error  # parked, not looping
        eng.step = real_step
        _, q2 = aeng.submit([2, 7, 1], SamplingParams(temperature=0.0, max_tokens=3))
        events = [q2.get(timeout=60) for _ in range(4)]
        assert events[-1] == ("done", "length")
        assert sum(1 for e in events if e[0] == "token") == 3
    finally:
        aeng.shutdown()


def test_stepper_that_cannot_select_its_device_parks_and_health_is_503(params, monkeypatch):
    """If the stepper thread cannot make the engine's card current, it
    parks at once: ``/health`` answers 503 and a completion fails fast
    instead of waiting out the request timeout."""
    import torch

    def refuse(device):
        raise ValueError("injected: cannot select the device")

    eng = _tiny_engine(params)
    # Only the stepper reads the device after construction.
    monkeypatch.setattr(InferenceEngine, "device",
                        property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.cuda, "set_device", refuse)
    httpd, aeng = tserver.make_server(
        eng, ByteTokenizer(), tserver.ServerConfig(host="127.0.0.1", port=0,
                                                   request_timeout_s=600.0))
    addr = _start(httpd)
    try:
        aeng._thread.join(timeout=30)
        assert not aeng._thread.is_alive() and aeng.dead
        assert _get(addr, "/health")[:2] == (503, b'{"status": "dead"}')
        t0 = time.monotonic()
        status, data = _post(addr, "/v1/completions", {"prompt": "hi", "max_tokens": 4})
        assert status == 503 and "engine is down" in data["error"]["message"]
        assert time.monotonic() - t0 < 30
    finally:
        httpd.shutdown()
        aeng.shutdown()
        httpd.server_close()


def test_cancel_flags_finish_queued_and_running_requests(params):
    """A cancelled queued request finishes as "stop" without a slot; a
    running one finishes as "stop" at its next token; ``finished`` holds
    both; ``abort_all`` empties the engine."""
    eng = _tiny_engine(params, max_seqs=1)
    running = eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=20))
    queued = eng.submit([4, 5], SamplingParams(temperature=0.0, max_tokens=20))
    eng.step()
    assert eng.slots[0].request is running and list(eng.waiting) == [queued]
    queued.cancel_requested = True
    running.cancel_requested = True
    eng.step()
    assert running.finish_reason == queued.finish_reason == "stop"
    assert queued.output_token_ids == [] and len(running.output_token_ids) == 2
    assert list(eng.finished) == [queued, running] and not eng.has_work
    assert eng.num_free_blocks == 31
    a = eng.submit([1, 2], SamplingParams(max_tokens=5))
    eng.step()
    b = eng.submit([3], SamplingParams(max_tokens=5))
    assert eng.abort_all("error") == [a, b]
    assert a.finish_reason == b.finish_reason == "error" and not eng.has_work
    assert eng.telemetry.ttft.snapshot()[2] == 2  # running's and a's first tokens


def test_request_timeout_cancels_the_request(params):
    eng = _tiny_engine(params)
    httpd, aeng = tserver.make_server(
        eng, ByteTokenizer(), tserver.ServerConfig(host="127.0.0.1", port=0,
                                                   request_timeout_s=0.0))
    addr = _start(httpd)
    try:
        status, data = _post(addr, "/v1/completions", {"prompt": "hi", "max_tokens": 20})
        assert status == 500 and "timed out" in data["error"]["message"]
        deadline = time.monotonic() + 30
        while eng.has_work and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not eng.has_work
        assert [r.finish_reason for r in eng.finished] == ["stop"]
        assert len(eng.finished[0].output_token_ids) < 20
    finally:
        httpd.shutdown()
        aeng.shutdown()
        httpd.server_close()


def test_multi_step_server_streams_match_jax(params):
    """Both servers at steps_per_sync=4 (several tokens a window): texts and
    SSE deltas equal the JAX server's, the deltas concatenate to the
    non-streamed text, and ``/metrics`` carries the decode-state counters."""
    from dlti_tpu.data.tokenizer import IdTokenizer as JaxIdTokenizer
    from dlti_tpu_torch.data import IdTokenizer

    ec = dict(EC, cache_dtype="float32", steps_per_sync=4)
    jeng = JaxEngine(JAX_PRESETS["llama_tiny"], jax.tree_util.tree_map(jnp.asarray, params),
                     JaxEngineConfig(**ec))
    teng = InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                           EngineConfig(**ec), device="cpu")
    servers = [jserver.make_server(jeng, JaxIdTokenizer(512),
                                   jserver.ServerConfig(host="127.0.0.1", port=0)),
               tserver.make_server(teng, IdTokenizer(vocab_size=512),
                                   tserver.ServerConfig(host="127.0.0.1", port=0))]
    jaddr, taddr = (_start(httpd) for httpd, _ in servers)
    try:
        for path, body in STREAM_BODIES:
            _, want = _post(jaddr, path, body)
            _, full = _post(taddr, path, body)
            deltas, _ = _stream(taddr, path, body)
            jdeltas, _ = _stream(jaddr, path, body)
            text = (full["choices"][0]["message"]["content"] if "chat" in path
                    else full["choices"][0]["text"])
            assert _without_unported(full)["choices"] == _without_unported(want)["choices"]
            assert deltas == jdeltas and "".join(deltas) == text
        assert teng.stats["decode_steps"] == jeng.stats["decode_steps"]
        metrics = _get(taddr, "/metrics")[1].decode()
        uploads = [ln for ln in metrics.splitlines()
                   if ln.startswith("dlti_decode_state_uploads ")]
        assert uploads and float(uploads[0].split()[1]) > 0
    finally:
        for httpd, async_engine in servers:
            httpd.shutdown()
            async_engine.shutdown()
            httpd.server_close()


def test_serve_cli_flags_reach_the_engine_and_it_warms_up(monkeypatch, capsys):
    """``--steps-per-sync`` and ``--no-decode-state-cache`` reach the
    engine's config (defaults: 1 and the cache on), and ``main`` warms the
    decode path up before it serves, printing the reference's two lines."""
    from dlti_tpu_torch import serving
    from dlti_tpu_torch.cli import serve as cli

    base = ["--device", "cpu", "--random-init", "llama_tiny", "--tokenizer", "byte",
            "--max-model-len", "64", "--num-blocks", "16"]
    engine, _, _ = cli.build(cli.parse_args(base))
    assert (engine.cfg.steps_per_sync, engine.cfg.decode_state_cache) == (1, True)
    served = []
    monkeypatch.setattr(serving, "serve", lambda eng, tok, sc: served.append(eng))
    warmed = []
    real_warmup = InferenceEngine.warmup_decode_ladder
    monkeypatch.setattr(InferenceEngine, "warmup_decode_ladder",
                        lambda self: (warmed.append(self), real_warmup(self)))
    cli.main(base + ["--steps-per-sync", "4", "--no-decode-state-cache"])
    [engine] = served
    assert warmed == [engine]
    assert (engine.cfg.steps_per_sync, engine.cfg.decode_state_cache) == (4, False)
    out = capsys.readouterr().out
    assert "pre-compiling decode programs (single-step + multi-step ladder)..." in out
    assert re.search(r"decode programs ready in \d+s", out)


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_serve_cli_starts_answers_and_exits_on_sigterm(kv):
    """``python -m dlti_tpu_torch.cli.serve`` on the CPU: it prints the port
    it bound, answers /health and a completion, and SIGTERM ends it with
    exit code 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlti_tpu_torch.cli.serve", "--device", "cpu",
         "--random-init", "llama_tiny", "--tokenizer", "byte", "--port", "0",
         "--max-model-len", "128", "--num-blocks", "64", "--kv-cache-dtype", kv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines, port = [], None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
        assert port, "".join(lines)
        addr = ("127.0.0.1", port)
        assert _get(addr, "/health")[:2] == (200, b'{"status": "ok"}')
        status, data = _post(addr, "/v1/completions", {"prompt": "hello", "max_tokens": 4,
                                                       "temperature": 0.0})
        assert status == 200 and data["usage"]["prompt_tokens"] == 6
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
