"""The port's load generator and traces (``dlti_tpu_torch.benchmarks``)
against the JAX package's (``dlti_tpu.benchmarks``).

* **Traces.** ``synthesize`` gives the same events for every generator and
  seed, ``write_trace`` the same bytes, each package reads the other's file,
  and ``trace_summary`` agrees.
* **Loadgen.** With one seed the two ``run_load_test`` send the same request
  bodies to the port's CPU server (``llama_tiny``, byte tokenizer, prefix
  caching and n-gram speculation on) and report the same ok/failed counts,
  output token counts and report keys; the scrapes of routes the port's
  server lacks (``/debug/*``, the fleet series) leave their sections empty
  and count no failed request. The port's loadgen also drives the JAX
  ``make_server``. The CLI runs as a subprocess.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlti_tpu.benchmarks import loadgen as jloadgen
from dlti_tpu.benchmarks import traces as jtraces
from dlti_tpu.config import MODEL_PRESETS as JAX_PRESETS
from dlti_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu.serving import server as jserver
from dlti_tpu_torch.benchmarks import loadgen as tloadgen
from dlti_tpu_torch.benchmarks import traces as ttraces
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.data import ByteTokenizer
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams
from dlti_tpu_torch.serving import server as tserver

ROOT = Path(__file__).resolve().parents[1]
EC = dict(max_seqs=4, block_size=8, num_blocks=256, max_model_len=256,
          eos_token_id=-1, cache_dtype="float32", enable_prefix_caching=True,
          speculative="ngram", max_prefill_tokens_per_step=32)

# ----------------------------------------------------------------------
# Traces
# ----------------------------------------------------------------------

TRACE_CASES = [
    ("poisson", dict()),
    ("poisson", dict(session_frac=0.5, adapters=("a", "b"), adapter_frac=0.3,
                     deadline_s=2.5)),
    ("diurnal", dict(tenants=3, zipf_alpha=1.5)),
    ("flash_crowd", dict(flash_factor=4.0, interactive_frac=0.5)),
]


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("generator,kw", TRACE_CASES,
                         ids=[f"{g}-{i}" for i, (g, _) in enumerate(TRACE_CASES)])
def test_synthesize_matches_jax_event_for_event(generator, kw, seed):
    want_meta, want = jtraces.synthesize(generator, duration_s=20.0, rate=3.0,
                                         seed=seed, **kw)
    got_meta, got = ttraces.synthesize(generator, duration_s=20.0, rate=3.0,
                                       seed=seed, **kw)
    assert got_meta == want_meta
    assert len(got) == len(want) > 0
    assert [dataclasses.asdict(e) for e in got] == [dataclasses.asdict(e) for e in want]
    assert ttraces.trace_summary(got) == jtraces.trace_summary(want)


@pytest.mark.parametrize("generator", list(jtraces.GENERATORS))
def test_write_trace_bytes_equal_and_each_reads_the_other(tmp_path, generator):
    assert ttraces.GENERATORS == jtraces.GENERATORS
    assert ttraces.TRACE_FORMAT == jtraces.TRACE_FORMAT
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    jmeta, jevents = jtraces.synthesize(generator, seed=3, duration_s=10.0)
    tmeta, tevents = ttraces.synthesize(generator, seed=3, duration_s=10.0)
    jtraces.write_trace(str(jpath), jevents, jmeta)
    ttraces.write_trace(str(tpath), tevents, tmeta)
    assert tpath.read_bytes() == jpath.read_bytes()
    jh, jev = jtraces.read_trace(str(tpath))
    th, tev = ttraces.read_trace(str(jpath))
    assert th == jh
    assert [dataclasses.asdict(e) for e in tev] == [dataclasses.asdict(e) for e in jev]


def test_trace_cli_writes_the_jax_file(tmp_path):
    flags = ["--generator", "flash_crowd", "--seed", "5", "--duration-s", "30",
             "--session-frac", "0.25"]
    outs, summaries = [], []
    for mod, name in (("dlti_tpu_torch.benchmarks.traces", "torch"),
                      ("dlti_tpu.benchmarks.traces", "jax")):
        out = tmp_path / f"{name}.jsonl"
        proc = subprocess.run([sys.executable, "-m", mod, "--out", str(out), *flags],
                              cwd=ROOT, capture_output=True, text=True, timeout=120,
                              env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(out.read_bytes())
        summaries.append({k: v for k, v in json.loads(proc.stdout).items() if k != "out"})
    assert outs[0] == outs[1] and outs[0]
    assert summaries[0] == summaries[1]


# ----------------------------------------------------------------------
# Loadgen against a live server
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    cfg = JAX_PRESETS["llama_tiny"]
    tree = JaxLlama(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]


@pytest.fixture(scope="module")
def servers(params):
    """{"torch": port, "jax": port}: each package's server on the same
    weights and engine configuration."""
    teng = InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                           EngineConfig(**EC), device="cpu")
    thttpd, tasync = tserver.make_server(
        teng, ByteTokenizer(), tserver.ServerConfig(
            host="127.0.0.1", port=0, default_params=SamplingParams(max_tokens=8)))
    jeng = JaxEngine(JAX_PRESETS["llama_tiny"], jax.tree_util.tree_map(jnp.asarray, params),
                     JaxEngineConfig(**EC))
    jhttpd, jasync = jserver.make_server(
        jeng, JaxByteTokenizer(), jserver.ServerConfig(
            host="127.0.0.1", port=0, default_params=JaxSamplingParams(max_tokens=8)))
    yield {"torch": _start(thttpd), "jax": _start(jhttpd)}
    for httpd, async_engine in ((thttpd, tasync), (jhttpd, jasync)):
        httpd.shutdown()
        async_engine.shutdown()
        httpd.server_close()
        sampler = getattr(httpd, "sampler", None)
        if sampler is not None:
            sampler.stop()


def _run(module, monkeypatch, **kw):
    """``module.run_load_test`` with every request body it posts recorded."""
    bodies = []
    orig = module._http_post_sse

    async def recording(host, port, path, body, *a, **k):
        bodies.append(json.dumps(body, sort_keys=True))
        return await orig(host, port, path, body, *a, **k)

    monkeypatch.setattr(module, "_http_post_sse", recording)
    report = module.run_load_test(module.LoadGenConfig(**kw))
    monkeypatch.setattr(module, "_http_post_sse", orig)
    return report, sorted(bodies)


LOAD_CASES = {
    "closed_loop": dict(num_requests=8, concurrency=4, max_tokens=8),
    "sessions": dict(sessions=3, turns=3, max_tokens=6, concurrency=3),
    "long_prompts": dict(num_requests=8, qps=40.0, max_tokens=6, long_prompt_frac=0.5,
                         long_prompt_tokens=96, scrape_server_metrics=True),
}


@pytest.mark.parametrize("case", list(LOAD_CASES))
def test_port_loadgen_matches_jax_loadgen_against_the_port_server(servers, monkeypatch,
                                                                  case):
    kw = dict(port=servers["torch"], seed=0, timeout_s=120.0, **LOAD_CASES[case])
    want, want_bodies = _run(jloadgen, monkeypatch, **kw)
    got, got_bodies = _run(tloadgen, monkeypatch, **kw)
    assert got_bodies == want_bodies and got_bodies
    assert (got.num_requests, got.num_ok) == (want.num_requests, want.num_ok)
    assert got.num_ok == got.num_requests and not got.errors, got.errors
    assert sorted(r.output_tokens for r in got.records) == \
        sorted(r.output_tokens for r in want.records)
    d = got.to_dict()
    assert set(d) == set(want.to_dict())
    # Routes the port's server lacks (/debug/slo, a fleet) or answers 404
    # (/debug/trace with tracing off): empty sections, no failure counted.
    # /debug/vars and /debug/memory answer: the memory map as the JAX
    # loadgen reads it from the same server.
    for key in ("watchdog_alerts", "slo", "fleet_federation"):
        assert d[key] == {}, key
    assert d["trace_coverage"] == 0.0
    wmem = want.to_dict()["memory"]
    assert set(d["memory"]) == set(wmem) and d["memory"]["owners"] == wmem["owners"]
    assert d["memory"]["bytes_in_use"] > 0 and d["memory"]["source"] == "owners"
    if case == "sessions":
        assert got.num_warm > 0 and got.cache_hit_rate > 0
    if case == "long_prompts":
        # The spec series came from /metrics, and the histograms too.
        assert set(d["spec"]) == set(want.to_dict()["spec"]) and d["spec"]
        assert d["server_histograms"]


def test_port_loadgen_drives_the_jax_server(servers, monkeypatch):
    kw = dict(seed=0, timeout_s=120.0, **LOAD_CASES["sessions"])
    on_jax, jax_bodies = _run(tloadgen, monkeypatch, port=servers["jax"], **kw)
    on_port, port_bodies = _run(tloadgen, monkeypatch, port=servers["torch"], **kw)
    assert jax_bodies == port_bodies
    assert on_jax.num_ok == on_jax.num_requests == 9 and not on_jax.errors
    assert sorted(r.output_tokens for r in on_jax.records) == \
        sorted(r.output_tokens for r in on_port.records)
    assert on_jax.cache_hit_rate > 0 and on_port.cache_hit_rate > 0


def test_benchmark_serving_cli_subprocess(servers, tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "dlti_tpu_torch.cli.benchmark_serving",
         "--port", str(servers["torch"]), "--num-requests", "8", "--concurrency", "4",
         "--max-tokens", "8", "--json-out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(out.read_text())
    assert report["num_requests"] == report["num_ok"] == 8 and not report["errors"]
    assert f"report -> {out}" in proc.stdout
