"""Multi-LoRA serving in the port (``dlti_tpu_torch.serving.adapters``, the
engine's pool, the server's routes, the serve CLI's flags) against the JAX
package's (``llama_tiny``, CPU, shared weights through ``params_from_jax``).

* The adapter checkpoint is byte-identical across the packages, and each
  registers the other's. The catalog and quarantine keep the contracts of
  ``tests/test_adapters.py``'s first eight tests: names, verification,
  corruption at registration and after it, a torn export quarantined whole
  and an ENOSPC export that reclaims the quarantine and lands.
* The pool: its bytes equal the planner's and the JAX pool's; refcounted
  LRU with the reference's counters; a full pinned pool defers; rank and
  targets are checked at acquire.
* The equivalence cells (``tests/torch_adapter_cells.py``), bf16 and int8
  base: a mixed batch of base rows and three adapters on one port engine
  gives the JAX multi-adapter engine's greedy tokens exactly (logprobs
  within 1e-4); greedy and seeded streams equal the port's merged-weights
  engines per adapter (the two packages draw seeded samples differently,
  so seeded streams are held to the reference test's contract: shared base
  = merged weights), and base rows equal an adapter-off engine's tokens and
  logprobs exactly. This file runs them at k 1 and 4;
  ``test_torch_adapters_cells.py`` at k 8 and with prefix caching,
  ``test_torch_adapters_features.py`` with chunked ragged prefill and with
  speculation (split three ways so that no file runs for long alone).
* The engine's admission: preemption and cancel release rows, an unknown
  adapter fails its request alone, prefix-cache keys are namespaced.
* The server: ``/v1/adapters``, ``X-Adapter`` (404 for an unknown name),
  ``/v1/reload``'s 400 and the ``dlti_adapter_*`` series; the serve CLI's
  ``--adapter-slots``, ``--adapter`` and ``--adapter-map``.
"""

import dataclasses
import errno
import http.client
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import adapters as jad
from dlti_tpu_torch.models import merge_lora_params, params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams
from dlti_tpu_torch.serving import adapters as tad
from dlti_tpu_torch.utils import durable_io

from torch_adapter_cells import (  # noqa: F401 (fixtures)
    ALPHA,
    CFG,
    GREEDY,
    JCFG,
    PROMPTS,
    R,
    TARGETS,
    _cell,
    _clean_catalogs,
    _corrupt,
    _ec,
    _files,
    _lora_tree,
    _register,
    _row,
    setup,
)

# ----------------------------------------------------------------------
# Checkpoint format and catalog
# ----------------------------------------------------------------------

def test_extract_and_save_require_lora_factors(setup, tmp_path):
    weights = tad.extract_adapter_weights(setup.flat["ad-a"])
    flat = tad._flatten_lora(weights)
    assert {p[-1] for p in flat} == set(TARGETS)
    assert len(flat) == CFG.num_layers * len(TARGETS)
    with pytest.raises(ValueError, match="no lora"):
        tad.save_adapter(str(tmp_path / "empty"), setup.base)


def test_adapter_checkpoints_are_byte_identical_across_packages(setup, tmp_path):
    jdir = str(tmp_path / "jax")
    jad.save_adapter(jdir, setup.trees["ad-b"], alpha=ALPHA)
    assert _files(jdir) == _files(setup.dirs["ad-b"])
    # each package registers and loads the other's
    jad.register_adapter("from-port", setup.dirs["ad-b"])
    tad.register_adapter("from-jax", jdir)
    assert "from-port" in jad.get_catalog() and "from-jax" in tad.get_catalog()


def test_catalog_register_verifies_and_lists(setup):
    cat = tad.get_catalog()
    assert tad.register_adapter("ad-a", setup.dirs["ad-a"]) == "ad-a"
    tad.register_adapter("ad-b", setup.dirs["ad-b"])
    assert cat.names() == ["ad-a", "ad-b"]
    assert "ad-a" in cat and "ghost" not in cat
    assert cat.directory("ad-a") == os.path.abspath(setup.dirs["ad-a"])
    assert cat.unregister("ad-a") and not cat.unregister("ad-a")
    assert cat.names() == ["ad-b"]
    with pytest.raises(tad.AdapterError, match="unreadable|corrupt"):
        tad.register_adapter("nope", "/does/not/exist")
    assert "nope" not in cat


@pytest.mark.parametrize("bad", ["", "has space", "a/b", "a\\b", "a\nb"])
def test_catalog_rejects_bad_names(setup, bad):
    with pytest.raises(tad.AdapterError, match="invalid adapter name"):
        tad.register_adapter(bad, setup.dirs["ad-a"])


def test_corrupt_checkpoint_quarantined_at_registration(setup, tmp_path):
    d = str(tmp_path / "bad")
    tad.save_adapter(d, setup.flat["ad-a"], alpha=ALPHA)
    _corrupt(d)
    with pytest.raises(tad.AdapterError, match="corrupt"):
        tad.register_adapter("bad", d)
    assert "bad" not in tad.get_catalog()
    qdir = os.path.join(str(tmp_path), "_quarantine")
    assert not os.path.exists(d)
    assert os.path.isdir(qdir) and os.listdir(qdir)


def test_corrupt_after_registration_unregisters_on_load(setup, tmp_path):
    d = str(tmp_path / "rots")
    tad.save_adapter(d, setup.flat["ad-a"], alpha=ALPHA)
    tad.register_adapter("rots", d)
    _corrupt(d)
    pool = tad.AdapterPool(setup.base, num_slots=2, rank=R, targets=TARGETS, device="cpu")
    with pytest.raises(tad.AdapterError, match="corrupt"):
        pool.acquire("rots")
    assert "rots" not in tad.get_catalog()
    assert not pool.resident("rots")
    with pytest.raises(tad.AdapterError, match="unknown adapter"):
        pool.acquire("rots")


@pytest.fixture()
def _no_reclaimers(monkeypatch):
    monkeypatch.setattr(durable_io, "_reclaimers", {})
    monkeypatch.setattr(durable_io, "BACKOFF_S", 0.0)


def _faulty_writes(monkeypatch, kind, count=None):
    """Payload writes (``*.bin``) fail: ``torn`` writes half, then EIO;
    ``ENOSPC`` raises at once. ``count`` limits how many fail."""
    real = durable_io._raw_write_bytes
    left = [count]

    def write(path, data):
        if path.endswith(".bin") and (left[0] is None or left[0] > 0):
            if left[0] is not None:
                left[0] -= 1
            if kind == "torn":
                buf = bytes(memoryview(data))
                with open(path, "wb") as f:
                    f.write(buf[:len(buf) // 2])
                raise OSError(errno.EIO, "torn write")
            raise OSError(errno.ENOSPC, "no space left on device")
        return real(path, data)

    monkeypatch.setattr(durable_io, "_raw_write_bytes", write)
    return lambda: monkeypatch.setattr(durable_io, "_raw_write_bytes", real)


def test_save_adapter_torn_write_quarantines_and_reexport_serves(
        setup, tmp_path, monkeypatch, _no_reclaimers):
    """A torn export (each of the ``adapter`` class's three attempts torn)
    leaves nothing at the target and no staging dir: the partial bytes are
    quarantined whole. A re-export loads rows equal to an unfaulted
    export's."""
    d = str(tmp_path / "ad-t")
    heal = _faulty_writes(monkeypatch, "torn")
    with pytest.raises(OSError):
        tad.save_adapter(d, setup.flat["ad-a"], alpha=ALPHA)
    heal()
    assert not os.path.exists(d)
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]
    qdir = os.path.join(str(tmp_path), "_quarantine")
    assert os.path.isdir(qdir) and os.listdir(qdir)
    tad.save_adapter(d, setup.flat["ad-a"], alpha=ALPHA)
    tad.register_adapter("ad-t", d)
    tad.register_adapter("ad-a", setup.dirs["ad-a"])
    pool = tad.AdapterPool(setup.base, num_slots=2, rank=R, targets=TARGETS, device="cpu")
    row_t, _ = pool.acquire("ad-t")
    row_a, _ = pool.acquire("ad-a")
    for mod, (a, b, s) in _row(pool, row_t).items():
        a2, b2, s2 = _row(pool, row_a)[mod]
        assert torch.equal(a, a2) and torch.equal(b, b2) and torch.equal(s, s2), mod


def test_save_adapter_enospc_reclaims_quarantine_then_lands(
        setup, tmp_path, monkeypatch, _no_reclaimers):
    """ENOSPC mid-export: the reclaim pass empties the quarantine a failed
    save left behind (the quarantine registers itself as reclaimable), and
    the retry lands the export whole."""
    heal = _faulty_writes(monkeypatch, "torn")
    with pytest.raises(OSError):
        tad.save_adapter(str(tmp_path / "ad-bad"), setup.flat["ad-a"], alpha=ALPHA)
    heal()
    qdir = tmp_path / "_quarantine"
    assert list(qdir.iterdir())
    d = str(tmp_path / "ad-ok")
    _faulty_writes(monkeypatch, "ENOSPC", count=1)
    tad.save_adapter(d, setup.flat["ad-a"], alpha=ALPHA)
    assert not qdir.exists() or not list(qdir.iterdir())
    tad.register_adapter("ad-ok", d)  # digest-verified: the export is whole


# ----------------------------------------------------------------------
# Pool
# ----------------------------------------------------------------------

@pytest.mark.parametrize("slots,targets", [(3, TARGETS), (1, ("q_proj", "down_proj"))])
def test_pool_bytes_match_planner_and_jax(setup, slots, targets):
    pool = tad.AdapterPool(setup.base, num_slots=slots, rank=R, targets=targets,
                           device="cpu")
    want = tad.plan_pool_bytes(CFG, targets, R, slots)
    assert pool.nbytes == want == jad.plan_pool_bytes(JCFG, targets, R, slots)
    assert want == jad.AdapterPool(setup.jbase, slots, R, targets).nbytes
    assert tad.pool_bytes_gauge.value == want and tad.pool_slots_gauge.value == slots
    with pytest.raises(ValueError, match="unknown adapter target"):
        tad.plan_pool_bytes(CFG, ("bogus",), R, 2)


def test_pool_rows_equal_the_jax_pool_rows(setup):
    _register(setup.dirs)
    tpool = tad.AdapterPool(setup.base, num_slots=2, rank=R + 2, targets=TARGETS,
                            device="cpu")
    jpool = jad.AdapterPool(setup.jbase, 2, R + 2, TARGETS)
    for name in ("ad-b", "ad-c"):
        (trow, _), (jrow, _) = tpool.acquire(name), jpool.acquire(name)
        assert trow == jrow
        got = _row(tpool, trow)
        jflat = params_from_jax(jax.tree_util.tree_map(lambda x: np.asarray(x[jrow]),
                                                       jpool.tree))
        for mod, (a, b, s) in got.items():
            assert torch.equal(a, jflat[f"{mod}.a"]) and torch.equal(b, jflat[f"{mod}.b"])
            assert torch.equal(s, jflat[f"{mod}.s"].reshape(()))


def test_pool_load_evict_reload_byte_equality(setup):
    _register(setup.dirs)
    pool = tad.AdapterPool(setup.base, num_slots=2, rank=R, targets=TARGETS, device="cpu")
    m0 = [m.value for m in tad.METRICS[:4]]
    row_a, loaded = pool.acquire("ad-a")
    assert (row_a, loaded) == (1, True)
    snap_a = _row(pool, row_a)
    assert pool.acquire("ad-a") == (1, False)  # hit, refcount 2
    pool.release(row_a), pool.release(row_a)
    row_b, loaded = pool.acquire("ad-b")
    assert (row_b, loaded) == (2, True)
    pool.release(row_b)
    row_c, loaded = pool.acquire("ad-c")  # evicts the LRU, ad-a
    assert loaded and row_c == 1
    assert not pool.resident("ad-a") and pool.resident("ad-c")
    pool.release(row_c)
    row_a2, loaded = pool.acquire("ad-a")
    assert loaded
    for mod, abs_ in _row(pool, row_a2).items():
        assert all(torch.equal(x, y) for x, y in zip(abs_, snap_a[mod])), mod
    assert pool.loaded_names() == ["ad-a", "ad-c"]
    assert [m.value - v for m, v in zip(tad.METRICS[:4], m0)] == [4, 2, 1, 4]


def test_pool_full_of_pinned_rows_defers(setup):
    _register(setup.dirs, ("ad-a", "ad-b"))
    pool = tad.AdapterPool(setup.base, num_slots=1, rank=R, targets=TARGETS, device="cpu")
    row, _ = pool.acquire("ad-a")
    assert pool.acquire("ad-b") == (-1, False)
    pool.release(row)
    row_b, loaded = pool.acquire("ad-b")
    assert loaded and row_b == row
    assert not pool.resident("ad-a")


def test_pool_rejects_incompatible_adapters(setup):
    _register(setup.dirs, ("ad-a",))
    pool = tad.AdapterPool(setup.base, num_slots=2, rank=R - 2, targets=TARGETS, device="cpu")
    with pytest.raises(tad.AdapterError, match="exceeds the pool rank"):
        pool.acquire("ad-a")
    assert "ad-a" not in tad.get_catalog()
    tad.register_adapter("ad-b", setup.dirs["ad-b"])
    narrow = tad.AdapterPool(setup.base, num_slots=2, rank=R, targets=("q_proj",),
                             device="cpu")
    with pytest.raises(tad.AdapterError, match="outside this pool"):
        narrow.acquire("ad-b")
    with pytest.raises(ValueError, match="unknown adapter target"):
        tad.AdapterPool(setup.base, num_slots=2, rank=R, targets=("qproj",), device="cpu")


# ----------------------------------------------------------------------
# The equivalence cells at k 1 and 4
# ----------------------------------------------------------------------

CONFIGS = ('k1', 'k4')


@pytest.mark.parametrize("config", CONFIGS)
def test_batched_adapters_match_merged_engines_bf16(setup, config):
    """bf16 base weights (float32 compute), three adapters and base rows in
    one batch."""
    _cell(setup, "bf16", config)


@pytest.mark.parametrize("config", CONFIGS)
def test_batched_adapters_match_merged_engines_int8(setup, config):
    """int8 base weights: both engines quantize the same base onto one grid;
    the adapter delta rides outside it."""
    _cell(setup, "int8", config)


# ----------------------------------------------------------------------
# Admission
# ----------------------------------------------------------------------

def test_unknown_adapter_fails_its_request_alone(setup):
    _register(setup.dirs, ("ad-a",))
    eng = InferenceEngine(CFG, setup.base, EngineConfig(adapter_slots=1, adapter_rank=R,
                                                        **_ec()), device="cpu")
    sp = SamplingParams(**GREEDY)
    bad = eng.submit(PROMPTS[0], sp, adapter="ghost")
    good = eng.submit(PROMPTS[1], sp, adapter="ad-a")
    base = eng.submit(PROMPTS[2], sp)
    while eng.has_work:
        eng.step()
    assert bad.finish_reason == "error" and not bad.output_token_ids
    assert good.finish_reason == base.finish_reason == "length"
    off = InferenceEngine(CFG, setup.base, EngineConfig(**_ec()), device="cpu")
    nopool = off.submit(PROMPTS[0], sp, adapter="ad-a")
    while off.has_work:
        off.step()
    assert nopool.finish_reason == "error"


def test_preemption_and_cancel_release_pool_rows(setup):
    """A pool of two rows for three adapters and a KV pool small enough to
    preempt: every row is released at finish, preemption and cancel, the
    deferred adapter runs once a row frees, and every stream equals its
    merged engine's."""
    _register(setup.dirs)
    ec = _ec(max_seqs=3, num_blocks=12, max_model_len=48)
    eng = InferenceEngine(CFG, setup.base, EngineConfig(adapter_slots=2, adapter_rank=R, **ec),
                          device="cpu")
    sp = SamplingParams(temperature=0.0, max_tokens=36)
    cancelled = eng.submit(PROMPTS[3], sp, adapter="ad-b")
    cancelled.cancel_requested = True
    reqs = [eng.submit(PROMPTS[i], sp, adapter=a)
            for i, a in [(0, "ad-a"), (1, "ad-b"), (2, "ad-c"), (4, "")]]
    eng.step()
    assert reqs[2].admitted_time is None  # every row pinned: deferred
    while eng.has_work:
        eng.step()
    assert cancelled.finish_reason == "stop" and not cancelled.output_token_ids
    assert eng.stats["preemptions"] > 0
    assert all(r.finish_reason == "length" for r in reqs)
    assert eng.adapter_pool._refs == [0, 0, 0]
    assert not eng._adapter_ids.any()
    for req in reqs:
        tree = setup.flat[req.adapter] if req.adapter else None
        params = merge_lora_params(tree, alpha=int(ALPHA)) if tree else setup.base
        want = InferenceEngine(CFG, params, EngineConfig(**ec), device="cpu").generate(
            [req.prompt_token_ids], sp)[0]
        assert req.output_token_ids == want.output_token_ids, req.adapter


def test_prefix_cache_keys_are_namespaced_by_adapter(setup):
    _register(setup.dirs, ("ad-a",))
    eng = InferenceEngine(CFG, setup.base, EngineConfig(
        adapter_slots=1, adapter_rank=R, enable_prefix_caching=True, **_ec()), device="cpu")
    sp = SamplingParams(temperature=0.0, max_tokens=4)
    prompt = list(range(1, 30))
    for adapter in ("", "ad-a", "ad-a", ""):
        before = eng.stats["prefix_cached_tokens"]
        req = eng.submit(prompt, sp, adapter=adapter)
        while eng.has_work:
            eng.step()
        hit = eng.stats["prefix_cached_tokens"] - before
        # the first request in each namespace misses, the second hits
        assert (hit == 0) == (req.request_id in ("req-0", "req-1")), (adapter, hit)


# ----------------------------------------------------------------------
# Server and CLI
# ----------------------------------------------------------------------

def _request(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_server_adapter_routes_reload_and_metrics(setup, tmp_path):
    from dlti_tpu_torch.data import ByteTokenizer
    from dlti_tpu_torch.serving import ServerConfig, make_server

    tad.register_adapter("ad-a", setup.dirs["ad-a"])
    eng = InferenceEngine(CFG, setup.base, EngineConfig(
        adapter_slots=2, adapter_rank=R, **_ec(max_model_len=128, eos_token_id=2)),
        device="cpu")
    httpd, aeng = make_server(eng, ByteTokenizer(), ServerConfig(host="127.0.0.1", port=0))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    addr = httpd.server_address[:2]
    try:
        assert json.loads(_request(addr, "GET", "/v1/adapters")[1])["data"] == ["ad-a"]
        assert _request(addr, "POST", "/v1/adapters", {"name": "ad-b"})[0] == 400
        status, data = _request(addr, "POST", "/v1/adapters",
                                {"name": "ad-b", "directory": str(tmp_path / "none")})
        assert status == 400 and b"unreadable" in data
        status, data = _request(addr, "POST", "/v1/adapters",
                                {"name": "ad-b", "directory": setup.dirs["ad-b"]})
        assert status == 200 and json.loads(data)["name"] == "ad-b"
        assert json.loads(_request(addr, "GET", "/v1/adapters")[1])["data"] == ["ad-a", "ad-b"]
        body = {"prompt": "abc", "max_tokens": 8, "temperature": 0.0, "logprobs": True}
        outs = {}
        for name in ("", "ad-a", "ad-b"):
            status, data = _request(addr, "POST", "/v1/completions", body,
                                    {"X-Adapter": name} if name else None)
            assert status == 200, data
            outs[name] = json.loads(data)["choices"][0]["logprobs"]["tokens"]
        status, data = _request(addr, "POST", "/v1/completions", body, {"X-Adapter": "ghost"})
        assert status == 404 and b"unknown adapter" in data
        for path_body, code in (({}, 400), ({"directory": str(tmp_path)}, 400),
                                ({"directory": setup.dirs["ad-a"]}, 400)):
            status, data = _request(addr, "POST", "/v1/reload", path_body)
            assert status == code, data
        assert b"replica lifecycle" in data
        metrics = _request(addr, "GET", "/metrics")[1].decode()
        for name in tad.ADAPTER_METRIC_NAMES:
            assert f"\n{name} " in metrics, name
        assert f"dlti_adapter_pool_bytes {float(eng.adapter_pool.nbytes)}" in metrics \
            or f"dlti_adapter_pool_bytes {eng.adapter_pool.nbytes}" in metrics
    finally:
        httpd.shutdown()
        aeng.shutdown()
        httpd.server_close()
    ids = ByteTokenizer().encode("abc", add_bos=True)
    sp = SamplingParams(temperature=0.0, max_tokens=8)
    for name, tokens in outs.items():
        params = merge_lora_params(setup.flat[name], alpha=int(ALPHA)) if name else setup.base
        want = InferenceEngine(CFG, params, EngineConfig(**_ec(max_model_len=128, eos_token_id=2)),
                               device="cpu").generate([ids], sp)[0]
        assert tokens == want.output_token_ids, name
    assert tad.ADAPTER_METRIC_NAMES == jad.ADAPTER_METRIC_NAMES


def test_serve_cli_adapter_flags(setup):
    from dlti_tpu_torch.cli import serve

    common = ["--device", "cpu", "--random-init", "llama_tiny", "--tokenizer", "byte",
              "--port", "0", "--max-model-len", "64", "--num-blocks", "32"]
    with pytest.raises(SystemExit, match="--adapter-slots > 0"):
        serve.build(serve.parse_args(common + ["--adapter", f"a={setup.dirs['ad-a']}"]))
    with pytest.raises(SystemExit, match="gateway"):
        serve.build(serve.parse_args(common + ["--adapter-map", "acme:a"]))
    with pytest.raises(SystemExit, match="NAME=DIR"):
        serve.build(serve.parse_args(common + ["--adapter-slots", "2", "--adapter", "a"]))
    engine, _, _ = serve.build(serve.parse_args(common + [
        "--adapter-slots", "2", "--adapter-rank", "8",
        "--adapter", f"A={setup.dirs['ad-a']}", "--adapter", f"B={setup.dirs['ad-b']}"]))
    assert tad.get_catalog().names() == ["A", "B"]
    assert engine.adapter_pool.rank == 8 and engine.adapter_pool.num_slots == 2
    assert engine.cfg.adapter_targets == JaxEngineConfig().adapter_targets
    assert (EngineConfig().adapter_slots, EngineConfig().adapter_rank) == (
        JaxEngineConfig().adapter_slots, JaxEngineConfig().adapter_rank)


def test_adapter_off_engine_has_no_pool_and_no_field():
    eng = InferenceEngine(CFG, merge_lora_params(params_from_jax(_lora_tree(1))),
                          EngineConfig(**_ec()), device="cpu")
    assert eng.adapter_pool is None
    assert "adapter_ids" not in eng.executor.state.fields
    on = dataclasses.replace(EngineConfig(**_ec()), adapter_slots=1)
    from dlti_tpu_torch.serving.engine import decode_mirrors

    assert list(decode_mirrors(on))[6] == "adapter_ids"
