"""The port's device-memory ledger (``dlti_tpu_torch.telemetry.memledger``)
against the JAX package's: conservation on the CPU, the engine's owners'
bytes against the JAX engine's on the same configuration, and
headroom-aware admission on the same injected snapshots (``llama_tiny``,
float32 and int8 pools, CPU). Bytes are integers: owners must be equal,
and buckets must sum to ``bytes_in_use`` exactly.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlti_tpu.config import MODEL_PRESETS as JAX_PRESETS
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu.telemetry import memledger as jml
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams
from dlti_tpu_torch.telemetry import memledger as tml
from torch_fleet_cells import seeded_params

CFG = MODEL_PRESETS["llama_tiny"]
JCFG = JAX_PRESETS["llama_tiny"]


def _sums_exactly(snap):
    assert sum(snap["buckets"].values()) == snap["bytes_in_use"], snap["buckets"]


# ----------------------------------------------------------------------
# The ledger alone
# ----------------------------------------------------------------------

def test_conservation_with_owners_aliases_and_a_carve():
    shared = torch.zeros(100, dtype=torch.float32)
    mod = torch.nn.Linear(4, 3)  # 12 + 3 float32
    led = tml.MemoryLedger(capacity_bytes=10_000)
    led.register("params", mod)
    led.register("kv_block_pool", {"k": shared, "v": [torch.zeros(50, dtype=torch.int8)]})
    led.register("decode_state_cache", lambda: (shared, torch.zeros(2, dtype=torch.int64)))
    led.register_carve("prefix_cache_hbm", "kv_block_pool", lambda: 120)
    led.register_carve("ghost", "no_such_parent", lambda: 5)
    snap = led.snapshot()
    _sums_exactly(snap)
    assert snap["source"] == "owners" and snap["untracked_bytes"] == snap["residual_bytes"] == 0
    assert snap["owners"]["params"]["bytes"] == 15 * 4
    # The aliased tensor counts once, for the owner registered first.
    assert snap["owners"]["kv_block_pool"]["bytes"] == 400 + 50 - 120
    assert snap["owners"]["prefix_cache_hbm"] == {"bytes": 120, "per_device": {},
                                                  "carved_from": "kv_block_pool"}
    assert snap["owners"]["decode_state_cache"]["bytes"] == 16
    assert snap["bytes_in_use"] == 60 + 450 + 16
    assert snap["headroom_bytes"] == 10_000 - snap["bytes_in_use"]
    led.unregister("params")
    assert led.owners() == ["decode_state_cache", "kv_block_pool"]
    after = led.snapshot()
    assert after["peak_bytes"] == snap["bytes_in_use"] > after["bytes_in_use"]
    assert "params" not in after["owner_peak_bytes"]


def test_disabled_ledger_is_inert_and_unknown_capacity_gates_nothing():
    off = tml.MemoryLedger(enabled=False)
    off.register("params", torch.zeros(4))
    assert off.snapshot() == {} and off.scalars() == {} and off.to_dict() == {}
    assert off.headroom_bytes() is None and off.owners() == []
    led = tml.MemoryLedger()
    led.register("params", torch.zeros(4))
    assert led.snapshot()["headroom_bytes"] is None and led.headroom_bytes() is None


def test_balloon_inflates_and_deflates_what_the_ledger_sees():
    led = tml.MemoryLedger(capacity_bytes=1 << 20)
    led.register("params", torch.zeros(1000))
    base = led.headroom_bytes()
    balloon = tml.MemoryBalloon(led)
    assert balloon.inflate(4000) == 4000 and balloon.inflate(8000) == 12000
    snap = led.snapshot()
    _sums_exactly(snap)
    assert snap["owners"]["chaos_balloon"]["bytes"] == 12000
    assert led.headroom_bytes() == base - 12000
    balloon.deflate()
    assert "chaos_balloon" not in led.snapshot()["owners"] and led.headroom_bytes() == base


def test_scalars_and_to_dict():
    led = tml.MemoryLedger(capacity_bytes=4096)
    t = torch.ones(64)
    led.register("params", t)
    untracked = torch.ones(333)  # held here, owned by no one
    sc = led.scalars()
    assert sc["hbm_bytes_in_use"] == sc["hbm_tracked_bytes"] == 256
    assert sc["hbm_headroom_bytes"] == 4096 - 256
    assert sc["hbm_headroom_frac"] == round((4096 - 256) / 4096, 6)
    assert sc["hbm_owner_params_bytes"] == 256
    assert tml.hbm_bytes_gauge.labels(owner="params").value == 256
    assert tml.hbm_headroom_gauge.value == 4096 - 256
    d = led.to_dict(top_k=4)
    assert "ts" in d and len(d["top_untracked_tensors"]) <= 4
    assert all(e["nbytes"] >= 0 and "shape" in e for e in d["top_untracked_tensors"])
    # The owned tensor is never listed as untracked.
    assert {"shape": [64], "dtype": "float32", "nbytes": 256,
            "per_device": {"cpu": 256}} not in d["top_untracked_tensors"]
    del untracked
    gc.collect()


def test_tree_nbytes_and_oom_classification_match_jax():
    tree = {"a": torch.zeros(3, 4), "b": [torch.zeros(5, dtype=torch.int8), None],
            "c": (torch.zeros(2, dtype=torch.float16),)}
    assert tml.tree_nbytes(tree) == 48 + 5 + 4
    assert tml.tree_nbytes(tree) == jml.tree_nbytes(
        jax.tree_util.tree_map(jnp.asarray, {"a": np.zeros((3, 4), np.float32),
                                             "b": [np.zeros(5, np.int8)],
                                             "c": (np.zeros(2, np.float16),)}))
    excs = [MemoryError(), RuntimeError("CUDA out of memory. Tried to allocate 2 GiB"),
            RuntimeError("RESOURCE_EXHAUSTED: while allocating"), ValueError("bad value"),
            RuntimeError("Allocation failure on device"), KeyError("out_of_memory")]
    assert [tml.is_oom_error(e) for e in excs] == [jml.is_oom_error(e) for e in excs]
    assert tml.is_oom_error(torch.OutOfMemoryError("x"))
    assert tml.MEMORY_OWNERS == jml.MEMORY_OWNERS
    assert tml.MEMLEDGER_METRIC_NAMES == jml.MEMLEDGER_METRIC_NAMES


def test_a_cpu_ledger_refuses_to_read_a_card_it_does_not_have():
    """(The card's side is tests/test_torch_cuda.py's ledger tests.)"""
    with pytest.raises(ValueError, match="CUDA device"):
        tml.device_memory(torch.device("cpu"))



# ----------------------------------------------------------------------
# The engine's owners against the JAX engine's
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return seeded_params()


def _pair(params, **kw):
    ec = dict(max_seqs=3, block_size=8, num_blocks=40, max_model_len=64,
              cache_dtype="float32", eos_token_id=-1)
    ec.update(kw)
    jeng = JaxEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, params), JaxEngineConfig(**ec))
    teng = InferenceEngine(CFG, params_from_jax(params), EngineConfig(**ec), device="cpu")
    return jeng, teng


PROMPTS = [list(range(1, 20)), list(range(30, 41)), [5, 6, 7]]


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_engine_owner_bytes_equal_jax(params, kv):
    jeng, teng = _pair(params, cache_dtype=kv, enable_prefix_caching=True, steps_per_sync=2)
    jeng.generate(PROMPTS, JaxSamplingParams(temperature=0.0, max_tokens=6))
    teng.generate(PROMPTS, SamplingParams(temperature=0.0, max_tokens=6))
    want = jeng.memledger.snapshot()["owners"]
    snap = teng.memledger.snapshot()
    got = snap["owners"]
    for owner in ("params", "decode_state_cache"):
        assert got[owner]["bytes"] == want[owner]["bytes"], owner
    # The carve: the reference's calls num_cached_blocks, a property, so its
    # ledger swallows a TypeError and moves 0 bytes (dlti_tpu/serving/
    # engine.py:1062); the port moves what the cached blocks hold. The pool
    # and the carve together are the reference's pool.
    assert want["prefix_cache_hbm"]["bytes"] == 0
    per_block = (want["kv_block_pool"]["bytes"] + want["prefix_cache_hbm"]["bytes"]) // 40
    cached = teng.prefix_cache.num_cached_blocks
    assert cached == jeng.prefix_cache.num_cached_blocks > 0
    assert got["prefix_cache_hbm"] == {"bytes": cached * per_block, "per_device": {},
                                       "carved_from": "kv_block_pool"}
    assert (got["kv_block_pool"]["bytes"] + got["prefix_cache_hbm"]["bytes"]
            == want["kv_block_pool"]["bytes"] + want["prefix_cache_hbm"]["bytes"])
    assert got["lora_adapters"]["bytes"] == 0
    _sums_exactly(snap)
    # The owners as counted from the shapes.
    assert got["params"]["bytes"] == sum(p.numel() * p.element_size()
                                         for p in teng.model.parameters())
    pool = sum(t.numel() * t.element_size() for layer in teng.cache for t in layer.values())
    assert got["kv_block_pool"]["bytes"] + got["prefix_cache_hbm"]["bytes"] == pool


class _Injected:
    """Both ledgers' snapshot: low headroom for the first ``low`` calls."""

    def __init__(self, low):
        self.low, self.calls = low, 0

    def __call__(self, top_k=0):
        self.calls += 1
        return {"capacity_bytes": 1000,
                "headroom_bytes": 10 if self.calls <= self.low else 900}


def _squeezed(engine, sp, injected):
    engine.memledger.snapshot = injected
    reqs = [engine.submit(p, sp) for p in PROMPTS + [[9, 9, 9, 9]]]
    trail = []
    while engine.has_work:
        engine.step()
        trail.append((engine.stats["hbm_deferred_admissions"], engine.num_active,
                      len(engine.waiting)))
    return (trail, [r.request_id for r in engine.finished], injected.calls,
            [r.finish_reason for r in reqs], [r.output_token_ids for r in reqs])


@pytest.mark.parametrize("k", [1, 4])
def test_headroom_admission_defers_the_same_passes_as_jax(params, k):
    jeng, teng = _pair(params, steps_per_sync=k, admit_min_headroom_frac=0.5)
    want = _squeezed(jeng, JaxSamplingParams(temperature=0.0, max_tokens=5), _Injected(3))
    got = _squeezed(teng, SamplingParams(temperature=0.0, max_tokens=5), _Injected(3))
    assert got == want
    trail, _, _, reasons, _ = got
    assert trail[0][:2] == (1, 0) and trail[2][0] == 3  # deferred, nothing admitted
    assert "error" not in reasons and set(reasons) == {"length"}


def test_a_real_balloon_defers_then_every_request_finishes(params):
    """The squeeze drill on the port's own CPU ledger: a budget, a balloon
    that leaves under half of it free, requests that wait, then deflate."""
    _, teng = _pair(params, admit_min_headroom_frac=0.5)
    in_use = teng.memledger.snapshot()["bytes_in_use"]
    teng.memledger.set_capacity(4 * in_use)
    balloon = tml.MemoryBalloon(teng.memledger)
    balloon.inflate(2 * in_use + 4096)
    reqs = [teng.submit(p, SamplingParams(temperature=0.0, max_tokens=4)) for p in PROMPTS]
    for _ in range(3):
        teng.step()
    assert teng.stats["hbm_deferred_admissions"] == 3 and teng.num_active == 0
    assert len(teng.waiting) == 3
    balloon.deflate()
    while teng.has_work:
        teng.step()
    assert [r.finish_reason for r in reqs] == ["length"] * 3
    assert teng.stats["hbm_deferred_admissions"] == 3
