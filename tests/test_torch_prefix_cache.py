"""Prefix caching with host and disk tiers, chunked prefill and ragged
prefill in the port (``dlti_tpu_torch.serving``), against the JAX package
on the same weights (``llama_tiny``, float32, CPU).

* ``PrefixCachingAllocator`` driven by one seeded op sequence gives the same
  block ids, hits, evictions, demotions and restores in both packages.
* The engine with prefix caching gives the JAX engine's tokens, logprobs
  (within 1e-5) and ``prefix_cached_tokens``; with host and disk tiers the
  same ``prefix_restored_tokens``, the same disk block names
  (``block-<key_digest>``), and a corrupted disk block is quarantined as in
  JAX and reads as a miss.
* Chunked prefill (``max_prefill_tokens_per_step=16``) equals the JAX
  engine; ragged prefill equals the JAX engine's ragged-OFF output in fewer
  ``prefill_batches``, and equals the port's own ragged-off output byte for
  byte (the contract of
  ``tests/test_spec_production.py::test_ragged_prefill_byte_identical_with_fewer_batches``).
* ``fetch_block_kv`` -> ``restore_block`` round-trips bit-equal on every
  pool dtype, with the JAX payload keys.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlti_tpu.config import MODEL_PRESETS as JAX_PRESETS
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu.serving import block_manager as jbm
from dlti_tpu.serving import prefix_cache as jpc
from dlti_tpu.serving import prefix_tiers as jtiers
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams
from dlti_tpu_torch.serving import block_manager as tbm
from dlti_tpu_torch.serving import prefix_cache as tpc
from dlti_tpu_torch.serving import prefix_tiers as ttiers
from dlti_tpu_torch.serving.engine import EngineExecutor

LOGPROB_ATOL = 1e-5


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


def _engines(params, **ec):
    base = dict(block_size=8, cache_dtype="float32", eos_token_id=-1)
    base.update(ec)
    jeng = JaxEngine(JAX_PRESETS["llama_tiny"], jax.tree_util.tree_map(jnp.asarray, params),
                     JaxEngineConfig(**base))
    teng = InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                           EngineConfig(**base), device="cpu")
    return jeng, teng


def _drive(engine, sp_cls, waves, max_tokens=6):
    """Submit each wave of prompts, drain, and return every request."""
    reqs = []
    for wave in waves:
        reqs += [engine.submit(p, sp_cls(temperature=0.0, max_tokens=max_tokens))
                 for p in wave]
        while engine.has_work:
            engine.step()
    return reqs


def _same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.output_token_ids == w.output_token_ids, g.request_id
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                   atol=LOGPROB_ATOL, rtol=0)


# ----------------------------------------------------------------------
# The allocator
# ----------------------------------------------------------------------

def _payload(pkg: str, block: int):
    a = np.full((4, 2, 3), block, np.float32)
    return {"l00000": {"k": a if pkg == "jax" else torch.from_numpy(a.copy()),
                       "v": -a if pkg == "jax" else torch.from_numpy(-a)}}


@pytest.mark.parametrize("host_blocks", [0, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_op_sequence_matches_jax(seed, host_blocks):
    """Admissions, retirements and evictions in a seeded order: every
    return value, stat and LRU/tier state agrees step by step."""
    allocs = {}
    for pkg, bm, pc, tiers in (("jax", jbm, jpc, jtiers), ("torch", tbm, tpc, ttiers)):
        store = tiers.TieredBlockStore(host_blocks=host_blocks) if host_blocks else None
        allocs[pkg] = pc.PrefixCachingAllocator(
            bm.BlockManager(12, 4), tier_store=store,
            kv_fetch=(lambda b, pkg=pkg: _payload(pkg, b)) if store else None)
    rng = np.random.default_rng(seed)
    prefixes = [[int(x) for x in rng.integers(0, 5, size=8)] for _ in range(3)]
    live = {"jax": [], "torch": []}
    for step in range(60):
        admit = rng.integers(0, 3) < 2
        tokens = (prefixes[rng.integers(0, 3)]
                  + [int(x) for x in rng.integers(0, 5, size=rng.integers(1, 7))])
        trace = {}
        for pkg, pc in allocs.items():
            if admit:  # a request sharing one of the prefixes
                cached, n = pc.match_prefix(tokens)
                pc.acquire(cached)
                tier_keys = pc.match_tiers(tokens, len(cached))
                fresh = pc.allocate(pc.bm.blocks_needed(len(tokens) + 1) - len(cached))
                if fresh is None:
                    pc.release(cached)
                    trace[pkg] = ("full", cached)
                    continue
                restored = 0
                for j, key in enumerate(tier_keys):
                    payload, tier = pc.fetch_restore(key)
                    if payload is None:
                        break
                    pc.register_restored(key, fresh[j])
                    restored += 1
                pc.record_admission(cached, {"host": restored} if restored else {})
                live[pkg].append((tokens, cached + fresh))
                trace[pkg] = (cached, n, fresh, restored, tier_keys)
            elif live[pkg]:  # retire the oldest live sequence
                done, blocks = live[pkg].pop(0)
                pc.release_sequence(done, blocks)
                trace[pkg] = ("retired", blocks)
        assert trace.get("torch") == trace.get("jax"), step
        j, t = allocs["jax"], allocs["torch"]
        assert t.stats == j.stats
        assert list(t._lru) == list(j._lru)
        assert t.bm.num_free == j.bm.num_free
        if host_blocks:
            assert list(t.tier_store._host) == list(j.tier_store._host)
    assert allocs["torch"].stats["hits"] > 0
    if host_blocks:
        assert allocs["torch"].stats["demotions"] > 0


def test_key_digest_and_metric_names_match_jax():
    key = ((((), (1, 2, 3, 4)), (5, 6, 7, 8)))
    assert ttiers.key_digest(key) == jtiers.key_digest(key)
    assert tpc.PREFIX_CACHE_METRIC_NAMES == jpc.PREFIX_CACHE_METRIC_NAMES


# ----------------------------------------------------------------------
# The engine
# ----------------------------------------------------------------------

SYSTEM = [5, 9, 2, 7, 3, 8, 1, 4] * 3  # three shared blocks of 8


def test_engine_prefix_caching_matches_jax(params):
    ec = dict(max_seqs=4, num_blocks=64, max_model_len=96, enable_prefix_caching=True)
    jeng, teng = _engines(params, **ec)
    waves = [[SYSTEM + [11, 12, 13]], [SYSTEM + [14 + i] * (i + 1) for i in range(5)],
             [SYSTEM + [11, 12, 13], SYSTEM[:8] + [20, 21]]]
    want = _drive(jeng, JaxSamplingParams, waves)
    got = _drive(teng, SamplingParams, waves)
    _same(want, got)
    for key in ("prefix_cached_tokens", "prefill_tokens", "prefill_batches"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["prefix_cached_tokens"] > 0
    assert teng.prefix_cache.stats == jeng.prefix_cache.stats
    # Off is the same stream, with every prompt token prefilled.
    _, off = _engines(params, max_seqs=4, num_blocks=64, max_model_len=96)
    _same(want, _drive(off, SamplingParams, waves))
    assert off.stats["prefill_tokens"] > teng.stats["prefill_tokens"]


def test_engine_prefix_caching_under_preemption_matches_jax(params):
    ec = dict(max_seqs=4, num_blocks=12, max_model_len=64, enable_prefix_caching=True)
    jeng, teng = _engines(params, **ec)
    waves = [[SYSTEM[:16] + [30 + i] for i in range(6)], [SYSTEM[:16] + [40]]]
    want = _drive(jeng, JaxSamplingParams, waves, max_tokens=12)
    got = _drive(teng, SamplingParams, waves, max_tokens=12)
    _same(want, got)
    assert teng.stats["preemptions"] == jeng.stats["preemptions"] > 0
    assert teng.stats["prefix_cached_tokens"] == jeng.stats["prefix_cached_tokens"]


SESSIONS = [[i] * 8 + [7] * 8 + [1, 2, 3] for i in range(4)]


@pytest.mark.parametrize("tiers", ["host", "disk", "host+disk"])
def test_engine_tiers_restore_like_jax(params, tmp_path, tiers):
    """A 7-block pool cannot hold every session, so round 2 revisits blocks
    the tiers absorbed: the same tokens, restores and disk block names."""
    kw = dict(max_seqs=1, num_blocks=7, max_model_len=40, enable_prefix_caching=True,
              prefix_host_blocks={"host": 8, "disk": 0, "host+disk": 2}[tiers])
    dirs = {}
    if "disk" in tiers:
        dirs = {pkg: tmp_path / pkg for pkg in ("jax", "torch")}
    base = dict(block_size=8, cache_dtype="float32", eos_token_id=-1, **kw)
    jeng = JaxEngine(JAX_PRESETS["llama_tiny"], jax.tree_util.tree_map(jnp.asarray, params),
                     JaxEngineConfig(**base, **({"prefix_disk_dir": str(dirs["jax"]),
                                                  "prefix_disk_blocks": 16} if dirs else {})))
    teng = InferenceEngine(
        MODEL_PRESETS["llama_tiny"], params_from_jax(params),
        EngineConfig(**base, **({"prefix_disk_dir": str(dirs["torch"]),
                                 "prefix_disk_blocks": 16} if dirs else {})),
        device="cpu")
    waves = [[p] for p in SESSIONS] * 2
    want = _drive(jeng, JaxSamplingParams, waves, max_tokens=4)
    got = _drive(teng, SamplingParams, waves, max_tokens=4)
    _same(want, got)
    assert teng.stats["prefix_restored_tokens"] == jeng.stats["prefix_restored_tokens"] > 0
    assert teng.stats["prefill_tokens"] == jeng.stats["prefill_tokens"]
    assert teng.prefix_cache.stats == jeng.prefix_cache.stats
    assert teng.prefix_cache.tier_store.stats == jeng.prefix_cache.tier_store.stats
    if dirs:
        names = {pkg: sorted(os.listdir(d)) for pkg, d in dirs.items()}
        assert names["torch"] == names["jax"] and names["torch"]
        assert all(n.startswith("block-") for n in names["torch"])


def test_corrupt_disk_block_is_quarantined_like_jax(params, tmp_path):
    """Bit-flip every array file of the disk tier: the next revisit reads a
    miss (the prefix re-prefills, outputs unchanged), the blocks move to
    ``_quarantine/`` under the same names, and both count the drop."""
    base = dict(max_seqs=1, num_blocks=7, max_model_len=40, enable_prefix_caching=True,
                block_size=8, cache_dtype="float32", eos_token_id=-1,
                prefix_disk_blocks=16)
    jeng = JaxEngine(JAX_PRESETS["llama_tiny"], jax.tree_util.tree_map(jnp.asarray, params),
                     JaxEngineConfig(prefix_disk_dir=str(tmp_path / "jax"), **base))
    teng = InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                           EngineConfig(prefix_disk_dir=str(tmp_path / "torch"), **base),
                           device="cpu")
    results = {}
    for pkg, eng, sp in (("jax", jeng, JaxSamplingParams), ("torch", teng, SamplingParams)):
        first = _drive(eng, sp, [[p] for p in SESSIONS], max_tokens=4)
        for f in glob.glob(str(tmp_path / pkg / "block-*" / "**" / "*.bin"), recursive=True):
            raw = bytearray(open(f, "rb").read())
            raw[len(raw) // 2] ^= 0xFF
            open(f, "wb").write(bytes(raw))
        second = _drive(eng, sp, [[p] for p in SESSIONS], max_tokens=4)
        assert [r.output_token_ids for r in second] == [r.output_token_ids for r in first]
        quarantined = sorted(os.listdir(tmp_path / pkg / "_quarantine"))
        results[pkg] = (quarantined, eng.prefix_cache.stats["tier_corrupt_dropped"],
                        eng.stats["prefix_restored_tokens"],
                        [r.output_token_ids for r in second])
    assert results["torch"] == results["jax"]
    assert results["torch"][1] > 0
    assert all("CheckpointCorruptError" in n for n in results["torch"][0])


# ----------------------------------------------------------------------
# Chunked and ragged prefill
# ----------------------------------------------------------------------

RAGGED_PROMPTS = [list(range(2, 2 + n)) for n in (5, 3, 9, 2, 17, 4)]
LONG_PROMPTS = [[(7 * i + 3 * j) % 200 + 3 for j in range(n)]
                for i, n in enumerate((40, 9, 23, 57, 3))]


def test_chunked_prefill_matches_jax(params):
    """Chunks of at most 16 tokens a step, each at its own offset: every
    chunk past the first attends to the keys its predecessors wrote."""
    ec = dict(max_seqs=4, num_blocks=64, max_model_len=96, max_prefill_tokens_per_step=16)
    jeng, teng = _engines(params, **ec)
    want = _drive(jeng, JaxSamplingParams, [LONG_PROMPTS])
    got = _drive(teng, SamplingParams, [LONG_PROMPTS])
    _same(want, got)
    assert teng.stats["prefill_batches"] == jeng.stats["prefill_batches"]
    assert teng.stats["prefill_tokens"] == jeng.stats["prefill_tokens"] == \
        sum(map(len, LONG_PROMPTS))


def test_chunked_prefill_with_a_prefix_hit_matches_jax(params):
    ec = dict(max_seqs=2, num_blocks=64, max_model_len=96, max_prefill_tokens_per_step=16,
              enable_prefix_caching=True, steps_per_sync=4)
    jeng, teng = _engines(params, **ec)
    waves = [[SYSTEM + [50, 51, 52]], [SYSTEM + list(range(60, 90)), SYSTEM + [50]]]
    want = _drive(jeng, JaxSamplingParams, waves)
    got = _drive(teng, SamplingParams, waves)
    _same(want, got)
    assert teng.stats["prefix_cached_tokens"] == jeng.stats["prefix_cached_tokens"] > 0


@pytest.mark.parametrize("mode", ["throughput", "chunked"])
def test_ragged_prefill_equals_jax_ragged_off_in_fewer_batches(params, mode):
    over = dict(max_seqs=8, num_blocks=64, max_model_len=128)
    if mode == "chunked":
        over["max_prefill_tokens_per_step"] = 16

    def run(cls, sp, ragged):
        eng = cls(ragged)
        reqs = _drive(eng, sp, [RAGGED_PROMPTS])
        return reqs, eng.stats["prefill_batches"]

    jeng, _ = _engines(params, ragged_prefill=False, **over)
    want, want_batches = _drive(jeng, JaxSamplingParams, [RAGGED_PROMPTS]), \
        jeng.stats["prefill_batches"]
    outs = {}
    for ragged in (False, True):
        eng = InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                              EngineConfig(block_size=8, cache_dtype="float32",
                                           eos_token_id=-1, ragged_prefill=ragged, **over),
                              device="cpu")
        reqs = _drive(eng, SamplingParams, [RAGGED_PROMPTS])
        outs[ragged] = ([(r.output_token_ids, r.output_logprobs) for r in reqs],
                        eng.stats["prefill_batches"], reqs)
    _same(want, outs[True][2])
    assert outs[False][1] == want_batches
    # The port's own contract: byte-equal on and off, in fewer calls.
    assert outs[True][0] == outs[False][0]
    assert outs[True][1] < outs[False][1]


# ----------------------------------------------------------------------
# Block transport
# ----------------------------------------------------------------------

@pytest.mark.parametrize("pool", ["float32", "bfloat16", "float16", "int8"])
def test_fetch_and_restore_block_round_trip_bit_equal(params, pool):
    ec = EngineConfig(max_seqs=2, block_size=8, num_blocks=16, max_model_len=64,
                      cache_dtype=pool, eos_token_id=-1)
    ex = EngineExecutor(MODEL_PRESETS["llama_tiny"], params_from_jax(params), ec,
                        device="cpu")
    gen = torch.Generator().manual_seed(0)
    for layer in ex.cache:
        for t in layer.values():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int8))
            else:
                t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    payload = ex.fetch_block_kv(5)
    want_keys = {"k", "v"} | ({"k_scale", "v_scale"} if pool == "int8" else set())
    assert sorted(payload) == [f"l{i:05d}" for i in range(len(ex.cache))]
    assert all(set(rows) == want_keys for rows in payload.values())
    before = [{k: t.clone() for k, t in layer.items()} for layer in ex.cache]
    ex.restore_block(9, payload)
    for layer, old in zip(ex.cache, before):
        for k, t in layer.items():
            assert torch.equal(t[9], old[k][5])
            assert torch.equal(t[5], old[k][5])
            others = [b for b in range(t.shape[0]) if b != 9]
            assert torch.equal(t[others], old[k][others])
