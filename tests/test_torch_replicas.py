"""The port's replica fleet (``serving.replicas``) against the JAX package's
``ReplicatedEngine`` (``llama_tiny``, CPU; the JAX replicas on its virtual
devices, the port's all on the CPU), on the same weights.

* **Dispatch**: the same submits land on the same replica indices,
  least-loaded with round-robin ties, sticky by rendezvous hash (the same
  SHA-256 score), after a replica dies, and past the spill threshold.
* **Failover**: ``raise`` and ``nan-logits`` faults (the latter tripping
  each engine's own numeric guard) give the same greedy tokens, finish
  reasons, retries and replicas, the healed replica serves again, and an
  exhausted retry budget errors the same requests.
* **Live migration**: a ``preempt`` drain at k 1 and 4 on float32 and int8
  pools gives the same tokens and migrations as JAX and as the unmigrated
  run. Seeded sampling through a migration is byte-equal to the port
  unmigrated (the port's draws are a counter hash, not threefry, so it is
  held to itself). An adapter request whose first survivor runs out of
  blocks after pinning the adapter leaves no pin there and decodes under
  its own row on the next survivor, as the merged-weights engine does.
* **Stepping**: a fleet step launches every replica's decode round before
  it completes any (replicas on different cards decode at once).

Greedy tokens are compared exactly.
"""

import itertools
import types

import pytest

from dlti_tpu.serving import ReplicatedEngine as JaxReplicated
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.models import merge_lora_params, params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, ReplicatedEngine, SamplingParams
from dlti_tpu_torch.serving.replicas import parse_fault_inject
from torch_adapter_cells import ALPHA, R, _clean_catalogs, _register, setup  # noqa: F401
from torch_fleet_cells import EC, PROMPTS, fleets, greedy, outcome, run, seeded_params


@pytest.fixture(scope="module")
def params():
    return seeded_params()


# ----------------------------------------------------------------------
# Dispatch (fleet skeletons around load-controllable fake engines)
# ----------------------------------------------------------------------

def _skeleton(cls, n, max_seqs=4, spill=4):
    """A fleet of ``cls`` around fakes whose load the test sets; the
    dispatch logic is host code over the engines' loads and configs."""
    def fake(i):
        eng = types.SimpleNamespace(idx=i, waiting=[], num_active=0,
                                    cfg=types.SimpleNamespace(max_seqs=max_seqs,
                                                              max_model_len=128))
        eng.submit = lambda ids, params, rid, trace_id="", _e=eng: (
            types.SimpleNamespace(request_id=rid, engine=_e))
        eng.enqueue = lambda req, _e=eng: req
        return eng

    rep = cls.__new__(cls)
    rep.engines = [fake(i) for i in range(n)]
    rep._dead, rep._draining = set(), set()
    rep._rr = 0
    rep._req_counter = itertools.count()
    rep.affinity_spill_threshold = spill
    rep.affinity = {"sticky": 0, "spill": 0}
    rep.shadow_tap = None
    return rep


def _landing(rep, req):
    return req.engine.idx if hasattr(req, "engine") else req.replica


def _dispatch_script(cls, sp):
    """A script of submits with loads moved between them; returns where each
    landed and the affinity counters."""
    rep = _skeleton(cls, 3, max_seqs=2, spill=1)
    out = []
    for i in range(7):  # least-loaded, round-robin ties
        out.append(_landing(rep, rep.submit([1, 2], sp, f"a{i}")))
    rep.engines[0].num_active = 3
    rep.engines[2].waiting = [object()]
    for i in range(4):
        out.append(_landing(rep, rep.submit([1, 2], sp, f"b{i}")))
    for k in range(24):  # sticky
        out.append(_landing(rep, rep.submit([3], sp, f"s{k}", affinity_key=f"sess-{k}")))
    rep._dead.add(1)  # a dead replica: only its keys re-rank
    for k in range(24):
        out.append(_landing(rep, rep.submit([3], sp, f"d{k}", affinity_key=f"sess-{k}")))
    rep._dead.discard(1)
    # Past the spill threshold (backlog = load - max_seqs > 1): least-loaded.
    for e in rep.engines:
        e.num_active, e.waiting = 2, [object()] * 2
    rep.engines[2].waiting = []
    for k in range(6):
        out.append(_landing(rep, rep.submit([3], sp, f"p{k}", affinity_key=f"hot-{k}")))
    return out, dict(rep.affinity)


def test_dispatch_lands_on_the_same_replicas_as_jax():
    want = _dispatch_script(JaxReplicated, JaxSamplingParams())
    got = _dispatch_script(ReplicatedEngine, SamplingParams())
    assert got == want
    assert want[1]["sticky"] > 0 and want[1]["spill"] > 0


@pytest.mark.parametrize("spec,want", [
    ("", None), ("1:3", (1, 3, "raise")), ("0:4:preempt", (0, 4, "preempt")),
    ("2:1:nan-logits", (2, 1, "nan-logits"))])
def test_fault_inject_spec_parses_as_jax(spec, want):
    from dlti_tpu.serving.replicas import _parse_fault_inject

    assert parse_fault_inject(spec) == _parse_fault_inject(spec) == want


@pytest.mark.parametrize("bad", ["1", "x:3", "1:3:melt"])
def test_fault_inject_spec_refuses_as_jax(bad):
    from dlti_tpu.serving.replicas import _parse_fault_inject

    with pytest.raises(ValueError):
        _parse_fault_inject(bad)
    with pytest.raises(ValueError, match="REPLICA:STEP"):
        parse_fault_inject(bad)


def test_fleet_refuses_tensor_replicas_and_too_few_devices(params):
    from dlti_tpu_torch.config import MODEL_PRESETS
    from dlti_tpu_torch.models import params_from_jax
    from dlti_tpu_torch.serving import EngineConfig

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ReplicatedEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params), EngineConfig(),
                         replicas=2, tensor=2, device="cpu")
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        ReplicatedEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params), EngineConfig(),
                         replicas=3, devices=["cpu", "cpu"])


# ----------------------------------------------------------------------
# Failover and self-healing on real engines
# ----------------------------------------------------------------------

def _script(rep, package):
    """Round 1 through the fault, heal, then round 2."""
    sp = greedy(8, package)
    r1 = run(rep, [rep.submit(p, sp) for p in PROMPTS])
    for _ in range(10):
        if rep.lifecycle.state(1) == "live":
            break
        rep.step()
    before = rep.engines[1].stats["requests"]
    r2 = run(rep, [rep.submit(p, sp) for p in PROMPTS])
    return (outcome(r1), outcome(r2), dict(rep.lifecycle.counters), rep.lifecycle_counts(),
            dict(rep.failover), rep.engines[1].stats["requests"] > before)


@pytest.mark.parametrize("mode", ["raise", "nan-logits"])
def test_failover_and_heal_match_jax(params, mode):
    jrep, trep = fleets(params, heal=True, fault_inject_step=f"1:3:{mode}")
    want, got = _script(jrep, "jax"), _script(trep, "torch")
    assert got == want
    r1 = got[0]
    assert all(finish == "length" for _, finish, *_ in r1)
    assert any(retries > 0 for _, _, retries, *_ in r1)
    assert got[2]["quarantines"] == 1 and got[2]["reinstates"] == 1
    assert got[3] == {"live": 2, "quarantined": 0, "draining": 0, "dead": 0}
    assert got[5], "the healed replica took no round-2 traffic"


def test_nan_logits_trip_the_ports_numeric_guard(params):
    _, trep = fleets(params, fault_inject_step="1:3:nan-logits")
    sick = trep.engines[1]
    run(trep, [trep.submit(p, greedy(8)) for p in PROMPTS])
    assert sick.stats["numeric_faults"] == 1
    assert trep.lifecycle_counts() == {"live": 1, "quarantined": 0, "draining": 0, "dead": 1}
    # Replica 0 owns its weights: the poison never reached it.
    assert all(p.isfinite().all() for p in trep.engines[0].model.parameters()
               if p.is_floating_point())


def test_exhausted_retries_error_as_jax(params):
    jrep, trep = fleets(params, fault_inject_step="1:3", max_retries=0)
    want = outcome(run(jrep, [jrep.submit(p, greedy(8, "jax")) for p in PROMPTS]))
    got = outcome(run(trep, [trep.submit(p, greedy(8)) for p in PROMPTS]))
    assert got == want
    assert sorted(f for _, f, *_ in got) == ["error", "error", "length", "length"]
    assert trep.failover == jrep.failover


# ----------------------------------------------------------------------
# Live migration on a preempt drain
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_preempt_migration_matches_jax_and_the_unmigrated_run(params, kv, k):
    jbase, tbase = fleets(params, cache_dtype=kv, steps_per_sync=k)
    want_base = [r.output_token_ids for r in jbase.generate(PROMPTS, greedy(8, "jax"))]
    got_base = [r.output_token_ids for r in tbase.generate(PROMPTS, greedy(8))]
    assert got_base == want_base
    jrep, trep = fleets(params, cache_dtype=kv, steps_per_sync=k,
                        fault_inject_step="1:2:preempt")
    want = outcome(run(jrep, [jrep.submit(p, greedy(8, "jax")) for p in PROMPTS]))
    got = outcome(run(trep, [trep.submit(p, greedy(8)) for p in PROMPTS]))
    assert got == want
    assert [toks for toks, *_ in got] == got_base
    assert any(migrations > 0 for *_, migrations, _ in got), "nothing migrated"
    assert trep.lifecycle.counters == jrep.lifecycle.counters


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_seeded_sampling_through_a_migration_is_byte_equal(params, kv):
    sp = SamplingParams(temperature=0.9, top_k=20, max_tokens=8, seed=7)
    unseeded = SamplingParams(temperature=0.9, max_tokens=8)
    _, base = fleets(params, cache_dtype=kv)
    want = [r.output_token_ids for r in base.generate(PROMPTS, sp)]
    _, trep = fleets(params, cache_dtype=kv, fault_inject_step="1:3:preempt")
    reqs = run(trep, [trep.submit(p, sp) for p in PROMPTS])
    assert [r.output_token_ids for r in reqs] == want
    assert any(r.num_migrations for r in reqs)
    # An unseeded request's seed came from its origin's own stream: the
    # handoff carries it, so the migrated stream is the one it would have
    # drawn there (the same tokens as a handoff onto an idle twin).
    _, trep = fleets(params, cache_dtype=kv)
    adopter = trep.engines[1]
    req = trep.submit(PROMPTS[0], unseeded)
    assert req.replica == 0
    for _ in range(3):
        trep.step()
    seed = trep.engines[0]._slot_seeds[0]
    trep.drain_replica(0)
    assert req.num_migrations == 1 and adopter.slots[0].request is req
    assert adopter._slot_seeds[0] == seed
    run(trep, [req])
    assert req.finish_reason == "length" and len(req.output_token_ids) == 8


def test_export_failure_leaves_the_slot_and_falls_back(params, monkeypatch):
    _, trep = fleets(params, fault_inject_step="1:3:preempt")
    sick = trep.engines[1]
    monkeypatch.setattr(sick.executor, "fetch_block_kv", lambda b: None)
    reqs = run(trep, [trep.submit(p, greedy(8)) for p in PROMPTS])
    _, base = fleets(params)
    assert [r.output_token_ids for r in reqs] == \
        [r.output_token_ids for r in base.generate(PROMPTS, greedy(8))]
    assert trep.lifecycle.counters["migration_fallbacks"] == 2
    assert sum(r.num_retries for r in reqs) == 2


def test_an_adapter_decode_migrates_past_a_survivor_out_of_blocks(setup, monkeypatch):
    """Replica 1, the first survivor tried, pins the adapter and then finds
    no blocks: it lets the row go, and replica 2 adopts the decode under a
    row of its own pool."""
    _register(setup.dirs, ["ad-a"])
    ec = dict(EC, cache_dtype="float32")
    rep = ReplicatedEngine(MODEL_PRESETS["llama_tiny"], setup.base,
                           EngineConfig(adapter_slots=2, adapter_rank=R, **ec),
                           replicas=3, device="cpu")
    req = rep.submit(PROMPTS[0], greedy(8), adapter="ad-a")
    assert req.replica == 0
    for _ in range(3):
        rep.step()
    out_of_blocks = rep.engines[1]
    monkeypatch.setattr(out_of_blocks, "_alloc", lambda n: None)
    assert rep.drain_replica(0) == []
    assert req.num_migrations == 1 and req.replica == 2
    assert out_of_blocks.adapter_pool._refs == [0, 0, 0]
    assert rep.engines[2].adapter_pool._names[req._adapter_slot] == "ad-a"
    run(rep, [req])
    merged = merge_lora_params(setup.flat["ad-a"], alpha=int(ALPHA))
    want = InferenceEngine(MODEL_PRESETS["llama_tiny"], merged, EngineConfig(**ec),
                           device="cpu").generate([PROMPTS[0]], greedy(8))[0]
    assert req.finish_reason == "length"
    assert req.output_token_ids == want.output_token_ids
    assert rep.engines[2].adapter_pool._refs == [0, 0, 0]


# ----------------------------------------------------------------------
# Stepping
# ----------------------------------------------------------------------

def test_a_fleet_step_launches_every_round_before_it_completes_any(params, monkeypatch):
    rep = ReplicatedEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                           EngineConfig(**dict(EC, cache_dtype="float32")), replicas=2,
                           device="cpu")
    calls = []
    for i, eng in enumerate(rep.engines):
        for name in ("step_launch", "step_finish"):
            def record(*a, _real=getattr(eng, name), _call=f"{name} {i}"):
                out = _real(*a)
                calls.append((_call, out is not None))
                return out

            monkeypatch.setattr(eng, name, record)
    reqs = [rep.submit(p, greedy(8)) for p in PROMPTS]
    steps = []
    while rep.has_work:
        calls.clear()
        rep.step()
        steps.append(list(calls))
    assert all(r.finish_reason == "length" and len(r.output_token_ids) == 8 for r in reqs)
    # Whenever both replicas step: both rounds launched, then both completed.
    both = [s for s in steps if len(s) == 4]
    assert all([c for c, _ in s] == ["step_launch 0", "step_launch 1", "step_finish 0",
                                     "step_finish 1"] for s in both)
    assert any(s[0][1] and s[1][1] for s in both), "no step had two rounds in flight"
