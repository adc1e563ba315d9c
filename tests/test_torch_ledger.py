"""The port's critical-path and goodput ledger (``dlti_tpu_torch.telemetry.
ledger``) against the JAX package's, the request phases the port's replica
fleet books through a failover and a preempt migration against the JAX
fleet's, and the token-storm guard against the JAX engine's (``llama_tiny``,
float32, CPU).

The ledger's functions get the same requests and the same injected clock
in both packages and must return equal values (no tolerance: the same
float arithmetic). Fleet breakdowns are compared by which stall kinds are
non-zero (the seconds are each run's own); each sums to its total within
1e-6, as the reference's own test holds.
"""

import copy
import json
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dlti_tpu.config import MODEL_PRESETS as JAX_PRESETS
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import NumericFault as JaxNumericFault
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu.telemetry import ledger as jl
from dlti_tpu.telemetry import tracer as jtr
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, NumericFault, SamplingParams
from dlti_tpu_torch.telemetry import ledger as tl
from dlti_tpu_torch.telemetry import tracer as ttr
from torch_fleet_cells import PROMPTS, fleets, greedy, run, seeded_params

CFG = MODEL_PRESETS["llama_tiny"]
JCFG = JAX_PRESETS["llama_tiny"]


class FakeClock:
    def __init__(self, t=500.0, step=0.0):
        self.t, self.step = t, step

    def monotonic(self):
        self.t += self.step
        return self.t

    def time(self):
        return 1.7e9 + self.t


def _req(**kw):
    base = dict(request_id="r", trace_id="0123456789abcdef", tenant="t", priority="batch",
                replica=1, finish_reason="length", prompt_token_ids=[1, 2, 3],
                output_token_ids=[4, 5], num_preemptions=0, num_retries=0,
                arrival_time=10.0, admitted_time=10.5, first_token_time=11.0,
                finish_time=13.0, restore_s=0.0, stall_s={}, stall_prefill_s=0.0,
                _requeue_mark=None, gateway_enqueue_time=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


BREAKDOWN_CASES = {
    "plain": {},
    "gateway": dict(gateway_enqueue_time=9.25),
    "restore": dict(restore_s=0.2),
    "stalls": dict(stall_s={"failover": 0.3, "preempt": 0.1}, stall_prefill_s=0.3),
    "open_mark": dict(finish_time=None, first_token_time=None, admitted_time=None,
                      _requeue_mark=("failover", 12.0)),
    "unfinished": dict(finish_time=None, stall_s={"preempt": 0.05}),
    "never_admitted": dict(admitted_time=None, first_token_time=None, output_token_ids=[]),
    "rounding": dict(arrival_time=0.1234567, admitted_time=0.2345671,
                     first_token_time=0.3456711, finish_time=0.9876543,
                     gateway_enqueue_time=0.0000004, restore_s=0.0111111,
                     stall_s={"preempt": 0.0222229}, stall_prefill_s=0.0111119),
}


@pytest.mark.parametrize("case", sorted(BREAKDOWN_CASES))
def test_request_breakdown_equals_jax(case, monkeypatch):
    out = []
    for mod in (jl, tl):
        monkeypatch.setattr(mod, "time", FakeClock(t=14.0))
        out.append(mod.request_breakdown(_req(**BREAKDOWN_CASES[case])))
    assert out[1] == out[0]
    b = out[1]
    assert sum(b["phases"].values()) == pytest.approx(b["total_s"], abs=1e-6)
    assert set(b["phases"]) <= set(tl.REQUEST_PHASES)


def test_requeue_marks_book_stalls_as_jax(monkeypatch):
    out = []
    for mod in (jl, tl):
        clock = FakeClock(t=20.0)
        monkeypatch.setattr(mod, "time", clock)
        r = _req(first_token_time=None)
        mod.note_readmitted(r)  # no mark: nothing
        mod.note_requeue(r, "preempt")
        clock.t += 0.5
        mod.note_requeue(r, "failover")  # folds the open preempt window first
        clock.t += 0.25
        mod.note_readmitted(r)
        r.first_token_time = clock.t
        mod.note_requeue(r, "preempt")
        clock.t += 1.0
        mod.note_readmitted(r)
        out.append((r.stall_s, r.stall_prefill_s, r._requeue_mark))
    assert out[1] == out[0] == ({"preempt": 1.5, "failover": 0.25}, 0.75, None)


def _drive_tracker(mod, monkeypatch):
    monkeypatch.setattr(mod, "time", FakeClock(t=30.0))
    tr = mod.CriticalPathTracker(slow_k=3)
    seen = []
    for i, case in enumerate(sorted(BREAKDOWN_CASES)):
        r = _req(request_id=f"r{i}", **BREAKDOWN_CASES[case])
        seen.append(tr.observe(r))
        seen.append(tr.observe(r))  # a second finish books nothing
    tr.enabled = False
    seen.append(tr.observe(_req(request_id="off")))
    log = mod.SlowLog(k=0)
    log.add({"total_s": 1.0})
    log.add({"total_s": 2.0})
    return seen, tr.slow.worst(), tr.slow.worst(2), len(tr.slow), log.worst()


def test_critical_path_tracker_and_slow_log_equal_jax(monkeypatch):
    want = _drive_tracker(jl, monkeypatch)
    got = _drive_tracker(tl, monkeypatch)
    assert got == want
    totals = [e["total_s"] for e in got[1]]
    assert len(totals) == 3 and totals == sorted(totals, reverse=True)
    assert got[4] == [{"total_s": 2.0}]


def test_phase_series_move_by_the_booked_seconds(monkeypatch):
    monkeypatch.setattr(tl, "time", FakeClock(t=30.0))
    n0 = tl.phase_requests_total.value
    d0 = tl.phase_seconds_total.labels(phase="decode").value
    b = tl.CriticalPathTracker().observe(_req(request_id="metrics"))
    assert tl.phase_requests_total.value == n0 + 1
    assert tl.phase_seconds_total.labels(phase="decode").value == pytest.approx(
        d0 + b["phases"]["decode"], abs=1e-12)


def _drive_goodput(mod, tmp_path):
    clock = FakeClock(t=0.0)
    led = mod.GoodputLedger(clock=clock.monotonic)
    off = mod.GoodputLedger(enabled=False, clock=clock.monotonic)
    off.enter("eval")
    trail = []
    for phase, dt in [("step_compute", 1.0), ("device_sync", 0.5), ("eval", 0.25),
                      ("step_compute", 2.0), ("checkpoint_save", 0.125)]:
        clock.t += dt
        led.enter(phase)
        trail.append(led.take_deltas() if phase == "eval" else None)
    led.begin_replay(7)
    clock.t += 1.0
    led.enter("device_sync")
    clock.t += 0.75
    led.enter("other")
    led.end_replay()
    clock.t += 0.5
    path = led.save(str(tmp_path / mod.__name__ / "ledger.json"), generation=2, rank=0)
    return (led.totals(), led.wall(), led.goodput_fraction(), led.scalars(), led.to_dict(),
            trail, json.load(open(path)), off.totals(), off.scalars(), off.wall(),
            off.save(str(tmp_path / "none.json")))


def test_goodput_ledger_equals_jax(tmp_path):
    got = _drive_goodput(tl, tmp_path)
    assert got == _drive_goodput(jl, tmp_path)
    assert sum(got[0].values()) == pytest.approx(got[1], abs=1e-12)
    assert got[0]["replay"] == pytest.approx(0.75)


def test_stitch_ledgers_and_generation_files_equal_jax(tmp_path):
    workers = [
        {"generation": 0, "rank": 1, "buckets": {"step_compute": 9.0}, "wall_s": 9.0},
        {"generation": 0, "rank": 0, "buckets": {"step_compute": 8.0, "startup": 2.0},
         "wall_s": 10.0, "goodput_fraction": 0.8},
        {"generation": 1, "rank": 0, "buckets": {"device_sync": 3.0, "other": 0.5},
         "wall_s": 3.5}]
    timeline = [{"generation": 0, "world_size": 4, "start": 0.0, "end": 10.0},
                {"generation": 1, "world_size": 3, "start": 12.5, "end": 16.0}]
    assert tl.stitch_ledgers(workers, timeline, 4) == jl.stitch_ledgers(workers, timeline, 4)
    for i, w in enumerate(workers):
        (tmp_path / f"ledger_g{w['generation']}_r{i}.json").write_text(json.dumps(w))
    (tmp_path / "ledger_gx_r0.json").write_text("{broken")
    (tmp_path / "other.json").write_text("{}")
    assert (tl.load_generation_ledgers(str(tmp_path))
            == jl.load_generation_ledgers(str(tmp_path)) != [])
    assert tl.load_generation_ledgers(str(tmp_path / "missing")) == []


def test_bucket_and_phase_catalogs_equal_jax():
    assert tl.GOODPUT_BUCKETS == jl.GOODPUT_BUCKETS
    assert tl.REQUEST_PHASES == jl.REQUEST_PHASES
    assert tl.PRODUCTIVE_BUCKETS == jl.PRODUCTIVE_BUCKETS
    assert tl.LEDGER_METRIC_NAMES == jl.LEDGER_METRIC_NAMES
    assert tl.REQUEST_PHASE_METRIC_NAMES == jl.REQUEST_PHASE_METRIC_NAMES


# ----------------------------------------------------------------------
# The engine and the fleet book real requests
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return seeded_params()


def test_engine_breakdown_sums_to_observed_latency(params):
    ec = EngineConfig(max_seqs=2, block_size=8, num_blocks=64, max_model_len=64,
                      cache_dtype="float32", eos_token_id=-1, steps_per_sync=2)
    eng = InferenceEngine(CFG, params_from_jax(params), ec, device="cpu")
    results = eng.generate([[1, 2, 3, 4], [5, 6, 7], [8, 9]],
                           SamplingParams(max_tokens=4, temperature=0.0))
    by_id = {r.request_id: r for r in results}
    for req in eng.finished:
        b = tl.request_breakdown(req)
        assert sum(b["phases"].values()) == pytest.approx(b["total_s"], abs=1e-6)
        assert b["total_s"] == pytest.approx(by_id[req.request_id].latency_s,
                                             rel=0.01, abs=0.002)
    worst = eng.telemetry.critical_path.slow.worst()
    assert len(worst) == 3 and all("prefill" in e["phases"] for e in worst)
    # The third request queued behind the two slots.
    assert max(e["phases"]["queue"] for e in worst) > 0


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


def _fleet_run(rep, package, tracer):
    reqs = run(rep, [rep.submit(p, greedy(8, package)) for p in PROMPTS])
    out = []
    for r in reqs:
        b = (tl if package == "torch" else jl).request_breakdown(r)
        assert sum(b["phases"].values()) == pytest.approx(b["total_s"], abs=1e-6)
        stalls = sorted(k for k in ("failover", "preempt") if b["phases"].get(k, 0) > 0)
        traces = {ev["args"]["trace"] for ev in tracer.events()
                  if ev.get("args", {}).get("id") == r.request_id and "trace" in ev["args"]}
        out.append((stalls, r.num_retries, r.num_migrations, traces, r.trace_id))
    return out


@pytest.mark.parametrize("fault", ["1:3", "1:2:preempt"])
def test_failover_and_migration_stalls_and_trace_ids_match_jax(params, tracers, fault):
    jtracer, ttracer = tracers
    jrep, trep = fleets(params, fault_inject_step=fault, steps_per_sync=2)
    want = _fleet_run(jrep, "jax", jtracer)
    got = _fleet_run(trep, "torch", ttracer)
    assert [g[:3] for g in got] == [w[:3] for w in want]
    kind = "preempt" if "preempt" in fault else "failover"
    moved = [g for g in got if g[1] or g[2]]
    assert moved and all(g[0] == [kind] for g in moved)
    for stalls, retries, migrations, traces, trace_id in got:
        # One trace id on every span of the request, on either replica.
        assert traces == {trace_id} and re.fullmatch(r"[0-9a-f]{16}", trace_id)


# ----------------------------------------------------------------------
# The token-storm guard
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def storm_params(params):
    """The final norm's scale zeroed: every logit is 0, so every slot's
    greedy token is 0 (the first of equal maxima in both packages)."""
    p = copy.deepcopy(params)
    p["model"]["final_norm"]["scale"] = np.zeros_like(p["model"]["final_norm"]["scale"])
    return p


def _storm(engine, sp, prompts, fault_cls):
    reqs = [engine.submit(p, sp) for p in prompts]
    err = None
    try:
        while engine.has_work:
            engine.step()
    except fault_cls as e:
        err = str(e)
    return (err, engine.stats["decode_steps"], engine.stats["numeric_faults"],
            [list(r.output_token_ids) for r in reqs])


@pytest.mark.parametrize("k,guard,prompts", [
    (1, 3, PROMPTS[:3]), (4, 6, PROMPTS[:2]), (4, 3, PROMPTS), (1, 0, PROMPTS[:2]),
    (4, 2, PROMPTS[:1])])
def test_token_storm_guard_trips_at_the_step_jax_does(storm_params, k, guard, prompts):
    ec = dict(max_seqs=4, block_size=8, num_blocks=64, max_model_len=64,
              cache_dtype="float32", eos_token_id=-1, steps_per_sync=k,
              guard_token_storm=guard)
    jeng = JaxEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, storm_params),
                     JaxEngineConfig(**ec))
    teng = InferenceEngine(CFG, params_from_jax(storm_params), EngineConfig(**ec),
                           device="cpu")
    want = _storm(jeng, JaxSamplingParams(temperature=0.0, max_tokens=12), prompts,
                  JaxNumericFault)
    got = _storm(teng, SamplingParams(temperature=0.0, max_tokens=12), prompts,
                 NumericFault)
    assert got == want
    if guard and len(prompts) >= 2:
        assert got[0] == (f"token storm: every active slot sampled the same token for "
                          f"{guard} consecutive steps (token 0)") and got[2] == 1
    else:  # guard off, or one active slot: the run finishes
        assert got[0] is None and all(len(t) == 12 for t in got[3])
