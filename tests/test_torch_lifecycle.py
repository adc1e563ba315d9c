"""The port's replica lifecycle (``serving.lifecycle``) and its rolling
reload against the JAX package's, on the same weights (``llama_tiny``, CPU).

* **The state machine**: the same scripted faults, drains, probes, probe
  verdicts and fake-clock advances give the same states, due probes
  (probation delays), flap evictions, counters and ``scalars()``.
* ``canary_digest``, the configuration blocks and their JSON agree.
* **Rolling reload** (3 replicas, decodes in flight): the same weights give
  the JAX fleet's tokens, which equal the run without a reload; 1.01x
  weights give the JAX fleet's tokens too, every replica ends on the new
  weights, and the digest pinned after the roll equals a fresh canary's on
  the new weights and the JAX fleet's. (``tests/test_lifecycle.py::
  test_rolling_reload_swaps_new_weights_with_zero_errors`` also asks the
  digest to change; on these weights the 4-token greedy canary is the same
  before and after, in both packages, so that test is held to what it can
  show: the digest is re-pinned against the new weights.)
* A sole replica reloads by waiting out its own work; a provider or a
  re-verification that fails aborts the roll as in JAX.

Greedy tokens are compared exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest

import dlti_tpu.config as jc
from dlti_tpu.serving import lifecycle as jlc
from dlti_tpu.serving.gateway import GATEWAY_METRIC_NAMES as JAX_GATEWAY_NAMES
from dlti_tpu.serving.gateway import PRIORITIES as JAX_PRIORITIES
import dlti_tpu_torch.config as tc
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import gateway as tgw
from dlti_tpu_torch.serving import lifecycle as tlc
from torch_fleet_cells import fleets, greedy, outcome, run, seeded_params


@pytest.fixture(scope="module")
def params():
    return seeded_params()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# Scripts of (op, replica or seconds); "adv" advances the fake clock.
SCRIPTS = {
    "quarantine_probe_reinstate": (
        dict(enabled=True, probation_initial_s=2.0), 2,
        [("fault", 1), ("adv", 1.0), ("adv", 1.0), ("probe", 1), ("pass", 1)]),
    "exponential_probation_capped_and_reset": (
        dict(probation_initial_s=1.0, probation_backoff=2.0, probation_max_s=5.0,
             flap_window_s=1e9, flap_max_cycles=100), 1,
        [("fault", 0), ("adv", 1.0)]
        + [x for w in (2.0, 4.0, 5.0) for x in (("probe", 0), ("fail", 0), ("adv", w - 0.1),
                                                 ("adv", 0.1))]
        + [("probe", 0), ("pass", 0), ("fault", 0), ("adv", 0.5), ("adv", 0.5)]),
    "flap_breaker_evicts": (
        dict(probation_initial_s=0.0, flap_window_s=100.0, flap_max_cycles=2), 2,
        [x for _ in range(3) for x in (("fault", 0), ("probe", 0), ("pass", 0))]
        + [("fault", 0), ("fault", 1)]),
    "flap_window_prunes": (
        dict(probation_initial_s=0.0, flap_window_s=10.0, flap_max_cycles=1), 1,
        [("fault", 0), ("probe", 0), ("pass", 0), ("adv", 11.0), ("fault", 0),
         ("probe", 0), ("pass", 0), ("adv", 1.0), ("fault", 0)]),
    "dead_evict_drain_migrations": (
        dict(), 3,
        [("mark_dead", 0), ("evict", 0), ("evict", 1), ("drain", 2), ("fault", 2),
         ("migrate", 3), ("fallback", 1), ("drain", 0), ("mark_dead", 2)]),
}


def _drive(mod, cfg_cls, cfg, n, script):
    clock = _Clock()
    lc = mod.ReplicaLifecycle(cfg_cls(**cfg), n, clock=clock)
    trace = []
    for op, arg in script:
        if op == "adv":
            clock.t += arg
            out = None
        else:
            out = {"fault": lambda i: lc.on_fault(i), "probe": lambda i: lc.begin_probe(i),
                   "pass": lambda i: lc.on_probe_result(i, True),
                   "fail": lambda i: lc.on_probe_result(i, False),
                   "evict": lambda i: lc.evict(i), "mark_dead": lambda i: lc.mark_dead(i),
                   "drain": lambda i: lc.begin_drain(i),
                   "migrate": lambda n: lc.note_migration(n),
                   "fallback": lambda n: lc.note_migration_fallback(n)}[op](arg)
        trace.append((op, arg, out, lc.states(), lc.due_probes(), dict(lc.counters),
                      lc.scalars()))
    return trace


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_state_machine_matches_jax(name):
    cfg, n, script = SCRIPTS[name]
    want = _drive(jlc, jc.ReplicaLifecycleConfig, cfg, n, script)
    got = _drive(tlc, tc.ReplicaLifecycleConfig, cfg, n, script)
    assert got == want


@pytest.mark.parametrize("tokens", [[], [0], [1, 2, 3], [3, 2, 1], [-1, 2 ** 40, 31999],
                                    list(range(64))])
def test_canary_digest_matches_jax(tokens):
    assert tlc.canary_digest(tokens) == jlc.canary_digest(tokens)


def test_names_and_states_match_jax():
    assert tlc.LIFECYCLE_METRIC_NAMES == jlc.LIFECYCLE_METRIC_NAMES
    assert tlc.STATES == jlc.STATES
    assert tgw.GATEWAY_METRIC_NAMES == JAX_GATEWAY_NAMES
    assert tgw.PRIORITIES == JAX_PRIORITIES


@pytest.mark.parametrize("block", ["GatewayConfig", "ReplicaLifecycleConfig"])
def test_config_blocks_match_jax(block):
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(getattr(tc, block)) == fields(getattr(jc, block))


def test_serving_config_round_trips_through_both_packages_json():
    jcfg = jc.Config(checkpoint=jc.CheckpointConfig(save_strategy="no"),
                     serving=jc.ServingConfig(
        gateway=jc.GatewayConfig(enabled=True, max_queued_requests=8, adapter_map="a:b"),
        lifecycle=jc.ReplicaLifecycleConfig(enabled=True, flap_max_cycles=5,
                                            probation_initial_s=7.5)))
    cfg = tc.Config.from_dict(jcfg.to_dict())
    assert dataclasses.asdict(cfg.serving.gateway) == dataclasses.asdict(jcfg.serving.gateway)
    assert dataclasses.asdict(cfg.serving.lifecycle) == \
        dataclasses.asdict(jcfg.serving.lifecycle)
    assert tc.Config.from_json(cfg.to_json()) == cfg
    back = jc.Config.from_dict(cfg.to_dict())
    assert back.serving.gateway == jcfg.serving.gateway
    assert back.serving.lifecycle == jcfg.serving.lifecycle


# ----------------------------------------------------------------------
# Rolling reload
# ----------------------------------------------------------------------

PROMPTS6 = [[i + 1, i + 2, i + 3] for i in range(6)]


def _roll(rep, package, provider, n=16):
    sp = greedy(n, package)
    reqs = [rep.submit(p, sp) for p in PROMPTS6]
    for _ in range(3):  # decodes in flight before the roll starts
        rep.step()
    assert rep.request_reload(provider)
    assert not rep.request_reload(provider)  # a roll is already in flight
    run(rep, reqs)
    return outcome(reqs)


def test_rolling_reload_of_the_same_weights_matches_jax_and_no_reload(params):
    jbase, tbase = fleets(params, replicas=3)
    base = [r.output_token_ids for r in tbase.generate(PROMPTS6, greedy(16))]
    assert base == [r.output_token_ids for r in jbase.generate(PROMPTS6, greedy(16, "jax"))]
    jrep, trep = fleets(params, replicas=3, heal=True)
    want = _roll(jrep, "jax", lambda: params)
    got = _roll(trep, "torch", lambda: params_from_jax(params))
    assert got == want
    assert [toks for toks, *_ in got] == base
    assert all(finish == "length" for _, finish, *_ in got)
    assert any(migrations for *_, migrations, _ in got)
    assert trep.lifecycle.counters == jrep.lifecycle.counters
    assert trep.lifecycle.counters["reinstates"] == 3 and not trep._dead
    assert trep.last_reload_ok is True and jrep.last_reload_ok is True


def test_rolling_reload_of_new_weights_matches_jax_and_repins_the_digest(params):
    new = jax.tree_util.tree_map(lambda x: np.asarray(x) * np.float32(1.01), params)
    jrep, trep = fleets(params, replicas=3, heal=True)
    old_digest = trep._canary_digest
    assert old_digest == jrep._canary_digest
    want = _roll(jrep, "jax", lambda: new)
    got = _roll(trep, "torch", lambda: params_from_jax(new))
    assert got == want
    assert all(finish == "length" for _, finish, *_ in got)
    # Every replica holds the new weights.
    new_t = params_from_jax(new)
    for e in trep.engines:
        for name, p in e.model.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), new_t[name].numpy())
    # The digest is re-pinned against the new weights: a fresh fleet's
    # canary on them, and the JAX fleet's after its roll.
    _, fresh = fleets(new, replicas=1, heal=True)
    assert trep._canary_digest == fresh._canary_digest == jrep._canary_digest
    assert trep.lifecycle.counts()["live"] == 3
    # Post-reload traffic serves the new weights as the JAX fleet does.
    assert [r.output_token_ids for r in trep.generate([[1, 2, 3]], greedy(12))] == \
        [r.output_token_ids for r in jrep.generate([[1, 2, 3]], greedy(12, "jax"))]


def test_a_sole_replica_reloads_after_its_own_work(params):
    jrep, trep = fleets(params, replicas=1, heal=True)
    want = _roll(jrep, "jax", lambda: params)
    got = _roll(trep, "torch", lambda: params_from_jax(params))
    assert got == want
    assert all(migrations == 0 for *_, migrations, _ in got)
    assert trep.lifecycle.counters["reinstates"] == 1 and not trep._draining


@pytest.mark.parametrize("fault", ["provider", "verify"])
def test_a_failed_reload_aborts_as_in_jax(params, fault):
    jrep, trep = fleets(params, replicas=2, heal=True)

    def bad():
        raise OSError("unreadable export")

    for rep, good in ((jrep, lambda: params), (trep, lambda: params_from_jax(params))):
        if fault == "provider":
            assert rep.request_reload(bad)
        else:
            assert rep.request_reload(good, verify=lambda: False)
        run(rep, [])
        rep.step()
    assert trep.last_reload_ok is False and jrep.last_reload_ok is False
    assert trep.lifecycle.states() == jrep.lifecycle.states() == {0: "live", 1: "live"}
    assert trep.lifecycle.counters == jrep.lifecycle.counters
