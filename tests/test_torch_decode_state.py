"""The decode step's host path in the port: the device-resident decode
state, multi-step decode windows and a dispatch that never waits on the
device, against the JAX package's ``InferenceEngine`` on the same weights
(``llama_tiny``, CPU).

Greedy tokens must be equal to the JAX engine's at ``steps_per_sync`` 1, 4
and 8 on float32 and int8 pools, under preemption and with a stop token
inside a window; logprobs agree within 1e-4 (the two frameworks sum in
different orders). The engines' scheduling counters must be equal too:
both run the same window ladder, growth and dirty tracking. Seeded sampling
draws different bits in the two frameworks by design, so the port's seeded
streams are held to its own promises (independent of the window, of batch
company and of the decode-state cache). Ports of
``tests/test_host_overlap.py``'s decode-state tests and
``tests/test_serving.py``'s multi-step tests close the file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dlti_tpu.config import MODEL_PRESETS as JAX_PRESETS
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.ops import kv_cache as tkv
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams
from dlti_tpu_torch.serving.sampling import sample_tokens

LOGPROB_ATOL = 1e-4
CFG = MODEL_PRESETS["llama_tiny"]
COUNTERS = ("decode_steps", "decode_slot_steps", "preemptions",
            "hbm_growth_deferrals", "decode_state_uploads", "decode_state_rows",
            "decode_state_clean_syncs")
# Seven usable blocks of 8 tokens for three sequences growing past 20
# tokens: the youngest is preempted and recomputed on readmission.
TIGHT = dict(max_seqs=3, block_size=8, num_blocks=8, max_model_len=48,
             eos_token_id=-1)
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13], [14, 15, 16, 17, 18]]


@pytest.fixture(scope="module")
def params():
    """JAX init plus numpy noise, so no float32 near-tie decides a greedy
    token (as in tests/test_torch_engine.py)."""
    tree = JaxLlama(JAX_PRESETS["llama_tiny"]).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def _port(params, **ec):
    kw = dict(TIGHT, cache_dtype="float32")
    kw.update(ec)
    return InferenceEngine(CFG, params_from_jax(params), EngineConfig(**kw),
                           device="cpu")


def _script(engine, sp, stop_token):
    """Three greedy requests under preemption, then a fourth that stops on
    ``stop_token`` (inside a window at k > 1), submitted mid-flight."""
    reqs = [engine.submit(p, sp(temperature=0.0, max_tokens=14)) for p in PROMPTS]
    engine.step()
    engine.step()
    reqs.append(engine.submit([2, 7, 1, 8], sp(temperature=0.0, max_tokens=12,
                                            stop_token_ids=(stop_token[0],))))
    while engine.has_work:
        engine.step()
    return reqs


@pytest.fixture(scope="module")
def stop_token(params):
    """(token, n): the first token greedy decoding of [2, 7, 1, 8] gives at
    index >= 2 that it has not given before, and the output length a stop
    on it leaves: the stop then falls inside a 4- or 8-step window."""
    eng = _port(params, max_seqs=1, num_blocks=16)
    [r] = eng.generate([[2, 7, 1, 8]], SamplingParams(temperature=0.0, max_tokens=8))
    out = r.output_token_ids
    i = next(i for i in range(2, len(out)) if out[i] not in out[:i])
    return out[i], i + 1


@pytest.fixture(scope="module")
def jax_runs(params, stop_token):
    """The JAX engine's run of the script, once per (k, pool): (requests,
    stats)."""
    runs = {}

    def run(k, pool):
        if (k, pool) not in runs:
            eng = JaxEngine(JAX_PRESETS["llama_tiny"],
                            jax.tree_util.tree_map(jnp.asarray, params),
                            JaxEngineConfig(cache_dtype=pool, steps_per_sync=k, **TIGHT))
            runs[k, pool] = (_script(eng, JaxSamplingParams, stop_token), dict(eng.stats))
        return runs[k, pool]
    return run


def _tokens(reqs):
    return [(r.output_token_ids, r.finish_reason) for r in reqs]


@pytest.mark.parametrize("pool", ["float32", "int8"])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_windows_match_jax_under_preemption_with_a_stop_inside(params, stop_token,
                                                              jax_runs, k, pool):
    want, want_stats = jax_runs(k, pool)
    eng = _port(params, cache_dtype=pool, steps_per_sync=k)
    got = _script(eng, SamplingParams, stop_token)
    assert _tokens(got) == _tokens(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                   atol=LOGPROB_ATOL, rtol=0)
    assert got[-1].finish_reason == "stop"
    assert len(got[-1].output_token_ids) == stop_token[1]
    assert want_stats["preemptions"] >= 1
    assert {c: eng.stats[c] for c in COUNTERS} == {c: want_stats[c] for c in COUNTERS}
    assert eng.block_manager.num_free == TIGHT["num_blocks"] - 1


def test_seeded_stream_is_the_same_at_every_window_and_in_any_company(params):
    """A seeded request's tokens depend on (seed, count) only: alone at
    k = 1, 4 and 8, and beside other sampling requests."""
    sp = SamplingParams(temperature=0.9, top_k=20, max_tokens=11, seed=321)
    outs = []
    for k in (1, 4, 8):
        eng = _port(params, steps_per_sync=k, num_blocks=64, max_seqs=4)
        [alone] = eng.generate([[3, 1, 4]], sp)
        seeded = eng.submit([3, 1, 4], sp)
        eng.submit([9, 8, 7], SamplingParams(temperature=1.0, max_tokens=5))
        eng.submit([2, 2], SamplingParams(temperature=0.7, max_tokens=9, seed=1))
        while eng.has_work:
            eng.step()
        assert seeded.output_token_ids == alone.output_token_ids
        outs.append(alone.output_token_ids)
    assert outs[0] == outs[1] == outs[2] and len(outs[0]) == 11


# ----------------------------------------------------------------------
# Nothing in the decode path reads the device back
# ----------------------------------------------------------------------

class _NoHostSync(TorchDispatchMode):
    """Raises on the ops that read a tensor back to the host or compute a
    shape from its values: ``.item()``/``.tolist()``-style scalars,
    ``nonzero``, ``masked_select``, and indexing by a bool mask."""

    FORBIDDEN = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
                 torch.ops.aten.masked_select.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.FORBIDDEN:
            raise AssertionError(f"host sync: {func}")
        if func.overloadpacket in (torch.ops.aten.index, torch.ops.aten.index_put_,
                                   torch.ops.aten.index_put):
            indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(i is not None and i.dtype == torch.bool for i in indices):
                raise AssertionError(f"host sync: {func} with a bool index")
        return func(*args, **kwargs)


@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_decode_window_and_kv_writes_never_wait_on_the_device(params, pool):
    """The executor's decode window (greedy and sampling rows, padding in
    the batch), ``paged_update`` with padding rows and ``sample_tokens``
    run no op that reads the device back."""
    eng = _port(params, cache_dtype=pool, steps_per_sync=4, num_blocks=64)
    eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=8))
    eng.submit([4, 5], SamplingParams(temperature=0.8, top_p=0.9, max_tokens=8, seed=3))
    eng.step()  # admission and prefill; the third slot stays free
    with _NoHostSync():
        pending = eng._decode_dispatch()
    assert pending is not None and pending[1] == 4
    eng._decode_complete(pending)

    layer = eng.cache[0]
    k_new = torch.randn(2, 3, CFG.num_kv_heads, CFG.resolved_head_dim)
    slots = tkv.slot_mapping(torch.tensor([[1, 2], [3, 4]], dtype=torch.int32),
                             torch.tensor([[0, 1, -1], [5, -1, -1]]), 8)
    logits = torch.randn(3, 40)
    with _NoHostSync():
        tkv.paged_update(layer, k_new, k_new, slots)
        sample_tokens(logits, torch.tensor([1, 2, 3]), torch.tensor([0, 4, 9]),
                      torch.tensor([0.0, 1.0, 0.5]), torch.tensor([0, 5, 0]),
                      torch.tensor([1.0, 1.0, 0.7]))


def test_the_guard_sees_a_host_sync():
    """The guard itself: a bool-mask index and ``.item()`` raise under it."""
    x = torch.arange(6.0)
    with _NoHostSync(), pytest.raises(AssertionError, match="bool index"):
        x[x > 2]
    with _NoHostSync(), pytest.raises(AssertionError, match="host sync"):
        x.sum().item()


# ----------------------------------------------------------------------
# Ports of tests/test_host_overlap.py (decode-state cache) and
# tests/test_serving.py (multi-step decode)
# ----------------------------------------------------------------------

def _cpu_engine(params, cache_on=True, **over):
    kw = dict(max_seqs=3, block_size=8, num_blocks=64, max_model_len=64,
              cache_dtype="float32", eos_token_id=-1, decode_state_cache=cache_on)
    kw.update(over)
    return InferenceEngine(CFG, params_from_jax(params), EngineConfig(**kw), device="cpu")


def _results(results):
    return [(r.request_id, r.output_token_ids, r.finish_reason) for r in results]


@pytest.mark.parametrize("sampled", [False, True])
def test_decode_state_cache_matches_reupload(params, sampled):
    """Identical outputs, greedy and seeded-sampled, cache on vs off."""
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8], [9, 10, 11, 12]]
    sp = (SamplingParams(temperature=0.9, top_k=7, seed=11, max_tokens=10) if sampled
          else SamplingParams(temperature=0.0, max_tokens=10))
    want = _cpu_engine(params, False).generate(prompts, sp)
    got = _cpu_engine(params, True).generate(prompts, sp)
    assert _results(got) == _results(want)


def test_decode_state_cache_matches_across_preemption(params):
    """Preemption and readmission (recompute) with seeded sampling: the
    counts resume mid-stream on readmission, cache on as off."""
    sp = SamplingParams(temperature=0.7, seed=5, max_tokens=12)
    kw = dict(max_seqs=3, num_blocks=8, max_model_len=48)
    want, got = _cpu_engine(params, False, **kw), _cpu_engine(params, True, **kw)
    rw, rg = want.generate(PROMPTS, sp), got.generate(PROMPTS, sp)
    assert want.stats["preemptions"] >= 1
    assert got.stats["preemptions"] == want.stats["preemptions"]
    assert _results(rg) == _results(rw)


def test_decode_state_cache_matches_multi_step(params):
    prompts = [[1, 2, 3, 4], [5, 6, 7]]
    sp = SamplingParams(temperature=0.0, max_tokens=9)
    want = _cpu_engine(params, False, max_seqs=2, steps_per_sync=4)
    got = _cpu_engine(params, True, max_seqs=2, steps_per_sync=4)
    assert _results(got.generate(prompts, sp)) == _results(want.generate(prompts, sp))


def test_clean_decode_step_issues_zero_uploads(params):
    """Once the batch settles, every further decode step reuses the
    resident state: zero decode-state uploads while decode_steps advances."""
    eng = _cpu_engine(params, True, block_size=64, num_blocks=8)
    eng.submit([1, 2, 3, 4], SamplingParams(temperature=0.0, max_tokens=30))
    eng.step()  # admission and prefill
    eng.step()  # first decode: uploads the admitted row
    settled = eng.stats["decode_state_uploads"]
    clean_before = eng.stats["decode_state_clean_syncs"]
    steps_before = eng.stats["decode_steps"]
    for _ in range(6):
        eng.step()
    assert eng.stats["decode_steps"] == steps_before + 6
    assert eng.stats["decode_state_uploads"] == settled
    assert eng.stats["decode_state_clean_syncs"] >= clean_before + 6
    _, _, n = eng.telemetry.host_prep.snapshot()
    assert n >= 7
    # The resident rows equal the host mirrors; the active row's count
    # advanced on the device (free rows' counts are never read).
    tables, seeds, counts = eng._state_cache.tensors[:3]
    np.testing.assert_array_equal(tables.numpy(), eng._mirrors["block_tables"])
    np.testing.assert_array_equal(seeds.numpy(), eng._mirrors["slot_seeds"])
    assert counts[0] == eng._mirrors["gen_counts"][0] == 8


def test_decode_state_upload_counters_exposed(params):
    """The counters ride the engine stats dict (the /metrics scalar
    source), present even with the cache disabled, and stay 0 there."""
    for on in (True, False):
        eng = _cpu_engine(params, on)
        eng.generate([[1, 2]], SamplingParams(temperature=0.0, max_tokens=3))
        for k in ("decode_state_uploads", "decode_state_rows",
                  "decode_state_clean_syncs", "hbm_growth_deferrals"):
            assert k in eng.stats
        assert (eng.stats["decode_state_uploads"] > 0) == on


@pytest.mark.parametrize("sampled", [False, True])
def test_multi_step_decode_matches_single_step(params, sampled):
    """steps_per_sync=4 gives the tokens of single-step decode, greedy and
    seeded, EOS handling inside the window included."""
    prompts = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8]]
    sp = (SamplingParams(temperature=0.8, top_k=20, seed=7, max_tokens=11) if sampled
          else SamplingParams(temperature=0.0, max_tokens=11))
    want = _cpu_engine(params, max_seqs=2, steps_per_sync=1).generate(prompts, sp)
    got = _cpu_engine(params, max_seqs=2, steps_per_sync=4).generate(prompts, sp)
    assert _results(got) == _results(want)


def test_warmup_decode_ladder_is_idempotent_and_matches_cold(params):
    prompts = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8]]
    sp = SamplingParams(temperature=0.0, max_tokens=9)
    want = _cpu_engine(params, max_seqs=2, steps_per_sync=4).generate(prompts, sp)
    warm = _cpu_engine(params, max_seqs=2, steps_per_sync=4)
    warm.warmup_decode_ladder()
    warm.warmup_decode_ladder()
    assert warm.executor.graph is None  # no graph off the card
    assert _results(warm.generate(prompts, sp)) == _results(want)


def test_multi_step_decode_respects_stop_tokens(params):
    """A stop token hit mid-window finishes the request there; the window's
    later tokens are discarded."""
    eng = _cpu_engine(params, max_seqs=1, num_blocks=32, steps_per_sync=4)
    [probe] = eng.generate([[5, 4, 3]], SamplingParams(temperature=0.0, max_tokens=8))
    stop = probe.output_token_ids[1]
    [r] = eng.generate([[5, 4, 3]], SamplingParams(temperature=0.0, max_tokens=8,
                                                   stop_token_ids=(stop,)))
    assert r.output_token_ids == probe.output_token_ids[:2]
    assert r.finish_reason == "stop" and eng.num_active == 0


def test_window_ladder_rounds_up_under_budget_and_down_under_room(params):
    """The reference's ladder: the smallest ladder length covering the
    least remaining budget, then halved under the KV room."""
    eng = _cpu_engine(params, max_seqs=1, steps_per_sync=8, max_model_len=64)
    req = eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=40))
    eng.step()
    slot = eng.slots[0]
    for budget, room, want in ((40, 60, 8), (5, 60, 8), (4, 60, 4), (3, 60, 4),
                               (1, 60, 1), (40, 5, 4), (40, 1, 1)):
        req.params.max_tokens = len(req.output_token_ids) + budget
        slot.seq_len = eng.cfg.max_model_len - room
        assert eng._window_steps([slot]) == want, (budget, room)


def test_a_window_that_cannot_reserve_its_blocks_falls_back_to_one_step(params):
    """A 4-step window needs a second block that the pool cannot give (its
    free blocks are held elsewhere, and there is nothing to preempt): the
    window shrinks to one step and counts a deferral instead of failing,
    and the tokens are those of an unconstrained run."""
    sp = SamplingParams(temperature=0.0, max_tokens=4)
    [want] = _cpu_engine(params, max_seqs=1, steps_per_sync=8).generate([[1, 2, 3, 4, 5]], sp)
    eng = _cpu_engine(params, max_seqs=1, num_blocks=8, max_model_len=32, steps_per_sync=8)
    req = eng.submit([1, 2, 3, 4, 5], sp)
    eng.step()  # admission: one block for the prompt and its next token
    held = eng.block_manager.allocate(eng.block_manager.num_free)
    while eng.has_work:
        eng.step()
    assert req.output_token_ids == want.output_token_ids
    assert eng.stats["hbm_growth_deferrals"] == 1
    eng.block_manager.free(held)
