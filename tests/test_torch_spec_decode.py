"""N-gram speculative decode in the port (``dlti_tpu_torch.serving.engine``)
against the JAX package on the same weights (``llama_tiny``, float32, CPU).

* The prompt-lookup proposal equals the JAX spec program's own ``propose``
  on seeded histories.
* Greedy speculative output equals plain decode and the JAX spec engine at
  k 1/4/8, at one and several rounds a host sync, on float32 and int8 pools;
  logprobs within 1e-5. With the gate off, ``spec_proposed`` and
  ``spec_accepted`` equal the JAX engine's (same ladder, same proposals).
* The per-slot gate holds the contract of
  ``tests/test_spec_production.py::test_zero_hit_slot_pauses_alone`` on that
  test's own weights: the slot whose drafts fail pauses, the cyclic slot
  never does, and the outputs equal plain decode.
* Sampling slots ride the spec rounds with their plain-decode draws: seeded
  streams equal the plain engine's, and the draw distribution agrees with
  the JAX spec engine's (chi-square).
* A spec dispatch runs no op that reads the device back.
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
from dlti_tpu.serving.engine import SPEC_METRIC_NAMES as JAX_SPEC_NAMES
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams
from dlti_tpu_torch.ops.attention import _half_window_attention, paged_window_attention
from dlti_tpu_torch.ops.kv_cache import init_paged_cache
from dlti_tpu_torch.serving.engine import SPEC_METRIC_NAMES, propose_drafts

LOGPROB_ATOL = 1e-5
CYCLIC = [6, 6, 7, 7, 6, 6, 7, 7]      # the JAX tests' favourable prompt
ACYCLIC = [2, 7, 1, 8, 2, 8]           # and their adversarial one
PROMPTS = [CYCLIC, [1, 2, 3, 4, 5], ACYCLIC, [5, 5, 5, 5], [9, 3, 9, 3, 9, 3, 9]]


def _jax_init():
    return JaxLlama(JAX_PRESETS["llama_tiny"]).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params():
    """JAX init plus numpy noise, so no float32 near-tie decides a greedy
    token (as in tests/test_torch_engine.py)."""
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(_jax_init()))


def _ec(**over):
    base = dict(max_seqs=4, block_size=8, num_blocks=64, max_model_len=128,
                cache_dtype="float32", eos_token_id=-1, speculative="ngram")
    base.update(over)
    return base


def _port(params, **ec):
    return InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                           EngineConfig(**_ec(**ec)), device="cpu")


def _jax(params, **ec):
    return JaxEngine(JAX_PRESETS["llama_tiny"], jax.tree_util.tree_map(jnp.asarray, params),
                     JaxEngineConfig(**_ec(**ec)))


def _same(want, got):
    for w, g in zip(want, got):
        assert g.output_token_ids == w.output_token_ids
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                   atol=LOGPROB_ATOL, rtol=0)


# ----------------------------------------------------------------------
# The proposal
# ----------------------------------------------------------------------

def _jax_propose(k: int, n: int, max_model_len: int):
    """The ``propose`` closure of the JAX spec program (``jax.jit`` keeps
    the traced Python function as ``__wrapped__``)."""
    ex = _jax(jax.device_get(_jax_init()), speculative="none", ngram_size=n,
              num_draft_tokens=k, max_model_len=max_model_len).executor
    inner = ex._build_spec_decode_fn(k, 1).__wrapped__
    return dict(zip(inner.__code__.co_freevars,
                    (c.cell_contents for c in inner.__closure__)))["propose"]


@pytest.mark.parametrize("k,n", [(1, 2), (4, 2), (8, 2), (4, 3), (3, 1)])
def test_proposal_matches_jax_propose(k, n):
    mml = 48
    propose = _jax_propose(k, n, mml)
    rng = np.random.default_rng(k * 10 + n)
    S, W = 16, mml + k + 2
    hits = misses = 0
    for trial in range(4):
        # Small vocabularies make repeats (hits), larger ones misses.
        hist = rng.integers(0, 3 + 5 * trial, size=(S, W)).astype(np.int32)
        seq_len = rng.integers(0, mml - 1, size=S).astype(np.int32)
        want = np.asarray(propose(jnp.asarray(hist), jnp.asarray(seq_len)))
        got = propose_drafts(torch.from_numpy(hist).long(), torch.from_numpy(seq_len).long(),
                             k, n).numpy()
        np.testing.assert_array_equal(got, want)
        hits += int((want[:, 0] >= 0).sum())
        misses += int((want[:, 0] < 0).sum())
    assert hits and misses


@pytest.mark.parametrize("pool,dtype,kv_heads", [
    ("int8", torch.bfloat16, 2), ("bfloat16", torch.bfloat16, 4), ("float16", torch.float16, 1)])
@pytest.mark.parametrize("window", [None, 9])
def test_half_window_attention_layout_equals_the_reference(pool, dtype, kv_heads, window):
    """The card's form of the multi-position paged attention (the window
    gathered once into q's dtype, GQA heads grouped, both products with
    float32 output) run with a float32 emulation of its GEMM gives the
    reference path's bytes on half-precision pools (the layout, the causal
    and window masks, padding rows). On an int8 pool it applies the row
    scales to the float32 scores and probabilities, where the reference
    rounds each ``payload * scale`` to q's dtype first: within one step of
    q's type (2**-6 in bf16) of the reference's output."""
    gen = torch.Generator().manual_seed(0)
    cache = init_paged_cache(1, 32, 8, kv_heads, 16,
                             "int8" if pool == "int8" else getattr(torch, pool))[0]
    for name in ("k", "v"):
        t = cache[name]
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int8))
            cache[name + "_scale"].uniform_(0.001, 0.02, generator=gen)
        else:
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    tables = torch.randint(1, 32, (3, 6), generator=gen, dtype=torch.int32)
    pos = torch.stack([torch.arange(5) + o for o in (0, 17, 40)]).to(torch.int32)
    pos[2, 3:] = -1  # padding rows
    q = torch.randn(3, 5, 8, 16, generator=gen).to(dtype)
    want = paged_window_attention(q, cache, tables, pos, window)  # the CPU: reference path
    got = _half_window_attention(q, cache, tables, pos, window,
                                 lambda a, b: torch.bmm(a.float(), b.float()))
    assert got.dtype == dtype
    if pool == "int8":
        torch.testing.assert_close(got.float(), want.float(), atol=2.0 ** -6, rtol=0)
        assert not torch.equal(got, want)  # the scales are applied elsewhere
    else:
        assert torch.equal(got, want)


def test_spec_metric_names_match_jax():
    assert SPEC_METRIC_NAMES == JAX_SPEC_NAMES


# ----------------------------------------------------------------------
# Greedy equality
# ----------------------------------------------------------------------

@pytest.mark.parametrize("steps_per_sync", [1, 4])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_greedy_spec_equals_plain_and_jax(params, k, steps_per_sync):
    over = dict(num_draft_tokens=k, steps_per_sync=steps_per_sync, spec_min_acceptance=0.0)
    sp = dict(temperature=0.0, max_tokens=24)
    jeng = _jax(params, **over)
    want = jeng.generate(PROMPTS, JaxSamplingParams(**sp))
    port = _port(params, **over)
    got = port.generate(PROMPTS, SamplingParams(**sp))
    _same(want, got)
    plain = _port(params, speculative="none", steps_per_sync=steps_per_sync)
    _same(plain.generate(PROMPTS, SamplingParams(**sp)), got)
    for key in ("spec_proposed", "spec_accepted", "decode_steps", "generated_tokens"):
        assert port.stats[key] == jeng.stats[key], key
    assert port.stats["spec_accepted"] > 0


@pytest.mark.parametrize("pool", ["int8"])
def test_greedy_spec_on_an_int8_pool_under_preemption_matches_jax(params, pool):
    over = dict(cache_dtype=pool, num_blocks=14, max_seqs=4, max_model_len=64,
                steps_per_sync=2, spec_min_acceptance=0.0)
    sp = dict(temperature=0.0, max_tokens=20)
    jeng = _jax(params, **over)
    want = jeng.generate(PROMPTS, JaxSamplingParams(**sp))
    port = _port(params, **over)
    got = port.generate(PROMPTS, SamplingParams(**sp))
    _same(want, got)
    assert port.stats["preemptions"] == jeng.stats["preemptions"] > 0
    plain = _port(params, **{**over, "speculative": "none"})
    _same(plain.generate(PROMPTS, SamplingParams(**sp)), got)


def test_spec_with_chunked_prefill_and_prefix_cache_matches_jax(params):
    over = dict(max_prefill_tokens_per_step=8, enable_prefix_caching=True,
                steps_per_sync=4, spec_min_acceptance=0.0)
    sp = dict(temperature=0.0, max_tokens=16)
    prompts = [CYCLIC * 3, CYCLIC * 3 + [1, 2], ACYCLIC * 2]
    jeng, port = _jax(params, **over), _port(params, **over)
    for _ in range(2):  # the second pass hits the cached prefixes
        _same(jeng.generate(prompts, JaxSamplingParams(**sp)),
              port.generate(prompts, SamplingParams(**sp)))
    for key in ("spec_proposed", "spec_accepted", "prefix_cached_tokens"):
        assert port.stats[key] == jeng.stats[key], key


# ----------------------------------------------------------------------
# The per-slot gate
# ----------------------------------------------------------------------

def test_zero_hit_slot_pauses_alone():
    """The JAX test's scenario on its own weights (the unperturbed JAX
    init): the adversarial slot's drafts keep failing and it pauses; the
    cyclic slot, whose lookups find nothing until its output turns
    repetitive and then land, never pauses; the outputs are plain
    decode's, and the JAX engine's plain decode's."""
    tiny = jax.device_get(_jax_init())
    over = dict(max_seqs=2, num_blocks=128, max_model_len=256)
    eng = _port(tiny, spec_probe_window=6, spec_cooldown=10_000, **over)
    sp = SamplingParams(temperature=0.0, max_tokens=48)
    fav = eng.submit(CYCLIC, sp)
    adv = eng.submit(ACYCLIC, sp)
    eng.step()
    sid = {s.request.request_id: s.slot_id for s in eng.slots if s.request}
    fav_paused = adv_paused = False
    while eng.has_work:
        eng.step()
        fav_paused |= bool(eng._spec_slot_pause[sid[fav.request_id]] > 0)
        adv_paused |= bool(eng._spec_slot_pause[sid[adv.request_id]] > 0)
    assert adv_paused and not fav_paused
    assert eng.stats["spec_paused_rounds"] > 0
    assert eng.stats["spec_accepted"] > 0
    plain = _port(tiny, speculative="none", **over).generate([CYCLIC, ACYCLIC], sp)
    assert [fav.output_token_ids, adv.output_token_ids] == \
        [r.output_token_ids for r in plain]
    jplain = _jax(tiny, speculative="none", **over).generate(
        [CYCLIC, ACYCLIC], JaxSamplingParams(temperature=0.0, max_tokens=48))
    assert [r.output_token_ids for r in plain] == [r.output_token_ids for r in jplain]


def test_released_slot_forgets_gate_state(params):
    eng = _port(params, max_seqs=1, spec_probe_window=4, spec_cooldown=10_000)
    req = eng.submit(ACYCLIC, SamplingParams(temperature=0.0, max_tokens=24))
    while eng.has_work:
        eng.step()
    assert req.finish_reason == "length"
    assert (eng._spec_slot_pause[0], eng._spec_slot_prop[0], eng._spec_slot_hits[0],
            eng._spec_slot_acc[0]) == (0, 0, 0, 0)
    assert eng._spec_slot_ewma[0] == eng.cfg.num_draft_tokens


def test_adaptive_ladder_shrinks_the_draft_and_a_pinned_one_does_not(params):
    sp = SamplingParams(temperature=0.0, max_tokens=48)
    for adaptive in (True, False):
        eng = _port(params, max_seqs=1, num_blocks=128, max_model_len=256,
                    spec_min_acceptance=0.0, spec_adaptive=adaptive)
        eng.submit(ACYCLIC, sp)
        ks = set()
        while eng.has_work:
            eng.step()
            ks.add(eng.spec_draft_len)
        if adaptive:
            assert min(ks - {0}) < eng.cfg.num_draft_tokens
        else:
            assert ks - {0} == {eng.cfg.num_draft_tokens}


# ----------------------------------------------------------------------
# Sampling slots
# ----------------------------------------------------------------------

def test_seeded_sampling_in_spec_rounds_equals_plain_decode(params):
    """Greedy cyclic slots speculate while seeded sampling slots share the
    batch: each sampling slot takes the plain-decode draw for its (seed,
    count), so its stream is the plain engine's."""
    reqs = [(CYCLIC, SamplingParams(temperature=0.0, max_tokens=20)),
            ([5, 5, 5, 5], SamplingParams(temperature=0.0, max_tokens=20))]
    reqs += [([1, 2, 3], SamplingParams(temperature=0.9, top_p=0.95, max_tokens=20, seed=s))
             for s in (3, 4)]
    outs = {}
    for mode in ("ngram", "none"):
        eng = _port(params, speculative=mode, steps_per_sync=4, spec_min_acceptance=0.0)
        got = [eng.submit(p, sp) for p, sp in reqs]
        while eng.has_work:
            eng.step()
        outs[mode] = [r.output_token_ids for r in got]
        if mode == "ngram":
            assert eng.stats["spec_accepted"] > 0
    assert outs["ngram"] == outs["none"]


def test_sampling_distribution_under_spec_agrees_with_jax(params):
    """Seeded sampling requests (temperature 1, top-k 4) share spec rounds
    with greedy cyclic requests in each package's engine. Their second
    token is drawn in a spec round; among the requests whose first token
    is the most common one, its distribution agrees between the packages
    (two-sample chi-square at the 99.9% quantile, the same support). The
    seeds are fixed, so the outcome is too."""
    from scipy.stats import chi2

    n = 192
    pairs = {}
    for name, eng, sp_cls in (
            ("jax", _jax(params, max_seqs=8, spec_min_acceptance=0.0), JaxSamplingParams),
            ("torch", _port(params, max_seqs=8, spec_min_acceptance=0.0), SamplingParams)):
        reqs = []
        for i in range(n):
            if i % 3 == 0:
                eng.submit(CYCLIC * 2, sp_cls(temperature=0.0, max_tokens=8))
            reqs.append(eng.submit([3, 1, 4], sp_cls(temperature=1.0, top_k=4,
                                                     max_tokens=2, seed=i)))
        while eng.has_work:
            eng.step()
        assert eng.stats["spec_proposed"] > 0
        pairs[name] = [tuple(r.output_token_ids) for r in reqs]
    firsts = [p[0] for ps in pairs.values() for p in ps]
    mode = max(set(firsts), key=firsts.count)
    seconds = {name: [p[1] for p in ps if p[0] == mode] for name, ps in pairs.items()}
    support = sorted(set(seconds["jax"]) | set(seconds["torch"]))
    assert len(support) <= 4 and set(seconds["torch"]) == set(seconds["jax"])
    a = np.array([seconds["jax"].count(t) for t in support], float)
    b = np.array([seconds["torch"].count(t) for t in support], float)
    na, nb = a.sum(), b.sum()
    assert min(na, nb) >= 20
    pooled = (a + b) / (na + nb)
    stat = (((a - na * pooled) ** 2) / (na * pooled)
            + ((b - nb * pooled) ** 2) / (nb * pooled)).sum()
    assert stat < chi2.ppf(0.999, len(support) - 1)


# ----------------------------------------------------------------------
# No host sync in a spec dispatch
# ----------------------------------------------------------------------

class _NoHostSync(TorchDispatchMode):
    """Raises on the ops that read a tensor back to the host or compute a
    shape from its values (as in tests/test_torch_decode_state.py)."""

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
def test_spec_dispatch_never_waits_on_the_device(params, pool):
    eng = _port(params, cache_dtype=pool, steps_per_sync=4, spec_min_acceptance=0.0)
    eng.submit(CYCLIC, SamplingParams(temperature=0.0, max_tokens=16))
    eng.submit([4, 5], SamplingParams(temperature=0.8, top_p=0.9, max_tokens=16, seed=3))
    eng.step()  # admission and prefill
    with _NoHostSync():
        pending = eng._decode_dispatch()
    assert pending[0] == "spec" and eng.spec_draft_len > 0
    eng._decode_complete(pending)
    while eng.has_work:
        eng.step()
