"""The port's ``InferenceEngine`` against the JAX package's on the same
weights (``llama_tiny``, float32, CPU).

Both engines run the same request script: a batch, more requests than
slots, a request submitted mid-flight, and a pool small enough to force
preemption. Greedy tokens must be equal; logprobs agree within 1e-4 (the
two frameworks sum in different orders, and the prefill bucket a
recomputed sequence lands in changes the padded shapes).
"""

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
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams

LOGPROB_ATOL = 1e-4


@pytest.fixture(scope="module")
def params():
    """JAX init plus numpy noise, so the logits are spread enough that no
    float32 near-tie decides a greedy token."""
    cfg = JAX_PRESETS["llama_tiny"]
    tree = JaxLlama(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def _engines(params, **ec):
    jax_engine = JaxEngine(JAX_PRESETS["llama_tiny"], jax.tree_util.tree_map(jnp.asarray, params),
                           JaxEngineConfig(**ec))
    torch_engine = InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                                   EngineConfig(**ec), device="cpu")
    return jax_engine, torch_engine


def _script(engine, sampling_params):
    """The request script both engines run; returns every request in order."""
    greedy = lambda n: sampling_params(temperature=0.0, max_tokens=n)  # noqa: E731
    reqs = [engine.submit(p, greedy(6)) for p in ([1, 2, 3], [4, 5, 6, 7, 8], [9], [10, 11])]
    reqs += [engine.submit([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], greedy(10))]  # crosses a block
    for _ in range(3):
        engine.step()
    reqs.append(engine.submit([4, 5], greedy(4)))  # joins mid-flight
    reqs += [engine.submit([i + 1, i + 7], greedy(3)) for i in range(10)]  # > max_seqs
    while engine.has_work:
        engine.step()
    return reqs


def _assert_same_outputs(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.output_token_ids == w.output_token_ids, g.request_id
        assert g.finish_reason == w.finish_reason
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                   atol=LOGPROB_ATOL, rtol=0)


def test_engine_matches_jax_more_requests_than_slots(params):
    ec = dict(max_seqs=4, block_size=8, num_blocks=64, max_model_len=64,
              cache_dtype="float32", eos_token_id=-1)
    jax_engine, torch_engine = _engines(params, **ec)
    want = _script(jax_engine, JaxSamplingParams)
    got = _script(torch_engine, SamplingParams)
    _assert_same_outputs(want, got)
    assert [len(r.output_token_ids) for r in got] == [6] * 4 + [10, 4] + [3] * 10
    assert torch_engine.block_manager.num_free == ec["num_blocks"] - 1
    assert torch_engine.num_active == 0


def test_engine_matches_jax_under_preemption(params):
    """Seven usable blocks of 8 tokens for three sequences growing to 19-24
    tokens: the youngest is preempted and recomputed on readmission."""
    ec = dict(max_seqs=3, block_size=8, num_blocks=8, max_model_len=48,
              cache_dtype="float32", eos_token_id=-1)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13], [14, 15, 16, 17, 18]]
    jax_engine, torch_engine = _engines(params, **ec)
    want = jax_engine.generate(prompts, JaxSamplingParams(temperature=0.0, max_tokens=12))
    got = torch_engine.generate(prompts, SamplingParams(temperature=0.0, max_tokens=12))
    _assert_same_outputs(want, got)
    assert all(len(r.output_token_ids) == 12 for r in got)
    assert jax_engine.stats["preemptions"] >= 1
    assert torch_engine.stats["preemptions"] >= 1
    for engine in (jax_engine, torch_engine):
        assert engine.block_manager.num_free == ec["num_blocks"] - 1


def test_engine_matches_jax_on_an_int8_pool(params):
    """The same request script on int8 KV pools (rows quantized at write,
    prefill through the dequantized gather, decode through the paged
    attention with scales) gives the JAX int8 engine's greedy tokens."""
    ec = dict(max_seqs=4, block_size=8, num_blocks=64, max_model_len=64,
              cache_dtype="int8", eos_token_id=-1)
    jax_engine, torch_engine = _engines(params, **ec)
    assert torch_engine.cache[0]["k"].dtype == torch.int8
    want = _script(jax_engine, JaxSamplingParams)
    got = _script(torch_engine, SamplingParams)
    _assert_same_outputs(want, got)
    assert torch_engine.block_manager.num_free == ec["num_blocks"] - 1


def test_engine_matches_jax_on_an_int8_pool_under_preemption(params):
    ec = dict(max_seqs=3, block_size=8, num_blocks=8, max_model_len=48,
              cache_dtype="int8", eos_token_id=-1)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13], [14, 15, 16, 17, 18]]
    jax_engine, torch_engine = _engines(params, **ec)
    want = jax_engine.generate(prompts, JaxSamplingParams(temperature=0.0, max_tokens=12))
    got = torch_engine.generate(prompts, SamplingParams(temperature=0.0, max_tokens=12))
    _assert_same_outputs(want, got)
    assert torch_engine.stats["preemptions"] >= 1


def test_engine_seeded_request_independent_of_batch_company(params):
    """A seeded sampling request draws the same tokens alone and in company
    (the port's own property; its bits differ from JAX's by design)."""
    ec = EngineConfig(max_seqs=4, block_size=8, num_blocks=64, max_model_len=64,
                      cache_dtype="float32", eos_token_id=-1)
    engine = InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params), ec,
                             device="cpu")
    p = SamplingParams(temperature=1.0, max_tokens=5, seed=123)
    [alone] = engine.generate([[1, 2, 3]], p)
    seeded = engine.submit([1, 2, 3], p)
    engine.submit([9, 8, 7], SamplingParams(temperature=1.0, max_tokens=7))
    engine.submit([4, 4], SamplingParams(temperature=0.7, max_tokens=3))
    while engine.has_work:
        engine.step()
    assert seeded.output_token_ids == alone.output_token_ids


def test_engine_rejects_unsatisfiable_pool_and_empty_prompt(params):
    ec = EngineConfig(max_seqs=2, block_size=8, num_blocks=8, max_model_len=64,
                      cache_dtype="float32")
    with pytest.raises(ValueError, match="num_blocks"):
        InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params), ec,
                        device="cpu")
    engine = InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                             EngineConfig(num_blocks=80, max_model_len=64,
                                          cache_dtype="float32"), device="cpu")
    with pytest.raises(ValueError):
        engine.submit([])
    with pytest.raises(ValueError, match="dtype"):
        InferenceEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                        EngineConfig(num_blocks=80, max_model_len=64,
                                     cache_dtype="float64"), device="cpu")
