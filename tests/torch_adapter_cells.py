"""Shared fixtures and the equivalence cells of the port's multi-LoRA
serving tests (``tests/test_torch_adapters*.py``): three adapters over one
shared ``llama_tiny`` base, written by the port, and :func:`_cell`, which
runs one mixed batch on a port engine against the JAX multi-adapter engine,
the port's merged-weights engines and an adapter-off engine. Imports both
packages; collected by no test run itself."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlti_tpu.config import MODEL_PRESETS as JAX_PRESETS
from dlti_tpu.config import LoRAConfig as JaxLoRAConfig
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.models.lora import merge_lora_params as jax_merge
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu.serving import adapters as jad
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.models import merge_lora_params, params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams
from dlti_tpu_torch.serving import adapters as tad

CFG = MODEL_PRESETS["llama_tiny"]
JCFG = JAX_PRESETS["llama_tiny"]
TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")
R, ALPHA = 4, 8.0
NAMES = ("ad-a", "ad-b", "ad-c")
LOGPROB_ATOL = 1e-4
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8], [5, 5, 5, 5], [11, 12, 13],
           [7, 7, 8, 8, 7, 7, 8, 8], [20, 21, 22, 23, 24], [9, 8, 7], [1, 2, 3, 1, 2]]
# Two base rows and two of each adapter in one batch of eight.
ASSIGN = ["ad-a", "ad-b", "", "ad-c", "ad-a", "", "ad-b", "ad-c"]


@pytest.fixture(autouse=True)
def _clean_catalogs():
    """Both catalogs are process-wide by design; keep tests hermetic."""
    tad.get_catalog().clear()
    jad.get_catalog().clear()
    yield
    tad.get_catalog().clear()
    jad.get_catalog().clear()


def _lora_tree(seed):
    """The JAX init under LoRA (r 4, alpha 8), base jittered so no float32
    near-tie decides a greedy token, both factors given real values."""
    tree = jax.device_get(JaxLlama(JCFG, JaxLoRAConfig(r=R, alpha=int(ALPHA), dropout=0.0))
                          .init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    base_rng = np.random.default_rng(0)
    lora_rng = np.random.RandomState(seed)

    def leaf(path, a):
        if getattr(path[-1], "key", "") in ("lora_a", "lora_b"):
            return lora_rng.normal(0.0, 0.2, a.shape).astype(np.float32)
        return (np.asarray(a) + 0.05 * base_rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Three adapters over one shared base, written by the port; their
    trees in both packages' forms and the merged weights."""
    root = tmp_path_factory.mktemp("adapters")
    trees = {name: _lora_tree(i + 1) for i, name in enumerate(NAMES)}
    flat = {name: params_from_jax(t) for name, t in trees.items()}
    base = merge_lora_params(flat["ad-a"], scaling=0.0)
    dirs = {}
    for name in NAMES:
        dirs[name] = str(root / name)
        tad.save_adapter(dirs[name], flat[name], alpha=ALPHA)
    return types.SimpleNamespace(trees=trees, flat=flat, base=base, dirs=dirs,
                                 jbase=jax_merge(trees["ad-a"], scaling=0.0))


def _register(dirs, names=NAMES):
    for name in names:
        tad.register_adapter(name, dirs[name])
        jad.register_adapter(name, dirs[name])


def _ec(**kw):
    d = dict(max_seqs=8, block_size=8, num_blocks=96, max_model_len=64,
             cache_dtype="float32", eos_token_id=-1)
    d.update(kw)
    return d


def _corrupt(directory):
    """Flip bytes in the largest data file so digest verification trips."""
    files = [os.path.join(directory, f) for f in os.listdir(directory)]
    target = max((f for f in files if os.path.isfile(f)), key=os.path.getsize)
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(64)
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))


def _row(pool, idx):
    """Row ``idx`` of each module's ``(a, b, s)``, copied."""
    return {mod: tuple(t[idx].clone() for t in abs_) for mod, abs_ in pool.tensors.items()}


def _files(directory):
    out = {}
    for root, _, names in os.walk(directory):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, directory)] = f.read()
    return out


GREEDY = dict(temperature=0.0, max_tokens=12)
SEEDED = dict(temperature=0.8, seed=1234, max_tokens=12)
CELL_CONFIGS = {
    "k1": dict(steps_per_sync=1),
    "k4": dict(steps_per_sync=4),
    "k8": dict(steps_per_sync=8),
    "prefix": dict(steps_per_sync=4, enable_prefix_caching=True),
    "chunked": dict(steps_per_sync=4, max_prefill_tokens_per_step=16, ragged_prefill=True),
    "spec": dict(steps_per_sync=2, speculative="ngram", num_draft_tokens=4,
                 spec_min_acceptance=0.0),
}


def _bf16_base(flat):
    return {n: (t if n.endswith(("lora_a", "lora_b")) else t.to(torch.bfloat16))
            for n, t in flat.items()}


def _run(engine, sp, assign=ASSIGN, prompts=PROMPTS, waves=1):
    reqs = []
    for _ in range(waves):
        reqs += [engine.submit(p, sp, adapter=a) if a else engine.submit(p, sp)
                 for p, a in zip(prompts, assign)]
        while engine.has_work:
            engine.step()
    return reqs


def _cell(setup, quant, config):
    """The shared-base port engine against the JAX shared-base engine
    (greedy), the port's merged-weights engines (greedy and seeded) and an
    adapter-off engine (base rows, exactly)."""
    _register(setup.dirs)
    bf16 = quant == "bf16"
    quantization = "int8" if quant == "int8" else "none"
    ec = _ec(quantization=quantization, **CELL_CONFIGS[config])
    base = _bf16_base(setup.base) if bf16 else setup.base
    shared = InferenceEngine(CFG, base, EngineConfig(adapter_slots=3, adapter_rank=R, **ec),
                             device="cpu")
    jbase = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16) if bf16 else jnp.asarray(a), setup.jbase)
    jshared = JaxEngine(JCFG, jbase, JaxEngineConfig(adapter_slots=3, adapter_rank=R, **ec))
    # with prefix caching: a shared 17-token prefix, sent twice
    waves, prompts = ((2, [list(range(30, 47)) + p for p in PROMPTS])
                      if config == "prefix" else (1, PROMPTS))
    got = _run(shared, SamplingParams(**GREEDY), prompts=prompts, waves=waves)
    want = _run(jshared, JaxSamplingParams(**GREEDY), prompts=prompts, waves=waves)
    assert shared.adapter_pool.loaded_names() == list(NAMES)
    for g, w in zip(got, want):
        assert g.output_token_ids == w.output_token_ids, (g.adapter, g.request_id)
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                   atol=LOGPROB_ATOL, rtol=0)
    if config == "prefix":
        assert shared.stats["prefix_cached_tokens"] > 0

    # merged-weights engines: the bf16 oracle folds the float32 delta over
    # the bf16-rounded base without rounding the sum again
    def merged(name):
        tree = setup.flat[name]
        if bf16:
            tree = {n: (t if n.endswith(("lora_a", "lora_b"))
                        else t.to(torch.bfloat16).float()) for n, t in tree.items()}
        return merge_lora_params(tree, alpha=int(ALPHA))

    refs = {"": InferenceEngine(CFG, base, EngineConfig(**ec), device="cpu")}
    refs.update({n: InferenceEngine(CFG, merged(n), EngineConfig(**ec), device="cpu")
                 for n in NAMES})
    for sp in (SamplingParams(**GREEDY), SamplingParams(**SEEDED)):
        rows = _run(shared, sp)
        for req, name, prompt in zip(rows, ASSIGN, PROMPTS):
            ref = refs[name].generate([prompt], sp)[0]
            assert req.output_token_ids == ref.output_token_ids, (name, sp.seed)
            if name:
                np.testing.assert_allclose(req.output_logprobs, ref.output_logprobs,
                                           atol=LOGPROB_ATOL, rtol=0)
            else:  # row 0 adds exactly +0.0
                assert req.output_logprobs == ref.output_logprobs
    # the adapters do steer generation
    base_tok = refs[""].generate([PROMPTS[0]], SamplingParams(**GREEDY))[0]
    assert refs["ad-a"].generate([PROMPTS[0]], SamplingParams(**GREEDY))[0] \
        .output_token_ids != base_tok.output_token_ids
