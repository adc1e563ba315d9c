"""The port's Llama model against the JAX model on shared weights (fp32, CPU).

Weights come from the JAX init plus numpy noise (so biases, norm offsets
and every other leaf are non-trivial), cross into the port through
``params_from_jax``, and both packages run the same token ids.
Tolerance: 1e-5 absolute on float32 logits — the two frameworks sum in
different orders, nothing else differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlti_tpu.config import MODEL_PRESETS as JAX_PRESETS
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.models.lora import LoRADense as JaxLoRADense
from dlti_tpu.ops.kv_cache import init_paged_cache as jax_init_paged_cache
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.models import LoRADense, load_model, params_from_jax
from dlti_tpu_torch.ops.kv_cache import init_paged_cache

ATOL = 1e-5

OVERRIDES = {
    "base": {},
    "attention_bias": {"attention_bias": True},
    "sliding_window": {"sliding_window": 5},
    "gelu_tanh": {"mlp_activation": "gelu_tanh"},
    "rmsnorm_offset": {"rmsnorm_offset": True},
    "embedding_scale": {"embedding_scale": True},
    "tie_embeddings": {"tie_embeddings": True},
}


def _configs(name):
    over = OVERRIDES[name]
    return (dataclasses.replace(JAX_PRESETS["llama_tiny"], **over),
            dataclasses.replace(MODEL_PRESETS["llama_tiny"], **over))


def _shared_params(jcfg, seed=0):
    params = JaxLlama(jcfg).init(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                   ).astype(np.float32), jax.device_get(params))


@pytest.mark.parametrize("name", list(OVERRIDES))
def test_full_sequence_logits_match_jax(name):
    jcfg, tcfg = _configs(name)
    params = _shared_params(jcfg)
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want, _ = JaxLlama(jcfg).apply({"params": params}, jnp.asarray(ids))
    model = load_model(tcfg, params_from_jax(params), device="cpu")
    got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _paged_run_jax(jcfg, params, steps, nb, bs):
    model = JaxLlama(jcfg)
    cache = jax_init_paged_cache(jcfg.num_layers, nb, bs, jcfg.num_kv_heads,
                                 jcfg.resolved_head_dim, jnp.float32)
    outs = []
    for ids, pos, bt in steps:
        layered = [{**layer, "block_tables": jnp.asarray(bt)} for layer in cache]
        logits, new = model.apply({"params": params}, jnp.asarray(ids),
                                  positions=jnp.asarray(pos), cache=layered)
        cache = [{k: v for k, v in c.items() if k != "block_tables"} for c in new]
        outs.append(np.asarray(logits))
    return outs


def _paged_run_torch(tcfg, params, steps, nb, bs):
    model = load_model(tcfg, params_from_jax(params), device="cpu")
    cache = init_paged_cache(tcfg.num_layers, nb, bs, tcfg.num_kv_heads,
                             tcfg.resolved_head_dim, torch.float32)
    outs = []
    with torch.no_grad():
        for ids, pos, bt in steps:
            outs.append(model(torch.from_numpy(ids).long(),
                              positions=torch.from_numpy(pos).long(),
                              cache=cache,
                              block_tables=torch.from_numpy(bt)).numpy())
    return outs


@pytest.mark.parametrize("name,impl", [("base", "auto"), ("base", "gather"),
                                       ("sliding_window", "kernel")])
def test_paged_prefill_then_decode_matches_jax(name, impl):
    """Prefill two ragged prompts through the paged cache, then decode three
    steps; the port's decode runs the paged decode path named by ``impl``
    (its plain version on the CPU), JAX's the gather path."""
    jcfg, tcfg = _configs(name)
    tcfg = dataclasses.replace(tcfg, paged_attention_impl=impl)
    params = _shared_params(jcfg, seed=2)
    bs, nb = 4, 16
    rng = np.random.default_rng(3)
    lens = [7, 3]
    bt = np.array([[3, 9, 5, 0], [12, 7, 0, 0]], np.int32)
    ids = np.zeros((2, 8), np.int32)
    pos = np.full((2, 8), -1, np.int32)
    for r, n in enumerate(lens):
        ids[r, :n] = rng.integers(0, jcfg.vocab_size, n)
        pos[r, :n] = np.arange(n)
    steps = [(ids, pos, bt)]
    for t in range(3):
        steps.append((rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32),
                      np.array([[lens[0] + t], [lens[1] + t]], np.int32), bt))
    want = _paged_run_jax(jcfg, params, steps, nb, bs)
    got = _paged_run_torch(tcfg, params, steps, nb, bs)
    for r, n in enumerate(lens):  # prefill: the real positions of each row
        np.testing.assert_allclose(got[0][r, :n], want[0][r, :n], atol=ATOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_lora_dense_adapter_branch_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    jmod = JaxLoRADense(features=8, use_bias=True, lora_r=4, lora_alpha=8,
                        dtype=jnp.float32, param_dtype=jnp.float32)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params = {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()}  # lora_b and bias start at zero
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = LoRADense(16, 8, use_bias=True, lora_r=4, lora_alpha=8,
                     dtype=torch.float32, param_dtype=torch.float32)
    tmod.load_state_dict(params_from_jax(params))
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
