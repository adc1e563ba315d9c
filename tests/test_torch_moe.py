"""Mixtral in the port against the JAX package (``mixtral_tiny``, CPU,
float32 unless stated; the JAX package's ``tests/test_moe.py`` and
``tests/test_moe_serving.py`` are the contract).

* ``ModelConfig.num_params`` / ``num_active_params`` equal the JAX
  package's for every preset (the port counted a dense MLP for a mixture of
  experts: 7.24 B for Mixtral-8x7B instead of 46.70 B).
* ``MoEMLP`` on shared weights: outputs and the load-balance loss within
  1e-5, at the default capacity 1.25 and at an overflowing 0.5, with and
  without a token mask; the dropped assignments identical (read from both
  packages through experts that are all one expert, where each token's
  output is its kept routing weight times that expert's).
* ``mixtral_tiny`` logits, packed rows included; the LoRA train step and
  the int8-base train step against ``make_train_step`` for 4 steps (loss,
  ``aux_loss``, grad norm, every trained leaf); the stacked experts' int8
  payloads and ``(E, 1, m)`` scales bit-equal; the one-leaf-at-a-time int8
  init equal to quantizing the whole tree.
* The engine: greedy tokens equal to the JAX engine's at the default
  capacity (one decode step a sync, where both engines route the same
  call shapes and inputs; within a multi-step window a free slot's sampled
  tokens, which route too, come from each framework's own seeded draws),
  and at the drop-free capacity ``E / k`` under preemption at k 1/4/8, on
  float32 and int8 weights; at ``E / k`` with prefix caching, chunked and
  ragged prefill and n-gram speculation too.
* A checkpoint crosses both stores both ways, and its export is served by
  both engines to the same tokens.
* The raises: LoRA on an MLP projection of a MoE model, ``loss_chunk``
  with MoE, and a Mixtral ``config.json`` in ``config_from_hf``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlti_tpu import config as jc
from dlti_tpu.checkpoint import export as jexport
from dlti_tpu.checkpoint import store as jstore
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.models import quantization as jq
from dlti_tpu.models.hf_interop import config_from_hf as jax_config_from_hf
from dlti_tpu.models.moe import MoEMLP as JaxMoE
from dlti_tpu.models.moe import collect_aux_loss as jax_collect_aux
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu.training import build_optimizer as jax_build_optimizer
from dlti_tpu.training import create_train_state as jax_create_state
from dlti_tpu.training import make_train_step as jax_make_step
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.checkpoint import export_merged_model, store
from dlti_tpu_torch.cli import serve as serve_cli
from dlti_tpu_torch.models import init_params, init_params_int8, load_model, params_from_jax
from dlti_tpu_torch.models import quantization as tq
from dlti_tpu_torch.models.hf_interop import config_from_hf
from dlti_tpu_torch.models.moe import MoEMLP
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams
from dlti_tpu_torch.training import build_optimizer, create_train_state, whole_params
from dlti_tpu_torch.training.state import load_state_leaves, state_leaves
from dlti_tpu_torch.training.step import MOE_METRICS, StepWindow, make_train_step

TOL = 1e-5
JCFG, TCFG = jc.MODEL_PRESETS["mixtral_tiny"], tc.MODEL_PRESETS["mixtral_tiny"]
E, K = JCFG.num_experts, JCFG.num_experts_per_tok
LORA = dict(r=4, alpha=8, dropout=0.0)
OPT = dict(learning_rate=1e-2, warmup_steps=2)
ACCUM, BS, SEQ, STEPS = 2, 4, 32, 4
# Drop-free at any token count (tests/test_moe_serving.py).
DROP_FREE = float(E) / K


def _jax_tree(lora=True, seed=0, cfg=JCFG):
    """JAX init plus numpy noise, so no float32 near-tie decides a route or
    a greedy token."""
    tree = JaxLlama(cfg, jc.LoRAConfig(**LORA) if lora else None).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


@pytest.fixture(scope="module")
def tree():
    return _jax_tree()


def _batches(n=STEPS, seed=7):
    rng = np.random.default_rng(seed)
    shape = (ACCUM, BS, SEQ)
    return [{"input_ids": rng.integers(3, JCFG.vocab_size, shape).astype(np.int32),
             "loss_mask": (rng.random(shape) > 0.3).astype(np.int32)} for _ in range(n)]


# ----------------------------------------------------------------------
# Parameter counts
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(tc.MODEL_PRESETS))
def test_param_counts_equal_jax(name):
    port, ref = tc.MODEL_PRESETS[name], jc.MODEL_PRESETS[name]
    for head in (True, False):
        assert port.num_params(head) == ref.num_params(head)
        assert port.num_active_params(head) == ref.num_active_params(head)


def test_mixtral_counts_the_routed_experts():
    m = tc.MODEL_PRESETS["mixtral_8x7b"]
    assert (m.num_params(), m.num_active_params()) == (46_702_792_704, 12_879_925_248)
    assert (TCFG.num_params(), TCFG.num_active_params()) == (287_552, 189_248)
    dense = tc.MODEL_PRESETS["mistral_7b"]
    assert dense.num_params() == dense.num_active_params()
    # A seeded tree holds exactly that many parameters.
    assert sum(t.numel() for t in init_params(TCFG, device="cpu").values()) == 287_552


# ----------------------------------------------------------------------
# The block
# ----------------------------------------------------------------------

def _mlp_pair(cf, seed=0, same_experts=False):
    """The JAX and the port ``MoEMLP`` at capacity factor ``cf`` on one
    weight set (every expert expert 0's with ``same_experts``)."""
    jcfg = dataclasses.replace(JCFG, moe_capacity_factor=cf)
    tcfg = dataclasses.replace(TCFG, moe_capacity_factor=cf)
    x = np.random.default_rng(seed).standard_normal((3, 16, JCFG.hidden_size)).astype(
        np.float32)
    params = jax.device_get(JaxMoE(jcfg).init(jax.random.PRNGKey(seed), jnp.asarray(x))
                            ["params"])
    params = {k: np.asarray(v) for k, v in params.items()}
    if same_experts:
        for k in ("w1", "w2", "w3"):
            params[k] = np.broadcast_to(params[k][:1], params[k].shape).copy()
    port = MoEMLP(tcfg)
    port.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                         assign=True)
    return JaxMoE(jcfg), params, port, x


def _mask(masked):
    mask = np.ones((3, 16), np.int32)
    if masked:
        mask[0, 5:] = 0
        mask[2, :3] = 0
    return mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_mlp_output_and_aux_match_jax(cf, masked):
    jm, params, port, x = _mlp_pair(cf)
    mask = _mask(masked)
    y, var = jm.apply({"params": params}, jnp.asarray(x), True,
                      jnp.asarray(mask) if masked else None, mutable=["intermediates"])
    got, aux = port(torch.from_numpy(x), torch.from_numpy(mask) if masked else None, True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jax_collect_aux(var["intermediates"])),
                               rtol=TOL, atol=TOL)
    if masked:  # padding is never dispatched
        assert not got[0, 5:].any() and not got[2, :3].any()


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_dropped_assignments_match_jax(cf):
    """With every expert one expert, a token's output is its kept routing
    weight times that expert's output: the kept weight of each token,
    solved from the JAX output, equals the port's from its routing's
    ``keep``, so both drop the same assignments. At 0.5 (C = 12: 48 kept
    at most of 48 tokens' 68 valid assignments over 4 experts), slot-major
    (every token's first choice before any second choice)."""
    jm, params, port, x = _mlp_pair(cf, seed=3, same_experts=True)
    mask = _mask(True)
    y = np.asarray(jm.apply({"params": params}, jnp.asarray(x), True, jnp.asarray(mask)),
                   np.float64).reshape(-1, JCFG.hidden_size)
    h = x.reshape(-1, JCFG.hidden_size).astype(np.float64)
    a, b = h @ params["w1"][0], h @ params["w3"][0]
    dense = (a / (1 + np.exp(-a)) * b) @ params["w2"][0]
    kept_jax = np.einsum("th,th->t", y, dense) / np.einsum("th,th->t", dense, dense)
    xt = torch.from_numpy(x).reshape(-1, JCFG.hidden_size)
    r = port.route(xt, torch.from_numpy(mask).reshape(-1).float())
    kept_port = (r.weights.T * r.keep).sum(0).detach().numpy()
    np.testing.assert_allclose(kept_port, kept_jax, rtol=1e-4, atol=1e-5)
    valid = mask.reshape(-1) > 0
    dropped = (~r.keep.numpy() & valid[None]).sum()
    assert (dropped > 0) == (cf < 1)
    if cf < 1:
        assert dropped >= K * valid.sum() - E * r.capacity  # at most E x C kept
        # Slot-major ranks: no first choice is dropped while a second choice
        # of the same expert is kept.
        v = torch.from_numpy(valid)
        for e in range(E):
            first = r.keep[0][(r.experts[0] == e) & v]
            second = r.keep[1][(r.experts[1] == e) & v]
            assert not (second.any() and not first.all())


def test_mixtral_tiny_logits_match_jax(tree):
    ids = np.random.default_rng(1).integers(3, JCFG.vocab_size, (2, 24)).astype(np.int32)
    segs = np.repeat(np.array([[1] * 10 + [2] * 8 + [0] * 6]), 2, 0).astype(np.int32)
    jm = JaxLlama(JCFG, jc.LoRAConfig(**LORA))
    port = load_model(TCFG, params_from_jax(tree), "cpu", lora=tc.LoRAConfig(**LORA))
    for kw in ({}, {"segment_ids": segs}):
        want, _ = jm.apply({"params": tree}, jnp.asarray(ids),
                           **{k: jnp.asarray(v) for k, v in kw.items()})
        with torch.no_grad():
            got = port(torch.from_numpy(ids),
                       **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# ----------------------------------------------------------------------
# Training
# ----------------------------------------------------------------------

def _jax_steps(tree, batches, quantize=False, cfg=JCFG):
    model = JaxLlama(cfg, jc.LoRAConfig(**LORA))
    state = jax_create_state(jax.random.PRNGKey(0), model,
                             jax_build_optimizer(jc.OptimizerConfig(**OPT)), (BS, SEQ),
                             init_fn=lambda r, x: tree)
    if quantize:
        state = state.replace(params=jq.quantize_params_int8(state.params))
    step = jax.jit(jax_make_step(model, accum_steps=ACCUM))
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return state, metrics


def _port_state(params, cfg=TCFG):
    model = load_model(cfg, params, "cpu", lora=tc.LoRAConfig(**LORA), trainable_lora=True)
    return create_train_state(model, build_optimizer(tc.OptimizerConfig(**OPT)))


def _port_steps(state, batches, first=1):
    window = StepWindow(state.model, accum_steps=ACCUM, cuda_graphs=False)
    assert window.metrics == MOE_METRICS
    return [dict(zip(window.metrics, window.run(state, [b], first + i)[0].tolist()))
            for i, b in enumerate(batches)]


def _assert_steps_match(got, want, state, jstate):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "aux_loss", "grad_norm", "num_tokens"):
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                       err_msg=f"step {i + 1} {k}")
    want_p = params_from_jax(jax.device_get(jstate.params))
    trained = state.trainable()
    assert len(trained) == 2 * 4 * JCFG.num_layers
    for n, t in trained.items():
        np.testing.assert_allclose(t.detach().numpy(), want_p[n].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=n)


def test_lora_train_step_matches_jax_for_4_steps(tree):
    batches = _batches()
    jstate, want = _jax_steps(tree, batches)
    state = _port_state(params_from_jax(tree))
    got = _port_steps(state, batches)
    _assert_steps_match(got, want, state, jstate)
    # The objective carries the load-balance loss, the reported loss does not.
    assert all(g["aux_loss"] > 1.0 for g in got)


def test_under_remat_the_aux_loss_counts_once(tree):
    """Under ``nothing_saveable`` remat each block's (x, aux) is recomputed
    in the backward: the step still matches the JAX remat step, whose
    objective counts each layer's load-balance loss once."""
    batches = _batches(2, seed=13)
    jstate, want = _jax_steps(tree, batches, cfg=dataclasses.replace(JCFG, remat=True))
    state = _port_state(params_from_jax(tree), dataclasses.replace(TCFG, remat=True))
    _assert_steps_match(_port_steps(state, batches), want, state, jstate)


def test_int8_base_step_matches_jax_and_expert_payloads_are_bit_equal(tree):
    qtree = jax.device_get(jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree)))
    qport = tq.quantize_params_int8(params_from_jax(tree))
    want = params_from_jax(qtree)
    assert sorted(qport) == sorted(want)
    layer = "model.layers.1.mlp"
    for w in ("w1", "w3", "w2"):
        q, s = qport[f"{layer}.{w}.q"], qport[f"{layer}.{w}.scale"]
        shape = tuple(want[f"{layer}.{w}.q"].shape)
        assert q.dtype == torch.int8 and q.shape == shape
        assert s.shape == (E, 1, shape[-1])
    assert f"{layer}.router" in qport and qport[f"{layer}.router"].dtype == torch.float32
    for n, t in qport.items():
        assert t.dtype == want[n].dtype and torch.equal(t, want[n]), n
    batches = _batches(seed=9)
    jstate, jmetrics = _jax_steps(tree, batches, quantize=True)
    state = _port_state(qport)
    assert isinstance(state.model.model.layers[0].mlp.w1, tq.QuantizedWeight)
    _assert_steps_match(_port_steps(state, batches), jmetrics, state, jstate)


def test_one_leaf_at_a_time_int8_init_equals_quantizing_the_tree():
    lora = tc.LoRAConfig(r=4, alpha=8)
    want = tq.quantize_params_int8(init_params(TCFG, seed=5, device="cpu", lora=lora))
    got = init_params_int8(TCFG, seed=5, device="cpu", lora=lora)
    assert list(got) == list(want)
    assert all(got[n].dtype == want[n].dtype and torch.equal(got[n], want[n]) for n in want)
    assert {n for n, t in got.items() if t.dtype == torch.int8} >= {
        f"model.layers.0.mlp.{w}.q" for w in ("w1", "w2", "w3")}
    # An int8 tree passes through quantize_params_int8 as it is.
    again = tq.quantize_params_int8(dict(got))
    assert list(again) == list(got) and all(again[n] is got[n] for n in got)


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------

TIGHT = dict(max_seqs=3, block_size=8, num_blocks=8, max_model_len=48, eos_token_id=-1,
             cache_dtype="float32")
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13], [14, 15, 16, 17, 18]]


def _script(engine, sp):
    """Three greedy requests under preemption, then a fourth admitted
    mid-flight."""
    reqs = [engine.submit(p, sp(temperature=0.0, max_tokens=14)) for p in PROMPTS]
    engine.step()
    engine.step()
    reqs.append(engine.submit([2, 7, 1, 8], sp(temperature=0.0, max_tokens=12)))
    while engine.has_work:
        engine.step()
    return reqs


def test_trash_slot_writes_are_dropped_and_ordered():
    """Rows writing the trash slot 0 leave what the reference's scatter
    leaves: the last row not dropped (here row 2; row 3 is padding, and in
    decode, where nothing is dropped, row 3), or the slot's own values when
    every one is padding, whatever order the scatter lands them in; other
    slots take their rows."""
    from dlti_tpu_torch.ops.kv_cache import init_paged_cache, paged_update

    g = torch.Generator().manual_seed(0)
    k, v = torch.randn(1, 4, 2, 4, generator=g), torch.randn(1, 4, 2, 4, generator=g)
    slots = torch.tensor([[0, 5, 0, 0]])
    drop = torch.tensor([[False, False, False, True]])
    for dtype in (torch.float32, "int8"):
        want = init_paged_cache(1, 4, 4, 2, 4, dtype, device="cpu")[0]
        paged_update(want, k[:, :3], v[:, :3], slots[:, :3])  # the live rows, in order
        got = init_paged_cache(1, 4, 4, 2, 4, dtype, device="cpu")[0]
        paged_update(got, k, v, slots, drop)
        assert all(torch.equal(got[n], want[n]) for n in want)
        want_all = init_paged_cache(1, 4, 4, 2, 4, dtype, device="cpu")[0]
        last = [1, 3]  # row 3 the last to slot 0
        paged_update(want_all, k[:, last], v[:, last], slots[:, last])
        got = init_paged_cache(1, 4, 4, 2, 4, dtype, device="cpu")[0]
        paged_update(got, k, v, slots, torch.zeros_like(drop))
        assert all(torch.equal(got[n], want_all[n]) for n in want_all)
        only_pad = init_paged_cache(1, 4, 4, 2, 4, dtype, device="cpu")[0]
        paged_update(only_pad, k[:, 3:], v[:, 3:], slots[:, 3:], drop[:, 3:])
        assert not any(t.any() for t in only_pad.values())


@pytest.fixture(scope="module")
def serve_tree():
    return _jax_tree(lora=False, seed=2)


@pytest.mark.parametrize("quantization", ["none", "int8"])
@pytest.mark.parametrize("cf,k", [(1.25, 1), (DROP_FREE, 1), (DROP_FREE, 4),
                                  (DROP_FREE, 8)])
def test_engine_tokens_equal_the_jax_engine(serve_tree, cf, k, quantization):
    jcfg = dataclasses.replace(JCFG, moe_capacity_factor=cf)
    tcfg = dataclasses.replace(TCFG, moe_capacity_factor=cf)
    ec = dict(TIGHT, steps_per_sync=k, quantization=quantization)
    jeng = JaxEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, serve_tree),
                     JaxEngineConfig(**ec))
    want = _script(jeng, JaxSamplingParams)
    teng = InferenceEngine(tcfg, params_from_jax(serve_tree), EngineConfig(**ec),
                           device="cpu")
    got = _script(teng, SamplingParams)
    assert [g.output_token_ids for g in got] == [w.output_token_ids for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=1e-4, rtol=0)
    assert teng.stats["preemptions"] == jeng.stats["preemptions"] >= 1
    assert teng.block_manager.num_free == TIGHT["num_blocks"] - 1


FEATURES = {"prefix": dict(enable_prefix_caching=True),
            "chunked": dict(max_prefill_tokens_per_step=8),
            "ragged": dict(max_prefill_tokens_per_step=8, ragged_prefill=True),
            "spec": dict(speculative="ngram", num_draft_tokens=3)}


@pytest.mark.parametrize("feature", list(FEATURES))
def test_engine_features_at_drop_free_capacity_equal_the_jax_engine(serve_tree, feature):
    """Prefix caching, chunked and ragged prefill and n-gram speculation
    change the tokens a call routes, so a mixture of experts is held at the
    drop-free capacity ``E / k`` with them (as the reference's own MoE
    serving tests are): two rounds of repetitive prompts (the second reuses
    the first's prefix blocks and n-gram history) give the JAX engine's
    greedy tokens, and the feature ran."""
    jcfg = dataclasses.replace(JCFG, moe_capacity_factor=DROP_FREE)
    tcfg = dataclasses.replace(TCFG, moe_capacity_factor=DROP_FREE)
    ec = dict(max_seqs=3, block_size=8, num_blocks=32, max_model_len=64, eos_token_id=-1,
              cache_dtype="float32", steps_per_sync=4, **FEATURES[feature])
    prompts = [[5, 6, 7] * 3 + [1], [5, 6, 7] * 3 + [2, 3], [9] * 4 + [8] * 4 + [9] * 3]
    jeng = JaxEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, serve_tree),
                     JaxEngineConfig(**ec))
    teng = InferenceEngine(tcfg, params_from_jax(serve_tree), EngineConfig(**ec),
                           device="cpu")
    for _ in range(2):
        want = jeng.generate(prompts, JaxSamplingParams(temperature=0.0, max_tokens=12))
        got = teng.generate(prompts, SamplingParams(temperature=0.0, max_tokens=12))
        assert [g.output_token_ids for g in got] == [w.output_token_ids for w in want]
    ran = {"prefix": teng.stats["prefix_cached_tokens"], "spec": teng.stats["spec_proposed"],
           "chunked": teng.stats["prefill_batches"] > 2 * len(prompts) // 3,
           "ragged": teng.stats["prefill_batches"]}[feature]
    assert ran


# ----------------------------------------------------------------------
# Checkpoints and exports
# ----------------------------------------------------------------------

def test_checkpoint_crosses_both_stores_and_its_export_serves_alike(tree, tmp_path):
    batches = _batches(2, seed=11)
    state = _port_state(params_from_jax(tree))
    _port_steps(state, batches[:1])
    store.save_train_state(str(tmp_path / "port"), 1, state_leaves(state), async_save=False)
    # The JAX package restores the port's step 1 and runs step 2 ...
    model = JaxLlama(JCFG, jc.LoRAConfig(**LORA))
    template = jax_create_state(jax.random.PRNGKey(0), model,
                                jax_build_optimizer(jc.OptimizerConfig(**OPT)), (BS, SEQ),
                                init_fn=lambda r, x: tree)
    assert jstore.verify_checkpoint(str(tmp_path / "port"), 1) == (True, "ok")
    jstate = jstore.restore_train_state(str(tmp_path / "port"), 1, template)
    mine = dict(state.model.named_parameters())
    for n, t in params_from_jax(jax.device_get(jstate.params)).items():
        assert torch.equal(t, mine[n].detach()), n
    step = jax.jit(jax_make_step(model, accum_steps=ACCUM))
    jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in batches[1].items()},
                     jax.random.PRNGKey(1))
    got = _port_steps(state, batches[1:], first=2)[0]
    np.testing.assert_allclose(got["aux_loss"], float(m["aux_loss"]), rtol=TOL, atol=TOL)
    # ... and saves step 2, which the port restores bit for bit.
    jstore.save_train_state(str(tmp_path / "jax"), 2, jstate)
    jstore.wait_for_saves(str(tmp_path / "jax"))
    fresh = _port_state(params_from_jax(tree))
    load_state_leaves(fresh, store.restore_train_state(
        str(tmp_path / "jax"), 2, state_leaves(fresh)))
    assert fresh.step == 2
    want = params_from_jax(jax.device_get(jstate.params))
    for n, t in fresh.model.named_parameters():
        assert torch.equal(t.detach(), want[n]), n
    # The export merges the attention adapters and keeps the experts.
    cfg = tc.Config(model=TCFG, lora=tc.LoRAConfig(**LORA),
                    checkpoint=tc.CheckpointConfig(save_strategy="no"))
    export_merged_model(str(tmp_path / "export"), whole_params(fresh), cfg)
    params, jcfg = jexport.load_exported_model(str(tmp_path / "export"))
    assert jcfg.model == JCFG and not jcfg.lora.enabled
    np.testing.assert_array_equal(np.asarray(params["model"]["layers_0"]["mlp"]["w1"]),
                                  want["model.layers.0.mlp.w1"].numpy())
    jeng = JaxEngine(jcfg.model, jax.tree_util.tree_map(jnp.asarray, params),
                     JaxEngineConfig(cache_dtype="float32", max_seqs=4, block_size=8,
                                     num_blocks=32, max_model_len=64))
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9], [300, 17]]
    jtok = [r.output_token_ids for r in jeng.generate(
        prompts, JaxSamplingParams(temperature=0.0, max_tokens=8))]
    args = serve_cli.parse_args(["--device", "cpu", "--model-dir", str(tmp_path / "export"),
                                 "--tokenizer", "byte", "--kv-cache-dtype", "float32",
                                 "--max-seqs", "4", "--block-size", "8",
                                 "--num-blocks", "32", "--max-model-len", "64"])
    engine, _, _ = serve_cli.build(args)
    ttok = [r.output_token_ids for r in engine.generate(
        prompts, SamplingParams(temperature=0.0, max_tokens=8))]
    assert ttok == jtok


# ----------------------------------------------------------------------
# What raises
# ----------------------------------------------------------------------

def test_lora_on_an_mlp_projection_of_a_moe_model_raises():
    with pytest.raises(NotImplementedError, match="LoRA on MLP"):
        load_model(TCFG, {}, "cpu", lora=tc.LoRAConfig(target_modules=("q_proj",
                                                                        "gate_proj")))
    with pytest.raises(NotImplementedError, match="LoRA on MLP"):
        JaxLlama(JCFG, jc.LoRAConfig(target_modules=("q_proj", "gate_proj"))).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))


def test_loss_chunk_with_moe_raises_the_reference_error():
    model = load_model(TCFG, init_params(TCFG, device="cpu"), "cpu")
    with pytest.raises(ValueError, match="loss_chunk does not compose with MoE"):
        make_train_step(model, loss_chunk=16)
    with pytest.raises(ValueError, match="loss_chunk does not compose with MoE"):
        jax_make_step(JaxLlama(JCFG), loss_chunk=16)


def test_a_mixtral_config_json_raises_as_in_the_reference():
    """The reference's error and message, which the port follows with why."""
    hf = {"model_type": "mixtral", "architectures": ["MixtralForCausalLM"],
          "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
          "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
          "num_local_experts": 8, "num_experts_per_tok": 2, "rope_theta": 1e6,
          "max_position_embeddings": 32768, "rms_norm_eps": 1e-5}
    with pytest.raises(NotImplementedError) as want:
        jax_config_from_hf(hf)
    with pytest.raises(NotImplementedError, match="mixture-of-experts") as got:
        config_from_hf(hf)
    assert str(got.value).startswith(str(want.value))


@pytest.mark.parametrize("shape", ["mixtral_tiny", "wide"])
def test_stacked_experts_are_drawn_as_flax_lecun_normal(shape):
    """F7: ``init_params`` draws each stacked expert leaf lecun-normal with
    fan in every dim but the last (E * h for ``w1``/``w3``, E * m for
    ``w2``), as flax's ``lecun_normal`` counts it on the reference's 3-D
    arrays: its std equals flax's draw of the same shape within sampling
    error, and 1 / sqrt(E * h), not 1 / sqrt(h), for ``w1``. The router
    (2-D) keeps fan in h."""
    import flax.linen as nn

    cfg = tc.MODEL_PRESETS["mixtral_tiny"]
    if shape == "wide":  # (8, 64, 128), the shape the fault was measured at
        cfg = dataclasses.replace(cfg, num_experts=8)
    params = init_params(cfg, seed=0, device="cpu")
    E, h, m = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    for leaf, dims in (("w1", (E, h, m)), ("w3", (E, h, m)), ("w2", (E, m, h)),
                       ("router", (h, E))):
        t = params[f"model.layers.0.mlp.{leaf}"]
        assert tuple(t.shape) == dims
        flax_std = float(jnp.std(nn.initializers.lecun_normal()(jax.random.PRNGKey(1), dims)))
        want = 1 / np.sqrt(np.prod(dims[:-1]))
        got = float(t.float().std())
        # the relative sampling error of a std over n draws is ~ 1/sqrt(2n)
        tol = 4 / np.sqrt(2 * np.prod(dims)) * want
        assert abs(got - want) < tol, (leaf, got, want)
        assert abs(flax_std - want) < tol, (leaf, flax_std, want)
    if shape == "mixtral_tiny":
        assert abs(float(params["model.layers.0.mlp.w1"].std()) - 0.0625) < 0.002
