"""The int8 frozen base and int8 serving weights in the port against the JAX
package (``models/quantization.py``), on a ``llama_tiny`` widened to
hidden 128 / intermediate 256 (so the projections pass the reference's
16384-element threshold, as its own tests widen it), float32 unless named,
CPU, weights from the JAX init plus numpy noise through ``params_from_jax``.

* Leaf selection and ``(q, scale)`` are bit-equal to JAX's
  ``quantize_params_int8`` (float32 and bfloat16 sources), and so is the
  dequantization into float32, bfloat16 and float16.
* The int8-base forward's logits and loss match the JAX model on the same
  int8 leaves within 1e-5 (float32 in two frameworks).
* ``Trainer`` at ``steps_per_sync=4`` with a save at step 4 against the JAX
  ``Trainer`` with ``quantize_frozen_base="int8"``: losses within rtol
  1e-5, LoRA factors within 1e-5 relative L2, the checkpoint's leaf names
  the JAX store's and its ``q``/``scale`` leaves bit-equal.
* Checkpoints cross both ways: the port resumes the JAX run's step 4 and
  the JAX ``Trainer`` the port's, and each continues the other's losses
  within rtol 1e-5.
* The merged export (bf16) equals the JAX export leaf for leaf, manifest
  digest included.
* ZeRO-3 at a world of 2 (gloo) on the int8 base against the JAX
  single-device int8 step: loss, grad norm and LoRA factors within rtol /
  atol 2e-4, as the port's other data-parallel tests.
* Greedy tokens of the int8-weight engine equal the JAX int8 engine's
  (logprobs within 1e-4).
* The frozen product saves ``q`` and ``scale`` for the backward, never an
  expanded weight.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from dlti_tpu import config as jc
from dlti_tpu.checkpoint import export_merged_model as jax_export
from dlti_tpu.checkpoint import store as jstore
from dlti_tpu.data import make_batches as jax_make_batches
from dlti_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.models import quantization as jq
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu.training import build_optimizer as jax_build_optimizer
from dlti_tpu.training import create_train_state as jax_create_state
from dlti_tpu.training import make_train_step as jax_make_step
from dlti_tpu.training.step import causal_lm_loss as jax_loss
from dlti_tpu.training.trainer import Trainer as JaxTrainer
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.checkpoint import export_merged_model, manifest_digest, store
from dlti_tpu_torch.data import ByteTokenizer, make_batches
from dlti_tpu_torch.models import load_model, params_from_jax
from dlti_tpu_torch.models import quantization as tq
from dlti_tpu_torch.models.lora import is_lora_name
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams
from dlti_tpu_torch.training import Trainer
from dlti_tpu_torch.training.step import causal_lm_loss

RTOL = 1e-5
DP_TOL = 2e-4
NO_SAVE = tc.CheckpointConfig(save_strategy="no")
WIDE = dict(hidden_size=128, intermediate_size=256)
JCFG = dataclasses.replace(jc.MODEL_PRESETS["llama_tiny"], **WIDE)
TCFG = dataclasses.replace(tc.MODEL_PRESETS["llama_tiny"], **WIDE)
LORA = dict(r=4, alpha=8, dropout=0.0)
OPT = dict(learning_rate=1e-2, warmup_steps=2)
ACCUM, BS, SEQ = 2, 2, 32


def _jax_tree(lora=True, seed=0, dtype=np.float32):
    tree = JaxLlama(JCFG, jc.LoRAConfig(**LORA) if lora else None).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape))
        .astype(dtype), jax.device_get(tree))


def _flat_np(tree):
    return {n: t for n, t in params_from_jax(jax.device_get(tree)).items()}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype in (torch.bfloat16, torch.float16) \
        else t.numpy()


@pytest.fixture(scope="module")
def tree():
    return _jax_tree()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_leaves_and_scales_are_bit_equal_to_jax(dtype):
    import ml_dtypes

    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    src = _jax_tree(dtype=np_dtype)
    want = _flat_np(jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, src)))
    got = tq.quantize_params_int8(params_from_jax(src))
    assert list(got) == list(want)  # the same leaves selected, the same names
    bases = tq.quant_bases(got)
    assert {"lm_head", "model.embed_tokens", "model.layers.0.attn.q_proj.kernel",
            "model.layers.1.mlp.down_proj.kernel"} <= set(bases)
    assert not any(is_lora_name(b) or b.endswith("k_proj.kernel") for b in bases)
    for n, t in got.items():
        assert t.dtype == want[n].dtype, n
        assert np.array_equal(_bits(t), _bits(want[n])), n
    assert got["lm_head.scale"].shape == (1, JCFG.vocab_size)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_dequantize_is_bit_equal_to_jax(tree, dtype):
    qtree = jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    want = _flat_np(jq.dequantize_params(qtree, getattr(jnp, dtype)))
    got = tq.dequantize_params(tq.quantize_params_int8(params_from_jax(tree)),
                               getattr(torch, dtype))
    assert got.keys() == want.keys()
    for n in tq.quant_bases(tq.quantize_params_int8(params_from_jax(tree))):
        assert np.array_equal(_bits(got[n]), _bits(want[n])), n
    assert tq.quantization_error(params_from_jax(tree), tq.quantize_params_int8(
        params_from_jax(tree))) == pytest.approx(
        jq.quantization_error(jax.tree_util.tree_map(jnp.asarray, tree), qtree), rel=1e-5)


def test_int8_base_forward_and_loss_match_jax(tree):
    rng = np.random.default_rng(3)
    ids = rng.integers(3, JCFG.vocab_size, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) > 0.2).astype(np.int32)
    qtree = jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    model = JaxLlama(JCFG, jc.LoRAConfig(**LORA))
    want, _ = model.apply({"params": qtree}, jnp.asarray(ids))
    want_sum, want_n = jax_loss(want, jnp.asarray(ids), jnp.asarray(mask))

    port = load_model(TCFG, tq.quantize_params_int8(params_from_jax(tree)), "cpu",
                      lora=tc.LoRAConfig(**LORA))
    assert isinstance(port.model.layers[0].attn.q_proj.kernel, tq.QuantizedWeight)
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long())
        got_sum, got_n = causal_lm_loss(got, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(float(got_sum / got_n), float(want_sum / want_n), rtol=RTOL)


def test_the_frozen_product_saves_q_and_scale_not_an_expanded_weight(tree):
    """Without remat, autograd keeps what the backward needs: for a
    quantized projection that is its int8 ``q`` and its ``scale``, and no
    tensor of a quantized kernel's shape in a float dtype."""
    cfg = dataclasses.replace(TCFG, remat=False)
    model = load_model(cfg, tq.quantize_params_int8(params_from_jax(tree)), "cpu",
                       lora=tc.LoRAConfig(**LORA), trainable_lora=True)
    kernel_shapes = {tuple(m.kernel.shape) for m in model.modules()
                     if isinstance(getattr(m, "kernel", None), tq.QuantizedWeight)}
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append((tuple(t.shape), t.dtype)) or t, lambda t: t):
        logits = model(torch.arange(3, 27).reshape(2, 12))
    logits.sum().backward()
    assert any(dt == torch.int8 for _, dt in saved)
    expanded = [(s, dt) for s, dt in saved if s in kernel_shapes and dt != torch.int8]
    assert not expanded, expanded


def _texts(n, seed=5):
    rng = np.random.default_rng(seed)
    return ["".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(5, 60)))
            for _ in range(n)]


TRAIN = dict(micro_batch_size=BS, grad_accum_steps=ACCUM, logging_steps=100,
             steps_per_sync=4, num_epochs=2, quantize_frozen_base="int8")


def _jax_trainer(out_dir, max_steps, tmp):
    cfg = jc.Config(
        model=JCFG, lora=jc.LoRAConfig(**LORA), optimizer=jc.OptimizerConfig(**OPT),
        data=jc.DataConfig(max_seq_len=SEQ, tokenizer="byte"),
        checkpoint=jc.CheckpointConfig(output_dir=str(out_dir), save_steps=4,
                                       save_total_limit=10, async_save=False),
        telemetry=jc.TelemetryConfig(step_log_path=str(tmp / f"steps-{max_steps}.jsonl")),
        train=jc.TrainConfig(max_steps=max_steps, metrics_csv=str(tmp / "jm.csv"), **TRAIN))
    return JaxTrainer(cfg)


def _jax_losses(tmp, max_steps):
    path = tmp / f"steps-{max_steps}.jsonl"
    return [r["loss"] for r in map(json.loads, path.read_text().splitlines())
            if r.get("type") == "step"]


def _jax_dataset(texts):
    return jax_make_batches(texts, JaxByteTokenizer(), seq_len=SEQ, micro_batch_size=BS,
                            grad_accum_steps=ACCUM, shard_by_host=False)


def _port_cfg(out_dir, max_steps):
    return tc.Config(
        model=TCFG, lora=tc.LoRAConfig(**LORA), optimizer=tc.OptimizerConfig(**OPT),
        data=tc.DataConfig(max_seq_len=SEQ, tokenizer="byte"),
        checkpoint=tc.CheckpointConfig(output_dir=str(out_dir), save_steps=4,
                                       save_total_limit=10, async_save=False),
        train=tc.TrainConfig(max_steps=max_steps, **TRAIN))


def _port_dataset(texts):
    return make_batches(texts, ByteTokenizer(), seq_len=SEQ, micro_batch_size=BS,
                        grad_accum_steps=ACCUM)


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    """Both Trainers, 6 steps at k=4 from the same float32 weights (each
    quantizes them itself), one save at step 4."""
    tmp = tmp_path_factory.mktemp("int8_trainer")
    texts = _texts(28)
    jt = _jax_trainer(tmp / "jck", 6, tmp)
    jstate = jax_create_state(jax.random.PRNGKey(0), jt.model, jt.tx, (BS, SEQ),
                              init_fn=lambda rng, x: jax.tree_util.tree_map(jnp.asarray, tree))
    jstate = jstate.replace(params=jq.quantize_params_int8(jstate.params))
    jstate, _ = jt.train(dataset=_jax_dataset(texts), state=jstate)
    tstate, rec = Trainer(_port_cfg(tmp / "tck", 6), params=params_from_jax(tree),
                          device="cpu").train(dataset=_port_dataset(texts))
    return dict(tmp=tmp, texts=texts, jstate=jstate, jlosses=_jax_losses(tmp, 6),
                tstate=tstate, rec=rec)


def test_int8_trainer_matches_the_jax_trainer_at_k4_with_a_save(trained):
    rec = trained["rec"]
    assert rec.steps == 6 and rec.windows == 2 and rec.save_steps == [4]
    np.testing.assert_allclose(rec.losses, trained["jlosses"], rtol=RTOL)
    flat = params_from_jax(jax.device_get(trained["jstate"].params))
    for n, p in trained["tstate"].model.named_parameters():
        if is_lora_name(n):
            want = flat[n].numpy()
            err = np.linalg.norm(p.detach().numpy() - want) / np.linalg.norm(want)
            assert err <= RTOL, f"{n}: relative L2 difference {err:.2e}"
        elif n.rpartition(".")[0] in tq.quant_bases(flat):
            assert torch.equal(p.detach(), flat[n]), n  # the base never moves
    tck, jck = str(trained["tmp"] / "tck"), str(trained["tmp"] / "jck")
    assert store.list_checkpoint_steps(tck) == jstore.list_checkpoint_steps(jck) == [4]
    names = lambda d: [e["name"] for e in json.load(open(os.path.join(d, "4", "MANIFEST.json")))["leaves"]]  # noqa: E731
    assert names(tck) == names(jck)
    assert any(n.endswith("['kernel']['q']") for n in names(tck))
    got = dict(store.restore_train_state(tck, 4, store_leaves(trained["tstate"]),
                                         device="cpu"))
    for n, t in got.items():
        if n.endswith(("['q']", "['scale']")) and "norm" not in n:
            want = jstore_leaf(jck, n)
            assert np.array_equal(t.numpy(), want), n


def store_leaves(state):
    from dlti_tpu_torch.training.state import state_leaves

    return state_leaves(state, whole=False)


def jstore_leaf(ck_dir, name):
    """One leaf of a JAX checkpoint, read back through the port's store
    (the format is shared), as numpy."""
    root = os.path.join(ck_dir, "4")
    manifest = json.load(open(os.path.join(root, "MANIFEST.json")))
    [entry] = [e for e in manifest["leaves"] if e["name"] == name]
    [arr] = store._read_leaves(root, [entry], pinned=False, verify=True)
    return np.asarray(arr)


def test_int8_checkpoints_resume_across_the_packages_both_ways(trained):
    """The port resumes the JAX run's step-4 checkpoint and the JAX Trainer
    the port's; both continue to step 6 as the uninterrupted runs did."""
    tmp, texts = trained["tmp"], trained["texts"]
    port_dir, jax_dir = tmp / "port_from_jax", tmp / "jax_from_port"
    shutil.copytree(tmp / "jck", port_dir)
    shutil.copytree(tmp / "tck", jax_dir)
    _, rec = Trainer(_port_cfg(port_dir, 6), device="cpu").train(
        dataset=_port_dataset(texts))
    assert rec.resumed_from == 4
    np.testing.assert_allclose(rec.losses, trained["jlosses"][4:], rtol=RTOL)
    jt = _jax_trainer(jax_dir, 6, tmp / "jax_from_port")
    os.makedirs(tmp / "jax_from_port", exist_ok=True)
    jt.train(dataset=_jax_dataset(texts))
    np.testing.assert_allclose(_jax_losses(tmp / "jax_from_port", 6),
                               trained["rec"].losses[4:], rtol=RTOL)


def test_int8_merged_export_equals_the_jax_export(trained, tmp_path):
    from dlti_tpu_torch.training import whole_params

    tstate, jstate = trained["tstate"], trained["jstate"]
    jcfg = jc.Config(model=JCFG, lora=jc.LoRAConfig(**LORA),
                     checkpoint=jc.CheckpointConfig(save_strategy="no"))
    jout = jax_export(str(tmp_path / "jax"), jstate.params, jcfg)
    # The port's export of the JAX run's weights (the same leaves, so the
    # same merged tree), and of its own run's.
    tout = export_merged_model(str(tmp_path / "port"),
                               params_from_jax(jax.device_get(jstate.params)),
                               tc.Config(model=TCFG, lora=tc.LoRAConfig(**LORA), checkpoint=NO_SAVE))
    assert manifest_digest(os.path.join(tout, "model")) == \
        jstore.manifest_digest(os.path.join(jout, "model"))
    # The port's own run exports the same tree structure: bf16 kernels, no
    # int8 leaf, no adapter.
    mine = export_merged_model(str(tmp_path / "mine"), whole_params(tstate),
                               tc.Config(model=TCFG, lora=tc.LoRAConfig(**LORA), checkpoint=NO_SAVE))
    got = params_from_jax(store.load_pytree(os.path.join(mine, "model")))
    want = params_from_jax(jax.device_get(jstore.load_pytree(os.path.join(jout, "model"))))
    assert got.keys() == want.keys()
    assert all(t.dtype == want[n].dtype != torch.int8 for n, t in got.items())


def test_zero3_world_2_int8_step_matches_jax_single_device(tree, tmp_path):
    """Under ZeRO-3 (the lowered shard threshold) every ``q`` and ``scale``
    leaf is a rank's shard, gathered at use, as the reference places them."""
    qtree = jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    rng = np.random.default_rng(7)
    shape = (W.ACCUM, W.BS, W.SEQ)
    batches = [{"input_ids": rng.integers(3, JCFG.vocab_size, shape).astype(np.int32),
                "loss_mask": (rng.random(shape) > 0.3).astype(np.int32)} for _ in range(3)]
    model = JaxLlama(JCFG, jc.LoRAConfig(**W.LORA))
    state = jax_create_state(jax.random.PRNGKey(0), model,
                             jax_build_optimizer(jc.OptimizerConfig(**W.OPT)), (W.BS, W.SEQ),
                             init_fn=lambda r, x: _jax_tree_r4())
    state = state.replace(params=jq.quantize_params_int8(state.params))
    step = jax.jit(jax_make_step(model, accum_steps=W.ACCUM))
    want = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i))
        want.append({k: float(v) for k, v in jax.device_get(m).items()})
    want_params = params_from_jax(jax.device_get(state.params))
    del qtree
    params = {n: t.numpy() for n, t in params_from_jax(jax.device_get(
        jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, _jax_tree_r4())))).items()}
    [r0, r1] = W.spawn_world(2, [("z3", "steps", dict(
        params=params, batches=batches, parallel=dict(zero_stage=3, fsdp=2), lora=W.LORA,
        model=WIDE))], str(tmp_path))
    got = r0["z3"]
    split = {n for n, (local, whole) in got["shapes"].items() if local != whole}
    assert {"model.layers.0.attn.q_proj.kernel.q", "model.layers.0.attn.q_proj.kernel.scale",
            "lm_head.q"} <= split
    for i, (g, w) in enumerate(zip(got["metrics"], want)):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=DP_TOL, atol=DP_TOL,
                                       err_msg=f"step {i + 1} {k}")
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, want_params[n].numpy(), rtol=DP_TOL, atol=DP_TOL,
                                   err_msg=n)


def _jax_tree_r4():
    """The float32 tree with the data-parallel tests' LoRA rank."""
    tree = JaxLlama(JCFG, jc.LoRAConfig(**W.LORA)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def test_int8_weight_engine_greedy_tokens_equal_the_jax_int8_engine():
    tree = _jax_tree(lora=False, seed=1)
    ec = dict(max_seqs=3, block_size=8, num_blocks=32, max_model_len=64,
              cache_dtype="float32", eos_token_id=-1, quantization="int8", steps_per_sync=4)
    jeng = JaxEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, tree), JaxEngineConfig(**ec))
    teng = InferenceEngine(TCFG, params_from_jax(tree), EngineConfig(**ec), device="cpu")
    assert isinstance(teng.executor.model.lm_head, tq.QuantizedWeight)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12], [13], [14, 15, 16, 17]]
    want = jeng.generate(prompts, JaxSamplingParams(temperature=0.0, max_tokens=10))
    got = teng.generate(prompts, SamplingParams(temperature=0.0, max_tokens=10))
    for w, g in zip(want, got):
        assert g.output_token_ids == w.output_token_ids
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs, atol=1e-4, rtol=0)
    # The int8 weights are really what it serves: the bf16 base serves other logits.
    plain = InferenceEngine(TCFG, params_from_jax(tree),
                            EngineConfig(**dict(ec, quantization="none")), device="cpu")
    other = plain.generate(prompts, SamplingParams(temperature=0.0, max_tokens=10))
    assert any(not np.allclose(a.output_logprobs, b.output_logprobs, atol=1e-6)
               for a, b in zip(other, got))


def test_cli_export_of_an_int8_run_equals_the_jax_scripts_export(tmp_path):
    """``cli.export --quantize-base int8`` of a port int8-base checkpoint
    (``llama_debug``: bf16, 4 blocks whose kernels pass the threshold)
    writes the export ``scripts/export_from_checkpoint.py --quantize-base
    int8`` writes from the same checkpoint: equal manifest digests."""
    import subprocess
    import sys

    from dlti_tpu_torch.cli import export as export_cli

    cfg = tc.Config(model=tc.MODEL_PRESETS["llama_debug"], lora=tc.LoRAConfig(**LORA),
                    data=tc.DataConfig(max_seq_len=SEQ, tokenizer="byte"),
                    checkpoint=tc.CheckpointConfig(output_dir=str(tmp_path / "ck"),
                                                   save_steps=2, async_save=False),
                    train=tc.TrainConfig(micro_batch_size=BS, grad_accum_steps=1,
                                         max_steps=2, quantize_frozen_base="int8"))
    Trainer(cfg, device="cpu").train(dataset=make_batches(
        _texts(8), ByteTokenizer(), seq_len=SEQ, micro_batch_size=BS))
    digest = export_cli.export(export_cli.parse_args(
        ["--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"), "--model",
         "llama_debug", "--lora-r", "4", "--quantize-base", "int8",
         "--out", str(tmp_path / "port")]))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "scripts/export_from_checkpoint.py", "--checkpoint-dir",
         str(tmp_path / "ck"), "--model", "llama_debug", "--lora-r", "4",
         "--quantize-base", "int8", "--out", str(tmp_path / "jax")],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == f"manifest sha256: {digest}"
    tree = params_from_jax(store.load_pytree(str(tmp_path / "port" / "model")))
    assert tree["lm_head"].dtype == torch.bfloat16 and "lm_head.q" not in tree
