"""The port's merged export, ``cli.export`` and ``cli.serve --model-dir``
against the JAX package's (``llama_tiny``, CPU).

* ``Config.to_dict`` / ``from_dict``: the JAX ``Config.from_dict`` of the
  port's ``config.json`` gives the JAX preset's ``ModelConfig`` for every
  preset the port has; the port reads the JAX package's ``config.json``
  and refuses a model it cannot run.
* Exports cross both ways: each package's merged kernels agree with the
  other's (float32 to 1e-6 relative, bfloat16 and float16 to one step of
  the type: the two merges sum in different orders), and a port export and
  a JAX export
  each give equal greedy tokens from the JAX engine and from the port's
  engine built by ``cli.serve.build --model-dir --device cpu``; an
  unmerged (``--keep-lora``) export serves the same tokens through its
  adapters.
* The CLI round trip ``cli.train --output-dir --export-dir`` ->
  ``cli.export`` -> ``cli.serve.build --model-dir`` on ``--device cpu``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlti_tpu import config as jc
from dlti_tpu.checkpoint import export as jexport
from dlti_tpu.checkpoint import store as jstore
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.checkpoint import (
    export_merged_model, load_exported_model, manifest_digest,
)
from dlti_tpu_torch.cli import export as export_cli
from dlti_tpu_torch.cli import serve as serve_cli
from dlti_tpu_torch.cli import train as train_cli
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import SamplingParams

LORA = dict(r=4, alpha=8, dropout=0.0)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9], [300, 17]]
ENGINE = dict(max_seqs=4, block_size=8, num_blocks=32, max_model_len=64)


@pytest.mark.parametrize("name", sorted(tc.MODEL_PRESETS))
def test_jax_reads_the_ports_config_json_back_to_its_preset(name):
    cfg = tc.Config(model=tc.MODEL_PRESETS[name],
                    checkpoint=tc.CheckpointConfig(save_strategy="no"))
    back = jc.Config.from_dict(json.loads(cfg.to_json()))
    assert back.model == jc.MODEL_PRESETS[name]
    assert back.lora == jc.LoRAConfig() and back.checkpoint.save_strategy == "no"


def test_port_reads_the_jax_config_json_and_refuses_models_it_cannot_run():
    jcfg = jc.Config(model=jc.MODEL_PRESETS["llama_tiny"], lora=jc.LoRAConfig(r=8, alpha=16),
                     checkpoint=jc.CheckpointConfig(save_steps=7),
                     train=jc.TrainConfig(seed=3, eval_steps=5))
    cfg = tc.Config.from_dict(jcfg.to_dict())
    assert cfg.model == tc.MODEL_PRESETS["llama_tiny"]
    assert cfg.lora == tc.LoRAConfig(r=8, alpha=16)
    assert cfg.checkpoint.save_steps == 7 and cfg.train.seed == 3
    assert cfg.optimizer.betas == (0.9, 0.999)
    assert tc.Config.from_json(cfg.to_json()) == cfg
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        tc.Config.from_dict(jc.Config(model=jc.MODEL_PRESETS["mixtral_tiny"],
                                      checkpoint=jc.CheckpointConfig(save_strategy="no"))
                            .to_dict())
    d = jcfg.to_dict()
    d["model"]["new_arch_flag"] = True
    with pytest.raises(ValueError, match="new_arch_flag"):
        tc.Config.from_dict(d)


def _params(dtype="float32", seed=0):
    """JAX init of llama_tiny with LoRA, plus numpy noise on every leaf (so
    the LoRA delta is not zero and no greedy token is a near-tie)."""
    jcfg = dataclasses.replace(jc.MODEL_PRESETS["llama_tiny"], dtype=dtype, param_dtype=dtype)
    tree = JaxLlama(jcfg, jc.LoRAConfig(**LORA)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.asarray(a).dtype), jax.device_get(tree))


def _configs(dtype="float32"):
    over = dict(dtype=dtype, param_dtype=dtype)
    jcfg = jc.Config(model=dataclasses.replace(jc.MODEL_PRESETS["llama_tiny"], **over),
                     lora=jc.LoRAConfig(**LORA),
                     checkpoint=jc.CheckpointConfig(save_strategy="no"))
    tcfg = tc.Config(model=dataclasses.replace(tc.MODEL_PRESETS["llama_tiny"], **over),
                     lora=tc.LoRAConfig(**LORA),
                     checkpoint=tc.CheckpointConfig(save_strategy="no"))
    return jcfg, tcfg


def _leaf_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_merged_exports_agree_across_packages(tmp_path, dtype):
    params = _params(dtype)
    jcfg, tcfg = _configs(dtype)
    jexport.export_merged_model(str(tmp_path / "jax"), params, jcfg)
    export_merged_model(str(tmp_path / "port"), params_from_jax(params), tcfg)
    jtree, _ = jexport.load_exported_model(str(tmp_path / "jax"))
    ptree, pcfg = load_exported_model(str(tmp_path / "port"))
    assert pcfg.lora.enabled is False
    assert json.loads((tmp_path / "port" / "config.json").read_text())["lora"]["enabled"] is False
    mj = json.loads((tmp_path / "jax" / "model" / "MANIFEST.json").read_text())
    mp = json.loads((tmp_path / "port" / "model" / "MANIFEST.json").read_text())
    assert [(e["name"], e["shape"], e["dtype"]) for e in mj["leaves"]] == \
        [(e["name"], e["shape"], e["dtype"]) for e in mp["leaves"]]
    theirs = params_from_jax(jtree)
    for name, ours in params_from_jax(ptree).items():
        want = theirs[name]
        if dtype != "float32":  # one bf16 / float16 step at most, same sign
            steps = np.abs(ours.view(torch.int16).numpy().astype(np.int32)
                           - want.view(torch.int16).numpy().astype(np.int32))
            assert steps.max() <= 1, name
        else:
            np.testing.assert_allclose(ours.numpy(), want.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=name)
    # Each package loads the other's export byte for byte.
    jback, _ = jexport.load_exported_model(str(tmp_path / "port"))
    for (p1, a), (p2, b) in zip(jax.tree_util.tree_flatten_with_path(jback)[0],
                                jax.tree_util.tree_flatten_with_path(ptree)[0]):
        np.testing.assert_array_equal(_leaf_bits(a), _leaf_bits(
            b.view(torch.int16).numpy() if b.dtype == torch.bfloat16 else b.numpy()))


def _jax_tokens(export_dir):
    params, cfg = jexport.load_exported_model(export_dir)
    engine = JaxEngine(cfg.model, jax.tree_util.tree_map(jnp.asarray, params),
                       JaxEngineConfig(cache_dtype="float32", **ENGINE),
                       lora_cfg=cfg.lora if cfg.lora.enabled else None)
    res = engine.generate(PROMPTS, JaxSamplingParams(temperature=0.0, max_tokens=8))
    return [list(r.output_token_ids) for r in res]


def _port_tokens(export_dir):
    args = serve_cli.parse_args(["--device", "cpu", "--model-dir", export_dir,
                                 "--tokenizer", "byte", "--kv-cache-dtype", "float32",
                                 "--max-seqs", "4", "--block-size", "8",
                                 "--num-blocks", "32", "--max-model-len", "64"])
    engine, _, _ = serve_cli.build(args)
    res = engine.generate(PROMPTS, SamplingParams(temperature=0.0, max_tokens=8))
    return [list(r.output_token_ids) for r in res]


@pytest.mark.parametrize("writer", ["port", "jax", "port_keep_lora", "jax_keep_lora"])
def test_either_engine_serves_either_export(tmp_path, writer, capsys):
    params = _params()
    jcfg, tcfg = _configs()
    d = str(tmp_path / writer)
    merge = not writer.endswith("keep_lora")
    if writer.startswith("port"):
        export_merged_model(d, params_from_jax(params), tcfg, merge_lora=merge)
    else:
        jexport.export_merged_model(d, params, jcfg, merge_lora=merge)
    jtok, ptok = _jax_tokens(d), _port_tokens(d)
    assert "loaded export" in capsys.readouterr().out
    assert jtok == ptok
    assert all(len(t) == 8 for t in ptok)
    if not merge:  # the adapters serve what the merged weights serve
        merged = str(tmp_path / "merged")
        export_merged_model(merged, params_from_jax(params), tcfg)
        assert _port_tokens(merged) == ptok


def test_manifest_of_is_the_digest_an_export_commits(tmp_path):
    """``manifest_of`` (how phase 13 of ``chip_smoke.py`` compares the live
    merge with the export without writing it) gives the manifest
    ``save_pytree`` commits."""
    import hashlib

    from dlti_tpu_torch.checkpoint.export import merged_tree
    from dlti_tpu_torch.checkpoint.store import manifest_of

    _, tcfg = _configs("bfloat16")
    params = params_from_jax(_params("bfloat16"))
    export_merged_model(str(tmp_path / "ex"), params, tcfg)
    assert hashlib.sha256(manifest_of(merged_tree(params, tcfg))).hexdigest() == \
        manifest_digest(str(tmp_path / "ex" / "model"))


def test_legacy_orbax_export_raises(tmp_path):
    _, tcfg = _configs()
    (tmp_path / "model").mkdir()
    (tmp_path / "config.json").write_text(tcfg.to_json())
    with pytest.raises(ValueError, match="Orbax"):
        load_exported_model(str(tmp_path))


def test_cli_train_export_serve_round_trip(tmp_path, capsys):
    """``cli.train`` checkpoints every 2 steps and exports; ``cli.export``
    of the newest verified step writes the same bytes (equal digests); the
    serve CLI's ``build`` serves it, with the JAX engine's greedy tokens."""
    data = tmp_path / "data.jsonl"
    rng = np.random.default_rng(3)
    data.write_text("".join(json.dumps({"text": " ".join(
        rng.choice(["lora", "model", "token", "x", "(y)"], rng.integers(3, 30)))}) + "\n"
        for _ in range(24)))
    ck, ex, ex2 = (str(tmp_path / n) for n in ("ck", "ex", "ex2"))
    train_cli.main(["--device", "cpu", "--model", "llama_tiny", "--tokenizer", "byte",
                    "--dataset-path", str(data), "--max-seq-len", "32",
                    "--per-device-batch-size", "2", "--gradient-accumulation-steps", "2",
                    "--max-steps", "4", "--save-steps", "2", "--warmup-steps", "1",
                    "--learning-rate", "1e-2", "--lora-r", "4",
                    "--output-dir", ck, "--export-dir", ex])
    out = capsys.readouterr().out
    assert sorted(os.listdir(ck)) == ["2", "4"]
    digest = manifest_digest(os.path.join(ex, "model"))
    assert f"manifest sha256: {digest}" in out
    assert json.loads(out.strip().splitlines()[-1])["save_steps"] == [2, 4]
    export_cli.main(["--device", "cpu", "--checkpoint-dir", ck, "--model", "llama_tiny",
                     "--lora-r", "4", "--out", ex2])
    out = capsys.readouterr().out
    assert "restoring step 4" in out
    assert out.strip().splitlines()[-1] == f"manifest sha256: {digest}"
    assert jstore.verify_pytree_dir(os.path.join(ex2, "model")) == (True, "ok")
    assert _port_tokens(ex2) == _jax_tokens(ex2)
    # A second run resumes from step 4 and stops at once (max steps reached).
    train_cli.main(["--device", "cpu", "--model", "llama_tiny", "--tokenizer", "byte",
                    "--dataset-path", str(data), "--max-seq-len", "32",
                    "--per-device-batch-size", "2", "--gradient-accumulation-steps", "2",
                    "--max-steps", "4", "--save-steps", "2", "--lora-r", "4",
                    "--output-dir", ck])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["resumed_from"] == 4 and summary["save_steps"] == []
    # --quantize-base int8 reads an int8-base run's checkpoint; this bf16
    # run's checkpoint does not match its template and is refused.
    with pytest.raises(ValueError, match="does not match the checkpoint"):
        export_cli.main(["--device", "cpu", "--checkpoint-dir", ck, "--model", "llama_tiny",
                         "--out", str(tmp_path / "q"), "--quantize-base", "int8"])


def test_cli_export_keep_lora_and_explicit_step(tmp_path, capsys):
    """``--keep-lora`` writes the adapters as leaves with LoRA on in the
    config; ``--step`` picks a step; a mismatched ``--lora-r`` is a
    structure error."""
    from dlti_tpu_torch.checkpoint import save_train_state
    from dlti_tpu_torch.models import load_model
    from dlti_tpu_torch.training import build_optimizer, create_train_state
    from dlti_tpu_torch.training.state import state_leaves

    _, tcfg = _configs()
    model = load_model(tcfg.model, params_from_jax(_params()), "cpu",
                       lora=tcfg.lora, trainable_lora=True)
    state = create_train_state(model, build_optimizer(tc.OptimizerConfig()))
    ck = str(tmp_path / "ck")
    for step in (3, 5):
        state.step = step
        save_train_state(ck, step, state_leaves(state), async_save=False)
    export_cli.main(["--device", "cpu", "--checkpoint-dir", ck, "--model", "llama_tiny",
                     "--lora-r", "4", "--step", "3", "--keep-lora", "--out",
                     str(tmp_path / "ex")])
    assert "restoring step 3" in capsys.readouterr().out
    tree, cfg = load_exported_model(str(tmp_path / "ex"))
    assert cfg.lora.enabled and cfg.lora.r == 4 and cfg.lora.alpha == 8
    assert "lora_a" in tree["model"]["layers_0"]["attn"]["q_proj"]
    with pytest.raises(ValueError, match="expects|leaves"):
        export_cli.main(["--device", "cpu", "--checkpoint-dir", ck, "--model",
                         "llama_tiny", "--lora-r", "8", "--out", str(tmp_path / "bad")])
