"""Hugging Face checkpoints and PEFT adapters in the port
(``dlti_tpu_torch.models.hf_interop``, ``dlti_tpu_torch.utils.safetensors``)
against the JAX package's ``hf_interop``, ``transformers`` and ``peft``.

* The package's safetensors codec against the ``safetensors`` package,
  both directions, every dtype the models use (bf16 included), and its
  refusal of malformed files.
* A directory ``transformers``' ``save_pretrained`` writes from a seeded
  tiny Llama loads in the port bit for bit as in the JAX package, and its
  logits match ``transformers`` within 2e-4 (float32).
* HF and PEFT directories cross between the packages both ways, the
  sharded writer makes the JAX writer's shards and index, a PEFT adapter
  the port writes loads in ``peft`` with the same merged logits, and the
  config mapping equals the JAX one family by family (MoE and per-layer
  windows raise).
* ``cli.train --init-from-hf --export-peft --export-hf`` against the JAX
  ``Trainer(base_params=...)``: per-step losses within 1e-5 (float32), and
  its exports against the trained state.
"""

import dataclasses
import functools
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlti_tpu import config as jc
from dlti_tpu.data import make_batches as jax_make_batches
from dlti_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.models import hf_interop as jhf
from dlti_tpu.training.trainer import Trainer as JaxTrainer
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.models import hf_interop as thf
from dlti_tpu_torch.models import load_model, merge_lora_params, params_from_jax
from dlti_tpu_torch.models.interop import params_to_jax
from dlti_tpu_torch.utils import safetensors as tst

safetensors = pytest.importorskip("safetensors")
transformers = pytest.importorskip("transformers")

LOGITS_TOL = 2e-4
RTOL = 1e-5
# The JAX tests' tiny Llama, with the byte tokenizer's vocabulary room.
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=64, dtype="float32",
            param_dtype="float32", remat=False, attention_impl="reference")
TCFG = tc.ModelConfig(**TINY)
JCFG = jc.ModelConfig(**TINY)


def _hf_model(tie=False):
    from transformers import LlamaConfig, LlamaForCausalLM

    hf_cfg = LlamaConfig(
        vocab_size=TCFG.vocab_size, hidden_size=TCFG.hidden_size,
        intermediate_size=TCFG.intermediate_size, num_hidden_layers=TCFG.num_layers,
        num_attention_heads=TCFG.num_heads, num_key_value_heads=TCFG.num_kv_heads,
        max_position_embeddings=TCFG.max_seq_len, rms_norm_eps=TCFG.rms_norm_eps,
        rope_theta=TCFG.rope_theta, tie_word_embeddings=tie, attention_bias=False)
    torch.manual_seed(0)
    return LlamaForCausalLM(hf_cfg).eval()


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A directory ``save_pretrained`` wrote, and the model that wrote it."""
    d = tmp_path_factory.mktemp("hf") / "tiny"
    model = _hf_model()
    model.save_pretrained(str(d), safe_serialization=True)
    return str(d), model


def _jax_flat(tree):
    return params_from_jax(jax.device_get(tree))


def _assert_equal_params(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


# ----------------------------------------------------------------------
# the safetensors codec
# ----------------------------------------------------------------------

def _sample_tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "w.bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "w.f32": torch.randn(4, 4, generator=g),
        "w.f16": torch.randn(2, 3, generator=g).half(),
        "q.i8": torch.randint(-127, 128, (7,), generator=g, dtype=torch.int8),
        "ids.i32": torch.arange(5, dtype=torch.int32),
        "ids.i64": torch.arange(3, dtype=torch.int64),
        "empty": torch.zeros(0, 4),
        "scalar": torch.tensor(2.5),
    }


def test_files_the_port_writes_load_in_safetensors(tmp_path):
    from safetensors import safe_open

    tensors = _sample_tensors()
    path = str(tmp_path / "t.safetensors")
    tst.save_file(tensors, path, {"format": "pt"})
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        assert sorted(f.keys()) == sorted(tensors)
        for k in f.keys():
            got = f.get_tensor(k)
            assert got.dtype == tensors[k].dtype and torch.equal(got, tensors[k]), k
    # numpy view of the same file (the framework the JAX package reads with)
    with safe_open(path, framework="np") as f:
        np.testing.assert_array_equal(f.get_tensor("w.f32"), tensors["w.f32"].numpy())
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]


def test_files_safetensors_writes_load_in_the_port(tmp_path):
    from safetensors.torch import save_file

    tensors = _sample_tensors()
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"k": "v"})
    header, meta, _ = tst.read_header(path)
    assert meta == {"k": "v"} and sorted(header) == sorted(tensors)
    got = tst.load_file(path)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


@pytest.mark.parametrize("damage", ["truncated", "hole", "bad_dtype", "short"])
def test_malformed_files_are_refused(tmp_path, damage):
    path = str(tmp_path / "t.safetensors")
    tst.save_file({"a": torch.ones(4), "b": torch.ones(2, dtype=torch.int8)}, path)
    raw = open(path, "rb").read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    if damage == "truncated":
        raw = raw[:-1]
    elif damage == "short":
        raw = raw[:5]
    else:
        if damage == "hole":
            header["b"]["data_offsets"] = [header["b"]["data_offsets"][0] + 1,
                                           header["b"]["data_offsets"][1] + 1]
        else:
            header["a"]["dtype"] = "C64"
        body = json.dumps(header).encode()
        body += b" " * (-len(body) % 8)
        raw = struct.pack("<Q", len(body)) + body + raw[8 + n:]
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(tst.SafetensorsError):
        tst.load_file(path)


# ----------------------------------------------------------------------
# checkpoints from transformers
# ----------------------------------------------------------------------

def test_transformers_directory_loads_as_the_jax_package_loads_it(hf_dir):
    d, _ = hf_dir
    tparams, tcfg_ = thf.load_hf_checkpoint(d, device="cpu")
    jparams, jcfg_ = jhf.load_hf_checkpoint(d)
    assert dataclasses.asdict(tcfg_) == dataclasses.asdict(jcfg_)
    _assert_equal_params(tparams, _jax_flat(jparams))
    # with the float32 config the packages' tests use
    tparams, _ = thf.load_hf_checkpoint(d, cfg=TCFG, device="cpu")
    jparams, _ = jhf.load_hf_checkpoint(d, cfg=JCFG)
    _assert_equal_params(tparams, _jax_flat(jparams))


def test_logits_match_transformers(hf_dir):
    d, hf_model = hf_dir
    params, _ = thf.load_hf_checkpoint(d, cfg=TCFG, device="cpu")
    ids = np.random.default_rng(0).integers(0, TCFG.vocab_size, (2, 16))
    with torch.no_grad():
        want = hf_model(torch.tensor(ids)).logits.numpy()
        got = load_model(TCFG, params, "cpu")(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_state_dict_round_trip_and_its_errors(hf_dir):
    _, hf_model = hf_dir
    sd = {k: v.detach().clone() for k, v in hf_model.state_dict().items()}
    params = thf.params_from_hf_state_dict(sd, TCFG)
    back = thf.hf_state_dict_from_params(params, TCFG)
    assert set(back) == {k for k in sd if "rotary_emb" not in k}
    jback = jhf.hf_state_dict_from_params(params_to_jax(
        {k: v.numpy() for k, v in params.items()}), JCFG)
    assert list(back) == list(jback)  # the JAX writer's key order
    for k in back:
        assert torch.equal(back[k], sd[k]), k
    extra = dict(sd)
    extra["model.layers.7.self_attn.q_proj.weight"] = sd["model.layers.0.self_attn.q_proj.weight"]
    with pytest.raises(ValueError, match="unconsumed"):
        thf.params_from_hf_state_dict(extra, TCFG)
    missing = dict(sd)
    del missing["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError):
        thf.params_from_hf_state_dict(missing, TCFG)
    with pytest.raises(ValueError, match="merge LoRA"):
        thf.hf_state_dict_from_params({**params, "model.layers.0.attn.q_proj.lora_a":
                                       torch.zeros(64, 4)}, TCFG)


def test_tied_checkpoint_omits_lm_head(tmp_path):
    model = _hf_model(tie=True)
    cfg = dataclasses.replace(TCFG, tie_embeddings=True)
    params = thf.params_from_hf_state_dict(model.state_dict(), cfg)
    assert "lm_head" not in params
    thf.save_hf_checkpoint(str(tmp_path), params, cfg)
    assert "lm_head.weight" not in tst.read_header(str(tmp_path / "model.safetensors"))[0]
    ids = torch.tensor([[5, 9, 200, 3]])
    with torch.no_grad():
        np.testing.assert_allclose(load_model(cfg, params, "cpu")(ids).numpy(),
                                   model(ids).logits.numpy(), rtol=LOGITS_TOL,
                                   atol=LOGITS_TOL)


@pytest.mark.parametrize("shard_bytes", [4 * 1024 ** 3, 200_000])
def test_port_and_jax_directories_cross_both_ways(tmp_path, shard_bytes):
    tree = jax.device_get(JaxLlama(JCFG).init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 8), jnp.int32))["params"])
    params = _jax_flat(tree)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    thf.save_hf_checkpoint(tdir, params, TCFG, max_shard_bytes=shard_bytes)
    jhf.save_hf_checkpoint(jdir, tree, JCFG, max_shard_bytes=shard_bytes)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in ("config.json", "model.safetensors.index.json"):
        if os.path.exists(os.path.join(jdir, name)):
            with open(os.path.join(tdir, name)) as a, open(os.path.join(jdir, name)) as b:
                assert json.load(a) == json.load(b), name
    jback, jcfg_ = jhf.load_hf_checkpoint(tdir, cfg=JCFG)
    _assert_equal_params(_jax_flat(jback), params)
    tback, _ = thf.load_hf_checkpoint(jdir, cfg=TCFG, device="cpu")
    _assert_equal_params(tback, params)
    loaded = transformers.LlamaForCausalLM.from_pretrained(tdir)
    ids = torch.tensor([[1, 7, 300, 4, 4]])
    with torch.no_grad():
        np.testing.assert_allclose(loaded(ids).logits.numpy(),
                                   load_model(TCFG, params, "cpu")(ids).numpy(),
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)


_FAMILIES = {
    "llama": dict(model_type="llama", hidden_act="silu"),
    "mistral": dict(model_type="mistral", sliding_window=32),
    "qwen2": dict(model_type="qwen2", sliding_window=32, use_sliding_window=True,
                  max_window_layers=0, torch_dtype="float32"),
    "gemma": dict(model_type="gemma", head_dim=32, hidden_activation=None),
    "llama_bias_f16": dict(model_type="llama", attention_bias=True, torch_dtype="float16",
                           tie_word_embeddings=True),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_config_mapping_matches_jax(family):
    hf = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
          "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
          **_FAMILIES[family]}
    got = thf.config_from_hf(hf, remat=False)
    want = jhf.config_from_hf(hf, remat=False)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert thf.config_to_hf(got) == jhf.config_to_hf(want)
    # config.json names head_dim explicitly
    back = thf.config_from_hf(thf.config_to_hf(got), remat=False)
    assert back == dataclasses.replace(got, head_dim=got.resolved_head_dim)


@pytest.mark.parametrize("hf,match", [
    ({"model_type": "mixtral", "num_local_experts": 8}, "mixture-of-experts"),
    ({"model_type": "qwen2_moe", "num_experts": 4}, "mixture-of-experts"),
    ({"model_type": "phi"}, "not supported"),
    ({"model_type": "qwen2", "sliding_window": 8, "use_sliding_window": True,
      "max_window_layers": 1, "num_hidden_layers": 2}, "per-layer sliding window"),
    ({"model_type": "llama", "hidden_act": "relu"}, "unsupported hidden_act"),
])
def test_unsupported_configs_raise_by_name(hf, match):
    with pytest.raises(NotImplementedError, match=match):
        thf.config_from_hf(hf)


def test_graft_keeps_lora_factors_and_refuses_mismatches(hf_dir):
    d, _ = hf_dir
    lora = tc.LoRAConfig(r=4, alpha=8, dropout=0.0)
    from dlti_tpu_torch.models.interop import init_params

    fresh = init_params(TCFG, seed=3, device="cpu", lora=lora)
    lora_before = {n: t.clone() for n, t in fresh.items() if "lora" in n}
    base, _ = thf.load_hf_checkpoint(d, cfg=TCFG, device="cpu")
    want = {n: t.clone() for n, t in base.items()}
    out = thf.graft_base_params(fresh, base)
    assert not base  # consumed leaf by leaf
    for n, t in want.items():
        assert torch.equal(out[n], t), n
    for n, t in lora_before.items():
        assert torch.equal(out[n], t), n
    bad, _ = thf.load_hf_checkpoint(d, cfg=TCFG, device="cpu")
    bad["model.embed_tokens"] = bad["model.embed_tokens"][:, :32]
    with pytest.raises(ValueError, match="shape"):
        thf.graft_base_params(init_params(TCFG, seed=3, device="cpu", lora=lora), bad)
    extra, _ = thf.load_hf_checkpoint(d, cfg=TCFG, device="cpu")
    extra["model.layers.9.attn.q_proj.kernel"] = torch.zeros(1)
    with pytest.raises(ValueError, match="lacks"):
        thf.graft_base_params(init_params(TCFG, seed=3, device="cpu", lora=lora), extra)


# ----------------------------------------------------------------------
# PEFT adapters
# ----------------------------------------------------------------------

def _lora_tree(seed, lora):
    tree = jax.device_get(JaxLlama(JCFG, lora).init(jax.random.PRNGKey(seed),
                                                    jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: rng.normal(0.0, 0.2, a.shape).astype(np.float32)
        if getattr(path[-1], "key", "") in ("lora_a", "lora_b") else np.asarray(a), tree)


def test_peft_adapters_cross_between_the_packages(tmp_path):
    jlora = jc.LoRAConfig(r=4, alpha=8, dropout=0.0)
    tlora = tc.LoRAConfig(r=4, alpha=8, dropout=0.0)
    tree = _lora_tree(1, jlora)
    params = _jax_flat(tree)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    thf.save_peft_adapter(tdir, params, tlora)
    jhf.save_peft_adapter(jdir, tree, jlora)
    with open(os.path.join(tdir, "adapter_config.json"), "rb") as a, \
            open(os.path.join(jdir, "adapter_config.json"), "rb") as b:
        assert a.read() == b.read()
    tsd = tst.load_file(os.path.join(tdir, "adapter_model.safetensors"))
    jsd = tst.load_file(os.path.join(jdir, "adapter_model.safetensors"))
    assert sorted(tsd) == sorted(jsd) and all(torch.equal(tsd[k], jsd[k]) for k in jsd)
    # each package loads the other's into a fresh tree
    fresh = _jax_flat(_lora_tree(2, jlora))
    thf.load_peft_adapter(jdir, fresh)
    jfresh = jhf.load_peft_adapter(tdir, _lora_tree(2, jlora))
    for name, t in params.items():
        if name.endswith(("lora_a", "lora_b")):
            assert torch.equal(fresh[name], t), name
            assert torch.equal(_jax_flat(jfresh)[name], t), name
    with pytest.raises(ValueError, match="no LoRA factors"):
        thf.save_peft_adapter(str(tmp_path / "none"), merge_lora_params(params), tlora)
    wrong = _jax_flat(_lora_tree(2, jc.LoRAConfig(r=2, alpha=8, dropout=0.0)))
    with pytest.raises(ValueError, match="shape"):
        thf.load_peft_adapter(tdir, wrong)


def test_port_peft_adapter_loads_in_peft_with_the_same_merged_logits(hf_dir, tmp_path):
    peft = pytest.importorskip("peft")
    d, _ = hf_dir
    lora = tc.LoRAConfig(r=4, alpha=8, dropout=0.0)
    params = _jax_flat(_lora_tree(3, jc.LoRAConfig(r=4, alpha=8, dropout=0.0)))
    base, _ = thf.load_hf_checkpoint(d, cfg=TCFG, device="cpu")
    params = thf.graft_base_params(params, base)
    thf.save_peft_adapter(str(tmp_path), params, lora)
    peft_model = peft.PeftModel.from_pretrained(_hf_model(), str(tmp_path)).merge_and_unload()
    ids = np.random.default_rng(1).integers(0, TCFG.vocab_size, (2, 12))
    with torch.no_grad():
        want = peft_model(torch.tensor(ids)).logits.numpy()
        got = load_model(TCFG, merge_lora_params(params, alpha=lora.alpha),
                         "cpu")(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


# ----------------------------------------------------------------------
# cli.train --init-from-hf
# ----------------------------------------------------------------------

def _texts(n=48):
    rng = np.random.default_rng(5)
    return ["".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(5, 60)))
            for _ in range(n)]


def test_cli_train_from_hf_matches_the_jax_trainer(hf_dir, tmp_path, monkeypatch, capsys):
    """The CLI with the JAX script's HF flags against the JAX ``Trainer``
    given the same checkpoint as ``base_params``. The two packages draw
    random numbers differently (ROADMAP, parity rules), so the port's seeded
    init is replaced by the JAX trainer's own initial tree (whose base the
    CLI's graft then replaces) and LoRA dropout is 0 on both sides; every
    other step is the CLI's."""
    from dlti_tpu_torch.cli import train as cli_train
    from dlti_tpu_torch.models import interop

    d, _ = hf_dir
    seq, bs, accum, steps = 32, 2, 2, 8
    data = tmp_path / "data.jsonl"
    texts = _texts()
    data.write_text("".join(json.dumps({"text": t}) + "\n" for t in texts))
    hf_model = jhf.config_from_hf(json.load(open(os.path.join(d, "config.json"))),
                                  **{f: getattr(JCFG, f) for f in cli_train.PERF_FIELDS})
    jcfg = jc.Config(
        model=hf_model, lora=jc.LoRAConfig(r=4, alpha=8, dropout=0.0),
        optimizer=jc.OptimizerConfig(learning_rate=1e-2, warmup_steps=2),
        data=jc.DataConfig(max_seq_len=seq, tokenizer="byte"),
        checkpoint=jc.CheckpointConfig(output_dir=str(tmp_path / "jck"), save_strategy="no"),
        train=jc.TrainConfig(micro_batch_size=bs, grad_accum_steps=accum, max_steps=steps,
                             steps_per_sync=4, seed=42, logging_steps=100,
                             metrics_csv=str(tmp_path / "jm.csv")),
        telemetry=jc.TelemetryConfig(step_log_path=str(tmp_path / "js.jsonl")))
    jbase, _ = jhf.load_hf_checkpoint(d, cfg=hf_model)
    init_tree = jax.device_get(JaxTrainer(jcfg).init_state().params)
    jtrainer = JaxTrainer(jcfg, base_params=jbase)
    jstate, jrecord = jtrainer.train(dataset=jax_make_batches(
        texts, JaxByteTokenizer(), seq_len=seq, micro_batch_size=bs,
        grad_accum_steps=accum, shard_by_host=False))

    monkeypatch.setattr(interop, "init_params", lambda *a, **k: _jax_flat(init_tree))
    monkeypatch.setattr(cli_train, "LoRAConfig",
                        functools.partial(tc.LoRAConfig, dropout=0.0))
    out = tmp_path / "out"
    cli_train.main([
        "--device", "cpu", "--model", "llama_tiny", "--tokenizer", "byte",
        "--dataset-path", str(data), "--max-seq-len", str(seq),
        "--per-device-batch-size", str(bs), "--gradient-accumulation-steps", str(accum),
        "--max-steps", str(steps), "--steps-per-sync", "4", "--lora-r", "4",
        "--learning-rate", "1e-2", "--warmup-steps", "2", "--save-strategy", "no",
        "--output-dir", str(tmp_path / "ck"),
        "--metrics-csv", str(tmp_path / "m.csv"), "--step-log", str(tmp_path / "s.jsonl"),
        "--init-from-hf", d, "--export-peft", str(out / "peft"),
        "--export-hf", str(out / "hf")])
    printed = capsys.readouterr().out
    assert "model arch from" in printed and "PEFT adapter ->" in printed
    losses, jlosses = ([json.loads(ln)["loss"] for ln in open(tmp_path / name)
                        if json.loads(ln).get("type") == "step"]
                       for name in ("s.jsonl", "js.jsonl"))
    assert len(losses) == steps == len(jlosses)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)

    # The exports: the PEFT factors and the merged HF model are the JAX
    # state's within the trajectory's tolerance, and load in both packages.
    jparams = _jax_flat(jstate.params)
    peft_sd = tst.load_file(str(out / "peft" / "adapter_model.safetensors"))
    for key, w in peft_sd.items():
        mod = key.removeprefix("base_model.model.").replace("self_attn", "attn")
        which = "lora_a" if ".lora_A." in key else "lora_b"
        want = jparams[mod.split(".lora_")[0] + "." + which].T
        err = (w - want).norm() / want.norm()
        assert err <= RTOL, (key, float(err))
    hf_back, back_cfg = thf.load_hf_checkpoint(str(out / "hf"), device="cpu",
                                               **{f: getattr(TCFG, f) for f in cli_train.PERF_FIELDS})
    jmerged = _jax_flat(jax.device_get(merge_jax(jstate.params)))
    for name, t in hf_back.items():
        torch.testing.assert_close(t, jmerged[name], rtol=RTOL, atol=1e-6)
    jhf_back, _ = jhf.load_hf_checkpoint(str(out / "hf"), cfg=hf_model)
    _assert_equal_params(_jax_flat(jhf_back), hf_back)


def merge_jax(params):
    from dlti_tpu.models.lora import merge_lora_params as jax_merge

    return jax_merge(jax.device_get(params), alpha=8)


def _train_cli(tmp_path, name, *extra):
    """``cli.train --init-from-hf`` on the CPU as a subprocess (a ZeRO preset
    forms its own group of one); returns its per-step losses."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    log = tmp_path / f"{name}.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "dlti_tpu_torch.cli.train", "--device", "cpu",
         "--model", "llama_tiny", "--tokenizer", "byte", "--dataset-path",
         str(tmp_path / "data.jsonl"), "--max-seq-len", "32", "--per-device-batch-size", "2",
         "--gradient-accumulation-steps", "2", "--max-steps", "4", "--lora-r", "4",
         "--learning-rate", "1e-2", "--warmup-steps", "1", "--save-strategy", "no",
         "--output-dir", str(tmp_path / f"{name}_ck"), "--metrics-csv",
         str(tmp_path / f"{name}.csv"), "--step-log", str(log),
         "--init-from-hf", str(tmp_path / "hf"), *extra],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-4000:]
    return [json.loads(ln)["loss"] for ln in open(log) if json.loads(ln).get("type") == "step"]


def test_cli_train_from_hf_takes_the_seeded_base_paths(tmp_path):
    """An HF base goes where a seeded base goes: under ZeRO-3 with both host
    offloads its losses are the baseline run's (a group of one reduces
    nothing), and under ``--quantize-base int8`` the frozen leaves are the
    int8 pairs of the HF weights (the merged export holds their
    expansion)."""
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.models.quantization import dequantize, quantize_int8

    cfg = tc.MODEL_PRESETS["llama_tiny"]
    hf_params = init_params(cfg, seed=7, device="cpu")
    thf.save_hf_checkpoint(str(tmp_path / "hf"), hf_params, cfg)
    (tmp_path / "data.jsonl").write_text(
        "".join(json.dumps({"text": t}) + "\n" for t in _texts(24)))
    base = _train_cli(tmp_path, "base")
    zero3 = _train_cli(tmp_path, "zero3", "--preset", "zero3", "--offload-params",
                       "--offload-optimizer")
    assert len(base) == 4 and zero3 == base
    _train_cli(tmp_path, "int8", "--quantize-base", "int8", "--export-hf",
               str(tmp_path / "int8_hf"))
    exported, _ = thf.load_hf_checkpoint(str(tmp_path / "int8_hf"), device="cpu",
                                         dtype="float32", param_dtype="float32")
    # llama_tiny's leaves large enough to quantize: the embedding and the head
    for name in ("model.embed_tokens", "lm_head"):
        want = dequantize(*quantize_int8(hf_params[name]), torch.bfloat16).float()
        assert torch.equal(exported[name], want), name
        assert not torch.equal(exported[name], hf_params[name]), name
