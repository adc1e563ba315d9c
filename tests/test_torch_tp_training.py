"""Tensor-parallel training in the port, over gloo on the CPU, against the
JAX package's single-device step on the whole batch.

The JAX package's contract (``tests/test_sharding.py``,
``tests/test_quantized_training.py::test_sharded_int8_matches_single_device``):
a step over a ``tensor`` mesh (and ``data x tensor``) gives the
single-device step's numbers. Here the devices are spawned processes in
one gloo group (``tests/torch_dist_worker.py``, a world of 2 and one of 4,
each spawned once for the module): ``tensor 2`` and ``data 2 x tensor 2``
(baseline, ZeRO-1, ZeRO-2) split heads, MLP hidden units and the
vocabulary, and the ranks of one tensor group take the same rows. Loss,
grad norm and every trained leaf (gathered whole) match the JAX
single-device step within 2e-4 under LoRA, in a full fine-tune, on an int8
frozen base (``llama_tiny`` widened so its projections are quantized) and
for ``mixtral_tiny``'s experts; with LoRA dropout on, the TP run equals the
port's own single-device run (every rank draws the single-device masks).
The placement rule equals the JAX ``param_pspec`` on float and int8 trees,
int8 parts equal the JAX TP engine's shards, a tensor-2 checkpoint verifies
in the JAX store and resumes at tensor 1, and each refused combination
raises by name.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from dlti_tpu import config as jc
from dlti_tpu.checkpoint import store as jstore
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.models import quantization as jq
from dlti_tpu.parallel import build_mesh as jax_build_mesh
from dlti_tpu.parallel.sharding import param_pspec
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.training import build_optimizer as jax_build_optimizer
from dlti_tpu.training import create_train_state as jax_create_state
from dlti_tpu.training import make_train_step as jax_make_step
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.models.interop import shard_params
from dlti_tpu_torch.models.quantization import quantize_params_int8
from dlti_tpu_torch.parallel.mesh import Mesh, check_strategy
from dlti_tpu_torch.parallel.tensor import tensor_shard_dim

RTOL = ATOL = 2e-4
STEPS = 2
WIDE = dict(hidden_size=128, intermediate_size=256)  # the int8 base quantizes projections
LORA, OPT = W.LORA, W.OPT
# name -> (preset, model overrides, LoRA or None, int8 base)
RUNS = {
    "lora": ("llama_tiny", {}, LORA, False),
    "full": ("llama_tiny", {}, None, False),
    "int8_base": ("llama_tiny", WIDE, LORA, True),
    "moe_lora": ("mixtral_tiny", {}, LORA, False),
    "moe_full": ("mixtral_tiny", {}, None, False),
}
# name -> (world, parallel), each a case on the "lora" run's weights and batches
MESHES = {
    "data2_tensor2": (4, dict(data=2, tensor=2)),
    "zero1_data2_tensor2": (4, dict(zero_stage=1, data=2, tensor=2)),
    "zero2_data2_tensor2": (4, dict(zero_stage=2, data=2, tensor=2)),
}
DROPOUT = dict(LORA, dropout=0.1)
REFUSED_ARGV = {  # cli.train argv on a world of 2 -> what build_mesh must name (None: runs)
    "zero3": (["--preset", "zero3", "--tensor", "2"], None),
    "offload": (["--preset", "zero2", "--tensor", "2", "--offload-optimizer"],
                "tensor x offload"),
    "expert": (["--model", "mixtral_tiny", "--tensor", "2", "--expert", "2"],
               "tensor x expert"),
}


def _cfgs(preset, model):
    return (dataclasses.replace(jc.MODEL_PRESETS[preset], **model),
            dataclasses.replace(tc.MODEL_PRESETS[preset], **model))


def _jax_tree(cfg, lora, seed=0):
    tree = JaxLlama(cfg, jc.LoRAConfig(**lora) if lora else None).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def _batches(vocab, n=STEPS, seed=7):
    rng = np.random.default_rng(seed)
    shape = (W.ACCUM, W.BS, W.SEQ)
    return [{"input_ids": rng.integers(3, vocab, shape).astype(np.int32),
             "loss_mask": (rng.random(shape) > 0.3).astype(np.int32)} for _ in range(n)]


def _port_numpy(tree):
    return {n: t.numpy() for n, t in params_from_jax(jax.device_get(tree)).items()}


def _jax_run(cfg, tree, batches, lora, int8):
    """The JAX single-device step over ``batches``: metrics and the final
    params in the port's names."""
    model = JaxLlama(cfg, jc.LoRAConfig(**lora) if lora else None)
    state = jax_create_state(jax.random.PRNGKey(0), model,
                             jax_build_optimizer(jc.OptimizerConfig(**OPT)), (W.BS, W.SEQ),
                             lora_enabled=lora is not None, init_fn=lambda r, x: tree)
    if int8:
        state = state.replace(params=jq.quantize_params_int8(state.params))
    step = jax.jit(jax_make_step(model, accum_steps=W.ACCUM))
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return metrics, _port_numpy(state.params)


@pytest.fixture(scope="module")
def setup():
    out = {}
    for name, (preset, model, lora, int8) in RUNS.items():
        jcfg, _ = _cfgs(preset, model)
        tree = _jax_tree(jcfg, lora)
        batches = _batches(jcfg.vocab_size)
        params = _port_numpy(jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree))
                             if int8 else tree)
        out[name] = dict(params=params, batches=batches,
                         ref=_jax_run(jcfg, tree, batches, lora, int8))
    return out


def _train_cfg(out_dir, parallel):
    return tc.Config(
        model=tc.MODEL_PRESETS["llama_tiny"], lora=tc.LoRAConfig(**LORA),
        optimizer=tc.OptimizerConfig(learning_rate=1e-2, warmup_steps=0),
        parallel=W._parallel(parallel),
        data=tc.DataConfig(max_seq_len=W.SEQ, tokenizer="byte"),
        checkpoint=tc.CheckpointConfig(output_dir=str(out_dir), save_strategy="steps",
                                       save_steps=2, save_total_limit=2),
        train=tc.TrainConfig(micro_batch_size=W.BS, grad_accum_steps=W.ACCUM, max_steps=2,
                             logging_steps=100, seed=0)).to_dict()


TEXTS = [" ".join(f"w{(i * 7 + j) % 23}" for j in range(3 + i % 9)) for i in range(48)]


def _cases(setup, world, tmp):
    cases = []
    if world == 2:
        for name, (preset, model, lora, _) in RUNS.items():
            r = setup[name]
            cases.append((name, "steps", dict(params=r["params"], batches=r["batches"],
                                              parallel=dict(tensor=2), lora=lora,
                                              model=model, preset=preset, opt=OPT)))
        lora = setup["lora"]
        cases.append(("dropout", "steps", dict(params=lora["params"], batches=lora["batches"],
                                               parallel=dict(tensor=2), lora=DROPOUT,
                                               opt=OPT, seed=5)))
        cases.append(("ckpt", "train", dict(cfg=_train_cfg(tmp / "tp2", dict(tensor=2)),
                                            params=None, texts=TEXTS)))
        cases += [(f"refused_{n}", "cli_mesh", dict(argv=argv))
                  for n, (argv, _) in REFUSED_ARGV.items()]
        cases += [(f"gather_{q}", "tp_gather", dict(params=setup["full"]["params"],
                                                    quantize=q == "int8"))
                  for q in ("float", "int8")]
    for name, (w, par) in MESHES.items():
        if w == world:
            r = setup["lora"]
            cases.append((name, "steps", dict(params=r["params"], batches=r["batches"],
                                              parallel=par, lora=LORA, opt=OPT)))
    return cases


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_training")
    return {w: W.spawn_world(w, _cases(setup, w, tmp), str(tmp)) for w in (2, 4)} | {
        "tmp": tmp}


def _assert_matches(got, ref, name):
    want_metrics, want_params = ref
    assert len(got["metrics"]) == len(want_metrics) == STEPS
    for i, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        for key in ("loss", "grad_norm") + (("aux_loss",) if "aux_loss" in w else ()):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name}: step {i + 1} {key}")
    assert got["trainable"]
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, want_params[n], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: {n} diverged")


@pytest.mark.parametrize("name", list(RUNS))
def test_tensor2_step_matches_jax_single_device(worlds, setup, name):
    _assert_matches(worlds[2][0][name], setup[name]["ref"], name)


@pytest.mark.parametrize("name", list(MESHES))
def test_data2_tensor2_step_matches_jax_single_device(worlds, setup, name):
    _assert_matches(worlds[4][0][name], setup["lora"]["ref"], name)


@pytest.mark.parametrize("name", ["lora", "full", "moe_full"])
def test_each_rank_holds_its_part(worlds, name):
    preset, model, _, _ = RUNS[name]
    _, cfg = _cfgs(preset, model)
    for rank_out in worlds[2]:
        shapes = rank_out[name]["shapes"]
        for n, (local, whole) in shapes.items():
            d = tensor_shard_dim(n, whole, 2)
            want = list(whole)
            if d is not None:
                want[d] //= 2
            assert list(local) == want, n
        assert shapes["model.embed_tokens"][0] == (cfg.vocab_size // 2, cfg.hidden_size)
        if preset == "mixtral_tiny":
            w1 = shapes["model.layers.0.mlp.w1"][0]
            assert w1 == (cfg.num_experts, cfg.hidden_size, cfg.intermediate_size // 2)


def test_dropout_masks_are_the_single_device_masks(worlds, setup):
    r = setup["lora"]
    one = W.steps(r["params"], r["batches"], {}, lora=DROPOUT, opt=OPT, seed=5)
    got = worlds[2][0]["dropout"]
    for g, w in zip(got["metrics"], one["metrics"]):
        np.testing.assert_allclose([g["loss"], g["grad_norm"]], [w["loss"], w["grad_norm"]],
                                   rtol=RTOL, atol=ATOL)
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, one["trainable"][n], rtol=RTOL, atol=ATOL, err_msg=n)
    # Dropout changed the step: the masks are drawn, not skipped.
    assert abs(got["metrics"][0]["loss"] - r["ref"][0][0]["loss"]) > 1e-4


def test_a_tensor2_checkpoint_verifies_in_jax_and_resumes_at_tensor1(worlds, tmp_path):
    from dlti_tpu_torch.config import Config
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.training import Trainer

    got = worlds[2][0]["ckpt"]
    assert got["save_steps"] == [2] and got["world"] == 2
    ck = str(worlds["tmp"] / "tp2")
    assert jstore.latest_verified_step(ck) == 2
    assert jstore.verify_checkpoint(ck, 2) == (True, "ok")
    with open(f"{ck}/2/MANIFEST.json") as f:
        leaves = {e["name"]: tuple(e["shape"]) for e in json.load(f)["leaves"]}
    cfg = tc.MODEL_PRESETS["llama_tiny"]
    q = [s for n, s in leaves.items() if n.startswith(".params") and "['q_proj']['kernel']" in n]
    emb = [s for n, s in leaves.items() if n.startswith(".params") and "embed_tokens" in n]
    # Whole leaves, consolidated from both ranks' parts.
    assert q == [(cfg.hidden_size, cfg.num_heads * cfg.resolved_head_dim)] * cfg.num_layers
    assert emb == [(cfg.vocab_size, cfg.hidden_size)]

    def run(out_dir, max_steps):
        c = Config.from_dict(_train_cfg(out_dir, {}))
        c = c.replace(train=dataclasses.replace(c.train, max_steps=max_steps))
        ds = make_batches(TEXTS, ByteTokenizer(), seq_len=W.SEQ, micro_batch_size=W.BS,
                          grad_accum_steps=W.ACCUM, shuffle_seed=c.data.shuffle_seed)
        return Trainer(c, device="cpu", cuda_graphs=False).train(dataset=ds)[1]

    shutil.copytree(ck, tmp_path / "resume")
    resumed = run(tmp_path / "resume", 4)
    straight = run(tmp_path / "straight", 4)
    assert resumed.resumed_from == 2
    np.testing.assert_allclose(resumed.losses, straight.losses[2:], rtol=RTOL, atol=ATOL)


def test_placement_rules_equal_the_jax_param_pspec():
    """Every leaf's tensor dim, float and int8 trees, llama and mixtral, is
    the dim the JAX ``param_pspec`` puts on 'tensor'."""
    mesh = jax_build_mesh(jc.ParallelConfig(tensor=2), devices=jax.devices()[:2])
    for preset, model, lora, int8 in RUNS.values():
        jcfg, _ = _cfgs(preset, model)
        tree = _jax_tree(jcfg, lora)
        if int8:
            tree = jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree))
        cfg = jc.Config(model=jcfg, parallel=jc.ParallelConfig(tensor=2),
                        checkpoint=jc.CheckpointConfig(save_strategy="no"))
        port = params_from_jax(jax.device_get(tree))
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert len(flat) == len(port)
        for (path, leaf), name in zip(flat, port):
            spec = tuple(param_pspec(path, leaf, cfg, mesh))
            want = spec.index("tensor") if "tensor" in spec else None
            assert tensor_shard_dim(name, leaf.shape, 2) == want, (name, spec)


def test_int8_parts_equal_the_jax_tp_engine_shards():
    """Quantized whole, then sliced: each rank's ``q`` and ``scale`` parts
    equal the JAX TP-2 engine's shards on that device, a row-parallel
    weight's scales whole on both."""
    jcfg, tcfg = _cfgs("llama_tiny", WIDE)
    tree = _jax_tree(jcfg, None)
    mesh = jax_build_mesh(jc.ParallelConfig(tensor=2), devices=jax.devices()[:2])
    engine = JaxEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                       JaxEngineConfig(max_seqs=2, block_size=8, num_blocks=16,
                                       max_model_len=32, quantization="int8"), mesh=mesh)
    shards = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(engine.params)[0]:
        name = ".".join(str(getattr(p, "key", p)) for p in path)
        name = name.replace("layers_", "layers.")
        by_dev = {s.device.id: np.asarray(s.data) for s in leaf.addressable_shards}
        shards[name] = [by_dev[d.id] for d in mesh.devices.flat[:2]]
    whole = {n: torch.from_numpy(a) for n, a in _port_numpy(tree).items()}
    assert "model.layers.0.mlp.down_proj.kernel.scale" in shards
    for rank in (0, 1):
        view = Mesh(parallel=tc.ParallelConfig(tensor=2), world=2, rank=rank,
                    device=torch.device("cpu"), tensor_group=object())
        part = shard_params(whole, view, tcfg, quantize=True)
        assert sorted(part) == sorted(shards)
        for n, t in part.items():
            np.testing.assert_array_equal(t.numpy(), shards[n][rank], err_msg=n)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_whole_shapes_invert_a_ranks_parts(run):
    """A model built around a tensor rank's parts (float and int8 trees,
    llama and mixtral; ``load_model(mesh=)``) holds the parts and records
    every leaf's whole shape (``LlamaForCausalLM.whole_shapes``): the shapes
    the trainer's layout reads of a model built at its local widths."""
    from dlti_tpu_torch.models import load_model

    preset, model, lora, int8 = RUNS[run]
    jcfg, tcfg = _cfgs(preset, model)
    whole = {n: torch.from_numpy(a) for n, a in _port_numpy(_jax_tree(jcfg, lora)).items()}
    view = Mesh(parallel=tc.ParallelConfig(tensor=2), world=2, rank=1,
                device=torch.device("cpu"), tensor_group=object())
    lcfg = tc.LoRAConfig(**lora) if lora else None
    part = shard_params(whole, view, tcfg, lcfg, quantize=int8)
    want = quantize_params_int8(dict(whole)) if int8 else whole
    assert any(part[n].shape != want[n].shape for n in part)
    net = load_model(tcfg, dict(part), "cpu", lora=lcfg, mesh=view)
    assert {n: tuple(p.shape) for n, p in net.named_parameters()} == {
        n: tuple(t.shape) for n, t in part.items()}
    assert net.whole_shapes == {n: tuple(t.shape) for n, t in want.items()}


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_shard_then_gather_params_gives_the_whole_tree_back(worlds, kind):
    """``shard_params`` keeps a rank's part, ``gather_params`` assembles
    whole leaves (for an export or a checkpoint) equal to the tree split."""
    for rank_out in worlds[2]:
        got = rank_out[f"gather_{kind}"]
        assert got["equal"]
        assert got["parts"]["model.embed_tokens" + (".q" if kind == "int8" else "")][0] \
            == tc.MODEL_PRESETS["llama_tiny"].vocab_size // 2


def test_tensor_axis_strategy_rules(worlds):
    P = tc.ParallelConfig
    check_strategy(P(tensor=2))
    check_strategy(P(data=2, tensor=2))
    check_strategy(P(zero_stage=tc.ZeROStage.ZERO2, data=2, tensor=2))
    # ZeRO-3 shards over its own fsdp axis beside the tensor one (the steps
    # are held to JAX's in tests/test_torch_zero3_steps.py).
    check_strategy(P(zero_stage=tc.ZeROStage.ZERO3, fsdp=2, tensor=2))
    check_strategy(P(zero_stage=tc.ZeROStage.ZERO3, tensor=2))
    for par, match in [(dict(expert=2, tensor=2), "tensor x expert"),
                       (dict(zero_stage=tc.ZeROStage.ZERO1, tensor=2, offload_params=True),
                        "tensor x offload")]:
        with pytest.raises(NotImplementedError, match=match):
            check_strategy(P(**par))
    for rank_out in worlds[2]:
        for name, (_, match) in REFUSED_ARGV.items():
            err = rank_out[f"refused_{name}"]["error"]
            if match is None:  # --preset zero3 --tensor 2 on 2 ranks: fsdp 1, ZeRO-3
                assert err is None, (name, err)
                assert (rank_out[f"refused_{name}"]["fsdp"],
                        rank_out[f"refused_{name}"]["zero_stage"]) == (1, 3)
            else:
                assert err is not None and match in err, (name, err)


def _cli_train(tmp_path, tag, launcher_args=(), flags=()):
    """``cli.train`` on the CPU (under the launcher when given its
    arguments); its JSON summary."""
    import os
    import subprocess
    import sys

    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    (data / "data.jsonl").write_text("".join(json.dumps({"text": t}) + "\n" for t in TEXTS))
    cmd = [sys.executable, "-m", "dlti_tpu_torch.cli.train", "--device", "cpu",
           "--model", "llama_tiny", "--tokenizer", "byte", "--dataset-path", str(data),
           "--max-seq-len", "32", "--per-device-batch-size", "2",
           "--gradient-accumulation-steps", "2", "--max-steps", "2", "--lora-r", "4",
           "--save-strategy", "no", "--no-resume", "--output-dir", str(tmp_path / tag), *flags]
    if launcher_args:
        cmd = [sys.executable, "-m", "dlti_tpu_torch.launcher", *launcher_args, "--", *cmd]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=240,
                          env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cli_train_tensor2_with_data2_zero2_under_the_launcher(tmp_path):
    """``launcher --num-processes 4 -- cli.train --tensor 2 --preset zero2``:
    the batch extent is the world over the tensor extent (2), and the run's
    losses are one device's (its global batch is 2 rows a rank x 2)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = _cli_train(tmp_path, "tp", ["--num-processes", "4", "--port", str(port)],
                     ["--tensor", "2", "--preset", "zero2"])
    want = _cli_train(tmp_path, "one", flags=["--per-device-batch-size", "4"])
    assert (got["world"], got["strategy"]) == (4, "zero2")
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=RTOL)
