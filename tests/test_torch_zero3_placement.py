"""ZeRO-3 on its own ``fsdp`` axis: the port's one placement rule
(``parallel.sharding.strategy_axes``) against the JAX package's.

The JAX package places every leaf of a strategy through one function,
``strategy_axes``, which its flat ``param_pspec`` and its stacked
``pipeline_param_shardings`` both call: an expert leaf's expert dim over
``expert``, the tensor rule's dim over ``tensor``, and under ZeRO-3 the
largest remaining dim of the whole shape that ``fsdp`` divides (the first
of equals, at least ``_MIN_FSDP_DIM``) over ``fsdp``. Here, with
``_MIN_FSDP_DIM`` lowered to 8 in both packages (at 1024 nothing of the
tiny models would shard):

* the port's flat rule (``leaf_axes``) gives every leaf of float and int8
  trees, LoRA and full fine-tune, ``llama_tiny`` and ``mixtral_tiny``, the
  spec ``param_pspec`` gives it on a JAX mesh of the same extents, for
  ``fsdp 4``, ``data 2 x fsdp 2``, ``fsdp 2 x tensor 2``, ``fsdp 2 x expert
  2`` and ZeRO-3 at ``fsdp 1`` beside ``tensor 2`` (nothing over fsdp);
* the stacked rule (``pipeline_param_placement``) gives every leaf of the
  stacked tree ``pipeline_param_shardings``'s spec under ``pipe 2 x fsdp
  2``, with ``tensor 2`` and with ``expert 2``;
* in a gloo world of 4 (spawned once), ``shard_params`` cuts each rank the
  very block the JAX array's shard on the device at the same mesh position
  holds (float and int8 trees, ``fsdp 2 x tensor 2`` and ``fsdp 2 x expert
  2``), ``gather_params`` gives the whole tree back bit for bit, and a model
  built around the parts keeps them (``load_model(mesh=)``,
  ``shard_model``) with the rule's placement.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

import torch_dist_worker as W
from dlti_tpu import config as jc
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.models import quantization as jq
from dlti_tpu.parallel import build_mesh as jax_build_mesh
from dlti_tpu.parallel import pipeline as jp
from dlti_tpu.parallel import sharding as jsharding
import torch
from dlti_tpu_torch import config as tc
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.parallel import pipeline as tp
from dlti_tpu_torch.parallel import sharding as tsharding
from dlti_tpu_torch.parallel.mesh import Mesh

LORA = dict(r=4, alpha=8, dropout=0.0)
WIDE = dict(hidden_size=128, intermediate_size=256)  # the int8 tree quantizes projections
# name -> (preset, model overrides, LoRA or None, int8)
TREES = {
    "llama_lora": ("llama_tiny", {}, LORA, False),
    "llama_full": ("llama_tiny", {}, None, False),
    "llama_int8": ("llama_tiny", WIDE, LORA, True),
    "mixtral_lora": ("mixtral_tiny", {}, LORA, False),
    "mixtral_int8": ("mixtral_tiny", {}, None, True),
}
Z3 = dict(zero_stage=3)
FLAT_MESHES = {
    "fsdp4": dict(Z3, fsdp=4),
    "data2_fsdp2": dict(Z3, data=2, fsdp=2),
    "fsdp2_tensor2": dict(Z3, fsdp=2, tensor=2),
    "fsdp2_expert2": dict(Z3, fsdp=2, expert=2),
    "zero3_fsdp1_tensor2": dict(Z3, tensor=2),
    "zero2_data2_tensor2": dict(zero_stage=2, data=2, tensor=2),
}
STACKED_MESHES = {
    "pipe2_fsdp2": dict(Z3, pipe=2, fsdp=2),
    "pipe2_fsdp2_tensor2": dict(Z3, pipe=2, fsdp=2, tensor=2),
    "pipe2_fsdp2_expert2": dict(Z3, pipe=2, fsdp=2, expert=2),
}
# The world-of-4 cuts: (tree, mesh).
PARTS = {
    "llama_lora_fsdp2_tensor2": ("llama_lora", "fsdp2_tensor2"),
    "llama_int8_fsdp2_tensor2": ("llama_int8", "fsdp2_tensor2"),
    "mixtral_lora_fsdp2_expert2": ("mixtral_lora", "fsdp2_expert2"),
    "mixtral_int8_data2_fsdp2": ("mixtral_int8", "data2_fsdp2"),
}


def _combos(meshes):
    """(tree, mesh) pairs: the expert axis splits a mixture of experts only."""
    return [(t, m) for t in sorted(TREES) for m in sorted(meshes)
            if meshes[m].get("expert", 1) == 1 or t.startswith("mixtral")]


@pytest.fixture
def low_min_dim(monkeypatch):
    monkeypatch.setattr(jsharding, "_MIN_FSDP_DIM", W.MIN_FSDP_DIM)
    monkeypatch.setattr(tsharding, "_MIN_FSDP_DIM", W.MIN_FSDP_DIM)


def _tree(name):
    """A JAX params tree of ``TREES[name]`` (int8 pairs for an int8 tree)."""
    preset, model, lora, int8 = TREES[name]
    cfg = dataclasses.replace(jc.MODEL_PRESETS[preset], **model)
    tree = JaxLlama(cfg, jc.LoRAConfig(**lora) if lora else None).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    if int8:
        tree = jq.quantize_params_int8(tree)
    return jax.device_get(tree)


def _named(tree):
    """``[(port name, JAX path, leaf)]`` in the JAX flatten order."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    port = params_from_jax(tree)
    assert len(flat) == len(port)
    return [(name, path, leaf) for (path, leaf), name in zip(flat, port)]


def _jax_mesh(par):
    par = jc.ParallelConfig(**{**par, "zero_stage": jc.ZeROStage(par.get("zero_stage", 0))})
    return par, jax_build_mesh(par, devices=jax.devices()[:par.num_devices])


def _port_mesh(par, rank=0):
    """A rank's view of ``par``'s mesh without a process group (the rule
    reads extents and coordinates only)."""
    p = tc.ParallelConfig(**{**par, "zero_stage": tc.ZeROStage(par.get("zero_stage", 0))})
    return Mesh(parallel=p, world=p.num_devices, rank=rank, device=torch.device("cpu"),
                tensor_group=object() if p.tensor > 1 else None)


def _spec(axes, ndim):
    spec = [None] * ndim
    for d, a in axes.items():
        spec[d] = a
    return tuple(spec)


@pytest.mark.parametrize("tree_name,mesh_name", _combos(FLAT_MESHES))
def test_flat_placement_equals_the_jax_param_pspec(low_min_dim, tree_name, mesh_name):
    par = FLAT_MESHES[mesh_name]
    jpar, jmesh = _jax_mesh(par)
    cfg = jc.Config(parallel=jpar, checkpoint=jc.CheckpointConfig(save_strategy="no"))
    mesh = _port_mesh(par)
    fsdp_split = 0
    for name, path, leaf in _named(_tree(tree_name)):
        want = tuple(jsharding.param_pspec(path, leaf, cfg, jmesh))
        want += (None,) * (leaf.ndim - len(want))
        got = _spec(tsharding.leaf_axes(name, leaf.shape, mesh), leaf.ndim)
        assert got == want, (name, leaf.shape, got, want)
        fsdp_split += "fsdp" in got
    # The lowered threshold splits leaves over fsdp wherever fsdp is above 1.
    assert (fsdp_split > 0) == (jpar.fsdp > 1 and int(jpar.zero_stage) == 3)


@pytest.mark.parametrize("tree_name,mesh_name", _combos(STACKED_MESHES))
def test_stacked_placement_equals_the_jax_pipeline_param_shardings(low_min_dim, tree_name,
                                                                  mesh_name):
    par = STACKED_MESHES[mesh_name]
    preset = TREES[tree_name][0]
    layers = jc.MODEL_PRESETS[preset].num_layers
    tree = _tree(tree_name)
    stacked = jp.to_pipeline_params(jax.tree_util.tree_map(jnp.asarray, tree), layers)
    _, jmesh = _jax_mesh(par)
    sh = jp.pipeline_param_shardings(stacked, jmesh)
    specs = {".".join(str(k.key) for k in path): tuple(s.spec)
             for path, s in jax.tree_util.tree_flatten_with_path(sh)[0]}
    port = tp.to_pipeline_params({n: torch.from_numpy(np.asarray(a))
                                  for n, a in params_from_jax(tree).items()}, layers)
    shapes = {n: tuple(t.shape) for n, t in port.items()}
    assert sorted(shapes) == sorted(specs)
    got = tp.pipeline_param_placement(shapes, tensor=par.get("tensor", 1),
                                      expert=par.get("expert", 1), fsdp=par.get("fsdp", 1))
    for n, spec in specs.items():
        spec = spec + (None,) * (len(shapes[n]) - len(spec))
        assert got[n] == spec, (n, shapes[n], got[n], spec)
    assert any("fsdp" in s for s in got.values())
    # A stage's live layout places each layer by the flat rule: the
    # stacked spec without its layer dim.
    mesh = _port_mesh(par)
    for n, spec in got.items():
        if n.startswith("layers."):
            flat = f"model.layers.0.{n[len('layers.'):]}"
            assert _spec(tsharding.leaf_axes(flat, shapes[n][1:], mesh),
                         len(shapes[n]) - 1) == spec[1:], n


def test_the_fsdp_pick_is_the_whole_shapes_first_of_equals(low_min_dim):
    """The fsdp dim is chosen on the whole shape, the tensor and expert dims
    left out, the first of equal dims taken, and nothing below the
    threshold or indivisible: the JAX function's answers."""
    cases = [("model.layers.0.attn.q_proj.kernel", (64, 64), dict(tp=2, fsdp=2)),
             ("model.layers.0.attn.q_proj.kernel", (64, 64), dict(fsdp=2)),
             ("model.layers.0.attn.o_proj.kernel", (64, 64), dict(tp=2, fsdp=2)),
             ("model.layers.0.mlp.w1", (4, 64, 128), dict(ep=2, fsdp=2)),
             ("model.layers.0.mlp.w2.scale", (4, 1, 64), dict(ep=2, fsdp=2)),
             ("model.layers.0.attn.q_proj.kernel.scale", (1, 64), dict(tp=2, fsdp=2)),
             ("model.embed_tokens", (512, 64), dict(tp=2, fsdp=2)),
             ("model.layers.0.input_norm.scale", (6,), dict(fsdp=2)),
             ("model.layers.0.attn.q_proj.lora_a", (64, 4), dict(tp=2, fsdp=4))]
    for name, shape, kw in cases:
        jpath = {"model.embed_tokens": "model/embed_tokens"}.get(
            name, name.replace("model.layers.0.", "model/layers_0/").replace(".", "/"))
        want = jsharding.strategy_axes(jsharding._quant_normalized_path(
            jpath, np.zeros((), np.int8 if jpath.endswith("/q") else np.float32)), shape, **kw)
        assert tsharding.strategy_axes(name, shape, **kw) == want, (name, shape, kw)
    # q_proj at llama2_7b's width: dim 1 over tensor, dim 0 over fsdp; its
    # int8 scale of (1, n) splits with the output channels over tensor and
    # stays whole over fsdp (a row-parallel one is whole over tensor, so
    # fsdp takes its n).
    assert tsharding.strategy_axes("model.layers.0.attn.q_proj.kernel", (4096, 4096),
                                   tp=2, fsdp=2) == {1: "tensor", 0: "fsdp"}
    assert tsharding.strategy_axes("model.layers.0.attn.q_proj.kernel.scale", (1, 4096),
                                   tp=2, fsdp=2) == {1: "tensor"}
    assert tsharding.strategy_axes("model.layers.0.attn.o_proj.kernel.scale", (1, 4096),
                                   tp=2, fsdp=2) == {1: "fsdp"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero3_parts")
    trees = {name: _tree(name) for name in {t for t, _ in PARTS.values()}}
    whole = {name: {n: np.asarray(a) for n, a in params_from_jax(t).items()}
             for name, t in trees.items()}
    cases = []
    for case, (tree_name, mesh_name) in PARTS.items():
        preset, model, lora, _ = TREES[tree_name]
        cases.append((case, "zero3_parts", dict(params=whole[tree_name],
                                                parallel=FLAT_MESHES[mesh_name],
                                                preset=preset, model=model, lora=lora)))
    return trees, W.spawn_world(4, cases, str(tmp))


@pytest.mark.parametrize("case", sorted(PARTS))
def test_each_rank_cuts_the_block_the_jax_shard_on_its_device_holds(world, low_min_dim, case):
    """Rank ``r`` is the JAX mesh's device ``r`` (both lay the axes out
    data, fsdp, tensor, sequence, pipe, expert, the last fastest): its part
    of every leaf is that device's shard of the JAX array placed by
    ``param_pspec``; the parts gather back whole; a model around them holds
    them, placed by the rule."""
    trees, ranks = world
    tree_name, mesh_name = PARTS[case]
    par = FLAT_MESHES[mesh_name]
    jpar, jmesh = _jax_mesh(par)
    cfg = jc.Config(parallel=jpar, checkpoint=jc.CheckpointConfig(save_strategy="no"))
    devices = list(jmesh.devices.flat)
    split = 0
    for name, path, leaf in _named(trees[tree_name]):
        spec = jsharding.param_pspec(path, leaf, cfg, jmesh)
        arr = jax.device_put(jnp.asarray(leaf), NamedSharding(jmesh, spec))
        by_dev = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
        axes = _spec(ranks[0][case]["axes"][name], leaf.ndim)
        assert axes == tuple(spec) + (None,) * (leaf.ndim - len(spec)), name
        split += any(a is not None for a in axes)
        for r, out in enumerate(ranks):
            np.testing.assert_array_equal(out[case]["parts"][name], by_dev[devices[r].id],
                                          err_msg=f"rank {r} {name}")
            assert out[case]["held"][name] == by_dev[devices[r].id].shape, (r, name)
    assert split > 0
    assert all(out[case]["equal"] for out in ranks)
