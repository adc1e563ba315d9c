"""Tensor-parallel serving in the port, over gloo on the CPU, against the
JAX package's engines on the same weights.

The JAX package's contract (``tests/test_serving.py::
test_engine_tensor_parallel_matches_single_device``,
``tests/test_quantization.py::test_int8_tp_engine_matches_unsharded_int8``):
an engine whose weights and KV pools are split over a ``tensor`` mesh gives
the unsplit engine's greedy tokens. Here the two tensor ranks are spawned
processes in one gloo group (``tests/torch_dist_worker.py``, spawned once
for the module): every rank builds the engine on its part of the weights
and of the KV heads, rank 0 runs the engine parity tests' request script
and the other rank follows its device calls. Greedy tokens equal the JAX
single-device engine's and the JAX TP-2 engine's, with logprobs within
1e-4 (``tests/test_torch_engine.py``'s rule), on float32, bfloat16 and int8
pools (on a bfloat16 pool within 1e-3, what the one-rank engine reads) and
on int8 weights (``llama_tiny`` widened to hidden 128 /
intermediate 256, so the projections are quantized), and for
``mixtral_tiny``'s experts. Seeded requests equal the port's own one-rank
engine. Over HTTP the TP-2 server's texts equal the one-rank server's, and
``cli.serve --tensor 2`` runs under the launcher and stops cleanly.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from dlti_tpu.config import MODEL_PRESETS as JAX_PRESETS
from dlti_tpu.config import ParallelConfig as JaxParallelConfig
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.parallel import build_mesh as jax_build_mesh
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import InferenceEngine as JaxEngine
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu_torch.config import MODEL_PRESETS
from dlti_tpu_torch.data import ByteTokenizer
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, ServerConfig, make_server

LOGPROB_ATOL = 1e-4
# A bfloat16 pool rounds each K/V row once, so a row a framework computes a
# float32 ulp apart can land a bfloat16 step apart: the port's one-rank
# engine already reads 4.7e-4 against the JAX engine on this script.
BF16_POOL_LOGPROB_ATOL = 1e-3
EC = dict(max_seqs=4, block_size=4, num_blocks=40, max_model_len=32, eos_token_id=-1)
WIDE = dict(hidden_size=128, intermediate_size=256)  # int8 weights quantize projections
# name -> (preset, model overrides, engine overrides)
RUNS = {
    "float32": ("llama_tiny", {}, dict(cache_dtype="float32")),
    "bfloat16_pool": ("llama_tiny", {}, dict(cache_dtype="bfloat16")),
    "int8_pool": ("llama_tiny", {}, dict(cache_dtype="int8")),
    "int8_weights": ("llama_tiny", WIDE, dict(cache_dtype="float32", quantization="int8")),
    "mixtral": ("mixtral_tiny", {}, dict(cache_dtype="float32")),
}
PROMPTS = ["Hello", "The quick brown fox", "tensor parallel"]


def _jax_params(preset, model, seed=0):
    cfg = dataclasses.replace(JAX_PRESETS[preset], **model)
    tree = JaxLlama(cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return cfg, jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def _jax_outputs(cfg, tree, ec, mesh=None):
    engine = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, tree), JaxEngineConfig(**ec),
                       mesh=mesh)
    reqs = W.run_script(engine, JaxSamplingParams)
    return [r.output_token_ids for r in reqs], [r.output_logprobs for r in reqs]


@pytest.fixture(scope="module")
def setup():
    out = {}
    tp_mesh = jax_build_mesh(JaxParallelConfig(tensor=2), devices=jax.devices()[:2])
    for name, (preset, model, ec) in RUNS.items():
        cfg, tree = _jax_params(preset, model)
        ec = {**EC, **ec}
        out[name] = dict(params={n: t.numpy() for n, t in params_from_jax(tree).items()},
                         ec=ec, ref=_jax_outputs(cfg, tree, ec),
                         ref_tp=(_jax_outputs(cfg, tree, ec, tp_mesh)
                                 if name in ("float32", "int8_weights") else None))
    return out


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serving")
    f32 = setup["float32"]
    cases = [(name, "tp_engine", dict(params=r["params"], ec=r["ec"], preset=RUNS[name][0],
                                      model=RUNS[name][1]))
             for name, r in setup.items()]
    cases += [("seeded", "tp_engine", dict(params=f32["params"], ec=f32["ec"], seeded=True)),
              ("sharded_init", "tp_engine", dict(params=f32["params"], ec=f32["ec"],
                                                 sharded_init=True)),
              ("server", "tp_server", dict(params=f32["params"], ec=f32["ec"],
                                           prompts=PROMPTS)),
              ("refusals", "tp_refusals", dict(params=f32["params"], ec=f32["ec"]))]
    return W.spawn_world(2, cases, str(tmp))


def _one_rank(setup, name, **kw):
    preset, model, _ = RUNS[name]
    cfg = dataclasses.replace(MODEL_PRESETS[preset], **model)
    tree = {n: torch.from_numpy(a.copy()) for n, a in setup[name]["params"].items()}
    return InferenceEngine(cfg, tree, EngineConfig(**{**setup[name]["ec"], **kw}), device="cpu")


@pytest.mark.parametrize("name", list(RUNS))
def test_tp2_engine_matches_the_jax_single_device_engine(world, setup, name):
    got = world[0][name]
    want_tokens, want_lps = setup[name]["ref"]
    assert got["tokens"] == want_tokens
    atol = BF16_POOL_LOGPROB_ATOL if name == "bfloat16_pool" else LOGPROB_ATOL
    for g, w in zip(got["logprobs"], want_lps):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["float32", "int8_weights"])
def test_tp2_engine_matches_the_jax_tp2_engine(world, setup, name):
    assert world[0][name]["tokens"] == setup[name]["ref_tp"][0]


@pytest.mark.parametrize("name", list(RUNS))
def test_each_rank_holds_its_heads_and_its_part(world, setup, name):
    preset, model, _ = RUNS[name]
    cfg = dataclasses.replace(MODEL_PRESETS[preset], **model)
    for rank_out in world:
        assert rank_out[name]["kv_heads"] == cfg.num_kv_heads // 2
        shapes = rank_out[name]["shapes"]
        q = next(s for n, s in shapes.items() if n.startswith("model.layers.0.attn.q_proj.kernel"))
        assert q[-1] == cfg.num_heads * cfg.resolved_head_dim // 2
        emb = next(s for n, s in shapes.items() if n.startswith("model.embed_tokens"))
        assert emb[0] == cfg.vocab_size // 2


def test_int8_scales_are_quantized_whole_then_sliced(world, setup):
    """A column-parallel weight's scales are its output channels' half; a
    row-parallel one's are the whole leaf's (computed over the whole
    contraction dim), as the reference's quantized TP engine places them."""
    from dlti_tpu_torch.models.quantization import quantize_int8

    whole = setup["int8_weights"]["params"]
    for rank, rank_out in enumerate(world):
        scales = rank_out["int8_weights"]["scales"]
        for proj, col in (("attn.q_proj", True), ("mlp.down_proj", False)):
            _, want = quantize_int8(torch.from_numpy(whole[f"model.layers.0.{proj}.kernel"]))
            if col:
                half = want.shape[-1] // 2
                want = want[..., rank * half:(rank + 1) * half]
            np.testing.assert_array_equal(scales[f"model.layers.0.{proj}.kernel.scale"],
                                          want.numpy())


def test_seeded_requests_match_the_one_rank_engine(world, setup):
    engine = _one_rank(setup, "float32")
    want = W.run_script(engine, seeded=True)
    assert world[0]["seeded"]["tokens"] == [r.output_token_ids for r in want]


def test_weights_sliced_as_drawn_serve_as_the_whole_draw(world):
    from dlti_tpu_torch.models.interop import init_params

    cfg = MODEL_PRESETS["llama_tiny"]
    engine = InferenceEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                             EngineConfig(**{**EC, "cache_dtype": "float32"}), device="cpu")
    assert world[0]["sharded_init"]["tokens"] == [
        r.output_token_ids for r in W.run_script(engine)]


def test_tp2_server_texts_match_the_one_rank_server(world, setup):
    import threading

    engine = _one_rank(setup, "float32")
    httpd, async_engine = make_server(engine, ByteTokenizer(),
                                      ServerConfig(host="127.0.0.1", port=0))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        want = []
        for p in PROMPTS:
            body = json.dumps({"prompt": p, "max_tokens": 8, "temperature": 0}).encode()
            req = urllib.request.Request(base + "/v1/completions", data=body,
                                         headers={"Content-Type": "application/json"})
            want.append(json.loads(urllib.request.urlopen(req, timeout=60).read())
                        ["choices"][0]["text"])
    finally:
        httpd.shutdown()
        async_engine.shutdown()
        httpd.server_close()
    got = world[0]["server"]
    assert got["texts"] == want
    assert got["requests"] == len(PROMPTS) and got["metrics_ok"]


def test_tp_engine_refuses_adapters_spec_and_tiers_by_name(world):
    for rank_out in world:
        for name, msg in rank_out["refusals"].items():
            assert msg is not None and "tensor parallelism" in msg and "ROADMAP" in msg, name


def test_serve_cli_tensor2_under_the_launcher_stops_cleanly():
    """``launcher --num-processes 2 -- cli.serve --tensor 2``: rank 0 serves,
    rank 1 follows; a completion answers, and SIGTERM to rank 0 ends both
    with exit code 0."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlti_tpu_torch.launcher", "--num-processes", "2",
         "--port", str(_free_port()), "--", sys.executable, "-m", "dlti_tpu_torch.cli.serve",
         "--device", "cpu", "--random-init", "llama_tiny", "--tokenizer", "byte",
         "--port", str(_free_port()), "--tensor", "2", "--max-model-len", "64",
         "--num-blocks", "64"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        addr = None
        deadline = time.monotonic() + 120
        lines = []
        while addr is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "serving on http://" in line:
                addr = line.split("serving on ")[1].split()[0]
        assert addr, "".join(lines)
        body = json.dumps({"prompt": "Hi", "max_tokens": 4, "temperature": 0}).encode()
        req = urllib.request.Request(addr + "/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert out["usage"]["completion_tokens"] == 4
        assert any("tensor rank 1: following rank 0" in ln for ln in lines)
        os.kill(_rank0_pid(proc.pid), signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, "".join(lines) + rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank0_pid(launcher_pid: int) -> int:
    """The launcher's child whose environment names process 0."""
    kids = subprocess.run(["pgrep", "-P", str(launcher_pid)], capture_output=True,
                          text=True).stdout.split()
    for pid in kids:
        with open(f"/proc/{pid}/environ", "rb") as f:
            if b"DLTI_PROCESS_ID=0\x00" in f.read() + b"\x00":
                return int(pid)
    raise AssertionError(f"no rank 0 among {kids}")
