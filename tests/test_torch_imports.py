"""The port stands alone: with ``jax`` blocked out of ``sys.modules`` it
imports, serves a ``llama_tiny`` request and trains two LoRA steps of
``llama_tiny`` through ``Trainer`` on the CPU (and two under ZeRO-3, the
launcher and ``parallel`` imported), and loads no module of
the JAX package (``dlti_tpu`` or ``dlti_tpu.*``; ``dlti_tpu_torch`` shares
the prefix and is not one). Without CUDA, an entry point called without a
device raises instead of running on the CPU.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_CHILD = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError

    import dlti_tpu_torch
    from dlti_tpu_torch.config import MODEL_PRESETS
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams

    cfg = MODEL_PRESETS["llama_tiny"]
    engine = InferenceEngine(
        cfg, init_params(cfg, seed=0, device="cpu"),
        EngineConfig(max_seqs=2, block_size=8, num_blocks=32, max_model_len=64,
                     cache_dtype="float32", eos_token_id=-1),
        device="cpu")
    [res] = engine.generate([[1, 2, 3, 4]], SamplingParams(temperature=0.0, max_tokens=5))
    assert len(res.output_token_ids) == 5, res

    from dlti_tpu_torch.config import CheckpointConfig, Config, DataConfig, TrainConfig
    from dlti_tpu_torch.data import get_tokenizer, make_batches
    from dlti_tpu_torch.training import Trainer

    tcfg = Config(model=cfg, data=DataConfig(max_seq_len=32, tokenizer="byte"),
                  checkpoint=CheckpointConfig(save_strategy="no"),
                  train=TrainConfig(micro_batch_size=2, grad_accum_steps=2,
                                    max_steps=2, logging_steps=1))
    texts = ["port " * n for n in range(1, 20)]
    ds = make_batches(texts, get_tokenizer("byte"), seq_len=32,
                      micro_batch_size=2, grad_accum_steps=2)
    state, record = Trainer(tcfg, device="cpu").train(dataset=ds)
    assert state.step == 2 and len(record.losses) == 2, record

    def is_jax_package(name):
        return name == "dlti_tpu" or name.startswith("dlti_tpu.")

    # sys.modules["jax"] is the None placed above; anything else loaded counts.
    loaded = sorted(n for n, m in sys.modules.items() if m is not None and (
        is_jax_package(n) or n == "jax" or n.startswith(("jax.", "jaxlib"))))
    assert not loaded, loaded
    print("OK", res.output_token_ids)
""")


def test_port_runs_without_jax_and_imports_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK")


_SERVER_CHILD = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None

    import http.client, json, threading
    import dlti_tpu_torch.cli.serve as cli
    import dlti_tpu_torch.telemetry
    from dlti_tpu_torch.serving import make_server

    args = cli.parse_args(["--device", "cpu", "--random-init", "llama_tiny",
                           "--tokenizer", "byte", "--port", "0",
                           "--max-model-len", "64", "--num-blocks", "16",
                           "--kv-cache-dtype", "int8"])
    engine, tok, sc = cli.build(args)
    httpd, aeng = make_server(engine, tok, sc)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
    conn.request("POST", "/v1/completions", json.dumps({"prompt": "hi", "max_tokens": 3}))
    resp = conn.getresponse()
    body = json.loads(resp.read())
    assert resp.status == 200 and body["usage"]["completion_tokens"] == 3, body
    httpd.shutdown(); aeng.shutdown(); httpd.server_close()

    loaded = sorted(n for n, m in sys.modules.items() if m is not None and (
        n in ("jax", "dlti_tpu") or n.startswith(("jax.", "jaxlib", "dlti_tpu."))))
    assert not loaded, loaded
    print("OK")
""")


def test_server_and_serve_cli_run_without_jax():
    """The server, the serve CLI's builder and the telemetry modules import
    and serve a completion on an int8 pool with ``jax`` blocked."""
    proc = subprocess.run([sys.executable, "-c", _SERVER_CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


_CHECKPOINT_CHILD = textwrap.dedent("""
    import dataclasses, sys, tempfile
    sys.modules["jax"] = None
    sys.modules["ml_dtypes"] = None  # the card machine has no ml_dtypes

    import torch
    import dlti_tpu_torch.checkpoint as ck
    import dlti_tpu_torch.cli.export as export_cli
    import dlti_tpu_torch.cli.train
    from dlti_tpu_torch.checkpoint import store
    from dlti_tpu_torch.config import MODEL_PRESETS, Config, LoRAConfig
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.models.interop import numpy_to_tensor, tensor_to_numpy
    from dlti_tpu_torch.telemetry import Counter, Gauge
    from dlti_tpu_torch.utils import durable_io

    t = torch.randn(5, 3).to(torch.bfloat16)
    arr, name = tensor_to_numpy(t)
    assert name == "bfloat16" and arr.dtype.name == "uint16", (name, arr.dtype)
    assert torch.equal(numpy_to_tensor(arr.copy(), name), t)

    d = tempfile.mkdtemp()
    leaves = [("['w']", t), ("['n']", torch.tensor(3, dtype=torch.int32))]
    ck.save_train_state(d + "/ck", 1, leaves, async_save=True)
    ck.wait_for_saves(d + "/ck")
    assert ck.verify_checkpoint(d + "/ck", 1) == (True, "ok")
    back = dict(ck.restore_train_state(d + "/ck", 1, leaves))
    assert back["['w']"].dtype == torch.bfloat16 and torch.equal(back["['w']"], t)

    cfg = dataclasses.replace(MODEL_PRESETS["llama_tiny"], dtype="bfloat16",
                              param_dtype="bfloat16")
    params = init_params(cfg, seed=0, device="cpu", lora=LoRAConfig(r=2))
    ck.export_merged_model(d + "/ex", params, Config(model=cfg, lora=LoRAConfig(r=2)))
    tree, back_cfg = ck.load_exported_model(d + "/ex")
    assert back_cfg.model == cfg and not back_cfg.lora.enabled
    assert tree["lm_head"].dtype == torch.bfloat16

    loaded = sorted(n for n, m in sys.modules.items() if m is not None and (
        n in ("jax", "dlti_tpu", "ml_dtypes")
        or n.startswith(("jax.", "jaxlib", "dlti_tpu.", "ml_dtypes."))))
    assert not loaded, loaded
    print("OK")
""")


def test_checkpoint_and_export_run_without_jax_or_ml_dtypes():
    """The checkpoint store, the export, the CLIs that use them and the
    bfloat16 codec import and round-trip with ``jax`` and ``ml_dtypes``
    blocked: bfloat16 travels as its bits."""
    proc = subprocess.run([sys.executable, "-c", _CHECKPOINT_CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


_ZERO_CHILD = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None

    import dlti_tpu_torch.launcher
    import dlti_tpu_torch.parallel
    import dlti_tpu_torch.parallel.mesh
    import dlti_tpu_torch.parallel.sharding
    import dlti_tpu_torch.cli.train
    import torch.distributed as dist
    from dlti_tpu_torch.config import (
        MODEL_PRESETS, CheckpointConfig, DataConfig, TrainConfig, preset)
    from dlti_tpu_torch.data import get_tokenizer, make_batches
    from dlti_tpu_torch.training import Trainer

    cfg = preset("zero3", model=MODEL_PRESETS["llama_tiny"],
                 data=DataConfig(max_seq_len=32, tokenizer="byte"),
                 checkpoint=CheckpointConfig(save_strategy="no"),
                 train=TrainConfig(micro_batch_size=2, grad_accum_steps=2, max_steps=2))
    ds = make_batches(["zero " * n for n in range(1, 20)], get_tokenizer("byte"),
                      seq_len=32, micro_batch_size=2, grad_accum_steps=2)
    dlti_tpu_torch.launcher.init_group_of_one("cpu")
    state, record = Trainer(cfg, device="cpu").train(dataset=ds)
    assert record.strategy == "zero3" and dist.get_world_size() == 1, record
    dist.destroy_process_group()

    loaded = sorted(n for n, m in sys.modules.items() if m is not None and (
        n in ("jax", "dlti_tpu") or n.startswith(("jax.", "jaxlib", "dlti_tpu."))))
    assert not loaded, loaded
    print("OK")
""")


def test_launcher_and_parallel_run_without_jax():
    """The launcher, the mesh and the ZeRO placement import with ``jax``
    blocked, and a ZeRO-3 run trains in a group of one."""
    proc = subprocess.run([sys.executable, "-c", _ZERO_CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


def test_chip_smoke_imports_no_jax():
    """``chip_smoke.py`` is a port entry point too: importing it pulls in
    neither JAX nor the JAX package."""
    code = ("import sys; sys.modules['jax'] = None; import runpy; "
            "runpy.run_path('chip_smoke.py', run_name='not_main'); "
            "assert not [n for n in sys.modules if n == 'dlti_tpu' "
            "or n.startswith('dlti_tpu.')]")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_entry_points_without_device_raise_when_there_is_no_cuda(monkeypatch):
    from dlti_tpu_torch.config import MODEL_PRESETS, CheckpointConfig, Config
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.serving import InferenceEngine
    from dlti_tpu_torch.training import Trainer
    from dlti_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MODEL_PRESETS["llama_tiny"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, init_params(cfg, seed=0, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config(model=cfg, checkpoint=CheckpointConfig(save_strategy="no")))
    assert resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_gives_cuda_its_index(monkeypatch):
    """``"cuda"`` resolves to the current card with its index, which
    ``torch.cuda.set_device`` needs; an explicit index is kept; without
    CUDA, ``"cuda"`` raises as the default does."""
    from dlti_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device(torch.device("cuda")) == torch.device("cuda", 3)
    assert resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)


_QUICKSTART_CHILD = textwrap.dedent("""
    import sys, tempfile
    for name in ("jax", "pandas", "matplotlib", "datasets"):
        sys.modules[name] = None  # any import of them now raises ImportError

    import dlti_tpu_torch.analysis as analysis
    import dlti_tpu_torch.cli.compare_training
    import dlti_tpu_torch.cli.prepare_dataset as prepare
    import dlti_tpu_torch.cli.run_experiments
    import dlti_tpu_torch.cli.train as train
    import dlti_tpu_torch.data.formats
    import dlti_tpu_torch.data.prefetch
    import dlti_tpu_torch.data.streaming
    import dlti_tpu_torch.models.quantization
    import dlti_tpu_torch.orchestration
    import dlti_tpu_torch.telemetry.steplog
    import dlti_tpu_torch.utils.experiment
    import dlti_tpu_torch.utils.metrics

    d = tempfile.mkdtemp()
    prepare.main(["--synthetic", "64", "--output-dir", d + "/data",
                  "--write-token-store", d + "/store", "--max-seq-len", "64"])
    train.main(["--device", "cpu", "--model", "llama_tiny", "--tokenizer", "byte",
                "--dataset-path", d + "/store", "--max-seq-len", "64",
                "--per-device-batch-size", "2", "--gradient-accumulation-steps", "2",
                "--max-steps", "2", "--quantize-base", "int8", "--remat-policy", "none",
                "--save-strategy", "no", "--output-dir", d + "/ck", "--metrics-csv", d + "/m.csv",
                "--step-log", d + "/steps.jsonl"])
    rows = analysis.compare(d + "/m.csv")
    assert len(rows) == 1 and rows[0]["experiment"] == "baseline", rows
    try:
        analysis.create_plots(rows, d + "/p.png")
    except ImportError:
        pass
    else:
        raise AssertionError("create_plots drew without matplotlib")

    def absent(name):
        return not any(m is not None and (n == name or n.startswith(name + "."))
                       for n, m in sys.modules.items())

    assert all(absent(n) for n in ("jax", "jaxlib", "dlti_tpu", "pandas", "matplotlib"))
    print("OK")
""")


def test_quickstart_modules_run_without_jax_pandas_or_matplotlib():
    """The data prep, int8 base, step log, metrics CSV and comparison
    modules import and run (prepare -> train on a token store with an int8
    base -> compare) with ``jax``, ``pandas``, ``matplotlib`` and
    ``datasets`` blocked, as on the card machine; only ``create_plots``
    needs matplotlib, and it raises without it."""
    proc = subprocess.run([sys.executable, "-c", _QUICKSTART_CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


def test_the_port_imports_neither_pandas_nor_matplotlib():
    """Importing every module of the port loads neither pandas nor
    matplotlib (both absent on the card machine)."""
    code = textwrap.dedent("""
        import pkgutil, importlib, sys
        import dlti_tpu_torch
        for m in pkgutil.walk_packages(dlti_tpu_torch.__path__, "dlti_tpu_torch."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("pandas", "matplotlib", "jax", "dlti_tpu"))
        assert not bad, bad
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


_HF_CHILD = textwrap.dedent("""
    import dataclasses, sys, tempfile
    for name in ("jax", "ml_dtypes", "safetensors", "transformers", "peft"):
        sys.modules[name] = None  # none of them is on the card machine

    import torch
    from dlti_tpu_torch.config import MODEL_PRESETS, LoRAConfig
    from dlti_tpu_torch.models import hf_interop as hf
    from dlti_tpu_torch.models import init_params, merge_lora_params
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams
    from dlti_tpu_torch.serving import adapters as ad

    cfg = dataclasses.replace(MODEL_PRESETS["llama_tiny"], dtype="bfloat16",
                              param_dtype="bfloat16")
    lora = LoRAConfig(r=2, alpha=4, dropout=0.0)
    params = init_params(cfg, seed=0, device="cpu", lora=lora)
    params = {n: (t + 0.1 if n.endswith("lora_b") else t) for n, t in params.items()}
    d = tempfile.mkdtemp()
    hf.save_hf_checkpoint(d + "/hf", merge_lora_params(params, scaling=0.0), cfg,
                          max_shard_bytes=100_000)
    back, back_cfg = hf.load_hf_checkpoint(d + "/hf", device="cpu")
    assert back_cfg.num_layers == cfg.num_layers and len(back) == 21
    hf.save_peft_adapter(d + "/peft", params, lora)
    fresh = init_params(cfg, seed=1, device="cpu", lora=lora)
    hf.load_peft_adapter(d + "/peft", fresh)
    assert torch.equal(fresh["model.layers.1.attn.v_proj.lora_b"],
                       params["model.layers.1.attn.v_proj.lora_b"])
    ad.register_adapter("a", ad.save_adapter(d + "/a", params, alpha=4.0))
    eng = InferenceEngine(cfg, back, EngineConfig(max_seqs=2, num_blocks=32, max_model_len=64,
                                                  adapter_slots=1, adapter_rank=2),
                          device="cpu")
    reqs = [eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=4), adapter=a)
            for a in ("a", "")]
    while eng.has_work:
        eng.step()
    assert [r.finish_reason for r in reqs] != ["error", "error"], reqs

    loaded = sorted(n for n, m in sys.modules.items() if m is not None and (
        n.split(".")[0] in ("jax", "jaxlib", "dlti_tpu", "ml_dtypes", "safetensors",
                            "transformers", "peft")))
    assert not loaded, loaded
    print("OK")
""")


def test_hf_interop_and_adapters_run_without_jax_or_safetensors():
    """HF checkpoints and PEFT adapters in and out, adapter checkpoints and
    a multi-LoRA engine, with ``jax``, ``ml_dtypes``, ``safetensors``,
    ``transformers`` and ``peft`` blocked: the port's own safetensors codec
    is all it needs."""
    proc = subprocess.run([sys.executable, "-c", _HF_CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


_FLEET_CHILD = textwrap.dedent("""
    import sys, tempfile
    sys.modules["jax"] = None

    import http.client, json, threading
    import dlti_tpu_torch.cli.serve as cli
    import dlti_tpu_torch.serving.gateway
    import dlti_tpu_torch.serving.lifecycle
    import dlti_tpu_torch.serving.replicas
    from dlti_tpu_torch.checkpoint.store import save_pytree
    from dlti_tpu_torch.models.interop import params_to_jax
    from dlti_tpu_torch.serving import make_server

    args = cli.parse_args(["--device", "cpu", "--random-init", "llama_tiny",
                           "--tokenizer", "byte", "--port", "0", "--max-model-len", "64",
                           "--num-blocks", "16", "--replicas", "2", "--gateway",
                           "--self-heal", "--fault-inject-step", "1:2:preempt"])
    engine, tok, sc = cli.build(args)
    httpd, aeng = make_server(engine, tok, sc)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    addr = ("127.0.0.1", httpd.server_address[1])

    def post(path, body):
        conn = http.client.HTTPConnection(*addr, timeout=60)
        conn.request("POST", path, json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())

    status, body = post("/v1/completions", {"prompt": "hi", "max_tokens": 3})
    assert status == 200 and body["usage"]["completion_tokens"] == 3, body
    d = tempfile.mkdtemp() + "/w"
    save_pytree(d, params_to_jax({k: p.detach() for k, p in
                                  engine.engines[0].model.named_parameters()}))
    assert post("/v1/reload", {"directory": d})[0] == 200
    httpd.shutdown(); httpd.gateway.shutdown(); aeng.shutdown(); httpd.server_close()

    loaded = sorted(n for n, m in sys.modules.items() if m is not None and (
        n in ("jax", "dlti_tpu") or n.startswith(("jax.", "jaxlib", "dlti_tpu."))))
    assert not loaded, loaded
    print("OK")
""")


def test_replica_fleet_gateway_and_lifecycle_run_without_jax():
    """The replica fleet, its lifecycle and the admission gateway import and
    serve (a completion, a live migration, a reload request) from the serve
    CLI's builder with ``jax`` blocked."""
    proc = subprocess.run([sys.executable, "-c", _FLEET_CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")
