"""Rank side of the port's data-parallel tests on the CPU: a world of N
spawned processes in one gloo group runs a list of cases, each rank its part,
and sends its results back. Imports the port and never JAX, so a rank starts
in a few seconds.

:func:`spawn_world` starts the world once for many cases (a world's start
is the expensive part), with a file rendezvous (no port to collide under
pytest-xdist) and a hard deadline, so a rank that dies fails the test
instead of hanging the suite. ``parallel.sharding._MIN_FSDP_DIM`` is lowered
to :data:`MIN_FSDP_DIM` in every rank, as the JAX package's tests lower it,
or ZeRO-3 would shard no leaf of ``llama_tiny``.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# The JAX package's sharding test's setup (tests/test_sharding.py:30-50).
LORA = dict(r=4, alpha=8, dropout=0.0)
OPT = dict(warmup_steps=2)
ACCUM, BS, SEQ = 2, 8, 32
MIN_FSDP_DIM = 8
TIMEOUT_S = 300.0

Case = Tuple[str, str, dict]  # (result name, case function, keyword arguments)


def spawn_world(world: int, cases: Sequence[Case], tmp_dir: str,
                timeout_s: float = TIMEOUT_S, backend: str = "gloo") -> List[Dict[str, object]]:
    """Run ``cases`` in a fresh world of ``world`` ranks; returns each rank's
    ``{name: result}``, by rank. Raises with the failing rank's traceback,
    or when the world overruns ``timeout_s``; every rank is gone on
    return. ``backend="nccl"``: rank ``r`` on card ``r`` (a machine with as
    many cards)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    rdzv = os.path.join(tmp_dir, f"rdzv-{world}-{os.getpid()}-{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, rdzv, list(cases), results, backend), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Dict[str, object]] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"world of {world} did not finish within {timeout_s} s "
                                   f"(ranks done: {sorted(got)})")
            try:
                rank, out, err = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode not in (0, None) and i not in got]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} of a world of {world} died "
                                       f"(exit codes {[procs[i].exitcode for i in dead]})")
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of a world of {world} failed:\n{err}")
            got[rank] = out
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


def _rank_main(rank: int, world: int, rdzv: str, cases: List[Case], results,
               backend: str = "gloo") -> None:
    try:
        torch.set_num_threads(1)
        kw = {}
        if backend == "nccl":
            torch.cuda.set_device(rank)
            kw["device_id"] = torch.device("cuda", rank)
        dist.init_process_group(backend, init_method=f"file://{rdzv}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
        from dlti_tpu_torch.parallel import sharding

        sharding._MIN_FSDP_DIM = MIN_FSDP_DIM
        out = {name: CASES[fn](**kw) for name, fn, kw in cases}
        results.put((rank, out, None))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ----------------------------------------------------------------------
# Cases: each runs on every rank of the world
# ----------------------------------------------------------------------

def _parallel(par: dict):
    from dlti_tpu_torch.config import ParallelConfig, ZeROStage

    return ParallelConfig(**{**par, "zero_stage": ZeROStage(par.get("zero_stage", 0))})


def _rank_world() -> Tuple[int, int]:
    """(rank, world) of the group, (0, 1) in a process without one (the
    single-device run a world is compared with)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rows(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s rows of a global ``(accum, bs, seq)`` batch: local
    element (a, b) is global row ``rank * bs_local + b`` of microbatch a."""
    bl = batch["input_ids"].shape[1] // world
    return {k: np.ascontiguousarray(v[:, rank * bl:(rank + 1) * bl]) for k, v in batch.items()}


def _state(params: dict, parallel: dict, lora: dict = None, opt: dict = None,
           model: dict = None, fp16_scale: float = None, preset: str = "llama_tiny",
           device: str = "cpu"):
    """A ``preset`` train state from ``params`` (port names, numpy; int8
    pairs ``{name}.q``/``{name}.scale`` load as a quantized base), placed on
    this rank under ``parallel``; this rank's experts of each stacked expert
    leaf under ``expert`` above 1, its stage's layers under ``pipe``."""
    from dlti_tpu_torch.config import MODEL_PRESETS, LoRAConfig, OptimizerConfig
    from dlti_tpu_torch.models import load_model
    from dlti_tpu_torch.models.interop import shard_params
    from dlti_tpu_torch.models.lora import is_lora_name
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.parallel.sharding import shard_model
    from dlti_tpu_torch.training import build_optimizer, create_train_state
    from dlti_tpu_torch.utils.device import resolve_dtype

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mcfg = dataclasses.replace(MODEL_PRESETS[preset], **(model or {}))
    lcfg = LoRAConfig(**lora) if lora else LoRAConfig(enabled=False)
    from dlti_tpu_torch.models.quantization import quant_bases

    mesh = build_mesh(_parallel(parallel), dev, lcfg.enabled)
    base_dtype = resolve_dtype(mcfg.param_dtype)
    quantized = quant_bases(params)  # int8 pairs keep their dtypes

    def leaf(n, a):
        t = torch.from_numpy(a.copy())
        if n.rpartition(".")[0] in quantized:
            return t
        return t.to(torch.float32 if is_lora_name(n) else base_dtype)

    lora_cfg = lcfg if lcfg.enabled else None
    from dlti_tpu_torch.parallel.pipeline import stage_params

    tree = {n: leaf(n, a) for n, a in params.items()}
    if mesh.pp > 1:
        tree = stage_params(tree, mesh.pipe.rank, mesh.pp, mcfg.num_layers)
    tree = shard_params(tree, mesh, mcfg, lora_cfg)
    net = load_model(mcfg, tree, dev, lora=lora_cfg, trainable_lora=True,
                     mesh=mesh, stage=(mesh.pipe.rank, mesh.pp))
    layout = shard_model(net, mesh, lcfg.enabled)
    return create_train_state(net, build_optimizer(OptimizerConfig(**(opt or OPT))),
                              lora_enabled=lcfg.enabled, fp16_initial_scale=fp16_scale,
                              layout=layout)


def steps(params: dict, batches: list, parallel: dict, lora: dict = None,
          opt: dict = None, model: dict = None, fp16_scale: float = None,
          seed: int = None, preset: str = "llama_tiny", accum: int = ACCUM,
          loss_chunk: int = 0, device: str = "cpu", graphs: bool = False) -> dict:
    """``len(batches)`` train steps of ``preset`` from ``params`` (port
    names, numpy) under ``parallel``, each rank on its rows (the batch
    axes' share: a tensor or expert group's ranks take the same rows), through
    ``StepWindow`` (eager, or on a card ``graphs``: the step a CUDA graph), on
    ``device``. Returns the metric rows, the captures, every trainable leaf
    whole (rank 0; the other ranks join the gathers and
    get none), and each leaf's (local, whole) shape."""
    from dlti_tpu_torch.models.lora import is_lora_name
    from dlti_tpu_torch.training import whole_params
    from dlti_tpu_torch.training.step import StepWindow

    state = _state(params, parallel, lora, opt, model, fp16_scale, preset, device)
    layout = state.layout
    rows_axis = layout.mesh.batch
    window = StepWindow(state.model, accum_steps=accum, seed=seed, cuda_graphs=graphs,
                        loss_chunk=loss_chunk)
    rows = [window.run(state, [local_rows(b, rows_axis.rank, rows_axis.world)], i + 1)[0]
            .tolist() for i, b in enumerate(batches)]
    whole = whole_params(state)
    return {"metrics": [dict(zip(window.metrics, r)) for r in rows],
            "captures": window.captures,
            "trainable": {n: t.cpu().numpy() for n, t in whole.items()
                          if is_lora_name(n) or not state.lora_enabled},
            "shapes": {n: (tuple(p.shape), layout.leaves[n].shape)
                       for n, p in state.model.named_parameters()}}


def gathered_leaves(params: dict, parallel: dict, lora: dict = None) -> dict:
    """What a save hands the store under ``parallel``: for each leaf of
    ``state_leaves``, its shape, whether it is a ``meta`` placeholder, and
    whether it shares memory with the live state; and each parameter's
    shape after the gathers (the model keeps its shards)."""
    from dlti_tpu_torch.training.state import state_leaves

    state = _state(params, parallel, lora)
    live = {t.data_ptr() for t in [*state.model.parameters(), *state.opt_state.mu.values(),
                                   *state.opt_state.nu.values()]}
    leaves = state_leaves(state)
    return {"leaves": {n: (tuple(t.shape), t.is_meta, not t.is_meta and t.data_ptr() in live)
                       for n, t in leaves},
            "after": {n: tuple(p.shape) for n, p in state.model.named_parameters()}}


def train(cfg: dict, params: dict, texts: list, copy_from: str = None,
          drop_steps: Sequence[int] = (), eval_texts: list = None,
          export_dir: str = None) -> dict:
    """A ``Trainer`` run of ``Config.from_dict(cfg)`` on ``texts`` (byte
    tokens), evaluated on ``eval_texts`` when given. ``copy_from``: rank 0
    first copies that checkpoint directory to the run's ``output_dir``
    without the steps ``drop_steps``, so the run resumes from what is
    left. ``export_dir``: the final state's merged export, gathered to rank
    0 and written there (as ``cli.train --export-dir``)."""
    import shutil

    from dlti_tpu_torch.config import Config
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.training import Trainer

    c = Config.from_dict(cfg)
    if copy_from and dist.get_rank() == 0:
        shutil.copytree(copy_from, c.checkpoint.output_dir)
        for s in drop_steps:
            shutil.rmtree(os.path.join(c.checkpoint.output_dir, str(s)))
    dist.barrier()
    ds = make_batches(texts, ByteTokenizer(), seq_len=c.data.max_seq_len,
                      micro_batch_size=c.train.micro_batch_size,
                      grad_accum_steps=c.train.grad_accum_steps,
                      shuffle_seed=c.data.shuffle_seed)
    params_t = None if params is None else {n: torch.from_numpy(a.copy())
                                            for n, a in params.items()}
    held_out = None if eval_texts is None else make_batches(
        eval_texts, ByteTokenizer(), seq_len=c.data.max_seq_len,
        micro_batch_size=c.train.micro_batch_size, grad_accum_steps=1, shuffle_seed=None)
    state, rec = Trainer(c, params=params_t, device="cpu", cuda_graphs=False).train(
        dataset=ds, eval_dataset=held_out)
    if export_dir:
        from dlti_tpu_torch.checkpoint import export_merged_model
        from dlti_tpu_torch.training import whole_params

        whole = whole_params(state)
        if dist.get_rank() == 0:
            export_merged_model(export_dir, whole, c)
    return {"losses": rec.losses, "grad_norms": rec.grad_norms,
            "eval_steps": rec.eval_steps, "eval_losses": rec.eval_losses,
            "resumed_from": rec.resumed_from, "save_steps": rec.save_steps,
            "windows": rec.windows, "strategy": rec.strategy, "world": rec.world}


def data_rows(texts: list, seq: int, bs: int, accum: int, n_steps: int,
              skip_steps: int = 0) -> list:
    """This rank's first ``n_steps`` batches of epoch 1 (the second epoch's
    permutation) after ``skip_steps``, from ``make_batches``."""
    from dlti_tpu_torch.data import ByteTokenizer, make_batches

    ds = make_batches(texts, ByteTokenizer(), seq_len=seq, micro_batch_size=bs,
                      grad_accum_steps=accum, shuffle_seed=3)
    out = []
    for b in ds.epoch(1, skip_steps=skip_steps):
        out.append(b)
        if len(out) == n_steps:
            break
    return out


def norm(shapes: dict, seed: int = 0) -> dict:
    """The whole gradient's norm from owned ZeRO-2 gradients of leaves of
    ``shapes`` (some with no dim the world divides, so held whole on every
    rank), against the norm of the whole gradients."""
    from dlti_tpu_torch.config import ParallelConfig, ZeROStage
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.parallel.sharding import (
        LeafPlacement, Layout, _largest_divisible_dim, shard_of, sharded_sq_norm,
    )

    world = dist.get_world_size()
    mesh = build_mesh(ParallelConfig(zero_stage=ZeROStage.ZERO2, data=world),
                      torch.device("cpu"))
    rng = np.random.default_rng(seed)
    grads = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for n, s in shapes.items()}
    layout = Layout(mesh, {n: LeafPlacement(shape=tuple(s), trainable=True,
                                            opt_dim=_largest_divisible_dim(s, world))
                           for n, s in shapes.items()})
    owned = {n: shard_of(g, layout.leaves[n].opt_dim, mesh.data) for n, g in grads.items()}
    whole = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    return {"sharded": float(torch.sqrt(sharded_sq_norm(owned, layout))),
            "whole": float(whole),
            "replicated": sorted(n for n, pl in layout.leaves.items() if pl.opt_dim is None)}


def cli_mesh(argv: list) -> dict:
    """``cli.train``'s parallel config for ``argv`` in this world, and what
    ``build_mesh`` raises for it (``"{type}: {message}"``; None when it
    builds)."""
    from dlti_tpu_torch.cli.train import build_config, parse_args
    from dlti_tpu_torch.parallel.mesh import build_mesh

    cfg = build_config(parse_args(argv))
    par = cfg.parallel
    error = None
    try:
        build_mesh(par, torch.device("cpu"), cfg.lora.enabled)
    except (NotImplementedError, ValueError) as e:
        error = f"{type(e).__name__}: {e}"
    return {"fsdp": par.fsdp, "expert": par.expert, "zero_stage": int(par.zero_stage),
            "error": error}


# ----------------------------------------------------------------------
# Tensor-parallel serving cases: rank 0 schedules, the others follow
# ----------------------------------------------------------------------

def _tensor_mesh():
    from dlti_tpu_torch.config import ParallelConfig
    from dlti_tpu_torch.parallel.mesh import build_mesh

    return build_mesh(ParallelConfig(tensor=dist.get_world_size()), torch.device("cpu"))


def _model_cfg(preset: str, model: dict = None):
    from dlti_tpu_torch.config import MODEL_PRESETS

    return dataclasses.replace(MODEL_PRESETS[preset], **(model or {}))


def run_script(engine, sampling_params=None, seeded: bool = False) -> list:
    """The engine parity tests' request script (``tests/test_torch_engine.py``)
    on either package's engine (``sampling_params``: its class, the port's
    by default): a batch, a request crossing a block, one joining
    mid-flight, more requests than slots; with ``seeded`` every other
    request samples. Returns every request in order."""
    if sampling_params is None:
        from dlti_tpu_torch.serving import SamplingParams as sampling_params

    def sp(i, n):
        if seeded and i % 2:
            return sampling_params(temperature=0.9, top_k=20, max_tokens=n, seed=100 + i)
        return sampling_params(temperature=0.0, max_tokens=n)

    prompts = [([1, 2, 3], 6), ([4, 5, 6, 7, 8], 6), ([9], 6), ([10, 11], 6),
               ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], 10)]
    reqs = [engine.submit(p, sp(i, n)) for i, (p, n) in enumerate(prompts)]
    for _ in range(3):
        engine.step()
    reqs.append(engine.submit([4, 5], sp(5, 4)))
    reqs += [engine.submit([i + 1, i + 7], sp(6 + i, 3)) for i in range(10)]
    while engine.has_work:
        engine.step()
    return reqs


def tp_engine(params: dict, ec: dict, preset: str = "llama_tiny", model: dict = None,
              seeded: bool = False, sharded_init: bool = False) -> dict:
    """An engine over the tensor group of the world from ``params`` (port
    names, numpy, whole; with ``sharded_init`` the rank's part of
    ``init_params(seed=0)`` instead): rank 0 runs :func:`run_script` and
    releases the others, which follow. Every rank reports its KV heads and
    what its model holds; rank 0 the tokens and logprobs."""
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = _model_cfg(preset, model)
    mesh = _tensor_mesh()
    tree = (init_params(cfg, seed=0, device="cpu", mesh=mesh) if sharded_init
            else {n: torch.from_numpy(a.copy()) for n, a in params.items()})
    engine = InferenceEngine(cfg, tree, EngineConfig(**ec), device="cpu", mesh=mesh)
    out = {"kv_heads": engine.cache[0]["k"].shape[2],
           "shapes": {n: tuple(p.shape) for n, p in engine.model.named_parameters()},
           "scales": {n: p.detach().numpy().copy() for n, p in engine.model.named_parameters()
                      if n.endswith(".scale") and ".kernel" in n}}
    if engine.follower:
        engine.follow()
        return out
    reqs = run_script(engine, seeded=seeded)
    engine.stop_followers()
    out.update(tokens=[r.output_token_ids for r in reqs],
               logprobs=[r.output_logprobs for r in reqs])
    return out


def tp_server(params: dict, ec: dict, prompts: list) -> dict:
    """``make_server`` over a tensor-parallel engine on rank 0 (the others
    follow): greedy completions of ``prompts`` over HTTP, ``/stats`` and
    ``/metrics`` answered, then the server's shutdown releases the
    followers. Rank 0 returns the texts."""
    import json as _json
    import threading
    import urllib.request

    from dlti_tpu_torch.data import ByteTokenizer
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, ServerConfig, make_server

    cfg = _model_cfg("llama_tiny")
    mesh = _tensor_mesh()
    engine = InferenceEngine(cfg, {n: torch.from_numpy(a.copy()) for n, a in params.items()},
                             EngineConfig(**ec), device="cpu", mesh=mesh)
    if engine.follower:
        engine.follow()
        return {}
    httpd, async_engine = make_server(engine, ByteTokenizer(),
                                      ServerConfig(host="127.0.0.1", port=0))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    texts = []
    try:
        for p in prompts:
            body = _json.dumps({"prompt": p, "max_tokens": 8, "temperature": 0}).encode()
            req = urllib.request.Request(base + "/v1/completions", data=body,
                                         headers={"Content-Type": "application/json"})
            texts.append(_json.loads(urllib.request.urlopen(req, timeout=60).read())
                         ["choices"][0]["text"])
        stats = _json.loads(urllib.request.urlopen(base + "/stats", timeout=60).read())
        metrics = urllib.request.urlopen(base + "/metrics", timeout=60).read().decode()
    finally:
        httpd.shutdown()
        async_engine.shutdown()  # releases the followers
        httpd.server_close()
    return {"texts": texts, "requests": stats["requests"],
            "metrics_ok": "dlti_" in metrics}


def tp_refusals(params: dict, ec: dict) -> dict:
    """What a tensor-parallel engine refuses, by name: each error's message."""
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine

    cfg = _model_cfg("llama_tiny")
    mesh = _tensor_mesh()
    tree = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    out = {}
    for name, extra in (("adapters", dict(adapter_slots=2)),
                        ("spec", dict(speculative="ngram")),
                        ("tiers", dict(enable_prefix_caching=True, prefix_host_blocks=8))):
        try:
            InferenceEngine(cfg, dict(tree), EngineConfig(**ec, **extra), device="cpu",
                            mesh=mesh)
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def tp_gather(params: dict, preset: str = "llama_tiny", quantize: bool = False) -> dict:
    """``shard_params`` of a whole tree (port names, numpy) on this tensor
    rank, then ``gather_params`` back: each leaf's part shape and whether
    the gathered tree equals the whole one bit for bit."""
    from dlti_tpu_torch.models.interop import gather_params, shard_params
    from dlti_tpu_torch.models.quantization import quantize_params_int8

    cfg = _model_cfg(preset)
    whole = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    if quantize:
        whole = quantize_params_int8(whole)
    mesh = _tensor_mesh()
    part = shard_params(dict(whole), mesh, cfg, quantize=False)
    back = gather_params(part, mesh, cfg)
    return {"parts": {n: tuple(t.shape) for n, t in part.items()},
            "equal": sorted(back) == sorted(whole)
            and all(torch.equal(back[n], whole[n]) for n in whole)}


def zero3_parts(params: dict, parallel: dict, preset: str = "llama_tiny", model: dict = None,
                lora: dict = None) -> dict:
    """``shard_params`` of a whole tree (port names, numpy; int8 pairs kept)
    on this rank under ``parallel``, ``gather_params`` back, and a model
    built around the parts and placed (``load_model(mesh=)``,
    ``shard_model``): this rank's parts, whether the gathered tree equals
    the whole one bit for bit, each leaf's placement and what the model
    holds."""
    from dlti_tpu_torch.config import LoRAConfig
    from dlti_tpu_torch.models import load_model
    from dlti_tpu_torch.models.interop import gather_params, shard_params
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.parallel.sharding import shard_model

    cfg = _model_cfg(preset, model)
    lcfg = LoRAConfig(**lora) if lora else None
    mesh = build_mesh(_parallel(parallel), torch.device("cpu"), lcfg is not None)
    whole = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    part = shard_params(dict(whole), mesh, cfg, lcfg)
    back = gather_params(part, mesh, cfg, lcfg)
    net = load_model(cfg, dict(part), "cpu", lora=lcfg, trainable_lora=lcfg is not None,
                     mesh=mesh)
    layout = shard_model(net, mesh, lcfg is not None)
    return {"parts": {n: t.numpy() for n, t in part.items()},
            "equal": sorted(back) == sorted(whole)
            and all(torch.equal(back[n], whole[n]) for n in whole),
            "axes": {n: dict(pl.axes) for n, pl in layout.leaves.items()},
            "held": {n: tuple(p.shape) for n, p in net.named_parameters()}}


# ----------------------------------------------------------------------
# Sequence and pipeline parallelism: the ring and the pipelined forward
# ----------------------------------------------------------------------

def ring(q, k, v, parallel: dict, positions=None, segment_ids=None, causal: bool = True,
         window: int = None, w=None) -> dict:
    """``parallel.ring_attention.ring_attention`` of whole float32 ``q``/``k``/
    ``v`` (numpy) over this world's mesh: the output, and with ``w`` the
    gradients of ``sum(out * w)`` summed over the world (each rank's reach
    its own rows, tokens and heads)."""
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.parallel.ring_attention import ring_attention
    from dlti_tpu_torch.parallel.tensor import all_reduce_

    mesh = build_mesh(_parallel(parallel), torch.device("cpu"))
    qt, kt, vt = (torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v))
    opt = lambda a: None if a is None else torch.from_numpy(a.copy())  # noqa: E731
    out = ring_attention(qt, kt, vt, mesh, positions=opt(positions),
                         segment_ids=opt(segment_ids), causal=causal, window=window)
    res = {"out": out.detach().numpy()}
    if w is not None:
        grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [qt, kt, vt])
        res["grads"] = [all_reduce_(g.contiguous(), mesh).numpy() for g in grads]
    return res


def pipe_state(params: dict, batches: list, lora: dict, opt: dict, accum: int) -> dict:
    """A whole ``llama_tiny`` train state on one device, made this rank's
    pipe-2 stage state by ``parallel.pipeline.to_pipeline_state``, then
    stepped as :func:`steps` steps: the metric rows."""
    from dlti_tpu_torch.config import LoRAConfig, OptimizerConfig, ParallelConfig
    from dlti_tpu_torch.models import load_model
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.parallel.pipeline import to_pipeline_state
    from dlti_tpu_torch.training import build_optimizer, create_train_state
    from dlti_tpu_torch.training.step import StepWindow

    cfg, lcfg = _model_cfg("llama_tiny"), LoRAConfig(**lora)
    net = load_model(cfg, {n: torch.from_numpy(a.copy()) for n, a in params.items()}, "cpu",
                     lora=lcfg, trainable_lora=True)
    flat = create_train_state(net, build_optimizer(OptimizerConfig(**opt)))
    mesh = build_mesh(ParallelConfig(pipe=dist.get_world_size()), torch.device("cpu"))
    state = to_pipeline_state(flat, mesh, lcfg)
    window = StepWindow(state.model, accum_steps=accum, cuda_graphs=False)
    rows = [window.run(state, [b], i + 1)[0].tolist() for i, b in enumerate(batches)]
    return {"metrics": [dict(zip(window.metrics, r)) for r in rows],
            "layers": len(state.model.model.layers)}


def permute(shift: int) -> dict:
    """``parallel.tensor.permute`` of this rank's ``[rank + 1] * 3`` over a
    sequence group of the whole world: what arrived, and the gradient of
    ``sum(received * (arange(3) + 10 * rank))`` back at the sender."""
    from dlti_tpu_torch.config import ParallelConfig
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.parallel.tensor import permute as differentiable_permute

    rank, world = _rank_world()
    mesh = build_mesh(ParallelConfig(sequence=world), torch.device("cpu"))
    t = torch.full((3,), float(rank + 1), requires_grad=True)
    got = differentiable_permute(t, shift, mesh.sequence)
    (got * (torch.arange(3) + 10.0 * rank)).sum().backward()
    return {"got": got.detach().tolist(), "grad": t.grad.tolist()}


def pipe_forward(params: dict, ids, num_microbatches: int, preset: str = "llama_tiny",
                 model: dict = None, segment_ids=None, positions=None) -> dict:
    """``parallel.pipeline.pipeline_forward`` of this world's pipe stages
    (``params`` whole, port names, numpy): rank 0's logits, and a stage's
    layer count."""
    from dlti_tpu_torch.config import ParallelConfig
    from dlti_tpu_torch.models import load_model
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.parallel.pipeline import pipeline_forward, stage_params

    cfg = _model_cfg(preset, model)
    mesh = build_mesh(ParallelConfig(pipe=dist.get_world_size()), torch.device("cpu"))
    tree = stage_params({n: torch.from_numpy(a.copy()) for n, a in params.items()},
                        mesh.pipe.rank, mesh.pp, cfg.num_layers)
    net = load_model(cfg, tree, "cpu", stage=(mesh.pipe.rank, mesh.pp))
    opt = lambda a: None if a is None else torch.from_numpy(a.copy())  # noqa: E731
    logits = pipeline_forward(net, torch.from_numpy(ids.copy()), mesh,
                              num_microbatches=num_microbatches,
                              segment_ids=opt(segment_ids), positions=opt(positions))
    return {"logits": logits.numpy(), "layers": len(net.model.layers)}


CASES = {"steps": steps, "ring": ring, "pipe_forward": pipe_forward, "permute": permute,
         "pipe_state": pipe_state, "train": train, "data_rows": data_rows, "norm": norm,
         "gathered_leaves": gathered_leaves, "cli_mesh": cli_mesh, "tp_engine": tp_engine,
         "tp_server": tp_server, "tp_refusals": tp_refusals, "tp_gather": tp_gather,
         "zero3_parts": zero3_parts}
