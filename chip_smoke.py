#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and HTTP serving paths on one
NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run if its check fails:

1. Card and build: the card's name and power limit, then every kernel of
   ``dlti_tpu_torch/csrc`` built with ``nvcc`` for ``sm_90a`` (one process
   per source, all started together).
2. The paged decode kernel (K4) against its plain PyTorch version at the
   decode shapes of the presets it serves (llama2_7b, llama3_8b's GQA,
   mistral_7b's window, head_dim 256, a float32 pool, poisoned pool rows and
   garbage table entries), with each case's error, kernel time, bound, plain
   time and the time of ``F.scaled_dot_product_attention`` over the gathered
   window (a yardstick the port never calls). Then K4's int8 program (K4q)
   the same way on int8 pools with float32 row scales: llama2_7b, llama3_8b's
   GQA, mistral_7b's window, head_dim 256, and NaN in the scales of every
   row that is not live with garbage table entries (SDPA over the window
   dequantized once, outside the timed call). bf16 cases are held to an
   absolute limit and to one relative to each batch row's largest output;
   a planted 25% scale fault in a late tile must fail the second.
3. The engine at full width: llama2_7b in bfloat16 from
   ``init_params(seed=0)``, 12 requests (prompts of 16 to 300 tokens,
   greedy and seeded sampling) submitted to ``InferenceEngine`` and driven
   by ``step`` with 8 slots, so admission happens mid-flight. Every request
   must finish with its token count, and K4 must have been launched once per
   layer per decode step.
4. Inside the model: one decode step's logits through K4 against the same
   step through the plain gather path (``paged_attention_impl="gather"``),
   and K4 against its plain version on the engine's real pool, tables and
   lengths, where its time is taken for the record.
5. Profile: ``torch.profiler`` over the remaining decode steps of phase 4's
   batch, for the device's busy share and the kernels by device time.
   The engine and its KV pool are then released.
6. Flash attention K1 (forward), K2 (dq) and K3 (dk/dv) against their plain
   versions: llama2_7b's training shape, llama3_8b's GQA at s 2048,
   mistral_7b's window 4096 at s 8192, head_dim 256 and 64, float32, and a
   packed batch at the unaligned length 1000 with padding rows. Each
   kernel's time, bound, plain time and SDPA's time (forward for K1, its
   autograd backward for K2 and K3).
7. The trainer at full width: llama2_7b bf16 with LoRA r=16 on q/k/v/o
   from ``init_params(seed=0)``, 8 steps of ``Trainer.train`` over
   ``make_batches`` (byte tokenizer, texts from a seeded generator, seq 512,
   micro-batch 4, grad-accum 2, warmup 2, lr 2e-4, remat on). Losses and
   grad norms finite, every ``lora_b`` moved off zero, and K1 launched
   2 x 32 x 2 x 8 times (forward and remat recompute), K2 and K3 32 x 2 x 8.
   Prints step ms, tokens/s, MFU (4N FLOPs per token) and peak memory.
8. Kernel path against reference path: one step's loss and LoRA grads with
   the kernels and with ``attention_impl="reference"``, same weights and
   batch, dropout off; then known-wrong controls (the kernels' outputs given
   seeded multiplicative noise), which the same gate must refuse.
9. Profile of one train step: device busy share, time by kernel group.
   The trainer is then released.
10. The OpenAI server at full width on an int8 KV pool: llama2_7b from the
    serve CLI's own builder (``--random-init llama2_7b --tokenizer byte
    --kv-cache-dtype int8`` and the CLI's defaults: 8 slots, 2048 blocks of
    16, max_model_len 2048) behind ``make_server`` on a free port. 12
    concurrent requests (6 greedy completions of 32 tokens with prompts of
    16-300 bytes, 2 streamed, 2 chat, 1 seeded ``n: 2``, 1 with a ``stop``
    string), then one greedy prompt twice and streamed, one at a time. Every
    response 200 with no SSE error frame or ``error`` finish, ``usage``
    agreeing with the tokens, the repeated prompt identical, the streamed
    deltas the completion's text, ``/health`` 200, ``/metrics`` with
    ``dlti_requests`` >= 12 and the TTFT histogram; K4q launched exactly 32
    x decode steps and the float K4 never. Prints requests/s, output tok/s,
    TTFT p50/p99 and mean TPOT from ``/stats``, and the pool's bytes.
11. Inside the model on the int8 pool: one decode step's logits through K4q
    against the gather path (dequantized in float32), gated; against the
    same step on a bf16 pool, printed only (quantization error). Then K4q
    against its plain version on the engine's pool and tables, timed.
12. The entry point itself: ``python -m dlti_tpu_torch.cli.serve
    --random-init llama_tiny --tokenizer byte --kv-cache-dtype int8 --port
    0`` as a subprocess on the card answers ``/health`` and a completion and
    exits 0 on SIGTERM.

Prints a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero without that line when
there is no CUDA device, when the package is not beside this file, or when
any check fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16
# tensor-core rate, float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# Kernel output against the plain version on identical inputs. float32: the
# two sum in different orders (1e-5 absolute). bfloat16: both round an fp32
# result to bf16, whose spacing below |x| = 4 is at most 2**-6, so they may
# land one bf16 step apart.
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
# The same bound per batch row, relative to the row's largest |output|: one
# bf16 step of an element x is at most 2**-7 |x|. Long rows average many
# tokens into small outputs, where the absolute limit would not see a fault.
ROW_REL_TOL = 2.0 ** -7
# Whole-model logits, kernel path against gather path in bfloat16: the two
# attention outputs may differ by one bf16 step per element and 32 layers
# carry that on, so the bound is relative to the logits' scale.
LOGITS_REL_TOL = 5e-2

KERNEL_REPLACES = "dlti_tpu/ops/pallas/paged_attention.py:46"


def log(*args):
    print(*args, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


# ----------------------------------------------------------------------
# Timing and bounds
# ----------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 20, flush=None) -> float:
    """Mean device time of ``fn`` by CUDA events around each call. With
    ``flush`` (a large buffer), L2 is overwritten before every call, as the
    next layer's decode finds it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def decode_work(q, k_pool, block_tables, seq_lens, window):
    """Bytes the paged decode must move and operations it must do for
    these inputs: K and V of every live (token, kv head) once (with their
    two float32 scales on an int8 pool), q and the output once, the live
    table entries and the lengths; two multiply-adds per (token, query
    head, channel)."""
    batch, _, heads, d = q.shape
    bs, kvh = k_pool.shape[1], k_pool.shape[2]
    lens = seq_lens.long().clamp(min=0, max=block_tables.shape[1] * bs)
    start = (lens - window).clamp(min=0) if window else lens * 0
    tokens = int((lens - start).sum())
    first_blk, last_blk = start // bs, (lens + bs - 1) // bs
    live_blocks = int((last_blk - first_blk).clamp(min=0).sum())
    kv_bytes = 2 * tokens * kvh * d * k_pool.element_size()
    if not k_pool.dtype.is_floating_point:  # int8: a float32 scale per row
        kv_bytes += 2 * 4 * tokens * kvh
    qo_bytes = 2 * q.numel() * q.element_size()
    meta_bytes = 4 * (live_blocks + batch)
    ops = 4 * tokens * heads * d
    return kv_bytes + qo_bytes + meta_bytes, ops


def bound(nbytes: int, ops: int, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_over_gathered(torch, q, k_pool, v_pool, block_tables, seq_lens, window,
                       k_scale=None, v_scale=None):
    """The library yardstick: ``scaled_dot_product_attention`` over the
    window gathered from the pool (the gather, and an int8 pool's
    dequantization, done once, outside the timed call). Returns the timed
    closure."""
    import torch.nn.functional as F

    batch, _, heads, d = q.shape
    nb, bs, kvh, _ = k_pool.shape
    bt = block_tables.long().clamp(0, nb - 1)
    max_len = bt.shape[1] * bs
    k = k_pool[bt].float() if k_scale is not None else k_pool[bt]
    v = v_pool[bt].float() if v_scale is not None else v_pool[bt]
    if k_scale is not None:
        k = k * k_scale[bt][..., None]
        v = v * v_scale[bt][..., None]
    k = k.reshape(batch, max_len, kvh, d).transpose(1, 2).to(q.dtype)
    v = v.reshape(batch, max_len, kvh, d).transpose(1, 2).to(q.dtype)
    pos = torch.arange(max_len, device=q.device)[None, :]
    lens = seq_lens.long()[:, None]
    valid = pos < lens
    if window:
        valid &= pos >= lens - window
    mask = valid[:, None, None, :]
    qh = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qh, k, v, attn_mask=mask, enable_gqa=kvh != heads)


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------

def phase_card_and_build(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from dlti_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log(f"[build] {len(paths)} source(s) in {time.perf_counter() - t0:.2f} s")
    for name, info in _build.build_log.items():
        usage = sorted({line.split(":", 1)[1].strip() for line in info["log"].splitlines()
                        if "registers" in line})
        log(f"[build] csrc/{name}.cu nvcc {info['seconds']:.2f} s; ptxas: "
            + "; ".join(usage))
    return card


def make_decode_case(torch, gen, *, heads, kv_heads, d, dtype, block_size,
                     seq_lens, max_blocks, window=None, poison=False, int8=False):
    """A pool holding exactly the blocks the sequences use (a random
    permutation of them), plus block tables. With ``poison``, every pool row
    that is not live holds NaN (on an int8 pool: its scales do) and table
    entries past each sequence point at random (poisoned) blocks; otherwise
    they are -1. With ``int8`` the pools are quantized as ``paged_update``
    stores them and the scales come back in a dict."""
    dev = torch.device("cuda")
    batch = len(seq_lens)
    need = [-(-n // block_size) for n in seq_lens]
    num_blocks = sum(need) + 8
    k_pool = torch.randn(num_blocks, block_size, kv_heads, d, device=dev,
                         generator=gen).to(dtype)
    v_pool = torch.randn(num_blocks, block_size, kv_heads, d, device=dev,
                         generator=gen).to(dtype)
    perm = torch.randperm(num_blocks, device=dev, generator=gen).to(torch.int32)
    if poison:
        tables = torch.randint(0, num_blocks, (batch, max_blocks), device=dev,
                               generator=gen, dtype=torch.int32)
    else:
        tables = torch.full((batch, max_blocks), -1, device=dev, dtype=torch.int32)
    live = torch.zeros(num_blocks * block_size, dtype=torch.bool, device=dev)
    nxt = 0
    for b, n in enumerate(seq_lens):
        blocks = perm[nxt:nxt + need[b]]
        tables[b, :need[b]] = blocks
        t = torch.arange(max(0, n - window) if window else 0, n, device=dev)
        live[blocks[t // block_size].long() * block_size + t % block_size] = True
        nxt += need[b]
    scales = {}
    if int8:
        from dlti_tpu_torch.ops.kv_cache import _quantize_rows

        (k_pool, scales["k_scale"]), (v_pool, scales["v_scale"]) = (
            _quantize_rows(k_pool), _quantize_rows(v_pool))
    if poison:
        live = live.view(num_blocks, block_size)
        for t in (scales.values() if int8 else (k_pool, v_pool)):
            t[~live] = float("nan")
    q = torch.randn(batch, 1, heads, d, device=dev, generator=gen).to(dtype)
    lens = torch.tensor(seq_lens, device=dev, dtype=torch.int32)
    return q, k_pool, v_pool, tables, lens, scales


def decode_errors(torch, out, ref):
    """(max abs error, max over batch rows of the row's max abs error over
    its max |ref|). A row whose reference is all zero (seq_len 0) must be
    exactly zero: any error there reads as infinite."""
    diff = (out.float() - ref.float()).abs().flatten(1).amax(1)
    scale = ref.float().abs().flatten(1).amax(1)
    row_rel = torch.where(scale > 0, diff / scale.clamp(min=1e-30),
                          torch.where(diff > 0, float("inf"), 0.0))
    return diff.max().item(), row_rel.max().item()


def measure_kernel(torch, tpa, q, k_pool, v_pool, tables, lens, window, flush,
                   scales=None):
    """Error against the plain version, and the four times. ``scales``: an
    int8 pool's ``k_scale``/``v_scale``; its tolerance and peak rate are
    those of q's dtype, in which both versions compute."""
    kw = dict(window=window, **(scales or {}))
    out = tpa.paged_decode_attention(q, k_pool, v_pool, tables, lens, **kw)
    torch.cuda.synchronize()
    ref = tpa.paged_decode_attention_reference(q, k_pool, v_pool, tables, lens, **kw)
    check(torch.isfinite(out).all().item(), "kernel output is not finite")
    err, row_rel = decode_errors(torch, out, ref)
    dtype_name = str(q.dtype if scales else k_pool.dtype).split(".")[-1]
    nbytes, ops = decode_work(q, k_pool, tables, lens, window)
    bound_ms, bound_by = bound(nbytes, ops, dtype_name)
    ms = time_ms(torch, lambda: tpa.paged_decode_attention(
        q, k_pool, v_pool, tables, lens, **kw), flush=flush)
    plain_ms = time_ms(torch, lambda: tpa.paged_decode_attention_reference(
        q, k_pool, v_pool, tables, lens, **kw), flush=flush)
    library_ms = time_ms(torch, sdpa_over_gathered(
        torch, q, k_pool, v_pool, tables, lens, window, **(scales or {})), flush=flush)
    return {"max_abs_err": err, "tol": TOL[dtype_name], "row_rel_err": row_rel,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "bytes": nbytes, "ops": ops}


def planted_scale_fault(torch, tpa, q, k_pool, v_pool, tables, lens, scales):
    """Known-wrong control for the int8 gate: K4q reads ``v_scale`` 25% high
    on the last block of the longest sequence (a scale misread in a late
    tile) and is held against the plain version on the true scales. The
    row-relative limit must refuse it; the absolute one, which such a fault
    can pass, is printed beside."""
    row = int(lens.argmax())
    block = int(tables[row, (int(lens[row]) - 1) // k_pool.shape[1]])
    bad = scales["v_scale"].clone()
    bad[block] *= 1.25
    out = tpa.paged_decode_attention(q, k_pool, v_pool, tables, lens,
                                     k_scale=scales["k_scale"], v_scale=bad)
    ref = tpa.paged_decode_attention_reference(q, k_pool, v_pool, tables, lens, **scales)
    err, row_rel = decode_errors(torch, out, ref)
    log(f"[kernel] control, v_scale x1.25 on row {row}'s last block: max_abs_err "
        f"{err:.3e} (abs tol {TOL['bfloat16']:.3e}), row rel {row_rel:.3e} "
        f"(tol {ROW_REL_TOL:.3e}): must be refused")
    check(row_rel > ROW_REL_TOL, "the row-relative gate passed a planted scale fault")


def phase_kernel_cases(torch, flush):
    """K4 on float pools, then its int8 program (K4q) on int8 pools with
    float32 row scales and bf16 queries, against their plain version.
    Returns (float cases, int8 cases)."""
    from dlti_tpu_torch.ops import paged_attention as tpa

    gen = torch.Generator(device="cuda").manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    # Decode batches of 8 at block_size 16 with a ragged mix: a seq_len of 0
    # (an idle slot), single tokens, tails inside a block, a full table.
    lens_1k = [0, 1, 17, 100, 255, 316, 600, 1024]
    lens_8k = [0, 5, 100, 4095, 4097, 5000, 6000, 8192]
    int8 = dict(dtype=bf16, int8=True)
    cases = [
        ("llama2_7b", dict(heads=32, kv_heads=32, d=128, dtype=bf16,
                           seq_lens=lens_1k, max_blocks=64)),
        ("llama3_8b_gqa", dict(heads=32, kv_heads=8, d=128, dtype=bf16,
                               seq_lens=lens_1k, max_blocks=64)),
        ("mistral_7b_window", dict(heads=32, kv_heads=8, d=128, dtype=bf16,
                                   seq_lens=lens_8k, max_blocks=512, window=4096)),
        ("gemma_7b_d256", dict(heads=16, kv_heads=16, d=256, dtype=bf16,
                               seq_lens=lens_1k, max_blocks=64)),
        ("llama2_7b_fp32", dict(heads=32, kv_heads=32, d=128, dtype=f32,
                                seq_lens=lens_1k, max_blocks=64)),
        ("poisoned_rows_garbage_tables", dict(heads=32, kv_heads=8, d=128,
                                              dtype=bf16, seq_lens=lens_1k,
                                              max_blocks=64, poison=True)),
        ("int8_llama2_7b", dict(heads=32, kv_heads=32, d=128, seq_lens=lens_1k,
                                max_blocks=64, **int8)),
        ("int8_llama3_8b_gqa", dict(heads=32, kv_heads=8, d=128, seq_lens=lens_1k,
                                    max_blocks=64, **int8)),
        ("int8_mistral_7b_window", dict(heads=32, kv_heads=8, d=128, seq_lens=lens_8k,
                                        max_blocks=512, window=4096, **int8)),
        ("int8_d256", dict(heads=16, kv_heads=16, d=256, seq_lens=lens_1k,
                           max_blocks=64, **int8)),
        ("int8_nan_scales_garbage_tables", dict(heads=32, kv_heads=8, d=128,
                                                seq_lens=lens_1k, max_blocks=64,
                                                poison=True, **int8)),
    ]
    results, int8_results = {}, {}
    for name, kw in cases:
        window = kw.get("window")
        *inputs, scales = make_decode_case(torch, gen, block_size=16, **kw)
        r = measure_kernel(torch, tpa, *inputs, window, flush, scales=scales)
        (int8_results if scales else results)[name] = r
        log(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3e} (tol "
            f"{r['tol']:.3e}), row rel {r['row_rel_err']:.3e}; kernel {r['ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
            f"{r['plain_ms']:.4f} ms, sdpa"
            f"{' over the dequantized window' if scales else ''} "
            f"{r['library_ms']:.4f} ms")
        check(r["max_abs_err"] <= r["tol"],
              f"kernel disagrees with its plain version on {name}: "
              f"{r['max_abs_err']} > {r['tol']}")
        if inputs[0].dtype == bf16:
            check(r["row_rel_err"] <= ROW_REL_TOL,
                  f"kernel disagrees with its plain version on {name}: row rel "
                  f"{r['row_rel_err']} > {ROW_REL_TOL}")
        if name == "int8_llama2_7b":
            planted_scale_fault(torch, tpa, *inputs[:5], scales)
        del inputs, scales
    torch.cuda.empty_cache()
    return results, int8_results


def phase_engine(torch):
    from dlti_tpu_torch.config import MODEL_PRESETS
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving.engine import EngineConfig, InferenceEngine
    from dlti_tpu_torch.serving.sampling import SamplingParams

    import numpy as np

    cfg = MODEL_PRESETS["llama2_7b"]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    check(n_params == cfg.num_params(), f"{n_params} params, expected {cfg.num_params()}")
    log(f"[engine] llama2_7b: {n_params / 1e9:.3f} B params "
        f"({cfg.num_layers} layers, hidden {cfg.hidden_size}, {cfg.num_heads} "
        f"heads, vocab {cfg.vocab_size}) in {cfg.param_dtype}, made on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    ec = EngineConfig(max_seqs=8, block_size=16, num_blocks=1024,
                      max_model_len=1024, cache_dtype="bfloat16",
                      eos_token_id=-1)  # every request runs to max_tokens
    engine = InferenceEngine(cfg, params, ec, device="cuda")
    log(f"[engine] KV pool {sum(c['k'].numel() * 2 * c['k'].element_size() for c in engine.cache) / 1e9:.2f} GB, "
        f"device memory allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    rng = np.random.default_rng(0)
    lengths = [16, 300] + rng.integers(16, 301, 10).tolist()
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in lengths]
    max_tokens = 32

    # Device time of each prefill and decode call, by CUDA events on the
    # stream around the executor's two programs.
    ex = engine.executor
    spans = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def call(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            spans[kind].append((a, b))
            return out
        return call

    ex.prefill = timed("prefill", ex.prefill)
    ex.decode = timed("decode", ex.decode)

    reqs = []
    for i, p in enumerate(prompts):
        sp = (SamplingParams(temperature=0.0, max_tokens=max_tokens) if i % 2 == 0
              else SamplingParams(temperature=0.8, top_p=0.95, top_k=50,
                                  max_tokens=max_tokens, seed=1000 + i))
        reqs.append((p, sp))

    tpa.launches = tpa.launches_int8 = 0  # the main path's counts start here
    t0 = time.perf_counter()
    results = []
    for p, sp in reqs:
        results.append(engine.submit(p, sp))
    while engine.has_work:
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, launches_int8 = tpa.launches, tpa.launches_int8  # ... and are read here
    del ex.prefill, ex.decode
    check(launches_int8 == 0, f"a bf16 pool launched the int8 kernel {launches_int8} times")

    stats = dict(engine.stats)
    for r, n in zip(results, lengths):
        check(r.finish_reason == "length" and len(r.output_token_ids) == max_tokens,
              f"request {r.request_id} (prompt {n}) finished {r.finish_reason} "
              f"with {len(r.output_token_ids)} tokens, expected {max_tokens}")
        check(all(0 <= t < cfg.vocab_size for t in r.output_token_ids),
              f"request {r.request_id} produced an out-of-vocabulary token")
        check(np.isfinite(r.output_logprobs).all(), "nonfinite logprobs")
    expected = cfg.num_layers * stats["decode_steps"]
    log(f"[engine] {len(results)} requests done in {wall:.2f} s; decode steps "
        f"{stats['decode_steps']}, prefill batches {stats['prefill_batches']}, "
        f"preemptions {stats['preemptions']}; kernel launches {launches} "
        f"(expected {cfg.num_layers} layers x {stats['decode_steps']} steps = {expected})")
    check(launches == expected, f"kernel launches {launches} != {expected}")
    check(engine.block_manager.num_free == ec.num_blocks - 1, "blocks leaked")

    prefill_s = sum(a.elapsed_time(b) for a, b in spans["prefill"]) / 1e3
    decode_s = sum(a.elapsed_time(b) for a, b in spans["decode"]) / 1e3
    decode_tokens = stats["decode_slot_steps"]
    perf = {
        "requests": len(results),
        "prompt_tokens": stats["prefill_tokens"],
        "generated_tokens": stats["generated_tokens"],
        "decode_steps": stats["decode_steps"],
        "prefill_calls": len(spans["prefill"]),
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "prefill_tok_s": stats["prefill_tokens"] / prefill_s,
        "decode_tok_s": decode_tokens / decode_s,
        "decode_step_ms": 1e3 * decode_s / stats["decode_steps"],
        "wall_s": wall,
        "wall_generated_tok_s": stats["generated_tokens"] / wall,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(f"[engine] prefill {perf['prefill_tok_s']:.1f} tok/s "
        f"({stats['prefill_tokens']} tokens in {prefill_s:.3f} s device time over "
        f"{perf['prefill_calls']} calls); decode {perf['decode_tok_s']:.1f} tok/s "
        f"({decode_tokens} tokens in {decode_s:.3f} s, {perf['decode_step_ms']:.2f} "
        f"ms/step at up to {ec.max_seqs} slots)")
    log("[engine] perf " + json.dumps(perf))
    return engine, launches


def phase_in_model(torch, engine, flush):
    """One decode step's logits, kernel path against gather path (an int8
    pool's window dequantized in float32), gated, on a batch of 8 freshly
    prefilled sequences. On an int8 pool also against the same step on a
    bf16 pool, printed only: that is quantization error, not a kernel fault.
    Then the kernel against its plain version on the engine's layer-0 pool
    and tables, timed."""
    import numpy as np

    from dlti_tpu_torch.models.interop import load_model
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.ops.kv_cache import init_paged_cache
    from dlti_tpu_torch.serving.sampling import SamplingParams

    cfg = engine.model_cfg
    layer = engine.cache[0]
    int8 = layer["k"].dtype == torch.int8
    tag, kname = ("[int8-in-model]", "K4q") if int8 else ("[in-model]", "kernel")
    # No slot may finish at its first token: the step below needs all 8.
    engine.cfg = dataclasses.replace(engine.cfg, eos_token_id=-1)
    rng = np.random.default_rng(1)
    for n in [40, 77, 128, 129, 200, 255, 300, 511]:
        engine.submit(rng.integers(3, cfg.vocab_size, n).tolist(),
                      SamplingParams(temperature=0.0, max_tokens=4))
    engine.step()  # no slot was active: admission prefill only
    check(engine.num_active == 8, f"expected 8 active slots, got {engine.num_active}")

    dev = engine.device
    ids = torch.tensor([[s.last_token] for s in engine.slots], device=dev)
    pos = torch.tensor([[s.seq_len] for s in engine.slots], device=dev)
    tables = torch.tensor(engine._block_tables, device=dev)
    gather_model = load_model(dataclasses.replace(cfg, paged_attention_impl="gather"),
                              dict(engine.model.state_dict()), dev)
    with torch.no_grad():
        if int8:  # the same prompts prefilled into a bf16 pool at the same blocks
            bf16_cache = init_paged_cache(cfg.num_layers, engine.cfg.num_blocks,
                                          engine.cfg.block_size, cfg.num_kv_heads,
                                          cfg.resolved_head_dim, torch.bfloat16, device=dev)
            prompts = [s.request.prompt_token_ids for s in engine.slots]
            width = max(len(p) for p in prompts)
            pre_ids = torch.zeros(8, width, dtype=torch.long, device=dev)
            pre_pos = torch.full((8, width), -1, dtype=torch.long, device=dev)
            for r, p in enumerate(prompts):
                pre_ids[r, :len(p)] = torch.tensor(p, device=dev)
                pre_pos[r, :len(p)] = torch.arange(len(p), device=dev)
            engine.model(pre_ids, positions=pre_pos, cache=bf16_cache, block_tables=tables)
            bf16_logits = engine.model(ids, positions=pos, cache=bf16_cache,
                                       block_tables=tables)[:, 0]
            del bf16_cache
        # Both write the same K/V rows at the same slots before attending.
        kernel_logits = engine.model(ids, positions=pos, cache=engine.cache,
                                     block_tables=tables)[:, 0]
        gather_logits = gather_model(ids, positions=pos, cache=engine.cache,
                                     block_tables=tables)[:, 0]
    del gather_model
    torch.cuda.empty_cache()
    check(torch.isfinite(kernel_logits).all().item(), f"nonfinite {kname}-path logits")
    scale = gather_logits.abs().max().item()
    diff = (kernel_logits - gather_logits).abs().max().item()
    agree = (kernel_logits.argmax(-1) == gather_logits.argmax(-1)).float().mean().item()
    log(f"{tag} decode logits {kname} vs gather path: max_abs_diff {diff:.4e}, "
        f"max |logit| {scale:.4e}, rel {diff / scale:.3e} (tol {LOGITS_REL_TOL:.1e}); "
        f"argmax agreement {agree:.3f}")
    extra = {"logits_rel": diff / scale, "argmax_agree": agree}
    if int8:
        qdiff = (kernel_logits - bf16_logits).abs().max().item()
        qagree = (kernel_logits.argmax(-1) == bf16_logits.argmax(-1)).float().mean().item()
        log(f"{tag} int8 pool vs bf16 pool (quantization error, not gated): "
            f"max_abs_diff {qdiff:.4e}, rel {qdiff / scale:.3e}, argmax agreement "
            f"{qagree:.3f}")
        extra.update(bf16_pool_rel=qdiff / scale, bf16_pool_argmax_agree=qagree)
    check(diff <= LOGITS_REL_TOL * scale,
          f"{kname}-path logits differ from gather-path by {diff} (scale {scale})")

    # The kernel on the engine's own pool, tables and lengths (positions
    # seq_len + 1 after the step above wrote them), with a random query.
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(8, 1, cfg.num_heads, cfg.resolved_head_dim, device=dev,
                    generator=gen).to(torch.bfloat16)
    lens = (pos[:, 0] + 1).to(torch.int32)
    scales = {k: layer[k] for k in ("k_scale", "v_scale") if k in layer}
    r = measure_kernel(torch, tpa, q, layer["k"], layer["v"], tables, lens,
                       cfg.sliding_window, flush, scales=scales)
    log(f"{tag} {kname} on the engine's pool (seq_lens {lens.tolist()}): "
        f"max_abs_err {r['max_abs_err']:.3e} (tol {r['tol']:.3e}), row rel "
        f"{r['row_rel_err']:.3e} (tol {ROW_REL_TOL:.3e}); kernel "
        f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
        f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms")
    check(r["max_abs_err"] <= r["tol"], f"{kname} disagrees on the engine's pool")
    check(r["row_rel_err"] <= ROW_REL_TOL, f"{kname} disagrees on the engine's pool "
          f"relative to its rows: {r['row_rel_err']}")
    return {**r, **extra}


def phase_profile(torch, engine):
    """Where a decode step's time goes: ``torch.profiler`` over the engine's
    remaining decode steps (8 active slots). Device busy time is the sum of
    the kernels' own device time; the rest of the wall time the card idles
    while the host prepares and launches work."""
    from torch.profiler import ProfilerActivity, profile

    steps = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while engine.has_work:
            engine.step()
            steps += 1
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels or busy_ms == 0:
        log("[profile] the profiler recorded no device time: not measured")
        return None
    n_kernels = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[profile] {steps} decode steps under torch.profiler: wall "
        f"{wall_ms / steps:.2f} ms/step, device busy {busy_ms / steps:.2f} ms/step "
        f"({100 * busy_ms / wall_ms:.1f}% busy, {100 - 100 * busy_ms / wall_ms:.1f}% idle), "
        f"{n_kernels / steps:.0f} kernels/step")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% x{e.count // steps:<4d} "
            f"{e.key[:90]}")
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "busy_ms_per_step": busy_ms / steps, "kernels_per_step": n_kernels / steps}


# ----------------------------------------------------------------------
# Training slice: flash attention K1-K3 and the LoRA trainer
# ----------------------------------------------------------------------

FLASH_REPLACES = {
    "flash_fwd": "dlti_tpu/ops/pallas/flash_attention.py:132",
    "flash_bwd_dq": "dlti_tpu/ops/pallas/flash_attention.py:366",
    "flash_bwd_dkv": "dlti_tpu/ops/pallas/flash_attention.py:424",
}
# Kernel against plain version on identical inputs, elementwise
# |got - want| <= atol + rtol |want|. Both compute in float32 and differ
# only in summation order; in bfloat16 both then round to bf16 (relative
# spacing 2**-7), so they may land one bf16 step apart.
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2.0 ** -7)}
# Kernel path against reference path, one llama2_7b train step in bf16. The
# reference path rounds the softmax probabilities to bf16 before p @ v and
# the kernels do not, so the two attention outputs differ by about one bf16
# step (2**-8 relative) in every layer; 32 layers carry that on. Gates: the
# loss relative difference, and the LoRA grads (all factors as one vector)
# by cosine and relative L2. On an H100 the sound path read loss rel
# 2.7e-5 and 1.3e-4, rel L2 3.8e-3 and 4.3e-3, 1 - cosine 7e-6 to 9.3e-6.
# The grad limits lie between those and the 10% controls below (rel L2
# 2.2e-2 and 6.9e-2, 1 - cosine 2.4e-4 and 2.0e-3), which must be refused.
# The loss barely moves on random weights (the 10% forward control read
# 2.0e-4), so its limit only catches gross faults. The 2% control reads
# within the limits (rel L2 6.1e-3): it is printed, not gated.
STEP_LOSS_RTOL = 5e-4
STEP_GRAD_COS = 0.9999
STEP_GRAD_REL_L2 = 0.012
# Known-wrong controls (kernels, eps, must be refused): the kernel path with
# the named kernels' outputs multiplied elementwise by (1 + eps * N(0, 1))
# from a seeded generator.
STEP_CONTROLS = [(("flash_fwd",), 0.1, True),
                 (("flash_bwd_dq", "flash_bwd_dkv"), 0.1, True),
                 (("flash_bwd_dq", "flash_bwd_dkv"), 0.02, False)]


def allowed_pairs(torch, b, s, causal, window, segs):
    """(query, key) pairs the mask allows, counted from this case's data."""
    if segs is None and not window:
        return b * (s * (s + 1) // 2 if causal else s * s)
    total = 0
    qi = torch.arange(s, device="cuda")[:, None]
    kj = torch.arange(s, device="cuda")[None, :]
    allowed = (kj <= qi) if causal else torch.ones(s, s, dtype=torch.bool, device="cuda")
    if causal and window:
        allowed &= kj > qi - window
    for row in range(b):
        m = allowed
        if segs is not None:
            m = m & (segs[row][:, None] == segs[row][None, :]) & (segs[row][None, :] != 0)
        total += int(m.sum())
    return total


def flash_work(q, k, segs, pairs):
    """Bytes each kernel must move (inputs read once, outputs written once)
    and operations it must do (2 per multiply-add; K1 two products per
    allowed pair and channel, K2 three, K3 four) for these inputs."""
    b, s, h, d = q.shape
    e = q.element_size()
    qb, kb = q.numel() * e, k.numel() * e
    rowb = b * h * s * 4                      # lse or D, float32
    segb = 0 if segs is None else segs.numel() * 4
    reads_bwd = 2 * qb + 2 * kb + 2 * rowb + segb       # q, k, v, dO, lse, D
    return {
        "flash_fwd": (qb + 2 * kb + segb + qb + rowb, 4 * h * d * pairs),
        "flash_bwd_dq": (reads_bwd + qb, 6 * h * d * pairs),
        "flash_bwd_dkv": (reads_bwd + 2 * kb, 8 * h * d * pairs),
    }


def sdpa_calls(torch, q, k, v, do, causal, window, segs):
    """The library yardstick, timed and never used by the port:
    ``F.scaled_dot_product_attention`` forward, and its backward through
    autograd (dq, dk and dv together)."""
    import torch.nn.functional as F

    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    kw = dict(enable_gqa=k.shape[2] != q.shape[2])
    if segs is None and not window:
        kw["is_causal"] = causal
    else:
        s = q.shape[1]
        qi = torch.arange(s, device="cuda")[:, None]
        kj = torch.arange(s, device="cuda")[None, :]
        m = (kj <= qi) & (kj > qi - window) if window else (kj <= qi)
        m = m[None, None]
        if segs is not None:
            m = m & ((segs[:, :, None] == segs[:, None, :]) & (segs[:, None, :] != 0))[:, None]
        kw["attn_mask"] = m
    out = F.scaled_dot_product_attention(qh, kh, vh, **kw)
    dout = do.transpose(1, 2)
    fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh, **kw)  # noqa: E731
    bwd = lambda: torch.autograd.grad(out, (qh, kh, vh), dout, retain_graph=True)  # noqa: E731
    return fwd, bwd


def within(got, want, dtype_name):
    atol, rtol = FLASH_TOL[dtype_name]
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return ok, err.max().item()


def phase_flash_cases(torch, flush):
    from dlti_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32

    def packed(b, s):
        segs = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        cpu = torch.Generator().manual_seed(5)
        for row in range(b):
            cuts = sorted((torch.randperm(s - 200, generator=cpu)[:4] + 20).tolist())
            prev = 0
            for i, c in enumerate(cuts):  # 4 documents, then padding rows
                segs[row, prev:c] = i + 1
                prev = c
        return segs

    cases = [
        ("llama2_7b_train", dict(b=4, s=512, h=32, hkv=32, d=128, dtype=bf16)),
        ("llama3_8b_gqa", dict(b=1, s=2048, h=32, hkv=8, d=128, dtype=bf16)),
        ("mistral_7b_window", dict(b=1, s=8192, h=32, hkv=8, d=128, dtype=bf16,
                                   window=4096)),
        ("gemma_7b_d256", dict(b=2, s=1024, h=16, hkv=16, d=256, dtype=bf16)),
        ("d64", dict(b=2, s=1024, h=16, hkv=16, d=64, dtype=bf16)),
        ("llama2_7b_fp32", dict(b=1, s=512, h=32, hkv=32, d=128, dtype=f32)),
        ("packed_unaligned_1000", dict(b=2, s=1000, h=32, hkv=8, d=128, dtype=bf16,
                                       packed=True)),
    ]
    results = {}
    for name, c in cases:
        b, s, h, hkv, d, dtype = c["b"], c["s"], c["h"], c["hkv"], c["d"], c["dtype"]
        window = c.get("window")
        q = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(dtype)
        do = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
        segs = packed(b, s) if c.get("packed") else None
        kw = dict(causal=True, window=window, segment_ids=segs)
        chunk = 1024 if s > 2048 else None    # bound the plain version's memory
        dtype_name = str(dtype).split(".")[-1]

        o, lse = tfa.flash_fwd(q, k, v, **kw)
        delta = tfa.backward_delta(o, do)
        dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        ro, rlse = tfa.flash_attention_reference(q, k, v, q_chunk=chunk, **kw)
        rdq, rdk, rdv = tfa.flash_attention_backward_reference(
            q, k, v, o, lse, do, q_chunk=chunk, **kw)
        errs = {}
        for label, got, want in (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk),
                                 ("dv", dv, rdv)):
            check(torch.isfinite(got).all().item(), f"{name}: nonfinite {label}")
            ok, errs[label] = within(got, want, dtype_name)
            check(ok, f"flash {label} disagrees with its plain version on {name}: "
                      f"max abs err {errs[label]}")
        masked = rlse == tfa.MASKED_LSE
        check(torch.equal(lse == tfa.MASKED_LSE, masked),
              f"{name}: fully masked rows differ")
        lse_err = (lse[~masked] - rlse[~masked]).abs().max().item()
        check(lse_err <= 1e-3, f"{name}: lse err {lse_err}")
        if segs is not None:
            check(not o[segs == 0].any().item(), f"{name}: padding rows not zero")

        pairs = allowed_pairs(torch, b, s, True, window, segs)
        work = flash_work(q, k, segs, pairs)
        sdpa_fwd, sdpa_bwd = sdpa_calls(torch, q, k, v, do, True, window, segs)
        iters = 5 if s > 2048 else 20
        times = {
            "flash_fwd": time_ms(torch, lambda: tfa.flash_fwd(q, k, v, **kw),
                                 iters, flush),
            "flash_bwd_dq": time_ms(torch, lambda: tfa.flash_bwd_dq(
                q, k, v, do, lse, delta, **kw), iters, flush),
            "flash_bwd_dkv": time_ms(torch, lambda: tfa.flash_bwd_dkv(
                q, k, v, do, lse, delta, **kw), iters, flush),
        }
        plain_fwd = time_ms(torch, lambda: tfa.flash_attention_reference(
            q, k, v, q_chunk=chunk, **kw), 3, flush)
        plain_bwd = time_ms(torch, lambda: tfa.flash_attention_backward_reference(
            q, k, v, o, lse, do, q_chunk=chunk, **kw), 3, flush)
        lib_fwd = time_ms(torch, sdpa_fwd, iters, flush)
        lib_bwd = time_ms(torch, sdpa_bwd, iters, flush)
        r = {"errs": errs, "lse_err": lse_err, "pairs": pairs}
        for kname in FLASH_REPLACES:
            nbytes, ops = work[kname]
            bound_ms, bound_by = bound(nbytes, ops, dtype_name)
            fwd = kname == "flash_fwd"
            r[kname] = {"ms": times[kname], "bound_ms": bound_ms, "bound_by": bound_by,
                        "plain_ms": plain_fwd if fwd else plain_bwd,
                        "library_ms": lib_fwd if fwd else lib_bwd,
                        "max_abs_err": errs["o"] if fwd else (
                            errs["dq"] if kname == "flash_bwd_dq"
                            else max(errs["dk"], errs["dv"])),
                        "bytes": nbytes, "ops": ops}
        results[name] = r
        log(f"[flash] {name} (b {b}, s {s}, h {h}/{hkv}, d {d}, {dtype_name}"
            f"{', window %d' % window if window else ''}{', packed' if segs is not None else ''}): "
            f"max abs err o {errs['o']:.3e} dq {errs['dq']:.3e} dk {errs['dk']:.3e} "
            f"dv {errs['dv']:.3e} lse {lse_err:.2e}")
        for kname in FLASH_REPLACES:
            x = r[kname]
            log(f"[flash]   {kname}: {x['ms']:.4f} ms, bound {x['bound_ms']:.4f} ms by "
                f"{x['bound_by']}, plain {x['plain_ms']:.4f} ms, sdpa {x['library_ms']:.4f} ms")
        del q, k, v, do, o, lse, delta, dq, dk, dv, ro, rlse, rdq, rdk, rdv
        del sdpa_fwd, sdpa_bwd
        torch.cuda.empty_cache()
    return results


def training_texts(n=96, seed=0):
    """Texts of 40 to 1400 characters from a seeded generator: with the byte
    tokenizer some fill seq 512 and some leave padding."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ["def", "return", "the", "model", "tokens", "(x)", "=", "+", "loss",
             "grad", "lora", "attention", "\n", "    ", "for", "in", "range"]
    return [" ".join(rng.choice(words, rng.integers(8, 280))) for _ in range(n)]


def phase_training(torch):
    """llama2_7b LoRA (r=16, bf16, seq 512, micro-batch 4 x accum 2, remat)
    for 8 steps through ``Trainer.train`` on ``make_batches`` output."""
    from dlti_tpu_torch.config import (
        MODEL_PRESETS, Config, DataConfig, LoRAConfig, OptimizerConfig, TrainConfig,
    )
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.training import Trainer

    mcfg = MODEL_PRESETS["llama2_7b"]
    steps, accum, micro, seq = 8, 2, 4, 512
    cfg = Config(model=mcfg, lora=LoRAConfig(),
                 optimizer=OptimizerConfig(learning_rate=2e-4, warmup_steps=2),
                 data=DataConfig(max_seq_len=seq, tokenizer="byte"),
                 train=TrainConfig(micro_batch_size=micro, grad_accum_steps=accum,
                                   max_steps=steps, logging_steps=1))
    check(mcfg.remat and mcfg.remat_policy == "nothing_saveable"
          and mcfg.attention_impl == "auto", "llama2_7b preset changed")
    dataset = make_batches(training_texts(), ByteTokenizer(), seq_len=seq,
                           micro_batch_size=micro, grad_accum_steps=accum)
    check(dataset.steps_per_epoch() >= steps, "dataset too small")
    first = next(dataset.epoch(0))
    pad_share = 1 - first["loss_mask"].mean()
    t0 = time.perf_counter()
    params = init_params(mcfg, seed=0, device="cuda", lora=cfg.lora)
    torch.cuda.synchronize()
    log(f"[train] llama2_7b + LoRA r={cfg.lora.r}: {sum(p.numel() for p in params.values()) / 1e9:.3f} B "
        f"params made on the card in {time.perf_counter() - t0:.1f} s; first batch "
        f"{100 * pad_share:.1f}% padding")
    trainer = Trainer(cfg, params=params, device="cuda")
    state = trainer.init_state()
    del params

    tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
    tpa.launches = 0  # the main path's counts start here ...
    state, record = trainer.train(dataset=dataset, state=state)
    torch.cuda.synchronize()
    launches = {"flash_fwd": tfa.fwd_launches, "flash_bwd_dq": tfa.dq_launches,
                "flash_bwd_dkv": tfa.dkv_launches}  # ... and are read here
    check(tpa.launches == 0, "training launched the decode kernel")
    layers = mcfg.num_layers
    want = {"flash_fwd": 2 * layers * accum * steps,
            "flash_bwd_dq": layers * accum * steps,
            "flash_bwd_dkv": layers * accum * steps}
    log(f"[train] {record.steps} steps; launches {launches} (expected {want}: K1 twice "
        f"per layer per microbatch under remat, K2/K3 once)")
    check(launches == want, f"flash launches {launches} != {want}")
    check(record.steps == steps, f"{record.steps} steps, expected {steps}")
    check(all(math.isfinite(x) for x in record.losses + record.grad_norms),
          f"nonfinite losses {record.losses} or grad norms {record.grad_norms}")
    check(record.skipped_updates == 0, "an update was skipped")
    lora_b = {n: p for n, p in state.model.named_parameters() if n.endswith("lora_b")}
    check(len(lora_b) == 4 * layers, f"{len(lora_b)} lora_b leaves")
    still_zero = [n for n, p in lora_b.items() if not p.detach().abs().max().item() > 0]
    check(not still_zero, f"lora_b still zero: {still_zero[:3]}")
    perf = {
        "steps": record.steps, "losses": record.losses, "grad_norms": record.grad_norms,
        "step_times_s": record.step_times_s, "step_ms": 1e3 * record.step_time_s,
        "tokens_per_step": record.tokens_per_step,
        "tokens_per_s": record.tokens_per_second, "mfu_percent": record.mfu_percent,
        "peak_memory_gb": record.peak_memory_gb,
        "num_params": mcfg.num_params(), "trainable_params": record.trainable_params,
    }
    log(f"[train] losses {[round(x, 4) for x in record.losses]}")
    log(f"[train] grad norms {[round(x, 4) for x in record.grad_norms]}")
    log(f"[train] step {perf['step_ms']:.1f} ms (mean of steps 3-{steps}), "
        f"{perf['tokens_per_s']:.1f} tokens/s, MFU {perf['mfu_percent']:.2f}% "
        f"(4N FLOPs/token, N = {mcfg.num_params():,}, vs 989 TFLOP/s bf16), peak "
        f"memory {perf['peak_memory_gb']:.2f} GB")
    log("[train] perf " + json.dumps(perf))
    return state, dataset, cfg.lora, launches, perf


def lora_loss_and_grads(torch, model, batch):
    """One step's token-mean loss and LoRA grads (float32), dropout off."""
    from dlti_tpu_torch.training.step import causal_lm_loss

    names = [n for n, p in model.named_parameters() if p.requires_grad]
    leaves = [p for n, p in model.named_parameters() if p.requires_grad]
    grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    loss_sum, n_tok = 0.0, 0.0
    for a in range(batch["input_ids"].shape[0]):
        ids = batch["input_ids"][a]
        logits = model(ids)
        ls, nt = causal_lm_loss(logits, ids, batch["loss_mask"][a])
        del logits
        for acc, g in zip(grads, torch.autograd.grad(ls, leaves)):
            acc += g.float()
        loss_sum += ls.item()
        n_tok += nt.item()
    return loss_sum / n_tok, {n: g / n_tok for n, g in zip(names, grads)}


@contextlib.contextmanager
def noisy_kernels(torch, names, eps, seed):
    """Within the block, each named kernel wrapper of ``ops.flash_attention``
    returns its outputs (o, not lse, for K1) times (1 + eps * N(0, 1))."""
    from dlti_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def noisy(t):
        z = torch.randn(t.shape, device=t.device, generator=gen)
        return (t.float() * (1 + eps * z)).to(t.dtype)

    def wrap(name, fn):
        def f(*args, **kw):
            out = fn(*args, **kw)
            if name == "flash_fwd":
                return noisy(out[0]), out[1]
            return tuple(map(noisy, out)) if isinstance(out, tuple) else noisy(out)
        return f

    saved = {n: getattr(tfa, n) for n in names}
    for n, fn in saved.items():
        setattr(tfa, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(tfa, n, fn)


def path_difference(torch, loss_a, grads_a, loss_b, grads_b):
    ga = torch.cat([g.flatten() for g in grads_a.values()])
    gb = torch.cat([grads_b[n].flatten() for n in grads_a])
    return {"loss_rel": abs(loss_a - loss_b) / abs(loss_b),
            "grad_cosine": torch.nn.functional.cosine_similarity(ga, gb, dim=0).item(),
            "grad_rel_l2": ((ga - gb).norm() / gb.norm()).item()}


def within_step_gate(d):
    return (d["loss_rel"] <= STEP_LOSS_RTOL and d["grad_cosine"] >= STEP_GRAD_COS
            and d["grad_rel_l2"] <= STEP_GRAD_REL_L2)


def phase_train_paths(torch, state, dataset, lora):
    """The same train step (weights, batch, dropout off) through the flash
    kernels and through ``attention_impl="reference"``; then the known-wrong
    controls, each of which the gate must refuse."""
    from dlti_tpu_torch.models.interop import load_model

    model = state.model
    ref_model = load_model(dataclasses.replace(model.cfg, attention_impl="reference"),
                           dict(model.named_parameters()), "cuda", lora=lora,
                           trainable_lora=True)
    host = next(dataset.epoch(1))
    batch = {k: torch.from_numpy(host[k]).cuda() for k in ("input_ids", "loss_mask")}
    loss_k, grads_k = lora_loss_and_grads(torch, model, batch)
    loss_r, grads_r = lora_loss_and_grads(torch, ref_model, batch)
    del ref_model
    d = path_difference(torch, loss_k, grads_k, loss_r, grads_r)
    log(f"[train-paths] loss kernels {loss_k:.6f} vs reference {loss_r:.6f} (rel "
        f"{d['loss_rel']:.3e}, tol {STEP_LOSS_RTOL:.0e}); LoRA grads cosine "
        f"{d['grad_cosine']:.7f} (>= {STEP_GRAD_COS}), rel L2 {d['grad_rel_l2']:.3e} "
        f"(<= {STEP_GRAD_REL_L2})")
    controls = []
    for i, (names, eps, gated) in enumerate(STEP_CONTROLS):
        with noisy_kernels(torch, names, eps, seed=77 + i):
            loss_c, grads_c = lora_loss_and_grads(torch, model, batch)
        c = {"kernels": list(names), "eps": eps, "gated": gated,
             **path_difference(torch, loss_c, grads_c, loss_r, grads_r)}
        controls.append(c)
        log(f"[train-paths] control {'+'.join(names)} x (1 + {eps} N(0,1)): loss rel "
            f"{c['loss_rel']:.3e}, grads cosine {c['grad_cosine']:.7f}, rel L2 "
            f"{c['grad_rel_l2']:.3e} -> {'passes' if within_step_gate(c) else 'refused'}"
            f"{'' if gated else ' (not gated)'}")
    check(math.isfinite(loss_k) and d["loss_rel"] <= STEP_LOSS_RTOL,
          f"kernel-path loss {loss_k} vs reference {loss_r}")
    check(d["grad_cosine"] >= STEP_GRAD_COS and d["grad_rel_l2"] <= STEP_GRAD_REL_L2,
          f"kernel-path grads differ: {d}")
    passed = [c for c in controls if c["gated"] and within_step_gate(c)]
    check(not passed, f"the gate let known-wrong controls through: {passed}")
    return {"loss_kernels": loss_k, "loss_reference": loss_r, **d, "controls": controls}


def phase_train_profile(torch, state, dataset):
    """Where a train step's time goes: ``torch.profiler`` over one more
    optimizer step of the trainer's own step function."""
    from torch.profiler import ProfilerActivity, profile

    from dlti_tpu_torch.models.llama import derive_seed
    from dlti_tpu_torch.training.step import make_train_step

    step_fn = make_train_step(state.model, accum_steps=2)
    host = next(dataset.epoch(2))
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    step_fn(state, batch, derive_seed(43, 100))  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch, derive_seed(43, 101))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels or busy_ms == 0:
        log("[train-profile] the profiler recorded no device time: not measured")
        return None
    n_kernels = sum(e.count for e in kernels)
    log(f"[train-profile] one train step under torch.profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% busy), "
        f"{n_kernels} kernels")
    groups = {}
    for e in kernels:
        key = e.key
        if "flash_fwd_kernel" in key:
            g = "K1 flash_fwd"
        elif "flash_bwd_dq_kernel" in key:
            g = "K2 flash_bwd_dq"
        elif "flash_bwd_dkv_kernel" in key:
            g = "K3 flash_bwd_dkv"
        elif "gemm" in key.lower() or "nvjet" in key or "cutlass" in key.lower():
            g = "matmul (cuBLAS)"
        else:
            g = "other"
        t, c = groups.get(g, (0.0, 0))
        groups[g] = (t + e.self_device_time_total / 1e3, c + e.count)
    for g, (t, c) in sorted(groups.items(), key=lambda x: -x[1][0]):
        log(f"[train-profile]   {t:9.2f} ms {100 * t / busy_ms:5.1f}% x{c:<6d} {g}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        log(f"[train-profile]   top {e.self_device_time_total / 1e3:9.2f} ms x{e.count:<5d} "
            f"{e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels": n_kernels,
            "groups": {g: t for g, (t, _) in groups.items()}}


# ----------------------------------------------------------------------
# Serving slice 3: the OpenAI server and serve CLI on an int8 KV pool (K4q)
# ----------------------------------------------------------------------

SERVE_ARGS = ["--random-init", "llama2_7b", "--tokenizer", "byte",
              "--kv-cache-dtype", "int8", "--host", "127.0.0.1", "--port", "0"]


def http_request(addr, method, path, body=None, timeout=600):
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def post_json(addr, path, body):
    status, data = http_request(addr, "POST", path, body)
    check(status == 200, f"POST {path} {body} answered {status}: {data[:300]!r}")
    obj = json.loads(data)
    for c in obj["choices"]:
        check(c["finish_reason"] in ("length", "stop"),
              f"POST {path}: finish_reason {c['finish_reason']!r}")
    return obj


def post_stream(addr, path, body):
    """(deltas, final chunk) of an SSE completion; any error frame fails."""
    status, raw = http_request(addr, "POST", path, {**body, "stream": True})
    check(status == 200, f"stream {path} answered {status}")
    events = [ln[len("data: "):] for ln in raw.decode().splitlines()
              if ln.startswith("data: ")]
    check(events and events[-1] == "[DONE]", "stream did not end with [DONE]")
    chunks = [json.loads(e) for e in events[:-1]]
    check(not any("error" in c for c in chunks), f"SSE error frame: {chunks[-1]}")
    deltas = [c["choices"][0]["delta"].get("content", "") if "delta" in c["choices"][0]
              else c["choices"][0].get("text", "") for c in chunks]
    final = chunks[-1]
    check(final["choices"][0]["finish_reason"] in ("length", "stop"),
          f"stream finish_reason {final['choices'][0]['finish_reason']!r}")
    return deltas, final


def incremental_text(tok, ids):
    """The text the server streams for these token ids: the suffix of the
    running decode, token by token (a replacement character, once
    streamed, is not taken back)."""
    emitted = ""
    for i in range(1, len(ids) + 1):
        emitted += tok.decode(ids[:i])[len(emitted):]
    return emitted


def server_requests(seed=0):
    """The phase's 12 requests: 6 greedy completions of 32 tokens (prompts
    of 16-300 bytes), 2 streamed, 2 chat, 1 n=2 seeded, 1 with a stop."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ["serve", "the", "model", "int8", "cache", "token", "decode", "page",
             "block", "attention", "kernel", "of", "a", "query"]

    def text(n):
        out = ""
        while len(out) < n:
            out += str(rng.choice(words)) + " "
        return out[:n]

    lengths = [16, 300] + rng.integers(16, 301, 6).tolist()
    greedy = dict(max_tokens=32, temperature=0.0, logprobs=True)
    reqs = [("completion", "/v1/completions", {"prompt": text(n), **greedy})
            for n in lengths[:6]]
    reqs += [("stream", "/v1/completions", {"prompt": text(n), "max_tokens": 32,
                                            "temperature": 0.0})
             for n in lengths[6:8]]
    reqs += [("chat", "/v1/chat/completions", {
        "messages": [{"role": "system", "content": "Answer briefly."},
                     {"role": "user", "content": text(n)}], **greedy})
        for n in (40, 120)]
    reqs.append(("n2", "/v1/completions", {"prompt": text(64), "n": 2, "seed": 7,
                                           "max_tokens": 32, "temperature": 0.8,
                                           "top_p": 0.95, "logprobs": True}))
    reqs.append(("stop", "/v1/completions", {"prompt": text(90), "stop": ["e "],
                                             **greedy}))
    return reqs


def phase_server(torch):
    """llama2_7b from the serve CLI's own builder on an int8 pool with the
    CLI's defaults, behind ``make_server`` on a free port: 12 concurrent
    requests, then a greedy prompt twice and streamed, one at a time."""
    import threading

    from dlti_tpu_torch.cli import serve as cli
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving import make_server
    from dlti_tpu_torch.serving.server import llama2_chat_prompt

    args = cli.parse_args(SERVE_ARGS)
    check((args.max_seqs, args.num_blocks, args.block_size, args.max_model_len)
          == (8, 2048, 16, 2048), "the serve CLI's defaults changed")
    t0 = time.perf_counter()
    engine, tok, sc = cli.build(args)
    torch.cuda.synchronize()
    cfg = engine.model_cfg
    pool_bytes = sum(t.numel() * t.element_size() for c in engine.cache for t in c.values())
    scale_bytes = sum(c[k].numel() * 4 for c in engine.cache for k in ("k_scale", "v_scale"))
    check(engine.cache[0]["k"].dtype == torch.int8, "the CLI did not build an int8 pool")
    log(f"[server] {args.random_init} engine from the serve CLI builder in "
        f"{time.perf_counter() - t0:.1f} s: int8 KV pool {pool_bytes / 1e9:.3f} GB "
        f"({scale_bytes / 1e9:.3f} GB of it float32 scales; {args.num_blocks} blocks x "
        f"{args.block_size} tokens x {cfg.num_layers} layers), device memory "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    # Host time of each engine step on the stepper thread (a step ends by
    # reading its tokens back, so the device work is inside it).
    step_s = []
    real_step = engine.step

    def timed_step():
        t = time.perf_counter()
        try:
            return real_step()
        finally:
            step_s.append(time.perf_counter() - t)

    engine.step = timed_step
    httpd, aeng = make_server(engine, tok, sc)
    addr = ("127.0.0.1", httpd.server_address[1])
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        reqs = server_requests()
        results = [None] * len(reqs)
        errors = []

        def run(i, kind, path, body):
            try:
                results[i] = (post_stream(addr, path, body) if kind == "stream"
                              else post_json(addr, path, body))
            except Exception as e:  # reported, and fails the phase below
                errors.append(f"{kind} {i}: {type(e).__name__}: {e}")

        # The main path's counts start here ...
        tpa.launches = tpa.launches_int8 = 0
        tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i, *r)) for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a request did not finish")
        check(not errors, f"server requests failed: {errors}")

        # One at a time: a greedy prompt twice, then streamed.
        kind, path, body = reqs[0]
        first = post_json(addr, path, body)
        again = post_json(addr, path, body)
        deltas, final = post_stream(addr, path, {k: v for k, v in body.items()
                                                  if k != "logprobs"})
        torch.cuda.synchronize()
        launches_int8, launches_float = tpa.launches_int8, tpa.launches  # ... read here
        flash = tfa.fwd_launches + tfa.dq_launches + tfa.dkv_launches
        decode_steps = engine.stats["decode_steps"]

        completion_tokens = 0
        for (kind, path, body), res in zip(reqs, results):
            if kind == "stream":
                deltas_i, fin = res
                usage = fin["usage"]
                check(0 < usage["completion_tokens"] <= 32, f"stream usage {usage}")
            else:
                usage = res["usage"]
                n_tok = sum(len(c["logprobs"]["tokens"]) for c in res["choices"])
                check(usage["completion_tokens"] == n_tok,
                      f"{kind}: usage {usage} but {n_tok} tokens")
                check(all(len(c["logprobs"]["tokens"]) <= 32 for c in res["choices"]),
                      f"{kind}: more than max_tokens")
                check(len(res["choices"]) == body.get("n", 1), f"{kind}: choices")
                if kind == "stop":
                    check("e " not in res["choices"][0]["text"], "stop string returned")
            prompt = (body["prompt"] if "prompt" in body
                      else llama2_chat_prompt(body["messages"]))
            check(usage["prompt_tokens"] == len(tok.encode(prompt, add_bos=True)),
                  f"{kind}: prompt_tokens {usage['prompt_tokens']}")
            check(usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"],
                  f"{kind}: total_tokens")
            completion_tokens += usage["completion_tokens"]
        ids = first["choices"][0]["logprobs"]["tokens"]
        check(again["choices"][0]["logprobs"]["tokens"] == ids
              and again["choices"][0]["text"] == first["choices"][0]["text"],
              "the same greedy prompt gave two different completions")
        check("".join(deltas) == incremental_text(tok, ids),
              "streamed deltas do not concatenate to the completion's text")
        check(final["usage"]["completion_tokens"] == len(ids), "streamed usage")

        status, data = http_request(addr, "GET", "/health")
        check(status == 200 and json.loads(data) == {"status": "ok"}, f"/health {status}")
        status, metrics = http_request(addr, "GET", "/metrics")
        metrics = metrics.decode()
        n_req = [float(ln.split()[1]) for ln in metrics.splitlines()
                 if ln.startswith("dlti_requests ")]
        check(status == 200 and n_req and n_req[0] >= 12, f"/metrics dlti_requests {n_req}")
        check("# TYPE dlti_request_ttft_seconds histogram" in metrics
              and "dlti_request_ttft_seconds_count" in metrics, "no TTFT histogram")
        stats = json.loads(http_request(addr, "GET", "/stats")[1])
    finally:
        httpd.shutdown()
        aeng.shutdown()
        httpd.server_close()
        del engine.step

    expected = cfg.num_layers * decode_steps
    log(f"[server] 12 concurrent requests in {wall:.2f} s, then 3 one at a time; decode "
        f"steps {decode_steps}; K4q launches {launches_int8} (expected {cfg.num_layers} "
        f"layers x {decode_steps} steps = {expected}), float K4 launches {launches_float}")
    check(launches_int8 == expected, f"K4q launches {launches_int8} != {expected}")
    check(launches_float == 0, f"the float K4 ran {launches_float} times on an int8 pool")
    check(flash == 0, f"serving launched the flash kernels {flash} times")
    ttft, tpot = stats["request_ttft_seconds"], stats["request_tpot_seconds"]
    perf = {"requests": 12, "wall_s": wall, "requests_per_s": 12 / wall,
            "completion_tokens": completion_tokens,
            "output_tok_s": completion_tokens / wall,
            "ttft_p50_s": ttft["p50"], "ttft_p99_s": ttft["p99"],
            "tpot_mean_s": tpot["mean"], "decode_steps": decode_steps,
            "engine_steps": len(step_s), "step_ms_p50": 1e3 * sorted(step_s)[len(step_s) // 2],
            "step_ms_mean": 1e3 * sum(step_s) / len(step_s),
            "kv_pool_bytes": pool_bytes, "kv_scale_bytes": scale_bytes,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[server] {perf['requests_per_s']:.3f} requests/s, {perf['output_tok_s']:.1f} "
        f"output tok/s ({completion_tokens} tokens); TTFT p50 {ttft['p50']:.4f} s, p99 "
        f"{ttft['p99']:.4f} s (/stats, bucket-interpolated); mean TPOT "
        f"{1e3 * tpot['mean']:.2f} ms; engine step on the stepper thread p50 "
        f"{perf['step_ms_p50']:.2f} ms, mean {perf['step_ms_mean']:.2f} ms over "
        f"{len(step_s)} steps")
    log("[server] perf " + json.dumps(perf))
    return engine, launches_int8, perf


def phase_serve_cli(torch):
    """The entry point itself: ``python -m dlti_tpu_torch.cli.serve`` on the
    card (llama_tiny, int8 pool, a free port) answers /health and one
    completion, and exits 0 on SIGTERM."""
    import os
    import queue
    import re
    import signal
    import threading

    cmd = [sys.executable, "-m", "dlti_tpu_torch.cli.serve", "--random-init",
           "llama_tiny", "--tokenizer", "byte", "--kv-cache-dtype", "int8",
           "--host", "127.0.0.1", "--port", "0"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                              daemon=True)
    reader.start()
    seen, port = [], None
    try:
        deadline = time.monotonic() + 240
        while port is None and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                check(proc.poll() is None, "the serve CLI exited early:\n" + "".join(seen))
                continue
            seen.append(line)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        check(port is not None, "the serve CLI never printed its port:\n" + "".join(seen))
        check(any("on cuda" in ln for ln in seen), "the serve CLI did not run on the card")
        addr = ("127.0.0.1", port)
        status, data = http_request(addr, "GET", "/health", timeout=60)
        check(status == 200, f"CLI /health answered {status}")
        out = post_json(addr, "/v1/completions", {"prompt": "hello", "max_tokens": 8,
                                                  "temperature": 0.0})
        check(out["usage"]["completion_tokens"] > 0, f"CLI completion {out}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        check(rc == 0, f"the serve CLI exited {rc} on SIGTERM:\n" + "".join(seen[-20:]))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=10)
        proc.stdout.close()
    log(f"[serve-cli] {' '.join(cmd[1:])}: port {port}, /health 200, one completion "
        f"200 ({out['usage']}), exit 0 on SIGTERM; {time.perf_counter() - t0:.1f} s")


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this smoke test runs on the card only")
    if not (ROOT / "dlti_tpu_torch" / "csrc").is_dir():
        return fail(f"the dlti_tpu_torch package is not beside {__file__}")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    try:
        phase_card_and_build(torch)
        # 256 MB written before each timed launch: more than the 50 MB L2.
        flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
        cases, int8_cases = phase_kernel_cases(torch, flush)
        engine, launches = phase_engine(torch)
        main_path = phase_in_model(torch, engine, flush)
        phase_profile(torch, engine)
        # The serving phases hold ~23 GB (weights and KV pool): release them
        # before the training phases build their own llama2_7b.
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        flash = phase_flash_cases(torch, flush)
        state, dataset, lora, flash_launches, train_perf = phase_training(torch)
        paths = phase_train_paths(torch, state, dataset, lora)
        phase_train_profile(torch, state, dataset)
        # The trainer holds ~16 GB: release it before the int8 server's llama2_7b.
        del state, dataset
        gc.collect()
        torch.cuda.empty_cache()
        engine, int8_launches, server_perf = phase_server(torch)
        int8_main = phase_in_model(torch, engine, flush)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_cli(torch)
    except CheckFailed as e:
        return fail(str(e))

    worst = max([r["max_abs_err"] for r in cases.values()] + [main_path["max_abs_err"]])
    kernels = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "dlti_tpu_torch/csrc/paged_attention.cu",
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": worst,
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": main_path["library_ms"],
    }]
    # K4q: times and bound at the int8 engine's decode state (phase 11); the
    # error is the worst over phase 2's int8 cases and that state.
    kernels.append({
        "name": "paged_decode_attention_int8",
        "route": "cuda",
        "source": "dlti_tpu_torch/csrc/paged_attention.cu",
        "replaces": KERNEL_REPLACES + " (quantized=True)",
        "launches": int8_launches,
        "max_abs_err": max([r["max_abs_err"] for r in int8_cases.values()]
                           + [int8_main["max_abs_err"]]),
        "ms": int8_main["ms"],
        "plain_ms": int8_main["plain_ms"],
        "bound_ms": int8_main["bound_ms"],
        "bound_by": int8_main["bound_by"],
        "library_ms": int8_main["library_ms"],
    })
    # K1-K3: times and bound at the training path's shape (llama2_7b,
    # b 4, s 512, bf16, causal); the error is the worst over every case.
    at = flash["llama2_7b_train"]
    for name, replaces in FLASH_REPLACES.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dlti_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": flash_launches[name],
            "max_abs_err": max(r[name]["max_abs_err"] for r in flash.values()),
            "ms": at[name]["ms"],
            "plain_ms": at[name]["plain_ms"],
            "bound_ms": at[name]["bound_ms"],
            "bound_by": at[name]["bound_by"],
            "library_ms": at[name]["library_ms"],
        })
    log("[train] summary " + json.dumps({**{k: train_perf[k] for k in (
        "step_ms", "tokens_per_s", "mfu_percent", "peak_memory_gb")}, **paths}))
    log("[server] summary " + json.dumps(server_perf))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
