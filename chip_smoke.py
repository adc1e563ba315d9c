#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, checkpoint-to-serving and
HTTP serving paths on one NVIDIA GPU (an H100).

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
   a planted 25% scale fault in a late tile must fail the second. Each case
   prints its program and its split-K plan (splits x tokens a split).
3. The engine at full width: llama2_7b in bfloat16 from
   ``init_params(seed=0)``, its decode iteration captured as a CUDA graph
   (``warmup_decode_ladder``), 12 requests (prompts of 16 to 300 tokens,
   greedy and seeded sampling) submitted to ``InferenceEngine`` and driven
   by ``step`` with 8 slots, so admission happens mid-flight. Every request
   must finish with its token count, and K4 must have been launched once per
   layer per decode step (graph replays credit the counter with what the
   capture counted). Then an equality script (8 requests of 24-96 tokens,
   greedy and seeded, admitted in one wave) four ways: steps_per_sync 1
   eager (``EngineExecutor(cuda_graphs=False)``), 1, 8 and 64 graphed. Every
   request's tokens and logprobs must be identical across the four; each
   run prints ms per device step (host clock over each window / k), decode
   tok/s, windows and host syncs per token.
4. Inside the model, on the k = 8 graphed engine: one decode step's logits
   through K4 against the same step through the plain gather path
   (``paged_attention_impl="gather"``), and K4 against its plain version on
   the engine's real pool, tables and lengths, where its time is taken for
   the record. Then ``torch.cuda.set_sync_debug_mode("error")`` around the
   dispatch of an 8-step window: nothing in it may wait on the card.
5. Profile: ``torch.profiler`` over the next 8-step graphed window, for the
   device's busy share and the kernels by device time; K4's split kernel
   and its combine kernel must run inside the replays, as many times as the
   launch counter says. Then the LM head (F2): a decode forward profiled
   with shapes must show the head's GEMM on bf16 inputs, and its memory
   peak must stay under the float32 head copy (524 MB) it used to make. The
   engine and its KV pool are then released.
6. Flash attention K1 (forward), K2 (dq) and K3 (dk/dv) against their plain
   versions: llama2_7b's training shape, llama3_8b's GQA at s 2048,
   mistral_7b's window 4096 at s 8192, head_dim 256 and 64, float32, and a
   packed batch at the unaligned length 1000 with padding rows. Each
   kernel's program in each case (``kernel_design``: wgmma on the tensor
   cores for bf16 K1 and K2, and K3 at d 64/128, which bf16 K2 must run;
   the CUDA cores otherwise), time,
   bound, plain time and SDPA's time (forward for K1, its autograd backward
   for K2 and K3).
7. The trainer at full width: llama2_7b bf16 with LoRA r=16 on q/k/v/o
   (dropout 0.05) from ``init_params(seed=0)``, 8 steps of
   ``Trainer.train`` over ``make_batches`` (byte tokenizer, texts from a
   seeded generator, seq 512, micro-batch 4, grad-accum 2, warmup 2, lr
   2e-4, remat on), with ``save_strategy="no"`` so its numbers stay
   comparable; each step one replay of the step's CUDA graph (one capture).
   Losses and grad norms finite, every ``lora_b`` moved off zero, and K1
   launched 2 x 32 x 2 x 9 times (forward and remat recompute, over the 8
   replayed steps and the capture's eager warm-up step), K2 and K3 32 x 2 x
   9. Before it, and released before it, the same 8 steps through an eager
   ``Trainer(cuda_graphs=False)`` from the same weights: losses and grad
   norms must be bit-equal. Prints
   both runs' step ms, tokens/s, MFU (4N FLOPs per token), peak memory and
   host syncs per step. Its losses and grad norms are phase 13's and phase
   14's reference.
8. Kernel path against reference path: one step's loss and LoRA grads with
   the kernels and with ``attention_impl="reference"``, same weights and
   batch, dropout off; then known-wrong controls (the kernels' outputs given
   seeded multiplicative noise), which the same gate must refuse.
9. Profiles: one eager train step, then a window of 2 graph replays
   (``StepWindow``, captured before the profile): wall and device busy time
   a step, busy share, kernels a step, time by kernel group; K1, K2 and K3
   must appear as their wgmma kernels in both. The trainer is then
   released.
14. Windows, eval and the chunked loss (run after phase 9, before phase 13),
    llama2_7b at full width and depth: phase 7's configuration over 2
    epochs of its 12 steps with ``steps_per_sync`` 8, ``max_steps`` 16 and
    ``eval_steps`` 8 on 4 eval batches (windows of 8, 4 at the epoch's end
    and 4 to ``max_steps``; evals at steps 8 and 16): steps 1-8 must be
    bit-equal to phase 7's. Then ``loss_chunk=128`` over the same 16 steps
    and windows: step 1's loss within 1e-4 of the run without, the peak
    memory below that run's, and K1-K3 launches a step unchanged.
    Prints each run's step ms, tokens/s, peak memory and host syncs per
    step.
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
    TTFT p50/p99 and mean TPOT from ``/stats``, and the pool's bytes. Then
    the same again as the reference's documented serving configuration
    (``--max-seqs 28 --steps-per-sync 64``, bf16 weights), followed by the
    sync check on its int8 pool.
11. Inside the model on the int8 pool: one decode step's logits through K4q
    against the gather path (dequantized in float32), gated; against the
    same step on a bf16 pool, printed only (quantization error). Then K4q
    against its plain version on the engine's pool and tables, timed.
12. The entry points themselves, as subprocesses on the card: ``python -m
    dlti_tpu_torch.cli.serve --random-init llama_tiny --tokenizer byte
    --kv-cache-dtype int8 --steps-per-sync 4 --port 0`` answers ``/health``
    and a completion and exits 0 on SIGTERM. Then, on ``llama_300m`` (head
    dim 64, which K1-K3 take): ``cli.train --max-steps 4 --save-steps 2
    --output-dir D --export-dir E`` exits 0 leaving steps 2 and 4 in D;
    ``cli.export --checkpoint-dir D --out E2`` prints the digest of E's
    params; ``cli.serve --model-dir E --port 0`` answers ``/health`` and a
    completion and exits 0 on SIGTERM.
13. Train -> checkpoint -> resume -> export -> serve (run after phase 14,
    before the servers), llama2_7b at full width and full depth (``layers
    32 of 32``; a checkpoint is ~13.7 GB, and ``shutil.disk_usage`` must
    show room for two checkpoints and an export, ~41 GB, or the phase
    fails with the number), in a temporary directory the phase removes. A
    fresh ``Trainer`` (phase 7's config, ``save_steps=4``,
    ``save_total_limit=2``, async) commits step 4; a second fresh one,
    from other random weights, resumes from step 4 (its log says so), runs
    steps 5-8 (each trainer its own CUDA graph of the step), whose losses
    and grad norms must be bit-equal to phase 7's, and commits step 8. ``verify_checkpoint`` passes both steps. The step-8
    checkpoint is exported through ``cli.export``'s function, merged on the
    card; its manifest digest must equal that of ``merge_lora_params`` of
    the live resumed state, and its ``config.json`` has LoRA off. An engine
    from ``cli.serve.build --model-dir <export> --tokenizer byte`` (bf16
    pool, the CLI's defaults: 8 slots, max_model_len 2048, so 128-block
    tables) serves 4 greedy requests, with K4 counted 32 x decode steps.
    Then phase 4's check on that engine, whose tables give K4 a split plan
    no other phase holds: one decode step's logits through K4 against the
    gather path, and K4 against its plain version on the engine's own pool
    and tables (these launches are not counted).
    Prints the host's rates (SHA-256, pinning, copies from the card), the
    loop's stall per save, the writer's seconds and GB per save, write+hash
    GB/s, restore, export and load seconds, and free disk, beside the
    card's name and power limit.

Prints a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero without that line when
there is no CUDA device, when the package is not beside this file, or when
any check fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import logging
import math
import re
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

# GPU cycles the card spins before each timed call (about 0.5 ms): the host
# prepares the call meanwhile, so the start event does not wait on it.
HOST_COVER_CYCLES = 1_000_000


def time_ms(torch, fn, iters: int = 20, flush=None) -> float:
    """Mean device time of ``fn`` by CUDA events around each call. With
    ``flush`` (a large buffer), L2 is overwritten before every call, as the
    next layer's decode finds it. A spin kernel queued ahead of the start
    event covers the wrapper's host time (argument checks, ctypes), so a
    short kernel's reading is the card's time, not the host's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(HOST_COVER_CYCLES)
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
    splits, chunk = tpa.last_plan  # the plan this launch ran
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
            "library_ms": library_ms, "bytes": nbytes, "ops": ops, "splits": splits,
            "chunk": chunk, "design": tpa.kernel_design(k_pool.dtype, q.shape[3])}


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
        log(f"[kernel] {name} ({r['design']}; {r['splits']} splits of {r['chunk']} "
            f"tokens): max_abs_err {r['max_abs_err']:.3e} (tol "
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


def card_engine(cfg, params, ec, graphs=True):
    """An engine on the card; ``graphs=False`` runs the decode iteration
    eagerly (the executor's constructor argument, for comparisons only)."""
    from dlti_tpu_torch.serving.engine import EngineExecutor, InferenceEngine

    ex = EngineExecutor(cfg, params, ec, device="cuda", cuda_graphs=graphs)
    return InferenceEngine(cfg, params, ec, device="cuda", executor=ex)


def window_clock(engine) -> list:
    """(k, seconds) of each decode window on the host clock, from the start
    of its dispatch to the end of its completion (which waits for it)."""
    spans, t = [], {}
    dispatch, complete = engine._decode_dispatch, engine._decode_complete

    def timed_dispatch():
        t["start"] = time.perf_counter()
        return dispatch()

    def timed_complete(pending):
        out = complete(pending)
        spans.append((pending[1], time.perf_counter() - t["start"]))
        return out

    engine._decode_dispatch, engine._decode_complete = timed_dispatch, timed_complete
    return spans


def free_memory(torch):
    """Return the memory of objects just dropped to the card."""
    gc.collect()
    torch.cuda.empty_cache()


# Phase 3's equality script: one wave of 8 requests (every slot admitted in
# the first step, so prefill groups and batch shapes match across runs),
# greedy and seeded, run four ways.
EQUALITY_RUNS = (("k=1 eager", 1, False), ("k=1 graph", 1, True),
                 ("k=8 graph", 8, True), ("k=64 graph", 64, True))
EQUALITY_LENGTHS = [16, 40, 77, 128, 200, 255, 300, 511]
EQUALITY_MAX_TOKENS = [24, 96, 33, 64, 48, 80, 57, 72]


def equality_requests(cfg):
    import numpy as np

    from dlti_tpu_torch.serving.sampling import SamplingParams

    rng = np.random.default_rng(2)
    out = []
    for i, (n, m) in enumerate(zip(EQUALITY_LENGTHS, EQUALITY_MAX_TOKENS)):
        sp = (SamplingParams(temperature=0.0, max_tokens=m) if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_p=0.95, top_k=50, max_tokens=m,
                             seed=2000 + i))
        out.append((rng.integers(3, cfg.vocab_size, n).tolist(), sp))
    return out


def phase_engine(torch):
    from dlti_tpu_torch.config import MODEL_PRESETS
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving.engine import EngineConfig
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
    engine = card_engine(cfg, params, ec)
    t0 = time.perf_counter()
    engine.warmup_decode_ladder()  # captures the decode graph, as the CLI does
    torch.cuda.synchronize()
    log(f"[engine] KV pool {sum(c['k'].numel() * 2 * c['k'].element_size() for c in engine.cache) / 1e9:.2f} GB, "
        f"decode graph captured in {time.perf_counter() - t0:.2f} s, device memory "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    rng = np.random.default_rng(0)
    lengths = [16, 300] + rng.integers(16, 301, 10).tolist()
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in lengths]
    max_tokens = 32

    # Device time of each prefill call and decode window, by CUDA events on
    # the stream around the executor's two calls.
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
    ex.decode_window = timed("decode", ex.decode_window)

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
    del ex.prefill, ex.decode_window
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
    log(f"[engine] {len(results)} requests done in {wall:.2f} s (decode graph, "
        f"steps_per_sync 1); decode steps {stats['decode_steps']}, prefill batches "
        f"{stats['prefill_batches']}, preemptions {stats['preemptions']}; decode state "
        f"uploads {stats['decode_state_uploads']} ({stats['decode_state_rows']} rows), "
        f"clean syncs {stats['decode_state_clean_syncs']}; kernel launches {launches} "
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
        f"ms/step at up to {ec.max_seqs} slots, CUDA events around each window)")
    log("[engine] perf " + json.dumps(perf))
    del engine
    free_memory(torch)

    # The equality script, four ways. Tokens and logprobs must be identical.
    runs, keep = {}, None
    for name, k, graphs in EQUALITY_RUNS:
        eng = card_engine(cfg, params, dataclasses.replace(ec, steps_per_sync=k), graphs)
        eng.warmup_decode_ladder()
        tpa.launches = 0
        windows = window_clock(eng)
        reqs = [eng.submit(p, sp) for p, sp in equality_requests(cfg)]
        while eng.has_work:
            eng.step()
        torch.cuda.synchronize()
        st = eng.stats
        check(all(r.finish_reason == "length" for r in reqs), f"{name}: a request stopped early")
        check(tpa.launches == cfg.num_layers * st["decode_steps"],
              f"{name}: K4 launches {tpa.launches} != {cfg.num_layers} x {st['decode_steps']}")
        secs = sum(s for _, s in windows)
        run = {"ms_per_device_step": 1e3 * secs / st["decode_steps"],
               "decode_tok_s": st["decode_slot_steps"] / secs,
               "windows": len(windows), "decode_steps": st["decode_steps"],
               "decode_tokens": st["decode_slot_steps"],
               "host_syncs_per_token": len(windows) / st["decode_slot_steps"],
               "k4_launches": tpa.launches,
               "state_uploads": st["decode_state_uploads"],
               "clean_syncs": st["decode_state_clean_syncs"],
               "outputs": [(r.output_token_ids, r.output_logprobs) for r in reqs]}
        runs[name] = run
        log(f"[equality] {name}: {run['ms_per_device_step']:.3f} ms per device step "
            f"(host clock over each window / k), decode {run['decode_tok_s']:.1f} tok/s, "
            f"{run['windows']} windows over {run['decode_steps']} device steps, "
            f"{run['host_syncs_per_token']:.4f} host syncs per token; K4 launches "
            f"{tpa.launches}; state uploads {run['state_uploads']}, clean syncs "
            f"{run['clean_syncs']}")
        del eng._decode_dispatch, eng._decode_complete
        if k == 8:
            keep = eng  # phases 4 and 5 run on the k = 8 graphed engine
        del eng
        free_memory(torch)
    first = runs[EQUALITY_RUNS[0][0]]["outputs"]
    for name, run in runs.items():
        for i, (got, want) in enumerate(zip(run["outputs"], first)):
            check(got[0] == want[0], f"{name}: request {i}'s tokens differ from "
                  f"{EQUALITY_RUNS[0][0]}'s")
            check(got[1] == want[1], f"{name}: request {i}'s logprobs differ from "
                  f"{EQUALITY_RUNS[0][0]}'s")
    log(f"[equality] tokens and logprobs identical across {', '.join(runs)} "
        f"({sum(len(t) for t, _ in first)} tokens, max_tokens {EQUALITY_MAX_TOKENS})")
    perf["equality"] = {n: {k: v for k, v in r.items() if k != "outputs"}
                        for n, r in runs.items()}
    log("[equality] perf " + json.dumps(perf["equality"]))
    return keep, launches, perf


def phase_in_model(torch, engine, flush, max_tokens=4):
    """One decode step's logits, kernel path against gather path (an int8
    pool's window dequantized in float32), gated, on a batch of 8 freshly
    prefilled sequences (``max_tokens`` each, so the engine's later windows
    can run on). On an int8 pool also against the same step on a bf16 pool,
    printed only: that is quantization error, not a kernel fault. Then the
    kernel against its plain version on the engine's layer-0 pool and
    tables, timed."""
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
                      SamplingParams(temperature=0.0, max_tokens=max_tokens))
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
    log(f"{tag} {kname} on the engine's pool (seq_lens {lens.tolist()}; {r['design']}; "
        f"{r['splits']} splits of {r['chunk']} tokens): "
        f"max_abs_err {r['max_abs_err']:.3e} (tol {r['tol']:.3e}), row rel "
        f"{r['row_rel_err']:.3e} (tol {ROW_REL_TOL:.3e}); kernel "
        f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
        f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms")
    check(r["max_abs_err"] <= r["tol"], f"{kname} disagrees on the engine's pool")
    check(r["row_rel_err"] <= ROW_REL_TOL, f"{kname} disagrees on the engine's pool "
          f"relative to its rows: {r['row_rel_err']}")
    return {**r, **extra}


def sync_check(torch, engine, tag, submit=False):
    """``torch.cuda.set_sync_debug_mode("error")`` around the dispatch of an
    8-step decode window: growing tables, syncing the resident state,
    uploading ids and positions and replaying the graph must not wait on
    the card. With ``submit``, first admits 8 greedy requests of 9 tokens
    (8 left after prefill: an 8-step window)."""
    import numpy as np

    from dlti_tpu_torch.serving.sampling import SamplingParams

    if submit:
        rng = np.random.default_rng(3)
        for n in [40, 77, 128, 129, 200, 255, 300, 511]:
            engine.submit(rng.integers(3, engine.model_cfg.vocab_size, n).tolist(),
                          SamplingParams(temperature=0.0, max_tokens=9))
        engine.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = engine._decode_dispatch()
    except RuntimeError as e:
        raise CheckFailed(f"{tag}: the decode dispatch synchronized: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(pending is not None and pending[1] == 8,
          f"{tag}: expected an 8-step window, got {pending and pending[1]}")
    engine._decode_complete(pending)
    log(f"{tag} sync check: set_sync_debug_mode('error') around the dispatch of an "
        f"8-step graphed window on a {engine.cfg.cache_dtype} pool "
        f"({len(pending[0])} active slots): no synchronization")


def phase_profile(torch, engine):
    """Where a graphed decode window's time goes: ``torch.profiler`` over
    the engine's remaining decode window (8 active slots, k = 8). Device
    busy time is the sum of the kernels' own device time; the rest of the
    wall time the card idles. K4's split and combine kernels must appear
    inside the replays, once per layer per device step each, as the launch
    counter says."""
    from torch.profiler import ProfilerActivity, profile

    from dlti_tpu_torch.ops import paged_attention as tpa

    steps0, calls, launches0 = engine.stats["decode_steps"], 0, tpa.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while engine.has_work:
            engine.step()
            calls += 1
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    steps = engine.stats["decode_steps"] - steps0
    launches = tpa.launches - launches0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(steps > 0, "no decode step left to profile")
    if not kernels or busy_ms == 0:
        log("[profile] the profiler recorded no device time: not measured")
        return None
    n_kernels = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[profile] {steps} device decode steps in {calls} engine step(s) under "
        f"torch.profiler (graph replays): wall {wall_ms / steps:.2f} ms/step, device "
        f"busy {busy_ms / steps:.2f} ms/step ({100 * busy_ms / wall_ms:.1f}% busy, "
        f"{100 - 100 * busy_ms / wall_ms:.1f}% idle), {n_kernels / steps:.0f} kernels/step")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% x{e.count // steps:<4d} "
            f"{e.key[:90]}")
    # K4 as split-K: its split kernel and its combine kernel, each once per
    # layer per device step.
    k4 = {}
    for e in kernels:
        for name in ("paged_decode_kernel", "paged_decode_combine_kernel"):
            if name in e.key:
                t, c = k4.get(name, (0.0, 0))
                k4[name] = (t + e.self_device_time_total / 1e3, c + e.count)
    log("[profile] K4 by kernel: " + "; ".join(
        f"{n} {t / steps:.3f} ms/step, {c} launches" for n, (t, c) in sorted(k4.items()))
        + f"; launch counter {launches} (= {launches // max(steps, 1)} x {steps} steps)")
    check(set(k4) == {"paged_decode_kernel", "paged_decode_combine_kernel"},
          f"the graphed window did not run K4's split and combine kernels: {sorted(k4)}")
    layers = engine.model_cfg.num_layers
    check(launches == layers * steps, f"K4 counter {launches} != {layers} x {steps}")
    check(all(c == launches for _, c in k4.values()),
          f"the profiler's K4 kernels {k4} disagree with the counter {launches}")
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "busy_ms_per_step": busy_ms / steps, "busy_share": busy_ms / wall_ms,
            "kernels_per_step": n_kernels / steps,
            "k4_ms_per_step": sum(t for t, _ in k4.values()) / steps}


def phase_head(torch, engine):
    """F2: one decode-shaped forward of the engine's model (8 rows, every
    K/V write into the trash block), profiled with shapes. The LM head's
    GEMM must take bf16 inputs, and the forward's memory peak must stay
    under the float32 head copy it used to make."""
    from torch.profiler import ProfilerActivity, profile

    cfg = engine.model_cfg
    dev = engine.device
    S = 8
    ids = torch.ones((S, 1), dtype=torch.long, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[:, None]
    tables = torch.zeros((S, engine.cfg.max_blocks_per_seq), dtype=torch.int32, device=dev)
    head_f32 = cfg.hidden_size * cfg.vocab_size * 4
    with torch.no_grad():
        engine.model(ids, positions=pos, cache=engine.cache, block_tables=tables)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine.model(ids, positions=pos, cache=engine.cache, block_tables=tables)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            engine.model(ids, positions=pos, cache=engine.cache, block_tables=tables)
            torch.cuda.synchronize()
    # The trace's op events carry their inputs' dims and types.
    trace_path = ROOT / "build" / "head_profile.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    shape = [cfg.hidden_size, cfg.vocab_size]
    heads = [e for e in events if e.get("name") == "aten::mm"
             and shape in (e.get("args", {}).get("Input Dims") or [])]
    check(len(heads) == 1, f"expected one head GEMM in the profile, found {len(heads)}")
    args = heads[0]["args"]
    dtypes = args.get("Input type") or []
    op_id = args.get("External id")
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"
                      and e.get("args", {}).get("External id") == op_id})
    log(f"[head] LM head GEMM: aten::mm input dims {args.get('Input Dims')}, input "
        f"types {dtypes}, kernels {kernels}")
    check(len(dtypes) >= 2 and all("BFloat16" in str(d) for d in dtypes[:2]),
          f"the head GEMM's inputs are {dtypes}, not bf16")
    log(f"[head] decode forward memory peak over the allocated base: {peak / 1e6:.1f} MB "
        f"(the float32 head copy alone was {head_f32 / 1e6:.1f} MB)")
    check(peak < head_f32, f"a decode forward still peaks at {peak} B >= {head_f32} B")
    return {"head_input_dtypes": dtypes, "head_kernels": kernels,
            "decode_forward_peak_mb": peak / 1e6, "f32_head_copy_mb": head_f32 / 1e6}


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
            r[kname] = {"design": tfa.kernel_design(kname, dtype, d),
                        "ms": times[kname], "bound_ms": bound_ms, "bound_by": bound_by,
                        "plain_ms": plain_fwd if fwd else plain_bwd,
                        "library_ms": lib_fwd if fwd else lib_bwd,
                        "max_abs_err": errs["o"] if fwd else (
                            errs["dq"] if kname == "flash_bwd_dq"
                            else max(errs["dk"], errs["dv"])),
                        "bytes": nbytes, "ops": ops}
        if dtype == bf16:
            check(r["flash_bwd_dq"]["design"].startswith("wgmma"),
                  f"{name}: bf16 K2 did not run its wgmma program")
        results[name] = r
        log(f"[flash] {name} (b {b}, s {s}, h {h}/{hkv}, d {d}, {dtype_name}"
            f"{', window %d' % window if window else ''}{', packed' if segs is not None else ''}): "
            f"max abs err o {errs['o']:.3e} dq {errs['dq']:.3e} dk {errs['dk']:.3e} "
            f"dv {errs['dv']:.3e} lse {lse_err:.2e}")
        for kname, label in zip(FLASH_REPLACES, ("K1", "K2", "K3")):
            x = r[kname]
            log(f"[flash]   {label} {kname} ({'bf16' if dtype == bf16 else 'fp32'}: "
                f"{x['design']}): {x['ms']:.4f} ms, bound {x['bound_ms']:.4f} ms by "
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


TRAIN_STEPS = 8
MODEL_LAYERS = 32  # llama2_7b


def train_config(checkpoint, max_steps, num_layers=None):
    """Phase 7's configuration (and phase 13's): llama2_7b LoRA r=16 on
    q/k/v/o, bf16, seq 512, micro-batch 4 x accum 2, warmup 2, lr 2e-4,
    remat, with an explicit checkpoint config."""
    from dlti_tpu_torch.config import (
        MODEL_PRESETS, Config, DataConfig, LoRAConfig, OptimizerConfig, TrainConfig,
    )

    mcfg = MODEL_PRESETS["llama2_7b"]
    if num_layers is not None:
        mcfg = dataclasses.replace(mcfg, num_layers=num_layers)
    return Config(model=mcfg, lora=LoRAConfig(),
                  optimizer=OptimizerConfig(learning_rate=2e-4, warmup_steps=2),
                  data=DataConfig(max_seq_len=512, tokenizer="byte"),
                  checkpoint=checkpoint,
                  train=TrainConfig(micro_batch_size=4, grad_accum_steps=2,
                                    max_steps=max_steps, logging_steps=1))


def train_perf(record, mcfg) -> dict:
    return {
        "steps": record.steps, "losses": record.losses, "grad_norms": record.grad_norms,
        "step_times_s": record.step_times_s, "step_ms": 1e3 * record.step_time_s,
        "tokens_per_step": record.tokens_per_step,
        "tokens_per_s": record.tokens_per_second, "mfu_percent": record.mfu_percent,
        "peak_memory_gb": record.peak_memory_gb, "windows": record.windows,
        "host_syncs_per_step": record.host_syncs_per_step, "captures": record.captures,
        "num_params": mcfg.num_params(), "trainable_params": record.trainable_params,
    }


def log_train_perf(tag, perf, mcfg):
    log(f"{tag} losses {[round(x, 4) for x in perf['losses']]}")
    log(f"{tag} grad norms {[round(x, 4) for x in perf['grad_norms']]}")
    log(f"{tag} step {perf['step_ms']:.1f} ms (mean of the steps after the first window "
        f"and step 2), {perf['tokens_per_s']:.1f} tokens/s, MFU {perf['mfu_percent']:.2f}% "
        f"(4N FLOPs/token, N = {mcfg.num_params():,}, vs 989 TFLOP/s bf16), peak memory "
        f"{perf['peak_memory_gb']:.2f} GB, {perf['windows']} windows, host syncs per step "
        f"{perf['host_syncs_per_step']:.3f}, graph captures {perf['captures']}")


def flash_counts(tfa) -> dict:
    return {"flash_fwd": tfa.fwd_launches, "flash_bwd_dq": tfa.dq_launches,
            "flash_bwd_dkv": tfa.dkv_launches}


def flash_expected(layers, accum, steps) -> dict:
    """K1 twice per layer per microbatch under remat (forward and
    recompute), K2 and K3 once."""
    n = layers * accum * steps
    return {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def phase_training(torch):
    """llama2_7b LoRA (r=16, bf16, seq 512, micro-batch 4 x accum 2, remat)
    for 8 steps through an eager ``Trainer(cuda_graphs=False)`` (the
    yardstick, released), then through ``Trainer.train`` on the same
    weights and ``make_batches`` output with the step as a CUDA graph (the
    main path, whose launches are counted)."""
    from dlti_tpu_torch.config import CheckpointConfig
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.training import Trainer

    # Phase 7 keeps its numbers comparable with earlier runs: no checkpoints.
    cfg = train_config(CheckpointConfig(save_strategy="no"), max_steps=TRAIN_STEPS)
    mcfg = cfg.model
    steps, accum, micro, seq = (TRAIN_STEPS, cfg.train.grad_accum_steps,
                                cfg.train.micro_batch_size, cfg.data.max_seq_len)
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
    # The yardstick first, released before the main path: the same steps
    # eagerly, from the same weights.
    eager_trainer = Trainer(cfg, params=params, device="cuda", cuda_graphs=False)
    eager_state, eager = eager_trainer.train(dataset=dataset)
    del eager_state, eager_trainer, params
    free_memory(torch)

    trainer = Trainer(cfg, params=init_params(mcfg, seed=0, device="cuda", lora=cfg.lora),
                      device="cuda")
    state = trainer.init_state()
    tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
    tpa.launches = 0  # the main path's counts start here ...
    state, record = trainer.train(dataset=dataset, state=state)
    torch.cuda.synchronize()
    launches = flash_counts(tfa)  # ... and are read here
    check(tpa.launches == 0, "training launched the decode kernel")
    layers = mcfg.num_layers
    # The capture's eager warm-up step launches K1-K3 once for real.
    want = flash_expected(layers, accum, steps + record.captures)
    log(f"[train] {record.steps} steps as a CUDA graph ({record.captures} capture); "
        f"launches {launches} (expected {want}: K1 twice per layer per microbatch under "
        f"remat, K2/K3 once, over {steps} replayed steps and the capture's warm-up step)")
    check(record.captures == 1, f"{record.captures} graph captures, expected 1")
    check(launches == want, f"flash launches {launches} != {want}")
    check(record.steps == steps, f"{record.steps} steps, expected {steps}")
    check(all(math.isfinite(x) for x in record.losses + record.grad_norms),
          f"nonfinite losses {record.losses} or grad norms {record.grad_norms}")
    check(record.skipped_updates == 0, "an update was skipped")
    lora_b = {n: p for n, p in state.model.named_parameters() if n.endswith("lora_b")}
    check(len(lora_b) == 4 * layers, f"{len(lora_b)} lora_b leaves")
    still_zero = [n for n, p in lora_b.items() if not p.detach().abs().max().item() > 0]
    check(not still_zero, f"lora_b still zero: {still_zero[:3]}")
    perf = train_perf(record, mcfg)
    log_train_perf("[train]", perf, mcfg)
    perf["eager"] = train_perf(eager, mcfg)
    log_train_perf("[train-eager]", perf["eager"], mcfg)
    same = eager.losses == record.losses and eager.grad_norms == record.grad_norms
    log(f"[train] graphed {perf['step_ms']:.1f} ms a step, {perf['tokens_per_s']:.1f} "
        f"tokens/s, peak {perf['peak_memory_gb']:.2f} GB; eager "
        f"{perf['eager']['step_ms']:.1f} ms, {perf['eager']['tokens_per_s']:.1f} tokens/s, "
        f"peak {perf['eager']['peak_memory_gb']:.2f} GB; losses and grad norms bit-equal: "
        f"{same}")
    check(same, f"graphed losses {record.losses} / grad norms {record.grad_norms} differ "
          f"from eager {eager.losses} / {eager.grad_norms}")
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


def train_profile_groups(torch, prof, wall_ms, steps, tag):
    """Device time by kernel group of a profiled run of ``steps`` train
    steps; K1, K2 and K3 must show up as their wgmma kernels."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels or busy_ms == 0:
        log(f"{tag} the profiler recorded no device time: not measured")
        return None
    n_kernels = sum(e.count for e in kernels)
    log(f"{tag} {steps} train step(s) under torch.profiler: wall {wall_ms / steps:.1f} ms "
        f"a step, device busy {busy_ms / steps:.1f} ms a step ({100 * busy_ms / wall_ms:.1f}% "
        f"busy), {n_kernels / steps:.0f} kernels a step")
    groups, flash_names = {}, {}
    for e in kernels:
        key = e.key
        # K1, K2 and K3 in bf16 are flash_fwd_wgmma_kernel,
        # flash_bwd_dq_wgmma_kernel and flash_bwd_dkv_wgmma_kernel; the
        # CUDA-core programs drop "_wgmma".
        kernel = re.search(r"flash_\w+_kernel", key)
        for label, name in (("K1", "flash_fwd"), ("K2", "flash_bwd_dq"),
                            ("K3", "flash_bwd_dkv")):
            if kernel and kernel.group(0).startswith(name + "_"):
                g = f"{label} {name}"
                flash_names.setdefault(label, set()).add(kernel.group(0))
                break
        else:
            if "gemm" in key.lower() or "nvjet" in key or "cutlass" in key.lower():
                g = "matmul (cuBLAS)"
            else:
                g = "other"
        t, c = groups.get(g, (0.0, 0))
        groups[g] = (t + e.self_device_time_total / 1e3, c + e.count)
    for g, (t, c) in sorted(groups.items(), key=lambda x: -x[1][0]):
        log(f"{tag}   {t / steps:9.2f} ms a step {100 * t / busy_ms:5.1f}% x{c // steps:<6d} {g}")
    log(f"{tag} flash kernels by name: "
        + "; ".join(f"{k}: {', '.join(sorted(v))}" for k, v in sorted(flash_names.items())))
    for label in ("K1", "K2", "K3"):
        check(any("wgmma" in n for n in flash_names.get(label, ())),
              f"{tag} the train step's {label} did not run its wgmma kernel: {flash_names}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        log(f"{tag}   top {e.self_device_time_total / 1e3 / steps:9.2f} ms a step "
            f"x{e.count // steps:<5d} {e.key[:90]}")
    return {"wall_ms": wall_ms / steps, "busy_ms": busy_ms / steps,
            "busy_share": busy_ms / wall_ms, "kernels": n_kernels / steps,
            "groups": {g: t / steps for g, (t, _) in groups.items()}}


PROFILE_WINDOW = 2


def phase_train_profile(torch, state, dataset):
    """Where a train step's time goes: ``torch.profiler`` over one eager
    optimizer step of the trainer's own step function, then over a window
    of ``PROFILE_WINDOW`` graph replays (``StepWindow``, captured before
    the profile)."""
    from torch.profiler import ProfilerActivity, profile

    from dlti_tpu_torch.training.step import StepWindow, make_train_step, step_seed
    from dlti_tpu_torch.utils.device import to_host

    step_fn = make_train_step(state.model, accum_steps=2)
    hosts = list(dataset.epoch(2))[:2 + PROFILE_WINDOW]
    batch = {k: torch.from_numpy(v).cuda() for k, v in hosts[0].items()}
    step_fn(state, batch, step_seed(43, 100))  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch, step_seed(43, 101))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    eager = train_profile_groups(torch, prof, wall_ms, 1, "[train-profile eager]")

    window = StepWindow(state.model, accum_steps=2, seed=43, capacity=PROFILE_WINDOW)
    to_host(window.run(state, hosts[1:2], 102))  # the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rows = to_host(window.run(state, hosts[2:], 103))[0]
        wall_ms = 1e3 * (time.perf_counter() - t0)
    window.release()
    check(all(math.isfinite(x) for x in rows[:, 0]), f"graphed window losses {rows[:, 0]}")
    graphed = train_profile_groups(torch, prof, wall_ms, PROFILE_WINDOW,
                                   "[train-profile graph]")
    return {"eager": eager, "graph": graphed}


# ----------------------------------------------------------------------
# Train-window slice 8: steps_per_sync windows, eval, loss_chunk
# ----------------------------------------------------------------------

WINDOW_K = 8
WINDOW_STEPS = 16
WINDOW_EVAL_BATCHES = 4
LOSS_CHUNK = 128
# Step 1 of the loss_chunk run against the run without, the same weights
# and batch: the chunked loss sums the same token losses in another order
# and its head GEMMs have other shapes, so cuBLAS may round the float32
# logits differently; the relative difference stays far below this.
LOSS_CHUNK_STEP1_RTOL = 1e-4


def phase_train_window(torch, reference):
    """Phase 14 (run after phase 9): llama2_7b at full width and depth,
    ``steps_per_sync`` 8 over 16 steps with ``eval_steps`` 8 on 4 eval
    batches, then ``loss_chunk=128`` over the same 16 steps; see the module
    docstring."""
    from dlti_tpu_torch.config import CheckpointConfig
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.training import Trainer

    base = train_config(CheckpointConfig(save_strategy="no"), max_steps=WINDOW_STEPS)
    base = dataclasses.replace(base, train=dataclasses.replace(base.train, num_epochs=2))
    mcfg, accum = base.model, base.train.grad_accum_steps
    # Phase 7's batches: 12 steps an epoch, so the 16 steps run as windows
    # of 8, 4 (the epoch's end) and 4 (max_steps).
    dataset = make_batches(training_texts(), ByteTokenizer(), seq_len=512,
                           micro_batch_size=4, grad_accum_steps=accum)
    check(dataset.steps_per_epoch() == 12, "phase 7's dataset changed")
    windows = {"window": 3, "loss_chunk": 3}
    eval_dataset = make_batches(training_texts(4 * WINDOW_EVAL_BATCHES, seed=11),
                                ByteTokenizer(), seq_len=512, micro_batch_size=4,
                                grad_accum_steps=1, shuffle_seed=None)
    check(eval_dataset.steps_per_epoch() == WINDOW_EVAL_BATCHES, "eval dataset size")
    perf = {}
    runs = {"window": dataclasses.replace(base, train=dataclasses.replace(
                base.train, steps_per_sync=WINDOW_K, eval_steps=WINDOW_K)),
            "loss_chunk": dataclasses.replace(base, train=dataclasses.replace(
                base.train, steps_per_sync=WINDOW_K, loss_chunk=LOSS_CHUNK))}
    for name, cfg in runs.items():
        trainer = Trainer(cfg, params=init_params(mcfg, seed=0, device="cuda",
                                                  lora=cfg.lora), device="cuda")
        tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
        state, rec = trainer.train(dataset=dataset, eval_dataset=eval_dataset)
        torch.cuda.synchronize()
        launches = flash_counts(tfa)
        del state, trainer
        free_memory(torch)
        steps = cfg.train.max_steps
        p = train_perf(rec, mcfg)
        p.update(launches=launches, eval_steps=rec.eval_steps, eval_losses=rec.eval_losses)
        perf[name] = p
        log_train_perf(f"[train-{name}]", p, mcfg)
        want = flash_expected(mcfg.num_layers, accum, steps + rec.captures)
        # Each eval runs K1 once per layer per eval batch (no backward).
        want["flash_fwd"] += mcfg.num_layers * WINDOW_EVAL_BATCHES * len(rec.eval_steps)
        log(f"[train-{name}] launches {launches} (expected {want}); evals at steps "
            f"{rec.eval_steps}, losses {[round(x, 4) for x in rec.eval_losses]}")
        # Both runs: K1-K3 launches a step as phase 7's, loss_chunk or not.
        check(rec.steps == steps and rec.captures == 1 and launches == want,
              f"{name}: {rec.steps} steps, {rec.captures} captures, launches {launches}")
        check(rec.windows == windows[name], f"{name}: {rec.windows} windows, "
              f"expected {windows[name]}")
        check(all(math.isfinite(x) for x in rec.losses + rec.eval_losses),
              f"{name}: losses {rec.losses}, eval losses {rec.eval_losses}")
    win, chunk = perf["window"], perf["loss_chunk"]
    first = reference["losses"][:TRAIN_STEPS]
    check(win["losses"][:TRAIN_STEPS] == first
          and win["grad_norms"][:TRAIN_STEPS] == reference["grad_norms"][:TRAIN_STEPS],
          f"k={WINDOW_K} steps 1-{TRAIN_STEPS} {win['losses'][:TRAIN_STEPS]} are not "
          f"bit-equal to phase 7's k=1 graphed {first}")
    check(win["eval_steps"] == [WINDOW_K, WINDOW_STEPS], f"evals at {win['eval_steps']}")
    rel = [abs(a - b) / abs(b) for a, b in zip(chunk["losses"], win["losses"])]
    log(f"[train-loss_chunk] losses against the run without: relative differences "
        f"{[f'{r:.2e}' for r in rel]} (step 1 limit {LOSS_CHUNK_STEP1_RTOL:.0e}); peak "
        f"memory {chunk['peak_memory_gb']:.2f} GB against {win['peak_memory_gb']:.2f} GB "
        f"without loss_chunk")
    check(rel[0] <= LOSS_CHUNK_STEP1_RTOL, f"loss_chunk step 1 loss rel {rel[0]:.2e}")
    check(chunk["peak_memory_gb"] < win["peak_memory_gb"],
          f"loss_chunk peak {chunk['peak_memory_gb']:.2f} GB is not below "
          f"{win['peak_memory_gb']:.2f} GB")
    perf["losses_bit_equal_to_k1"] = True
    perf["loss_chunk_loss_rel"] = rel
    log("[train-window] perf " + json.dumps(perf))
    return perf


# ----------------------------------------------------------------------
# Checkpoint slice 7: train -> checkpoint -> resume -> export -> serve
# ----------------------------------------------------------------------

# Phase 13's depth: llama2_7b at full width and full depth. A checkpoint is
# ~13.7 GB (the 13.5 GB bf16 base, LoRA factors and float32 moments); two
# checkpoints and an export need ~41 GB of disk.
CKPT_LAYERS = 32
CKPT_SAVE_STEPS = 4
CKPT_REQUESTS = 4
CKPT_NEW_TOKENS = 16
# Free space the phase needs beyond its three artifacts.
CKPT_DISK_MARGIN = 2 << 30


class LogLines(logging.Handler):
    """Keeps the messages of the records it is handed."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def tree_bytes(step_dir) -> int:
    """Bytes of every file a manifest lists."""
    manifest = json.loads((Path(step_dir) / "MANIFEST.json").read_text())
    return sum(e["size"] for e in manifest["leaves"]) + sum(
        m["size"] for m in manifest["meta_files"].values())


def host_rates(torch) -> dict:
    """The host's side of a checkpoint, on 1 GiB: SHA-256 on one core,
    pinning a fresh host buffer, and copies from the card into pinned and
    into pageable memory (GB/s)."""
    n = 1 << 30
    src = torch.empty(n, dtype=torch.uint8, device="cuda")
    data = bytes(n)
    t0 = time.perf_counter()
    hashlib.sha256(data).hexdigest()
    rates = {"sha256_gb_s": n / (time.perf_counter() - t0) / 1e9}
    del data
    t0 = time.perf_counter()
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    rates["pin_gb_s"] = n / (time.perf_counter() - t0) / 1e9
    for name, dst in (("d2h_pinned_gb_s", pinned),
                      ("d2h_pageable_gb_s", torch.empty(n, dtype=torch.uint8))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.copy_(src)
        torch.cuda.synchronize()
        rates[name] = n / (time.perf_counter() - t0) / 1e9
    return rates


def phase_checkpoint(torch, reference, card, flush):
    """Phase 13: llama2_7b LoRA trained on the card, checkpointed, resumed,
    verified, exported through ``cli.export`` and served from the export
    through ``cli.serve.build``; see the module docstring."""
    import shutil
    import tempfile

    from dlti_tpu_torch.checkpoint import store
    from dlti_tpu_torch.checkpoint.export import merged_tree
    from dlti_tpu_torch.cli import export as export_cli
    from dlti_tpu_torch.cli import serve as serve_cli
    from dlti_tpu_torch.config import CheckpointConfig
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving import SamplingParams
    from dlti_tpu_torch.training import Trainer

    root = Path(tempfile.mkdtemp(prefix="dlti-ckpt-"))
    ck_dir, ex_dir = root / "ckpt", root / "export"
    ckpt = CheckpointConfig(output_dir=str(ck_dir), save_strategy="steps",
                            save_steps=CKPT_SAVE_STEPS, save_total_limit=2,
                            async_save=True)
    first = train_config(ckpt, max_steps=CKPT_SAVE_STEPS, num_layers=CKPT_LAYERS)
    mcfg, lora = first.model, first.lora
    perf = {"card": card, "layers": mcfg.num_layers, **host_rates(torch)}
    t_phase = time.perf_counter()
    log(f"[ckpt] {card}; llama2_7b layers {mcfg.num_layers} of "
        f"{MODEL_LAYERS}, full width")
    log(f"[ckpt] host rates on 1 GiB: SHA-256 {perf['sha256_gb_s']:.2f} GB/s (one core), "
        f"pinning {perf['pin_gb_s']:.2f} GB/s, card to pinned {perf['d2h_pinned_gb_s']:.1f}"
        f" GB/s, card to pageable {perf['d2h_pageable_gb_s']:.2f} GB/s")
    handler, port_log = LogLines(), logging.getLogger("dlti_tpu_torch")
    level = port_log.level
    port_log.addHandler(handler)
    port_log.setLevel(logging.INFO)
    try:
        # Two checkpoints and an export, all of the model's size, plus margin.
        model_bytes = 2 * mcfg.num_params()
        need = 3 * model_bytes + CKPT_DISK_MARGIN
        free0 = shutil.disk_usage(root).free
        perf["free_gb_before"] = free0 / 1e9
        check(free0 >= need, f"phase 13 needs {need / 1e9:.1f} GB free under {root}, "
              f"the disk has {free0 / 1e9:.1f} GB")
        dataset = make_batches(training_texts(), ByteTokenizer(), seq_len=512,
                               micro_batch_size=4, grad_accum_steps=2)
        tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
        tpa.launches = 0  # this path's counts start here ...

        # 1. Save: steps 1-4 from phase 7's weights, step 4 committed async.
        sum0 = store.save_seconds.snapshot()[1]
        trainer = Trainer(first, params=init_params(mcfg, seed=0, device="cuda", lora=lora),
                          device="cuda")
        state, rec1 = trainer.train(dataset=dataset)
        sum1 = store.save_seconds.snapshot()[1]
        check(rec1.save_steps == [CKPT_SAVE_STEPS] and rec1.resumed_from is None,
              f"first run saved {rec1.save_steps}, resumed from {rec1.resumed_from}")
        check(store.list_checkpoint_steps(ck_dir) == [CKPT_SAVE_STEPS],
              f"checkpoints {store.list_checkpoint_steps(ck_dir)}")
        del state, trainer
        free_memory(torch)

        # 2. Resume: a fresh trainer (other random weights, which the restore
        # replaces) continues to step 8.
        second = dataclasses.replace(first, train=dataclasses.replace(
            first.train, max_steps=TRAIN_STEPS))
        trainer = Trainer(second, params=init_params(mcfg, seed=1, device="cuda", lora=lora),
                          device="cuda")
        state, rec2 = trainer.train(dataset=dataset)
        sum2 = store.save_seconds.snapshot()[1]
        check(rec2.resumed_from == CKPT_SAVE_STEPS and any(
            f"resumed from verified checkpoint step {CKPT_SAVE_STEPS}" in ln
            for ln in handler.lines), f"no resume from step {CKPT_SAVE_STEPS}: "
              f"{rec2.resumed_from}, log {handler.lines[-5:]}")
        check(rec2.save_steps == [TRAIN_STEPS], f"second run saved {rec2.save_steps}")
        steps = list(range(CKPT_SAVE_STEPS + 1, TRAIN_STEPS + 1))
        log(f"[ckpt] resumed losses {rec2.losses} / phase 7 "
            f"{reference['losses'][CKPT_SAVE_STEPS:]}")
        log(f"[ckpt] resumed grad norms {rec2.grad_norms} / phase 7 "
            f"{reference['grad_norms'][CKPT_SAVE_STEPS:]}")
        if mcfg.num_layers == MODEL_LAYERS:
            check(rec2.losses == reference["losses"][CKPT_SAVE_STEPS:]
                  and rec2.grad_norms == reference["grad_norms"][CKPT_SAVE_STEPS:],
                  f"steps {steps} after the resume are not bit-equal to phase 7's")
        check(store.list_checkpoint_steps(ck_dir) == [CKPT_SAVE_STEPS, TRAIN_STEPS],
              f"checkpoints {store.list_checkpoint_steps(ck_dir)}")
        train_launches = {"flash_fwd": tfa.fwd_launches, "flash_bwd_dq": tfa.dq_launches,
                          "flash_bwd_dkv": tfa.dkv_launches}
        # 8 replayed steps and each trainer's capture warm-up step.
        want = flash_expected(mcfg.num_layers, 2,
                              TRAIN_STEPS + rec1.captures + rec2.captures)
        check(train_launches == want, f"training launches {train_launches} != {want}")

        # 3. Verify both steps (re-hash every file).
        t0 = time.perf_counter()
        for step in (CKPT_SAVE_STEPS, TRAIN_STEPS):
            ok = store.verify_checkpoint(ck_dir, step)
            check(ok == (True, "ok"), f"verify_checkpoint step {step}: {ok}")
        verify_s = (time.perf_counter() - t0) / 2

        # 4. Export step 8 through cli.export; its params must be byte-equal
        # to the merge of the live resumed state, run on the card.
        with torch.no_grad():
            live = merged_tree(dict(state.model.named_parameters()), second)
            live_digest = hashlib.sha256(store.manifest_of(live)).hexdigest()
        del live, state, trainer
        free_memory(torch)
        t0 = time.perf_counter()
        digest = export_cli.export(export_cli.parse_args([
            "--checkpoint-dir", str(ck_dir), "--step", str(TRAIN_STEPS),
            "--model", "llama2_7b", "--lora-r", str(lora.r), "--out", str(ex_dir)]))
        export_s = time.perf_counter() - t0
        check(digest == live_digest, f"export digest {digest} != live merge {live_digest}")
        exported = json.loads((ex_dir / "config.json").read_text())
        check(exported["lora"]["enabled"] is False, "the export's config keeps LoRA on")
        free_memory(torch)

        # 5. Serve 4 greedy requests from the export (bf16 pool, CLI defaults).
        argv = ["--model-dir", str(ex_dir), "--tokenizer", "byte"]
        if mcfg.num_layers != MODEL_LAYERS:  # the cut model's config names its depth
            check(exported["model"]["num_layers"] == mcfg.num_layers, "export depth")
        t0 = time.perf_counter()
        engine, tok, _ = serve_cli.build(serve_cli.parse_args(argv))
        load_s = time.perf_counter() - t0
        engine.warmup_decode_ladder()
        launches_before = tpa.launches
        decode_before = engine.stats["decode_steps"]
        prompts = [tok.encode(t[:96]) for t in training_texts(CKPT_REQUESTS, seed=7)]
        results = engine.generate(prompts, SamplingParams(temperature=0.0,
                                                          max_tokens=CKPT_NEW_TOKENS))
        decode_steps = engine.stats["decode_steps"] - decode_before
        k4 = tpa.launches - launches_before
        check(len(results) == CKPT_REQUESTS and all(r.output_token_ids for r in results),
              "a request from the export produced no tokens")
        check(k4 == mcfg.num_layers * decode_steps,
              f"K4 launches {k4} != {mcfg.num_layers} x {decode_steps} decode steps")
        log(f"[ckpt] served {CKPT_REQUESTS} greedy requests from the export: "
            f"{[len(r.output_token_ids) for r in results]} tokens, {decode_steps} decode "
            f"steps, K4 {k4} launches (+ the warm-up's)")
        launches = {**train_launches, "paged_decode_attention": tpa.launches}
        # ... and are read here, with the serve's warm-up. Then the engine's
        # state (the export's weights, 128-block tables) is checked.
        log("[ckpt] the served export's engine, checked as in phase 4:")
        in_model = phase_in_model(torch, engine, flush)
        perf["in_model"] = {k: in_model[k] for k in (
            "max_abs_err", "row_rel_err", "logits_rel", "argmax_agree", "splits",
            "chunk", "ms", "plain_ms", "bound_ms")}
        del engine
        free_memory(torch)

        gb = [tree_bytes(ck_dir / str(s)) / 1e9 for s in (CKPT_SAVE_STEPS, TRAIN_STEPS)]
        writer_s = [sum1 - sum0, sum2 - sum1]
        free1 = shutil.disk_usage(root).free
        perf.update({
            "losses_bit_equal": rec2.losses == reference["losses"][CKPT_SAVE_STEPS:],
            "save_stall_ms": [1e3 * rec1.save_stall_s[0], 1e3 * rec2.save_stall_s[0]],
            "writer_s": writer_s, "gb_written": gb,
            "write_hash_gb_s": [g / w for g, w in zip(gb, writer_s)],
            "restore_s": rec2.restore_s, "verify_s": verify_s, "export_s": export_s,
            "export_gb": tree_bytes(ex_dir / "model") / 1e9, "load_s": load_s,
            "free_gb_after": free1 / 1e9, "launches": launches,
            "train_step_ms": [1e3 * x for x in rec1.step_times_s + rec2.step_times_s]})
        log(f"[ckpt] save stall {perf['save_stall_ms'][0]:.1f} ms at step "
            f"{CKPT_SAVE_STEPS} (cold: the whole state copied) and "
            f"{perf['save_stall_ms'][1]:.1f} ms at step {TRAIN_STEPS} (the frozen base's "
            f"host copy kept from the restore)")
        log(f"[ckpt] writer {writer_s[0]:.2f} s / {writer_s[1]:.2f} s per save for "
            f"{gb[0]:.3f} / {gb[1]:.3f} GB: write+hash {perf['write_hash_gb_s'][0]:.3f} / "
            f"{perf['write_hash_gb_s'][1]:.3f} GB/s")
        log(f"[ckpt] restore {rec2.restore_s:.2f} s (scan, re-hash, read, placement on the "
            f"card); verify {verify_s:.2f} s a step; export {export_s:.2f} s "
            f"({perf['export_gb']:.3f} GB); --model-dir load {load_s:.2f} s")
        perf["phase_s"] = time.perf_counter() - t_phase
        log(f"[ckpt] free disk {perf['free_gb_before']:.1f} GB before, "
            f"{perf['free_gb_after']:.1f} GB with both checkpoints and the export; "
            f"phase {perf['phase_s']:.1f} s")
    finally:
        port_log.removeHandler(handler)
        port_log.setLevel(level)
        shutil.rmtree(root, ignore_errors=True)
    log("[ckpt] perf " + json.dumps(perf))
    return launches, perf


# ----------------------------------------------------------------------
# Serving slice 3: the OpenAI server and serve CLI on an int8 KV pool (K4q)
# ----------------------------------------------------------------------

SERVE_ARGS = ["--random-init", "llama2_7b", "--tokenizer", "byte",
              "--kv-cache-dtype", "int8", "--host", "127.0.0.1", "--port", "0"]
# The reference's documented serving configuration (README's serve command):
# int8 KV, 28 slots, 64 decode steps a host sync; bf16 weights (int8 weights
# are not ported).
DOCUMENTED_ARGS = SERVE_ARGS + ["--max-seqs", "28", "--steps-per-sync", "64"]


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


def phase_server(torch, argv=SERVE_ARGS, tag="[server]"):
    """llama2_7b from the serve CLI's own builder on an int8 pool (the CLI's
    defaults, or ``argv``), warmed up as the CLI warms it, behind
    ``make_server`` on a free port: 12 concurrent requests, then a greedy
    prompt twice and streamed, one at a time."""
    import threading

    from dlti_tpu_torch.cli import serve as cli
    from dlti_tpu_torch.ops import flash_attention as tfa
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving import make_server
    from dlti_tpu_torch.serving.server import llama2_chat_prompt

    args = cli.parse_args(argv)
    if argv is SERVE_ARGS:
        check((args.max_seqs, args.num_blocks, args.block_size, args.max_model_len,
               args.steps_per_sync) == (8, 2048, 16, 2048, 1),
              "the serve CLI's defaults changed")
    t0 = time.perf_counter()
    engine, tok, sc = cli.build(args)
    engine.warmup_decode_ladder()
    torch.cuda.synchronize()
    cfg = engine.model_cfg
    pool_bytes = sum(t.numel() * t.element_size() for c in engine.cache for t in c.values())
    scale_bytes = sum(c[k].numel() * 4 for c in engine.cache for k in ("k_scale", "v_scale"))
    check(engine.cache[0]["k"].dtype == torch.int8, "the CLI did not build an int8 pool")
    log(f"{tag} {' '.join(argv)}: {args.random_init} engine from the serve CLI "
        f"builder, warmed up, in "
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
    log(f"{tag} 12 concurrent requests in {wall:.2f} s, then 3 one at a time; decode "
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
            "max_seqs": args.max_seqs, "steps_per_sync": args.steps_per_sync,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"{tag} {perf['requests_per_s']:.3f} requests/s, {perf['output_tok_s']:.1f} "
        f"output tok/s ({completion_tokens} tokens); TTFT p50 {ttft['p50']:.4f} s, p99 "
        f"{ttft['p99']:.4f} s (/stats, bucket-interpolated); mean TPOT "
        f"{1e3 * tpot['mean']:.2f} ms; engine step on the stepper thread p50 "
        f"{perf['step_ms_p50']:.2f} ms, mean {perf['step_ms_mean']:.2f} ms over "
        f"{len(step_s)} steps")
    log(f"{tag} perf " + json.dumps(perf))
    return engine, launches_int8, perf


def serve_subprocess(cmd, tag):
    """Run a serve CLI command as a subprocess on the card: it must print its
    port, answer /health and one greedy completion, and exit 0 on SIGTERM."""
    import os
    import queue
    import signal
    import threading

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
                check(proc.poll() is None, f"{tag} the serve CLI exited early:\n"
                      + "".join(seen))
                continue
            seen.append(line)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        check(port is not None, f"{tag} the serve CLI never printed its port:\n"
              + "".join(seen))
        check(any("on cuda" in ln for ln in seen), f"{tag} the serve CLI did not run on "
              "the card")
        addr = ("127.0.0.1", port)
        status, data = http_request(addr, "GET", "/health", timeout=60)
        check(status == 200, f"{tag} CLI /health answered {status}")
        out = post_json(addr, "/v1/completions", {"prompt": "hello", "max_tokens": 8,
                                                  "temperature": 0.0})
        check(out["usage"]["completion_tokens"] > 0, f"{tag} CLI completion {out}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        check(rc == 0, f"{tag} the serve CLI exited {rc} on SIGTERM:\n"
              + "".join(seen[-20:]))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=10)
        proc.stdout.close()
    log(f"{tag} {' '.join(cmd[1:])}: port {port}, /health 200, one completion "
        f"200 ({out['usage']}), exit 0 on SIGTERM; {time.perf_counter() - t0:.1f} s")
    return seen


def phase_serve_cli(torch):
    """The entry point itself: ``python -m dlti_tpu_torch.cli.serve`` on the
    card (llama_tiny, int8 pool, a free port) answers /health and one
    completion, and exits 0 on SIGTERM."""
    serve_subprocess([sys.executable, "-m", "dlti_tpu_torch.cli.serve", "--random-init",
                      "llama_tiny", "--tokenizer", "byte", "--kv-cache-dtype", "int8",
                      "--steps-per-sync", "4", "--host", "127.0.0.1", "--port", "0"],
                     "[serve-cli]")


def run_cli(cmd, tag, timeout=600):
    """A CLI as a subprocess that must exit 0; returns its stdout."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=timeout)
    check(proc.returncode == 0, f"{tag} {' '.join(cmd[1:])} exited {proc.returncode}:\n"
          + proc.stdout[-2000:] + proc.stderr[-3000:])
    log(f"{tag} {' '.join(cmd[1:])}: exit 0 in {time.perf_counter() - t0:.1f} s")
    return proc.stdout


def phase_cli_round_trip(torch):
    """The three entry points as subprocesses on the card, on llama_300m (d
    64, which K1-K3 take): ``cli.train`` checkpoints steps 2 and 4 and
    exports; ``cli.export`` of the checkpoints prints the export's digest;
    ``cli.serve --model-dir`` serves the export."""
    import shutil
    import tempfile

    from dlti_tpu_torch.checkpoint import list_checkpoint_steps, manifest_digest

    root = Path(tempfile.mkdtemp(prefix="dlti-cli-"))
    data, ck, ex, ex2 = (root / n for n in ("data.jsonl", "ckpt", "export", "export2"))
    data.write_text("".join(json.dumps({"text": t}) + "\n" for t in training_texts()))
    py = [sys.executable, "-m"]
    try:
        out = run_cli(py + ["dlti_tpu_torch.cli.train", "--model", "llama_300m",
                            "--tokenizer", "byte", "--dataset-path", str(data),
                            "--max-steps", "4", "--save-steps", "2",
                            "--output-dir", str(ck), "--export-dir", str(ex)], "[cli]")
        check(list_checkpoint_steps(ck) == [2, 4],
              f"cli.train left checkpoints {list_checkpoint_steps(ck)}")
        digest = manifest_digest(ex / "model")
        check(digest is not None and f"manifest sha256: {digest}" in out,
              f"cli.train's export digest {digest} is not in its output")
        out = run_cli(py + ["dlti_tpu_torch.cli.export", "--checkpoint-dir", str(ck),
                            "--model", "llama_300m", "--out", str(ex2)], "[cli]")
        check(out.strip().splitlines()[-1] == f"manifest sha256: {digest}",
              f"cli.export printed {out.strip().splitlines()[-1:]}, the export is {digest}")
        seen = serve_subprocess(py + ["dlti_tpu_torch.cli.serve", "--model-dir", str(ex),
                                      "--tokenizer", "byte", "--host", "127.0.0.1",
                                      "--port", "0"], "[cli]")
        check(any("loaded export" in ln for ln in seen), "cli.serve did not load the export")
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
        card = phase_card_and_build(torch)
        # 256 MB written before each timed launch: more than the 50 MB L2.
        flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
        cases, int8_cases = phase_kernel_cases(torch, flush)
        engine, launches, engine_perf = phase_engine(torch)
        # Phases 4 and 5 on the k = 8 graphed engine: 17 tokens a request
        # leave two 8-step windows after the prefill, one dispatched under
        # the sync check and one profiled.
        main_path = phase_in_model(torch, engine, flush, max_tokens=17)
        sync_check(torch, engine, "[in-model]")
        profile_perf = phase_profile(torch, engine)
        head_perf = phase_head(torch, engine)
        # The serving phases hold ~23 GB (weights and KV pool): release them
        # before the training phases build their own llama2_7b.
        del engine
        free_memory(torch)
        flash = phase_flash_cases(torch, flush)
        state, dataset, lora, flash_launches, train_perf = phase_training(torch)
        paths = phase_train_paths(torch, state, dataset, lora)
        train_profile = phase_train_profile(torch, state, dataset)
        # The trainer holds ~16 GB: release it before phases 14 and 13.
        del state, dataset
        gc.collect()
        torch.cuda.empty_cache()
        window_perf = phase_train_window(torch, train_perf)
        ckpt_launches, ckpt_perf = phase_checkpoint(torch, train_perf, card, flush)
        engine, int8_launches, server_perf = phase_server(torch)
        int8_main = phase_in_model(torch, engine, flush)
        del engine
        free_memory(torch)
        engine, _, documented_perf = phase_server(torch, DOCUMENTED_ARGS,
                                                  "[server-documented]")
        sync_check(torch, engine, "[server-documented]", submit=True)
        while engine.has_work:
            engine.step()
        del engine
        free_memory(torch)
        phase_serve_cli(torch)
        phase_cli_round_trip(torch)
    except CheckFailed as e:
        return fail(str(e))

    worst = max([r["max_abs_err"] for r in cases.values()]
                + [main_path["max_abs_err"], ckpt_perf["in_model"]["max_abs_err"]])
    kernels = [{
        "name": "paged_decode_attention",
        "design": main_path["design"],
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
        "design": int8_main["design"],
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
    # "design" is the program that shape runs.
    at = flash["llama2_7b_train"]
    for name, replaces in FLASH_REPLACES.items():
        kernels.append({
            "name": name,
            "design": at[name]["design"],
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
    keys = ("step_ms", "tokens_per_s", "mfu_percent", "peak_memory_gb",
            "host_syncs_per_step")
    log("[train] summary " + json.dumps({
        "graph": {k: train_perf[k] for k in keys},
        "eager": {k: train_perf["eager"][k] for k in keys},
        "busy_share": {k: v and v["busy_share"] for k, v in train_profile.items()},
        "profile_ms_a_step": {k: v and {"wall": v["wall_ms"], "busy": v["busy_ms"]}
                              for k, v in train_profile.items()},
        **{f"k{WINDOW_K}" if name == "window" else name: {k: window_perf[name][k]
                                                          for k in keys}
           for name in ("window", "loss_chunk")},
        **paths}))
    log("[engine] summary " + json.dumps({
        "decode_step_ms_k1_graph_events": engine_perf["decode_step_ms"],
        **{name: {k: r[k] for k in ("ms_per_device_step", "decode_tok_s", "windows",
                                   "host_syncs_per_token")}
           for name, r in engine_perf["equality"].items()},
        "profile_k8": profile_perf, "head": head_perf}))
    log("[server] summary " + json.dumps(server_perf))
    log("[server-documented] summary " + json.dumps(documented_perf))
    log("[ckpt] summary " + json.dumps({k: ckpt_perf[k] for k in (
        "card", "layers", "losses_bit_equal", "save_stall_ms", "writer_s", "gb_written",
        "write_hash_gb_s", "restore_s", "export_s", "load_s", "free_gb_before",
        "free_gb_after", "phase_s", "sha256_gb_s", "pin_gb_s", "d2h_pinned_gb_s",
        "d2h_pageable_gb_s", "in_model")}))
    log("[ckpt] launches on the train -> checkpoint -> resume -> export -> serve path "
        + json.dumps(ckpt_launches))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
