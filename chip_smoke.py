#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run if its check fails:

1. Card and build: the card's name and power limit, then every kernel of
   ``dlti_tpu_torch/csrc`` built with ``nvcc`` for ``sm_90a``.
2. The paged decode kernel against its plain PyTorch version at the decode
   shapes of the presets it serves (llama2_7b, llama3_8b's GQA, mistral_7b's
   window, head_dim 256, a float32 pool, poisoned pool rows and garbage
   table entries), with each case's error, kernel time, bound, plain time
   and the time of ``F.scaled_dot_product_attention`` over the gathered
   window (a yardstick the port never calls).
3. The engine at full width: llama2_7b in bfloat16 from
   ``init_params(seed=0)``, 12 requests (prompts of 16 to 300 tokens,
   greedy and seeded sampling) submitted to ``InferenceEngine`` and driven
   by ``step`` with 8 slots, so admission happens mid-flight. Every request must finish with
   its token count, and the kernel must have been launched once per layer
   per decode step.
4. Inside the model: one decode step's logits through the kernel against
   the same step through the plain gather path (``paged_attention_impl=
   "gather"``), and the kernel against its plain version on the engine's
   real pool, tables and lengths, where its time is taken for the record.
5. Profile: ``torch.profiler`` over the remaining decode steps of phase
   4's batch, for the device's busy share and the kernels by device time.

Prints a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero without that line when
there is no CUDA device, when the package is not beside this file, or when
any check fails.
"""

from __future__ import annotations

import dataclasses
import json
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
    these inputs: K and V of every live (token, kv head) once, q and the
    output once, the live table entries and the lengths; two multiply-adds
    per (token, query head, channel)."""
    batch, _, heads, d = q.shape
    bs, kvh = k_pool.shape[1], k_pool.shape[2]
    lens = seq_lens.long().clamp(min=0, max=block_tables.shape[1] * bs)
    start = (lens - window).clamp(min=0) if window else lens * 0
    tokens = int((lens - start).sum())
    first_blk, last_blk = start // bs, (lens + bs - 1) // bs
    live_blocks = int((last_blk - first_blk).clamp(min=0).sum())
    kv_bytes = 2 * tokens * kvh * d * k_pool.element_size()
    qo_bytes = 2 * q.numel() * q.element_size()
    meta_bytes = 4 * (live_blocks + batch)
    ops = 4 * tokens * heads * d
    return kv_bytes + qo_bytes + meta_bytes, ops


def bound(nbytes: int, ops: int, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_over_gathered(torch, q, k_pool, v_pool, block_tables, seq_lens, window):
    """The library yardstick: ``scaled_dot_product_attention`` over the
    window gathered from the pool (the gather is done once, outside the
    timed call). Returns the timed closure."""
    import torch.nn.functional as F

    batch, _, heads, d = q.shape
    nb, bs, kvh, _ = k_pool.shape
    bt = block_tables.long().clamp(0, nb - 1)
    max_len = bt.shape[1] * bs
    k = k_pool[bt].reshape(batch, max_len, kvh, d).transpose(1, 2).to(q.dtype)
    v = v_pool[bt].reshape(batch, max_len, kvh, d).transpose(1, 2).to(q.dtype)
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
                     seq_lens, max_blocks, window=None, poison=False):
    """A pool holding exactly the blocks the sequences use (a random
    permutation of them), plus block tables. With ``poison``, every pool row
    that is not live holds NaN and table entries past each sequence point at
    random (poisoned) blocks; otherwise they are -1."""
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
    if poison:
        live = live.view(num_blocks, block_size)
        k_pool[~live] = float("nan")
        v_pool[~live] = float("nan")
    q = torch.randn(batch, 1, heads, d, device=dev, generator=gen).to(dtype)
    lens = torch.tensor(seq_lens, device=dev, dtype=torch.int32)
    return q, k_pool, v_pool, tables, lens


def measure_kernel(torch, tpa, q, k_pool, v_pool, tables, lens, window, flush):
    """Error against the plain version, and the four times."""
    out = tpa.paged_decode_attention(q, k_pool, v_pool, tables, lens, window=window)
    torch.cuda.synchronize()
    ref = tpa.paged_decode_attention_reference(q, k_pool, v_pool, tables, lens,
                                               window=window)
    check(torch.isfinite(out).all().item(), "kernel output is not finite")
    err = (out.float() - ref.float()).abs().max().item()
    dtype_name = str(k_pool.dtype).split(".")[-1]
    nbytes, ops = decode_work(q, k_pool, tables, lens, window)
    bound_ms, bound_by = bound(nbytes, ops, dtype_name)
    ms = time_ms(torch, lambda: tpa.paged_decode_attention(
        q, k_pool, v_pool, tables, lens, window=window), flush=flush)
    plain_ms = time_ms(torch, lambda: tpa.paged_decode_attention_reference(
        q, k_pool, v_pool, tables, lens, window=window), flush=flush)
    library_ms = time_ms(torch, sdpa_over_gathered(
        torch, q, k_pool, v_pool, tables, lens, window), flush=flush)
    return {"max_abs_err": err, "tol": TOL[dtype_name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "bytes": nbytes, "ops": ops}


def phase_kernel_cases(torch, flush):
    from dlti_tpu_torch.ops import paged_attention as tpa

    gen = torch.Generator(device="cuda").manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    # Decode batches of 8 at block_size 16 with a ragged mix: a seq_len of 0
    # (an idle slot), single tokens, tails inside a block, a full table.
    lens_1k = [0, 1, 17, 100, 255, 316, 600, 1024]
    lens_8k = [0, 5, 100, 4095, 4097, 5000, 6000, 8192]
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
    ]
    results = {}
    for name, kw in cases:
        window = kw.get("window")
        inputs = make_decode_case(torch, gen, block_size=16, **kw)
        r = measure_kernel(torch, tpa, *inputs, window, flush)
        results[name] = r
        log(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3e} (tol "
            f"{r['tol']:.3e}); kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} "
            f"ms by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, sdpa "
            f"{r['library_ms']:.4f} ms")
        check(r["max_abs_err"] <= r["tol"],
              f"kernel disagrees with its plain version on {name}: "
              f"{r['max_abs_err']} > {r['tol']}")
        del inputs
    torch.cuda.empty_cache()
    return results


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

    tpa.launches = 0  # the main path's count starts here
    t0 = time.perf_counter()
    results = []
    for p, sp in reqs:
        results.append(engine.submit(p, sp))
    while engine.has_work:
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tpa.launches  # ... and is read here
    del ex.prefill, ex.decode

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
    return engine, params, launches


def phase_in_model(torch, engine, params, flush):
    """One decode step's logits, kernel path against gather path, on a batch
    of 8 freshly prefilled sequences; then the kernel against its plain
    version on the engine's layer-0 pool and tables."""
    import numpy as np

    from dlti_tpu_torch.models.interop import load_model
    from dlti_tpu_torch.ops import paged_attention as tpa
    from dlti_tpu_torch.serving.sampling import SamplingParams

    cfg = engine.model_cfg
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
                              params, dev)
    with torch.no_grad():
        # Both write the same K/V rows at the same slots before attending.
        kernel_logits = engine.model(ids, positions=pos, cache=engine.cache,
                                     block_tables=tables)[:, 0]
        gather_logits = gather_model(ids, positions=pos, cache=engine.cache,
                                     block_tables=tables)[:, 0]
    check(torch.isfinite(kernel_logits).all().item(), "nonfinite kernel-path logits")
    scale = gather_logits.abs().max().item()
    diff = (kernel_logits - gather_logits).abs().max().item()
    agree = (kernel_logits.argmax(-1) == gather_logits.argmax(-1)).float().mean().item()
    log(f"[in-model] decode logits kernel vs gather: max_abs_diff {diff:.4e}, "
        f"max |logit| {scale:.4e}, rel {diff / scale:.3e} (tol {LOGITS_REL_TOL:.1e}); "
        f"argmax agreement {agree:.3f}")
    check(diff <= LOGITS_REL_TOL * scale,
          f"kernel-path logits differ from gather-path by {diff} (scale {scale})")

    # The kernel on the engine's own pool, tables and lengths (positions
    # seq_len + 1 after the step above wrote them), with a random query.
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(8, 1, cfg.num_heads, cfg.resolved_head_dim, device=dev,
                    generator=gen).to(torch.bfloat16)
    lens = (pos[:, 0] + 1).to(torch.int32)
    layer = engine.cache[0]
    r = measure_kernel(torch, tpa, q, layer["k"], layer["v"], tables, lens,
                       cfg.sliding_window, flush)
    log(f"[in-model] kernel on the engine's pool (seq_lens {lens.tolist()}): "
        f"max_abs_err {r['max_abs_err']:.3e} (tol {r['tol']:.3e}); kernel "
        f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
        f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms")
    check(r["max_abs_err"] <= r["tol"], "kernel disagrees on the engine's pool")
    return r


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
        cases = phase_kernel_cases(torch, flush)
        engine, params, launches = phase_engine(torch)
        main_path = phase_in_model(torch, engine, params, flush)
        phase_profile(torch, engine)
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
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
