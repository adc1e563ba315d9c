#!/usr/bin/env python3
"""Compare checkouts of this repository on one NVIDIA GPU, in turns.

    python3 chip_ab.py [--what flash|decode|step|serve|restore|both] ROOT [ROOT ...]

Each ROOT is a checkout (``.`` for this one; another commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists). Give them in
the order to run them, parent and change alternating (``P . . P``), so that
a drift of the card shows. For each ROOT a fresh process, started in that
ROOT, builds its kernels and uses that ROOT's own ``chip_smoke.py``:

* ``flash``: K1 (forward), K2 (dq) and K3 (dk/dv) at the bf16 shapes of
  ``chip_smoke.py``'s phase 6, timed by its ``time_ms`` (L2 flushed before
  each call), and each output's agreement with the plain version. Where the
  ROOT's ``time_ms`` has a host cover (``HOST_COVER_CYCLES``), the time
  without it follows in brackets.
* ``decode``: K4 (float pools) and K4q (int8 pools) at phase 2's shapes and
  at the engines' decode states (llama2_7b, batch 8, seq_lens 41-512, a
  bf16 pool behind 64-block tables and an int8 pool behind 128-block
  tables), timed the same way, each held to phase 2's limits.
* ``step``: phase 7, the llama2_7b LoRA trainer for 8 steps: step ms and
  tokens/s (and, where the ROOT's phase 7 has one, its eager yardstick's).
* ``serve``: phase 10, the OpenAI server on the serve CLI's llama2_7b int8
  engine answering 12 concurrent requests: requests/s, mean TPOT, and the
  engine step's p50 and mean on the server's stepper thread.
* ``restore``: phase 13's resume, llama2_7b LoRA (13.7 GB): the first ROOT
  saves one checkpoint of a fresh state into a temporary directory, then
  every ROOT restores it twice through ``restore_latest_verified`` with
  the trainer's ``HostCache``, as ``Trainer.train`` resumes: restore
  seconds, and the scan's ``latest_verified_step`` alone.

Prints one line per ROOT and measurement, and the card's name and power
limit first. Needs the card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile

FLASH = r'''
import sys, torch
sys.path.insert(0, ".")
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke as cs
from dlti_tpu_torch.ops import _build, flash_attention as tfa

_build.build(["flash_attention"])
flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
gen = torch.Generator(device="cuda").manual_seed(4321)
SHAPES = {"llama2_7b_train": (4, 512, 32, 32, 128, None),
          "llama3_8b_gqa": (1, 2048, 32, 8, 128, None),
          "mistral_7b_window": (1, 8192, 32, 8, 128, 4096),
          "gemma_7b_d256": (2, 1024, 16, 16, 256, None),
          "d64": (2, 1024, 16, 16, 64, None)}

def timed(fn):
    ms = cs.time_ms(torch, fn, 20, flush)
    cover = getattr(cs, "HOST_COVER_CYCLES", None)
    if not cover:
        return f"{ms:.4f}"
    cs.HOST_COVER_CYCLES = 0
    try:
        bare = cs.time_ms(torch, fn, 20, flush)
    finally:
        cs.HOST_COVER_CYCLES = cover
    return f"{ms:.4f} ({bare:.4f})"

for name, (b, s, h, hkv, d, window) in SHAPES.items():
    q, do = (torch.randn(b, s, h, d, device="cuda", generator=gen).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, device="cuda", generator=gen).bfloat16() for _ in range(2))
    o, lse = tfa.flash_fwd(q, k, v, window=window)
    delta = tfa.backward_delta(o, do)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, window=window)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, window=window)
    chunk = 1024 if s > 2048 else None
    ro, _ = tfa.flash_attention_reference(q, k, v, window=window, q_chunk=chunk)
    rdq, rdk, rdv = tfa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                           window=window, q_chunk=chunk)
    ok = all(cs.within(got, want, "bfloat16")[0]
             for got, want in ((o, ro), (dq, rdq), (dk, rdk), (dv, rdv)))
    k1 = timed(lambda: tfa.flash_fwd(q, k, v, window=window))
    k2 = timed(lambda: tfa.flash_bwd_dq(q, k, v, do, lse, delta, window=window))
    k3 = timed(lambda: tfa.flash_bwd_dkv(q, k, v, do, lse, delta, window=window))
    print(f"RESULT flash {name}: K1 {k1} ms, K2 {k2} ms, K3 {k3} ms, within phase 6's "
          f"limit: {ok}", flush=True)
    del q, k, v, do, o, lse, delta, dq, dk, dv, ro, rdq, rdk, rdv
    torch.cuda.empty_cache()
'''

DECODE = r'''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from dlti_tpu_torch.ops import _build, paged_attention as tpa

_build.build(["paged_attention"])
flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
gen = torch.Generator(device="cuda").manual_seed(1234)
bf16, f32 = torch.bfloat16, torch.float32
lens_1k = [0, 1, 17, 100, 255, 316, 600, 1024]
lens_8k = [0, 5, 100, 4095, 4097, 5000, 6000, 8192]
engine = [41, 78, 129, 130, 201, 256, 301, 512]
CASES = [
    ("engine_bf16", dict(heads=32, kv_heads=32, d=128, dtype=bf16, seq_lens=engine,
                         max_blocks=64)),
    ("engine_int8", dict(heads=32, kv_heads=32, d=128, dtype=bf16, seq_lens=engine,
                         max_blocks=128, int8=True)),
    ("llama2_7b", dict(heads=32, kv_heads=32, d=128, dtype=bf16, seq_lens=lens_1k,
                       max_blocks=64)),
    ("llama3_8b_gqa", dict(heads=32, kv_heads=8, d=128, dtype=bf16, seq_lens=lens_1k,
                           max_blocks=64)),
    ("mistral_7b_window", dict(heads=32, kv_heads=8, d=128, dtype=bf16, seq_lens=lens_8k,
                               max_blocks=512, window=4096)),
    ("gemma_7b_d256", dict(heads=16, kv_heads=16, d=256, dtype=bf16, seq_lens=lens_1k,
                           max_blocks=64)),
    ("llama2_7b_fp32", dict(heads=32, kv_heads=32, d=128, dtype=f32, seq_lens=lens_1k,
                            max_blocks=64)),
    ("int8_llama3_8b_gqa", dict(heads=32, kv_heads=8, d=128, dtype=bf16, seq_lens=lens_1k,
                                max_blocks=64, int8=True)),
    ("int8_mistral_7b_window", dict(heads=32, kv_heads=8, d=128, dtype=bf16,
                                    seq_lens=lens_8k, max_blocks=512, window=4096,
                                    int8=True)),
]
for name, kw in CASES:
    window = kw.get("window")
    q, k, v, tables, lens, scales = cs.make_decode_case(torch, gen, block_size=16, **kw)
    args = dict(window=window, **scales)
    out = tpa.paged_decode_attention(q, k, v, tables, lens, **args)
    ref = tpa.paged_decode_attention_reference(q, k, v, tables, lens, **args)
    err, row_rel = cs.decode_errors(torch, out, ref)
    tol = cs.TOL["float32" if q.dtype == f32 else "bfloat16"]
    ok = err <= tol and (q.dtype == f32 or row_rel <= cs.ROW_REL_TOL["bfloat16"])
    ms = cs.time_ms(torch, lambda: tpa.paged_decode_attention(q, k, v, tables, lens, **args),
                    20, flush)
    nbytes, ops = cs.decode_work(q, k, tables, lens, window)
    bound_ms, _ = cs.bound(nbytes, ops, "float32" if q.dtype == f32 else "bfloat16")
    print(f"RESULT decode {name}: {'K4q' if scales else 'K4'} {ms:.4f} ms (bound "
          f"{bound_ms:.4f}), within phase 2's limits: {ok}", flush=True)
    del q, k, v, tables, lens, scales, out, ref
    torch.cuda.empty_cache()
'''

STEP = r'''
import sys, torch
sys.path.insert(0, ".")
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke as cs

cs.phase_card_and_build(torch)
perf = cs.phase_training(torch)[-1]
print(f"RESULT step: {perf['step_ms']:.1f} ms, {perf['tokens_per_s']:.1f} tokens/s, "
      f"MFU {perf['mfu_percent']:.2f}%", flush=True)
if "eager" in perf:  # a root whose phase 7 also runs the eager yardstick
    print(f"RESULT step eager: {perf['eager']['step_ms']:.1f} ms, "
          f"{perf['eager']['tokens_per_s']:.1f} tokens/s", flush=True)
'''

RESTORE = r'''
import sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from dlti_tpu_torch.checkpoint import store
from dlti_tpu_torch.config import CheckpointConfig
from dlti_tpu_torch.models.interop import init_params
from dlti_tpu_torch.training import Trainer
from dlti_tpu_torch.training.state import frozen_param_keys, state_leaves

directory = sys.argv[1]
cfg = cs.train_config(CheckpointConfig(save_strategy="no"), max_steps=0)
state = Trainer(cfg, params=init_params(cfg.model, seed=0, device="cuda", lora=cfg.lora),
                device="cuda").init_state()
leaves = state_leaves(state)
if not store.list_checkpoint_steps(directory):
    store.save_train_state(directory, 1, leaves, async_save=False)
for i in range(2):
    t0 = time.perf_counter()
    store.latest_verified_step(directory)
    scan = time.perf_counter() - t0
    cache = store.HostCache(frozen_param_keys(state))
    t0 = time.perf_counter()
    placed, step, _ = store.restore_latest_verified(directory, leaves, cache=cache)
    restore = time.perf_counter() - t0
    print(f"RESULT restore {i}: {restore:.2f} s (scan alone {scan:.2f} s) for step {step}",
          flush=True)
    del placed, cache
    torch.cuda.empty_cache()
'''

SERVE = r'''
import sys, torch
sys.path.insert(0, ".")
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke as cs

cs.phase_card_and_build(torch)
perf = cs.phase_server(torch)[-1]
print(f"RESULT serve: {perf['requests_per_s']:.3f} requests/s, mean TPOT "
      f"{1e3 * perf['tpot_mean_s']:.1f} ms, stepper p50 {perf['step_ms_p50']:.1f} ms, "
      f"mean {perf['step_ms_mean']:.1f} ms over {perf['engine_steps']} steps", flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", choices=("flash", "decode", "step", "serve", "restore",
                                       "both"),
                    default="both")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_ab: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)
    codes = {"flash": [FLASH], "decode": [DECODE], "step": [STEP], "serve": [SERVE],
             "restore": [RESTORE], "both": [FLASH, STEP]}[args.what]
    failed = False
    scratch = tempfile.mkdtemp(prefix="chip-ab-")  # restore's checkpoint
    try:
        for root in args.roots:
            for code in codes:
                run = subprocess.run([sys.executable, "-c", code, scratch], cwd=root,
                                     capture_output=True, text=True)
                for line in run.stdout.splitlines():
                    if line.startswith("RESULT "):
                        print(f"{root}: {line[len('RESULT '):]}", flush=True)
                if run.returncode != 0:
                    failed = True
                    print(f"{root}: exited {run.returncode}\n{run.stderr[-3000:]}",
                          flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
