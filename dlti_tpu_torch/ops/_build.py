"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled, the first time a CUDA tensor needs it,
into ``build/torch_kernels/lib<name>-<hash>.so`` at the repository root
(a directory ``.gitignore`` lists) for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o lib<name>-<hash>.so <name>.cu

A source :data:`PARTS` names is compiled in parts instead, all at once
(``nvcc -c -DDLTI_PART=i``, each part one family of its programs: the
source says which), and the objects are linked into the one library: the
build then takes about as long as its largest part. The file name carries a
hash of the source and its parts, so an edited kernel is rebuilt and a
stale library is never loaded. The sources expose plain C functions;
nothing here includes PyTorch's headers, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Sources compiled in this many parts (``-DDLTI_PART=0..n-1``).
PARTS = {"flash_attention": 3, "paged_attention": 4}

_loaded: Dict[str, ctypes.CDLL] = {}
# Per source: seconds its nvcc took and the compiler's -Xptxas -v report,
# for the chip smoke test to print (empty when the library was already built).
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    parts = f"parts={PARTS.get(name, 1)}".encode()
    digest = hashlib.sha256(src.read_bytes() + parts).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) that have no
    up-to-date library yet, one ``nvcc`` process per source or part, all
    started together. Returns each name's library path."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    paths = {n: _library_path(n) for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def start(cmd):
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)

    jobs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp, src = path.with_suffix(f".tmp{os.getpid()}"), str(CSRC_DIR / f"{name}.cu")
        n = PARTS.get(name, 1)
        objs = [f"{tmp}.{i}.o" for i in range(n)] if n > 1 else []
        procs = ([start([_nvcc(), *NVCC_FLAGS, "-c", f"-DDLTI_PART={i}", "-o", o, src])
                  for i, o in enumerate(objs)]
                 or [start([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), src])])
        jobs[name] = (procs, objs, tmp, time.perf_counter())
    for name, (procs, objs, tmp, t0) in jobs.items():
        logs = [proc.communicate()[0] for proc in procs]
        failed = [log for proc, log in zip(procs, logs) if proc.returncode != 0]
        if objs and not failed:
            link = subprocess.run([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            if link.returncode != 0:
                failed.append(link.stdout)
        for o in objs:
            Path(o).unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n" + "\n".join(failed))
        os.replace(tmp, paths[name])  # atomic: concurrent builders agree
        build_log[name] = {"seconds": time.perf_counter() - t0, "log": "\n".join(logs)}
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return lib
