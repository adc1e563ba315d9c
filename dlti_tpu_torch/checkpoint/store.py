"""Crash-consistent train-state checkpoint store: the port of
``dlti_tpu/checkpoint/store.py``, byte-compatible with it on disk, so
either package restores, verifies and exports what the other wrote.

* **Atomic commit.** A save writes everything into a
  ``.tmp-<step>-<pid>-<attempt>`` staging dir (array files, the sidecar,
  ``MANIFEST.json`` with per-file SHA-256 digests, then a ``COMMIT`` marker
  carrying the manifest's own digest, in that order, each fsynced), and
  only then renames it to the bare-integer step dir.
* **Verified resume.** :func:`latest_verified_step` /
  :func:`restore_latest_verified` walk committed steps newest-first,
  re-hash every file against the manifest, and quarantine (rename into
  ``_quarantine/``, count, log) anything incomplete or corrupt, falling
  back to the newest checkpoint that proves out.
* **Bounded retry.** A failed staging cycle retries with exponential
  backoff (``dlti_ckpt_save_retries``); a save that exhausts its retries
  is logged and never raised to the training loop.
* **Async by default.** The device-to-host snapshot happens on the
  caller's thread (the next step updates the state in place); hashing,
  file writes and the commit rename run on a per-directory writer thread.
  ``hashlib`` and file I/O release the GIL, so training overlaps them.
  :func:`wait_for_saves` joins the queue.

The port's state is a flat list of ``(name, tensor)`` under the JAX
pytree's key strings (``.params['model']['layers_0']...``), in the JAX
flatten order: ``training.state.state_leaves`` builds it. Arrays are raw
little-endian C-order buffers named in the manifest with that name, shape
and numpy dtype name; ``bfloat16`` is written as its bits, the bytes JAX
writes for it.

Where the port differs from the reference, the format does not:

* The snapshot copies every leaf into one host buffer (pinned on the card,
  with non-blocking copies and one stream synchronisation), so a save adds
  one wait on the card to its step. A :class:`HostCache` keeps the host
  copies and digests of leaves that do not change between saves (the
  frozen base under LoRA), guarded by each tensor's identity and its
  ``_version`` counter: an in-place write to the tensor makes it copy
  and hash anew. A write through ``.data`` bypasses the counter, as it
  bypasses autograd's checks. A resume seeds the cache with the host
  copies it read and their manifest digests, which the scan has just
  checked against the files, as the reference trusts them.
* Files are written and hashed by a few threads at once, and verification
  hashes files in parallel; the manifest lists them in leaf order all the
  same.
* The reference's ``_launder`` (a jitted copy of a restored state, the
  workaround for a heap fault in JAX's CPU backend when a transfer-created
  array is donated) has no counterpart: nothing here donates buffers.
* Data-parallel runs write consolidated checkpoints, as the reference's
  multi-host saves do: every rank joins the gathers of the leaves it holds
  shards of (``training.state.state_leaves``), rank 0 alone calls
  :func:`save_train_state`, and rotation and quarantine run there. The
  others restore the step rank 0's scan chose (``training.trainer``).
* A leaf that rests in pinned host memory (ZeRO-3's ``offload_params``) is
  its own host copy: the cache keeps the live tensor, so the frozen base is
  not held on the host twice.
* The reference's ENOSPC reclaimers are not ported.

Checkpoint layout (``<dir>/<step>/``)::

    train_state/l00000.bin ...   raw array bytes (little-endian, C order)
    train_meta.json              sidecar: data cursor, rng schedule, seeds
    MANIFEST.json                {leaves: [{name, shape, dtype, file,
                                 size, sha256}], meta_files: {...}}
    COMMIT                       {"manifest_sha256": ...}, written last
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import queue
import re
import shutil
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dlti_tpu_torch.models.interop import numpy_to_tensor, tensor_to_numpy
from dlti_tpu_torch.telemetry.registry import Counter, Gauge, Histogram
from dlti_tpu_torch.utils import durable_io

logger = logging.getLogger("dlti_tpu_torch.checkpoint")

_FORMAT_VERSION = 1
_MANIFEST = "MANIFEST.json"
_COMMIT = "COMMIT"
_SIDECAR = "train_meta.json"
_ARRAY_DIR = "train_state"
_TMP_PREFIX = ".tmp-"
_QUARANTINE_DIR = "_quarantine"
# Threads that write and hash a save's files, and hash or read a
# checkpoint's files, at once (SHA-256 runs ~1.4 GB/s on one core).
_IO_THREADS = 4
# Host buffers place each leaf at a multiple of this many bytes.
_ALIGN = 64

CKPT_IO_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0, 60.0, 120.0, 300.0)
CKPT_METRIC_NAMES = (
    "dlti_ckpt_save_seconds",
    "dlti_ckpt_restore_seconds",
    "dlti_ckpt_corrupt_skipped",
    "dlti_ckpt_save_retries",
    "dlti_ckpt_last_verified_step",
)

save_seconds = Histogram(
    CKPT_METRIC_NAMES[0], CKPT_IO_BUCKETS,
    help="checkpoint write+commit duration (writer thread)",
    stats_key="ckpt_save_seconds")
restore_seconds = Histogram(
    CKPT_METRIC_NAMES[1], CKPT_IO_BUCKETS,
    help="checkpoint read+place duration",
    stats_key="ckpt_restore_seconds")
corrupt_skipped = Counter(
    CKPT_METRIC_NAMES[2],
    help="checkpoints quarantined as incomplete or corrupt")
save_retries = Counter(
    CKPT_METRIC_NAMES[3],
    help="checkpoint save attempts retried after an I/O failure")
last_verified_step = Gauge(
    CKPT_METRIC_NAMES[4],
    help="newest checkpoint step that passed digest verification")

Leaves = Sequence[Tuple[str, torch.Tensor]]


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (truncated, bit-flipped,
    missing commit marker). Resume paths quarantine and fall back."""


# ----------------------------------------------------------------------
# Host snapshot: tensors -> host buffers (+ the frozen-leaf cache)
# ----------------------------------------------------------------------

def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _layout(tensors: Sequence[torch.Tensor]) -> Tuple[List[int], int]:
    offsets, total = [], 0
    for t in tensors:
        offsets.append(total)
        total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    return offsets, total


def _copy_to_host(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Host copies of ``tensors`` in one buffer, pinned when any lies on the
    card; copies from the card are queued without blocking, so the caller
    synchronises (:func:`_sync_sources`) before reading them."""
    offsets, total = _layout(tensors)
    on_cuda = any(t.is_cuda for t in tensors)
    buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=on_cuda)
    out = []
    for t, off in zip(tensors, offsets):
        n = t.numel() * t.element_size()
        dst = buf[off:off + n].view(t.dtype).view(t.shape)
        dst.copy_(t.detach(), non_blocking=on_cuda)
        out.append(dst)
    return out


def _sync_sources(tensors: Iterable[torch.Tensor]) -> None:
    """One synchronisation of the current stream of each card among the
    tensors' devices."""
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()


def _is_host_resident(t: torch.Tensor) -> bool:
    """A leaf kept in pinned host memory (offloaded): its own host copy."""
    return t.device.type == "cpu" and t.is_pinned()


@dataclasses.dataclass
class _CacheEntry:
    ref: "weakref.ref"
    version: int
    host: torch.Tensor
    sha256: Optional[str] = None


class HostCache:
    """Host copies (and, once a save has hashed them, digests) of the
    leaves named in ``names``, kept from one save to the next. An entry
    serves a save only while the live tensor is the same object at the same
    ``_version``."""

    def __init__(self, names: Iterable[str]):
        self.names = frozenset(names)
        self._entries: Dict[str, _CacheEntry] = {}
        self._lock = threading.Lock()
        # Verified host copies read by a restore, waiting for bind_restored.
        self._restored: Dict[str, Tuple[torch.Tensor, str]] = {}

    def lookup(self, name: str, t: torch.Tensor) -> Optional[_CacheEntry]:
        with self._lock:
            e = self._entries.get(name)
        if e is not None and e.ref() is t and e.version == t._version:
            return e
        return None

    def put(self, name: str, t: torch.Tensor, host: torch.Tensor,
            sha256: Optional[str] = None) -> _CacheEntry:
        e = _CacheEntry(weakref.ref(t), t._version, host, sha256)
        with self._lock:
            self._entries[name] = e
        return e

    def bind_restored(self, live: "Leaves") -> None:
        """After a restore (:func:`restore_latest_verified` with this cache)
        was loaded into the live state: record the host copies it read, with
        their manifest digests, as the copies of the live tensors, so the
        next save neither copies nor hashes them again."""
        for name, t in live:
            if name in self._restored:
                host, digest = self._restored[name]
                self.put(name, t, t.detach() if _is_host_resident(t) else host, digest)
        self._restored = {}

    def __len__(self) -> int:
        return len(self._entries)


@dataclasses.dataclass
class _HostLeaf:
    meta: dict
    data: np.ndarray           # 1-D uint8 view of the leaf's bytes
    entry: Optional[_CacheEntry] = None  # where a known digest lives


def _as_bytes(host: torch.Tensor) -> Tuple[np.ndarray, str]:
    arr, dtype = tensor_to_numpy(host)
    return arr.reshape(-1).view(np.uint8), dtype


def snapshot(leaves: Leaves, cache: Optional[HostCache] = None
             ) -> List[_HostLeaf]:
    """Every leaf's bytes on the host NOW (the state changes in place at the
    next step), with its manifest entry. Leaves the cache holds a current
    copy of are not copied again; leaves it may hold are copied into a
    buffer of their own, which the cache keeps."""
    hosts: List[Optional[torch.Tensor]] = [None] * len(leaves)
    entries: List[Optional[_CacheEntry]] = [None] * len(leaves)
    fresh, to_cache = [], []
    for i, (name, t) in enumerate(leaves):
        hit = cache.lookup(name, t) if cache is not None else None
        if hit is not None:
            hosts[i], entries[i] = hit.host, hit
        elif cache is not None and name in cache.names and _is_host_resident(t):
            hosts[i] = t.detach()
            entries[i] = cache.put(name, t, hosts[i])
        elif cache is not None and name in cache.names:
            to_cache.append(i)
        else:
            fresh.append(i)
    for group in (g for g in (fresh, to_cache) if g):
        for i, h in zip(group, _copy_to_host([leaves[i][1] for i in group])):
            hosts[i] = h
    _sync_sources(leaves[i][1] for i in fresh + to_cache)
    for i in to_cache:
        entries[i] = cache.put(leaves[i][0], leaves[i][1], hosts[i])
    out = []
    for i, ((name, _), host) in enumerate(zip(leaves, hosts)):
        data, dtype = _as_bytes(host)
        out.append(_HostLeaf(
            meta={"name": name, "shape": list(host.shape), "dtype": dtype,
                  "file": f"{_ARRAY_DIR}/l{i:05d}.bin"},
            data=data, entry=entries[i]))
    return out


def _decode_leaf(raw: np.ndarray, meta: dict) -> torch.Tensor:
    """A leaf's bytes (1-D uint8) as a CPU tensor sharing their memory."""
    name = meta["dtype"]
    np_dtype = np.uint16 if name == "bfloat16" else np.dtype(name)
    return numpy_to_tensor(raw.view(np_dtype), name).reshape(tuple(meta["shape"]))


def _sha256_bytes(data) -> str:
    return hashlib.sha256(data).hexdigest()


def _sha256_file(path: str, chunk: int = 16 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


# ----------------------------------------------------------------------
# Async writer: one thread + FIFO queue per checkpoint directory
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _PendingSave:
    step: int
    leaves: List[_HostLeaf]
    train_meta: Optional[dict]
    keep: Optional[int]
    retries: int
    retry_backoff_s: float
    # durable_io's path class: "prefix_tier" for KV-block demotions.
    path_class: str = "checkpoint"


class _Writer:
    def __init__(self, directory: str):
        self.directory = directory
        self._q: "queue.Queue[_PendingSave]" = queue.Queue()
        self._idle = threading.Event()
        self._idle.set()
        self.last_error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="dlti-ckpt-writer", daemon=True)
        self._thread.start()

    def submit(self, pending: _PendingSave) -> None:
        self._idle.clear()
        self._q.put(pending)

    def wait(self) -> None:
        self._q.join()
        self._idle.wait()

    @property
    def busy(self) -> bool:
        return not self._idle.is_set()

    def _run(self) -> None:
        while True:
            pending = self._q.get()
            try:
                _write_and_commit(self.directory, pending)
            except Exception as e:  # logged, not fatal: training goes on
                self.last_error = e
                logger.error("checkpoint save at step %s FAILED after retries: %s",
                             pending.step, e)
            finally:
                # Drop the snapshot (a host copy of the state) before waiting
                # for the next one.
                del pending
                self._q.task_done()
                if self._q.unfinished_tasks == 0:
                    self._idle.set()


_writers: Dict[str, _Writer] = {}
_writers_lock = threading.Lock()


def _writer(directory: str) -> _Writer:
    directory = os.path.abspath(directory)
    with _writers_lock:
        w = _writers.get(directory)
        if w is None:
            w = _writers[directory] = _Writer(directory)
        return w


def _write_and_commit(directory: str, p: _PendingSave) -> None:
    """The atomic-finalize protocol, with bounded retry and backoff."""
    t0 = time.perf_counter()
    final = os.path.join(directory, str(p.step))
    attempt = 0
    while True:
        tmp = os.path.join(directory, f"{_TMP_PREFIX}{p.step}-{os.getpid()}-{attempt}")
        try:
            if os.path.isdir(final):
                return  # idempotent: this step is already committed
            _write_staging(tmp, p)
            durable_io.replace(tmp, final)
            durable_io.fsync_dir(directory)
            break
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            attempt += 1
            if attempt > max(0, p.retries):
                raise
            save_retries.inc()
            time.sleep(p.retry_backoff_s * (2 ** (attempt - 1)))
    if p.keep:
        _rotate(directory, p.keep)
    last_verified_step.set(p.step)
    save_seconds.observe(time.perf_counter() - t0)


def _write_leaf(tmp: str, leaf: _HostLeaf, path_class: str) -> dict:
    known = leaf.entry.sha256 if leaf.entry is not None else None
    digest = known or _sha256_bytes(leaf.data)
    durable_io.write_bytes(os.path.join(tmp, leaf.meta["file"]), leaf.data,
                           path_class=path_class)
    if leaf.entry is not None and known is None:
        leaf.entry.sha256 = digest
    return {**leaf.meta, "size": int(leaf.data.nbytes), "sha256": digest}


def _write_staging(tmp: str, p: _PendingSave) -> None:
    os.makedirs(os.path.join(tmp, _ARRAY_DIR), exist_ok=True)
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        entries = list(pool.map(lambda leaf: _write_leaf(tmp, leaf, p.path_class),
                                p.leaves))
    manifest: dict = {"format": _FORMAT_VERSION, "step": p.step,
                      "leaves": entries, "meta_files": {}}
    if p.train_meta is not None:
        data = json.dumps(p.train_meta, indent=2, sort_keys=True).encode()
        durable_io.write_bytes(os.path.join(tmp, _SIDECAR), data,
                               path_class=p.path_class)
        manifest["meta_files"][_SIDECAR] = {
            "size": len(data), "sha256": _sha256_bytes(data)}
    mbytes = json.dumps(manifest, indent=2, sort_keys=True).encode()
    durable_io.write_bytes(os.path.join(tmp, _MANIFEST), mbytes,
                           path_class=p.path_class)
    # The commit marker is written LAST and names the manifest's digest: a
    # torn copy of this directory cannot present a valid COMMIT over a
    # mismatched manifest.
    durable_io.write_bytes(os.path.join(tmp, _COMMIT), json.dumps(
        {"manifest_sha256": _sha256_bytes(mbytes)}).encode(),
        path_class=p.path_class)
    durable_io.fsync_dir(os.path.join(tmp, _ARRAY_DIR))
    durable_io.fsync_dir(tmp)


def _rotate(directory: str, keep: int) -> None:
    steps = list_checkpoint_steps(directory)
    for step in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, str(step)), ignore_errors=True)


# ----------------------------------------------------------------------
# Public API
# ----------------------------------------------------------------------

def save_train_state(directory: str, step: int, leaves: Leaves,
                     keep: Optional[int] = 3, async_save: bool = True,
                     train_meta: Optional[dict] = None, retries: int = 3,
                     retry_backoff_s: float = 0.2,
                     cache: Optional[HostCache] = None) -> None:
    """Checkpoint ``leaves`` under ``directory/step`` atomically.

    The device-to-host snapshot is taken before this returns (the caller
    may change the state right after); writing, hashing and the commit
    rename happen on the directory's writer thread when ``async_save``
    (:func:`wait_for_saves` settles them)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    pending = _PendingSave(step=int(step), leaves=snapshot(leaves, cache),
                           train_meta=train_meta, keep=keep, retries=retries,
                           retry_backoff_s=retry_backoff_s)
    if async_save:
        _writer(directory).submit(pending)
    else:
        _write_and_commit(directory, pending)


def wait_for_saves(directory: str) -> None:
    """Block until every queued async save for ``directory`` has committed
    (or exhausted its retries: failures are logged, not raised, so exit
    paths can settle saves without masking the original exception)."""
    w = _writers.get(os.path.abspath(directory))
    if w is not None:
        w.wait()


def list_checkpoint_steps(directory: str) -> List[int]:
    """Committed (renamed-into-place) checkpoint steps, ascending. Staging
    (``.tmp-*``) and quarantined dirs are never listed."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit() and os.path.isdir(os.path.join(directory, name)))


def latest_step(directory: str) -> Optional[int]:
    """Newest committed step (no content verification)."""
    steps = list_checkpoint_steps(directory)
    return steps[-1] if steps else None


def verify_checkpoint(directory: str, step: int) -> Tuple[bool, str]:
    """Deep integrity check: commit marker present, manifest digest matches
    the marker, and every listed file exists with the recorded size and
    SHA-256. Returns (ok, reason)."""
    return _verify_root(os.path.join(os.path.abspath(directory), str(step)))


def verify_pytree_dir(directory: str) -> Tuple[bool, str]:
    """The same deep check for a :func:`save_pytree` artifact."""
    return _verify_root(os.path.abspath(directory))


def manifest_digest(directory: str) -> Optional[str]:
    """The committed manifest's SHA-256 for a step dir or a
    :func:`save_pytree` dir; None without a readable commit marker."""
    try:
        with open(os.path.join(os.path.abspath(directory), _COMMIT), "rb") as f:
            return json.loads(f.read()).get("manifest_sha256")
    except (OSError, ValueError):
        return None


def _read_manifest(root: str) -> Tuple[Optional[dict], str]:
    commit_path = os.path.join(root, _COMMIT)
    manifest_path = os.path.join(root, _MANIFEST)
    if not os.path.isfile(commit_path):
        return None, "missing-commit"
    if not os.path.isfile(manifest_path):
        return None, "missing-manifest"
    try:
        with open(manifest_path, "rb") as f:
            mbytes = f.read()
        with open(commit_path, "rb") as f:
            commit = json.loads(f.read())
        if commit.get("manifest_sha256") != _sha256_bytes(mbytes):
            return None, "manifest-digest-mismatch"
        return json.loads(mbytes), "ok"
    except (ValueError, OSError):
        return None, "bad-manifest"


def _verify_root(root: str) -> Tuple[bool, str]:
    manifest, reason = _read_manifest(root)
    if manifest is None:
        return False, reason
    entries = list(manifest.get("leaves", []))
    entries += [dict(v, file=k) for k, v in manifest.get("meta_files", {}).items()]
    paths = [os.path.join(root, e["file"]) for e in entries]
    for entry, path in zip(entries, paths):
        if not os.path.isfile(path):
            return False, f"missing-file:{entry['file']}"
        if os.path.getsize(path) != entry["size"]:
            return False, f"size-mismatch:{entry['file']}"
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        digests = list(pool.map(_sha256_file, paths))
    for entry, digest in zip(entries, digests):
        if digest != entry["sha256"]:
            return False, f"digest-mismatch:{entry['file']}"
    return True, "ok"


def quarantine_step(directory: str, name: str, reason: str) -> Optional[str]:
    """Move a checkpoint (or staging dir) aside instead of deleting it: the
    bytes stay for forensics and the resume scan stops seeing it. Returns
    the quarantine path."""
    directory = os.path.abspath(directory)
    src = os.path.join(directory, name)
    if not os.path.exists(src):
        return None
    qdir = os.path.join(directory, _QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    safe_reason = "".join(c if c.isalnum() or c in "-_." else "-" for c in reason)
    k = 0
    while True:
        dst = os.path.join(qdir, f"{name.lstrip('.')}__{safe_reason}__{k}")
        if not os.path.exists(dst):
            break
        k += 1
    durable_io.replace(src, dst)
    corrupt_skipped.inc()
    logger.warning("quarantined checkpoint %s (%s) -> %s", src, reason, dst)
    return dst


def latest_verified_step(directory: str) -> Optional[int]:
    """Newest step that passes :func:`verify_checkpoint`. Anything newer
    that fails is quarantined, and so are stale staging dirs of killed
    saves (when no save of this process is in flight)."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    w = _writers.get(directory)
    if w is None or not w.busy:
        for name in sorted(os.listdir(directory)):
            if name.startswith(_TMP_PREFIX):
                quarantine_step(directory, name, "incomplete-save")
    for step in reversed(list_checkpoint_steps(directory)):
        ok, reason = verify_checkpoint(directory, step)
        if ok:
            last_verified_step.set(step)
            return step
        quarantine_step(directory, str(step), reason)
    return None


def load_train_meta(directory: str, step: int) -> Optional[dict]:
    """The sidecar written beside the arrays; None for a checkpoint saved
    without one."""
    path = os.path.join(os.path.abspath(directory), str(step), _SIDECAR)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _read_into(path: str, out: np.ndarray) -> None:
    """Fill ``out`` (1-D uint8) with the file's bytes; the file must hold
    exactly that many."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size != out.nbytes:
            raise CheckpointCorruptError(
                f"array file {path} is {os.fstat(f.fileno()).st_size} bytes, "
                f"manifest says {out.nbytes} (truncated?)")
        view, got = memoryview(out), 0
        while got < out.nbytes:
            n = f.readinto(view[got:])
            if not n:
                raise CheckpointCorruptError(f"array file {path} ended early")
            got += n


def _read_leaves(root: str, entries: Sequence[dict], pinned: bool,
                 verify: bool) -> List[torch.Tensor]:
    """Every entry's file read (by a few threads) into one host buffer;
    with ``verify`` each is hashed against its manifest digest."""
    sizes = [int(e["size"]) for e in entries]
    offsets, total = [], 0
    for s in sizes:
        offsets.append(total)
        total += -(-s // _ALIGN) * _ALIGN
    buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=pinned)
    raw = buf.numpy()

    def read(i: int) -> None:
        e, view = entries[i], raw[offsets[i]:offsets[i] + sizes[i]]
        try:
            _read_into(os.path.join(root, e["file"]), view)
        except OSError as err:
            raise CheckpointCorruptError(
                f"unreadable array file {e['file']} under {root}: {err}") from err
        if verify and _sha256_bytes(view) != e["sha256"]:
            raise CheckpointCorruptError(
                f"array file {e['file']} under {root} failed its digest check")

    with ThreadPoolExecutor(_IO_THREADS) as pool:
        list(pool.map(read, range(len(entries))))
    return [_decode_leaf(raw[o:o + s], e) for o, s, e in zip(offsets, sizes, entries)]


def restore_train_state(directory: str, step: int, target: Leaves, *,
                        device=None) -> Leaves:
    """Read step ``step`` into the structure of ``target`` (the state's
    leaves, as ``state_leaves`` gives them; they may live on the ``meta``
    device). Returns ``[(name, tensor)]`` on ``device`` (default: each
    template leaf's device) with the template's dtypes, read into one host
    buffer (pinned when the card is the destination).

    Raises :class:`CheckpointCorruptError` on unreadable or damaged data
    and ``ValueError`` on a structure mismatch (another model, optimizer or
    LoRA config)."""
    restored, _ = _restore(directory, step, target, device)
    return restored


def _restore(directory, step, target, device):
    t0 = time.perf_counter()
    root = os.path.join(os.path.abspath(directory), str(step))
    try:
        with open(os.path.join(root, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest for step {step} under {directory}: {e}") from e
    entries = manifest.get("leaves", [])
    if len(entries) != len(target):
        raise ValueError(
            f"checkpoint step {step} has {len(entries)} array leaves but the "
            f"target state has {len(target)}; the run config "
            "(model/optimizer/LoRA) does not match the checkpoint")
    devices = []
    for entry, (name, leaf) in zip(entries, target):
        if entry["name"] != name:
            raise ValueError(f"checkpoint leaf {entry['name']!r} does not line up "
                             f"with target leaf {name!r} (structure mismatch)")
        want_shape, want_dtype = tuple(entry["shape"]), entry["dtype"]
        if tuple(leaf.shape) != want_shape or _dtype_name(leaf) != want_dtype:
            raise ValueError(
                f"checkpoint leaf {name} is {want_dtype}{list(want_shape)} but the "
                f"target expects {_dtype_name(leaf)}{list(leaf.shape)}")
        dev = torch.device(device) if device is not None else leaf.device
        if dev.type == "meta":
            raise ValueError(f"target leaf {name} is on the meta device: pass device=")
        devices.append(dev)
    hosts = _read_leaves(root, entries, pinned=any(d.type == "cuda" for d in devices),
                         verify=False)
    placed = [(name, h.to(dev, non_blocking=True) if dev.type != "cpu" else h.clone())
              for (name, _), h, dev in zip(target, hosts, devices)]
    _sync_sources(t for _, t in placed)
    restore_seconds.observe(time.perf_counter() - t0)
    return placed, [(h, e["sha256"]) for h, e in zip(hosts, entries)]


def restore_latest_verified(directory: str, target: Leaves, *, device=None,
                            cache: Optional[HostCache] = None
                            ) -> Optional[Tuple[Leaves, int, Optional[dict]]]:
    """Resume entry point: restore the newest checkpoint that verifies,
    quarantining and falling back past any that turn out corrupt even after
    passing the scan. Returns ``(leaves, step, sidecar)`` or None when
    nothing restorable exists; ``ValueError`` (a structure mismatch)
    propagates.

    Every file is hashed once, by the scan. With ``cache``, the host copies
    of the leaves the cache may hold wait for :meth:`HostCache.bind_restored`
    with the digests the scan checked."""
    while True:
        step = latest_verified_step(directory)
        if step is None:
            return None
        try:
            placed, hosts = _restore(directory, step, target, device)
        except CheckpointCorruptError as e:
            logger.warning("verified checkpoint step %d failed on restore (%s); "
                           "falling back", step, e)
            quarantine_step(directory, str(step), "restore-failed")
            continue
        if cache is not None:
            cache._restored = {name: host for (name, _), host in zip(target, hosts)
                               if name in cache.names}
        return placed, step, load_train_meta(directory, step)


# ----------------------------------------------------------------------
# Pytree artifacts (exports): nested dicts of tensors
# ----------------------------------------------------------------------

def flatten_tree(tree: Mapping, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """A nested dict's leaves in the JAX flatten order (sorted keys), named
    by their key strings (``['model']['layers_0']...``). numpy leaves
    become tensors."""
    out = []
    for k in sorted(tree):
        v, name = tree[k], f"{prefix}[{k!r}]"
        if isinstance(v, Mapping):
            out += flatten_tree(v, name)
        else:
            out.append((name, v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))))
    return out


def save_pytree(directory: str, tree: Mapping, *,
                path_class: str = "checkpoint") -> str:
    """Write a nested dict of tensors (an export's params, a prefix-cache
    block) with the same manifest and commit protocol as a step checkpoint,
    synchronously and atomically (staging dir + rename). ``path_class``
    selects durable_io's retry budget (``"prefix_tier"`` for KV-block
    demotions). A save that fails mid-staging quarantines its staging dir
    and re-raises. Returns ``directory``."""
    directory = os.path.abspath(directory)
    parent = os.path.dirname(directory) or "."
    os.makedirs(parent, exist_ok=True)
    pending = _PendingSave(step=0, leaves=snapshot(flatten_tree(tree)),
                           train_meta=None, keep=None, retries=3, retry_backoff_s=0.2,
                           path_class=path_class)
    tmp = f"{directory}{_TMP_PREFIX}{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        _write_staging(tmp, pending)
        if os.path.isdir(directory):
            shutil.rmtree(directory)
        durable_io.replace(tmp, directory, path_class=path_class)
    except BaseException:
        try:
            quarantine_step(parent, os.path.basename(tmp), "save-failed")
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    durable_io.fsync_dir(parent)
    return directory


def manifest_of(tree: Mapping) -> bytes:
    """The ``MANIFEST.json`` bytes :func:`save_pytree` would write for
    ``tree``, computed without writing: its SHA-256 is the digest the
    export's commit marker would carry."""
    leaves = snapshot(flatten_tree(tree))
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        digests = list(pool.map(lambda leaf: _sha256_bytes(leaf.data), leaves))
    entries = [{**leaf.meta, "size": int(leaf.data.nbytes), "sha256": d}
               for leaf, d in zip(leaves, digests)]
    return json.dumps({"format": _FORMAT_VERSION, "step": 0, "leaves": entries,
                       "meta_files": {}}, indent=2, sort_keys=True).encode()


_KEY_RE = re.compile(r"\['([^']*)'\]")


def parse_keys(name: str) -> List[str]:
    """``['model']['layers_0']`` -> ``['model', 'layers_0']``; raises on a
    name that is not a dict-keyed path."""
    keys = _KEY_RE.findall(name)
    if not keys or "".join(f"['{k}']" for k in keys) != name:
        raise ValueError(f"leaf {name!r} is not a dict-keyed path; only "
                         "nested-dict trees load")
    return keys


def load_pytree(directory: str, verify: bool = False, device=None) -> dict:
    """Load a :func:`save_pytree` artifact (either package's) back into
    nested dicts of tensors (on the CPU unless ``device`` names another)."""
    directory = os.path.abspath(directory)
    try:
        with open(os.path.join(directory, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"unreadable manifest under {directory}: {e}") from e
    entries = manifest.get("leaves", [])
    keys = [parse_keys(e["name"]) for e in entries]
    dev = torch.device(device) if device is not None else torch.device("cpu")
    hosts = _read_leaves(directory, entries, pinned=dev.type == "cuda", verify=verify)
    out: dict = {}
    for path, host in zip(keys, hosts):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = host.to(dev, non_blocking=True) if dev.type != "cpu" else host.clone()
    _sync_sources(t for _, t in flatten_tree(out))
    return out
