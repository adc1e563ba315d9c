"""Durable file writes for the checkpoint store and the prefix cache's disk
tier: this package's copy of the part of ``dlti_tpu/utils/durable_io.py``
that they use (``write_bytes`` with fsync, ``replace``, the fsync of a
directory, the ENOSPC reclaimers and ``dir_bytes``).

Each write names its path class, whose retry budget is the reference's:
``"checkpoint"`` 3 retries, ``"prefix_tier"`` 1. A transient errno
(``EIO``, ``EAGAIN``, ``EINTR``, ``EBUSY``, ``ETIMEDOUT``, ``ESTALE``: the
flaky-network-filesystem family) retries with exponential backoff within
that budget; ``ENOSPC``/``EDQUOT`` first runs the registered reclaimers
once (components offer what they can afford to lose: quarantined
wreckage, cold disk-tier blocks) and retries at once if they freed
anything. Any other error, or the last retryable one, is raised for the
caller's own fallback. The reference's per-class degrade ledger and its
fault injector are not ported: their consumers (the fleet, the chaos
drills) are not ported either. Tests inject faults by replacing
:func:`_raw_write_bytes` or :func:`_raw_replace`, the only two places that
touch the file boundary.
"""

from __future__ import annotations

import errno
import logging
import os
import shutil
import threading
import time
from typing import Callable, Dict

# Retry budgets by path class, the reference's (3 retries = 4 attempts).
RETRIES = {"checkpoint": 3, "prefix_tier": 1}
BACKOFF_S = 0.05

_TRANSIENT_ERRNOS = frozenset(
    e for e in (errno.EIO, errno.EAGAIN, errno.EINTR, errno.EBUSY,
                errno.ETIMEDOUT, getattr(errno, "ESTALE", None))
    if e is not None)
_RECLAIM_ERRNOS = frozenset(
    e for e in (errno.ENOSPC, getattr(errno, "EDQUOT", None))
    if e is not None)

_lock = threading.Lock()
logger = logging.getLogger("dlti_tpu_torch.durable_io")
_reclaimers: Dict[str, Callable[[int], int]] = {}


def _raw_write_bytes(path: str, data) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _raw_replace(src: str, dst: str) -> None:
    os.replace(src, dst)


def _attempt(op: Callable[[], None], path_class: str, nbytes: int) -> None:
    budget = RETRIES[path_class]
    attempt = 0
    reclaimed = False
    while True:
        try:
            op()
            return
        except OSError as e:
            if e.errno in _RECLAIM_ERRNOS and not reclaimed:
                reclaimed = True
                if reclaim(max(nbytes, 1)) > 0:
                    continue  # space came back: retry without burning budget
            retryable = e.errno in _TRANSIENT_ERRNOS or e.errno in _RECLAIM_ERRNOS
            if not retryable or attempt >= budget:
                raise
            time.sleep(BACKOFF_S * (2 ** attempt))
            attempt += 1


def write_bytes(path: str, data, *, path_class: str = "checkpoint") -> None:
    """Write ``data`` (bytes or any contiguous buffer) to ``path``,
    replacing it, and fsync it."""
    path = str(path)
    _attempt(lambda: _raw_write_bytes(path, data), path_class,
             memoryview(data).nbytes)


def replace(src: str, dst: str, *, path_class: str = "checkpoint") -> None:
    """``os.replace`` (an atomic rename, staging directories included)."""
    src, dst = str(src), str(dst)
    _attempt(lambda: _raw_replace(src, dst), path_class, 0)


def register_reclaimer(name: str, fn: Callable[[int], int]) -> None:
    """Register ``fn(bytes_needed) -> bytes_freed`` under ``name``
    (re-registering a name replaces it)."""
    with _lock:
        _reclaimers[name] = fn


def reclaim(bytes_needed: int) -> int:
    """Run reclaimers until ``bytes_needed`` is freed (or all ran); returns
    the bytes freed. A reclaimer that raises is logged and skipped."""
    with _lock:
        items = list(_reclaimers.items())
    freed = 0
    for name, fn in items:
        try:
            freed += max(0, int(fn(max(0, bytes_needed - freed))))
        except Exception:
            logger.exception("reclaimer %r failed", name)
        if bytes_needed > 0 and freed >= bytes_needed:
            break
    logger.warning("durable_io: reclaim pass freed %d bytes (%d "
                         "reclaimers, wanted %d)", freed, len(items), bytes_needed)
    return freed


def dir_bytes(path: str) -> int:
    """Recursive byte count of ``path`` (file or directory)."""
    if os.path.isfile(path):
        try:
            return os.path.getsize(path)
        except OSError:
            return 0
    total = 0
    for root, _dirs, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return total


def sweep_oldest(directory: str, keep: int = 0, bytes_needed: int = 0) -> int:
    """Delete oldest-mtime entries under ``directory`` until ``keep`` remain
    (stopping early once ``bytes_needed`` > 0 is freed); returns bytes
    freed."""
    if not os.path.isdir(directory):
        return 0
    try:
        entries = sorted(
            (os.path.join(directory, n) for n in os.listdir(directory)),
            key=lambda p: os.path.getmtime(p) if os.path.exists(p) else 0)
    except OSError:
        return 0
    freed = 0
    for path in (entries[:-keep] if keep > 0 else entries):
        size = dir_bytes(path)
        try:
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.remove(path)
        except OSError:
            continue
        freed += size
        if bytes_needed > 0 and freed >= bytes_needed:
            break
    return freed


def quarantine_reclaimer(root: str,
                         subdir: str = "_quarantine") -> Callable[[int], int]:
    """A reclaimer that empties ``root/subdir`` oldest first: quarantined
    wreckage is forensics, and forensics lose to keeping the run writing."""
    qdir = os.path.join(os.path.abspath(root), subdir)

    def _sweep(bytes_needed: int) -> int:
        return sweep_oldest(qdir, keep=0, bytes_needed=bytes_needed)

    return _sweep


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename or a new file in it is durable. Best
    effort: some filesystems refuse ``O_RDONLY`` on directories."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
