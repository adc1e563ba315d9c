"""Durable file writes for the checkpoint store: this package's copy of the
part of ``dlti_tpu/utils/durable_io.py`` that the store uses (its
``write_bytes`` with fsync, ``replace``, and the fsync of a directory).

A transient errno (``EIO``, ``EAGAIN``, ``EINTR``, ``EBUSY``,
``ETIMEDOUT``, ``ESTALE``: the flaky-network-filesystem family) retries
with exponential backoff, up to the checkpoint class's budget of 3 retries;
any other error, or the last transient one, is raised for the store's own
staging retry to handle. The reference's per-class degrade ledger, its
fault injector and its ENOSPC reclaimers are not ported: their consumers
(the fleet, the chaos drills) are not ported either. Tests inject faults by
replacing :func:`_raw_write_bytes` or :func:`_raw_replace`, the only two
places that touch the file boundary.
"""

from __future__ import annotations

import errno
import os
import time
from typing import Callable

# The checkpoint class's retry budget in the reference (3 retries = 4 attempts).
RETRIES = 3
BACKOFF_S = 0.05

_TRANSIENT_ERRNOS = frozenset(
    e for e in (errno.EIO, errno.EAGAIN, errno.EINTR, errno.EBUSY,
                errno.ETIMEDOUT, getattr(errno, "ESTALE", None))
    if e is not None)


def _raw_write_bytes(path: str, data) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _raw_replace(src: str, dst: str) -> None:
    os.replace(src, dst)


def _attempt(op: Callable[[], None]) -> None:
    attempt = 0
    while True:
        try:
            op()
            return
        except OSError as e:
            if e.errno not in _TRANSIENT_ERRNOS or attempt >= RETRIES:
                raise
            time.sleep(BACKOFF_S * (2 ** attempt))
            attempt += 1


def write_bytes(path: str, data) -> None:
    """Write ``data`` (bytes or any contiguous buffer) to ``path``,
    replacing it, and fsync it."""
    path = str(path)
    _attempt(lambda: _raw_write_bytes(path, data))


def replace(src: str, dst: str) -> None:
    """``os.replace`` (an atomic rename, staging directories included)."""
    src, dst = str(src), str(dst)
    _attempt(lambda: _raw_replace(src, dst))


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
