"""Lower tiers of the hierarchical prefix-KV cache: host RAM and disk. The
port of ``dlti_tpu/serving/prefix_tiers.py``: the same tiers, budgets,
digest names and quarantine convention.

Without tiers the HBM prefix cache (:mod:`dlti_tpu_torch.serving.
prefix_cache`) *discards* evicted blocks — a returning chat session whose
system prompt fell out of the pool re-prefills it from scratch. This
module is the memory hierarchy below the device pool:

* **Host tier** — a bounded LRU of evicted blocks' KV payloads in host
  RAM (CPU tensors, fetched device→host at eviction time through pinned
  memory by ``EngineExecutor.fetch_block_kv``). Restoring from here costs
  one host→device scatter instead of a full re-prefill.
* **Disk tier** — host-tier overflow demotes to digest-verified block
  dirs written with the checkpoint store's manifest/SHA-256 protocol
  (:func:`dlti_tpu_torch.checkpoint.store.save_pytree` — atomic staging +
  rename, per-file SHA-256 in ``MANIFEST.json``). A bit-flipped or
  truncated block fails verification on read, is *quarantined* into
  ``_quarantine/`` (the checkpoint store's convention), and reads as a
  cache miss — never an engine fault.

Tier payloads are keyed by the allocator's exact chain key (nested token
tuples), so a lower-tier hit carries the same no-collision guarantee as
an HBM hit. A hit *pops* the payload (the block promotes back up to HBM;
budgets stay meaningful), and every byte moved down comes back up
bit-identical (round-trip equality is tier-1-tested).

Metric names (tier-labeled, the reference's) live in
:mod:`dlti_tpu_torch.serving.prefix_cache` alongside the allocator that
drives them.
"""

from __future__ import annotations

import collections
import hashlib
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from dlti_tpu_torch.utils import durable_io

_QUARANTINE_DIR = "_quarantine"

# Disk-tier health policy: this many consecutive write failures flip the
# tier memory-only (writes skipped, existing blocks still readable) until
# the cooldown expires, when the next demotion probes the disk again. A
# dead disk costs pool misses / re-prefills — never a request error.
DISK_FAIL_LIMIT = 3
DISK_RETRY_COOLDOWN_S = 30.0

# A block payload: {"l00000": {"k": torch.Tensor, "v": torch.Tensor, ...}, ...}
# — one entry per model layer, every array of the per-layer pool's row
# shape (block_size, kv_heads, head_dim) (plus scale rows for int8 pools).
Payload = Dict[str, Dict[str, torch.Tensor]]


def key_digest(key: tuple) -> str:
    """Stable content digest of a chain key (used as the disk dir name).

    The chain key is nested tuples of ints, whose ``repr`` is canonical
    across processes — so a restarted server could in principle re-adopt
    block dirs (today the index is in-memory and rebuilt empty).
    """
    return hashlib.sha256(repr(key).encode()).hexdigest()[:32]


class TieredBlockStore:
    """Bounded host-RAM + disk store of demoted prefix-KV blocks.

    Single-threaded by contract: all calls happen on the engine stepper
    thread (the same contract as the allocator it backs). The one
    exception is the durable writer's ENOSPC reclaimer, which may fire
    on any thread mid-write — the disk index is lock-protected for it.

    Disk-tier storage faults degrade, never error: ``disk_fail_limit``
    consecutive write failures flip the tier memory-only until
    ``disk_retry_cooldown_s`` elapses, then the next demotion probes the
    disk again (automatic recovery once the fault clears).
    """

    def __init__(self, host_blocks: int = 0, disk_dir: str = "",
                 disk_blocks: int = 0,
                 disk_fail_limit: int = DISK_FAIL_LIMIT,
                 disk_retry_cooldown_s: float = DISK_RETRY_COOLDOWN_S,
                 clock: Callable[[], float] = time.monotonic):
        if disk_blocks > 0 and not disk_dir:
            raise ValueError("disk_blocks > 0 needs a disk_dir")
        self.host_blocks = int(host_blocks)
        self.disk_dir = os.path.abspath(disk_dir) if disk_dir else ""
        self.disk_blocks = int(disk_blocks) if self.disk_dir else 0
        self.disk_fail_limit = int(disk_fail_limit)
        self.disk_retry_cooldown_s = float(disk_retry_cooldown_s)
        self._clock = clock
        # LRU order, oldest first; host maps key -> payload, disk maps
        # key -> block dir path (the index is in-memory: payloads on disk
        # are only trusted after digest verification at read time).
        self._host: "collections.OrderedDict[tuple, Payload]" = \
            collections.OrderedDict()
        self._disk: "collections.OrderedDict[tuple, str]" = \
            collections.OrderedDict()
        self._disk_lock = threading.Lock()
        self._fail_streak = 0
        self._down_until = 0.0     # clock() time the cooldown expires
        self.logger = logging.getLogger("dlti_tpu_torch.serving")
        self.stats = {"host_puts": 0, "disk_puts": 0, "host_hits": 0,
                      "disk_hits": 0, "disk_evictions": 0,
                      "corrupt_dropped": 0, "disk_write_failures": 0,
                      "disk_degraded_skips": 0}
        if self.disk_dir:
            os.makedirs(self.disk_dir, exist_ok=True)
            # ENOSPC escape hatches: quarantined wreckage first, then
            # cold (oldest-LRU) live blocks — a demoted block is a cache
            # entry, and cache entries lose to keeping the system writing.
            durable_io.register_reclaimer(
                f"prefix-quarantine:{self.disk_dir}",
                durable_io.quarantine_reclaimer(self.disk_dir))
            durable_io.register_reclaimer(
                f"prefix-cold-blocks:{self.disk_dir}",
                self._reclaim_cold_blocks)

    @property
    def disk_degraded(self) -> bool:
        """True while the disk tier is flipped memory-only."""
        return (self._fail_streak >= self.disk_fail_limit
                and self._clock() < self._down_until)

    def _reclaim_cold_blocks(self, bytes_needed: int) -> int:
        """Durable-writer reclaimer: drop oldest-LRU disk blocks (each
        one is just a future cache hit) until enough bytes are freed."""
        import shutil

        freed = 0
        while True:
            with self._disk_lock:
                if not self._disk:
                    break
                _vk, vpath = self._disk.popitem(last=False)
            size = durable_io.dir_bytes(vpath)
            shutil.rmtree(vpath, ignore_errors=True)
            self.stats["disk_evictions"] += 1
            freed += size
            if bytes_needed > 0 and freed >= bytes_needed:
                break
        return freed

    # ------------------------------------------------------------------
    @property
    def num_host_blocks(self) -> int:
        return len(self._host)

    @property
    def num_disk_blocks(self) -> int:
        with self._disk_lock:
            return len(self._disk)

    def tier_of(self, key: tuple) -> Optional[str]:
        """Which tier holds ``key`` (index lookup only — a disk entry may
        still fail verification at fetch time)."""
        if key in self._host:
            return "host"
        with self._disk_lock:
            if key in self._disk:
                return "disk"
        return None

    # ------------------------------------------------------------------
    def put(self, key: tuple, payload: Payload) -> Optional[str]:
        """Demote an evicted HBM block's payload into the hierarchy.

        Returns the tier it landed in ("host" | "disk") or None when no
        tier is configured to take it (payload dropped, legacy behavior).
        Host overflow cascades its LRU victim down to disk.
        """
        with self._disk_lock:
            if key in self._host or key in self._disk:
                return None  # already demoted under this content key
        if self.host_blocks > 0:
            self._host[key] = payload
            self._host.move_to_end(key)
            self.stats["host_puts"] += 1
            while len(self._host) > self.host_blocks:
                from dlti_tpu_torch.serving.prefix_cache import (
                    demotions_total, evictions_total,
                )

                vk, vp = self._host.popitem(last=False)  # LRU victim
                evictions_total.labels(tier="host").inc()
                if self._spill_to_disk(vk, vp) is not None:
                    demotions_total.labels(tier="disk").inc()
            return "host"
        return self._spill_to_disk(key, payload)

    def _spill_to_disk(self, key: tuple, payload: Payload) -> Optional[str]:
        if self.disk_blocks <= 0:
            return None  # no disk tier: the payload is dropped
        if self.disk_degraded:
            # Memory-only until the cooldown expires: the demotion reads
            # as a drop (a future pool miss), never a request error.
            self.stats["disk_degraded_skips"] += 1
            return None
        from dlti_tpu_torch.checkpoint.store import save_pytree

        path = os.path.join(self.disk_dir, f"block-{key_digest(key)}")
        # A payload fetched from the card may still be copying to the host:
        # its bytes are read here, so wait for them.
        wait = getattr(payload, "wait", None)
        if wait is not None:
            wait()
        try:
            # Checkpoint-store protocol: staging dir + per-file SHA-256
            # manifest + atomic rename — a kill mid-write can never
            # present a torn block as valid. path_class="prefix_tier"
            # gives the writes the tier's (short) retry budget.
            save_pytree(path, payload, path_class="prefix_tier")
        except OSError as e:
            self.stats["disk_write_failures"] += 1
            self._fail_streak += 1
            if self._fail_streak >= self.disk_fail_limit:
                newly = self._clock() >= self._down_until
                self._down_until = self._clock() + self.disk_retry_cooldown_s
                if newly:
                    self.logger.error(
                        "prefix disk tier DEGRADED to memory-only after %d "
                        "consecutive write failures (last: %s); retrying "
                        "in %.0fs", self._fail_streak, e,
                        self.disk_retry_cooldown_s)
            else:
                self.logger.warning("prefix disk tier write failed (%s); "
                                    "block dropped", e)
            return None
        if self._fail_streak:
            self.logger.warning("prefix disk tier recovered (write "
                                "succeeded after %d failures)",
                                self._fail_streak)
        self._fail_streak = 0
        self._down_until = 0.0
        with self._disk_lock:
            self._disk[key] = path
            self._disk.move_to_end(key)
        self.stats["disk_puts"] += 1
        while True:
            with self._disk_lock:
                if len(self._disk) <= self.disk_blocks:
                    break
                vk, vpath = self._disk.popitem(last=False)
            from dlti_tpu_torch.serving.prefix_cache import evictions_total

            import shutil

            shutil.rmtree(vpath, ignore_errors=True)
            self.stats["disk_evictions"] += 1
            evictions_total.labels(tier="disk").inc()
        return "disk"

    # ------------------------------------------------------------------
    def fetch(self, key: tuple) -> Tuple[Optional[Payload], Optional[str]]:
        """Pop ``key``'s payload for promotion back to HBM.

        Returns ``(payload, tier)``; ``(None, None)`` on miss. A disk
        payload that fails digest verification is quarantined and
        reported as a miss — corruption degrades, never faults.
        """
        payload = self._host.pop(key, None)
        if payload is not None:
            self.stats["host_hits"] += 1
            return payload, "host"
        with self._disk_lock:
            path = self._disk.pop(key, None)
        if path is None:
            return None, None
        from dlti_tpu_torch.checkpoint.store import (
            CheckpointCorruptError, load_pytree,
        )

        try:
            payload = load_pytree(path, verify=True)
        except (CheckpointCorruptError, OSError, ValueError, KeyError) as e:
            self._quarantine(path, f"{type(e).__name__}")
            self.stats["corrupt_dropped"] += 1
            return None, None
        import shutil

        shutil.rmtree(path, ignore_errors=True)  # promoted back up
        self.stats["disk_hits"] += 1
        return payload, "disk"

    def _quarantine(self, path: str, reason: str) -> None:
        """Move a failed block dir into ``_quarantine/`` (the checkpoint
        store's convention): the bytes stay for forensics, the index
        forgets them, the request that probed them sees a miss."""
        qdir = os.path.join(self.disk_dir, _QUARANTINE_DIR)
        try:
            os.makedirs(qdir, exist_ok=True)
            base = os.path.basename(path)
            dst = os.path.join(qdir, f"{base}__{reason}")
            k = 0
            while os.path.exists(dst):
                k += 1
                dst = os.path.join(qdir, f"{base}__{reason}__{k}")
            durable_io.replace(path, dst, path_class="prefix_tier")
            self.logger.warning(
                "quarantined corrupt prefix block %s (%s) -> %s",
                path, reason, dst)
        except OSError:
            # Even quarantine failing must read as a plain miss.
            self.logger.warning("could not quarantine %s; dropping index "
                                "entry only", path)
