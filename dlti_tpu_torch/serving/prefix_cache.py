"""Automatic prefix caching for the paged KV cache: the port of
``dlti_tpu/serving/prefix_cache.py`` (pure Python, the same keys, the same
LRU order and the same tier-labelled series).

vLLM-style: a *full* KV block's contents are a pure function of the token
chain that produced it (same model, same params), so full blocks are
registered in a content-addressed table and reused across requests that
share a prompt prefix — chat system prompts, few-shot preambles, and
preempted-then-readmitted sequences prefill only their novel suffix.

Design:

* Keys are exact: ``key_i = (key_{i-1}, tokens_of_block_i)`` — no hash
  collisions, verification-free reuse.
* Ref-counted sharing: a cached block may back any number of active
  sequences; it is only evictable at refcount 0.
* Eviction is lazy LRU: unreferenced cached blocks stay registered (and
  allocated in the :class:`BlockManager` pool) until the pool runs dry,
  then the least-recently-used are freed back to the allocator — O(1)
  per eviction via an insertion-ordered dict of refcount-0 entries.
* Only *full* blocks are ever cached. The partial tail block of a
  sequence is exclusively owned and freed normally, so decode writes
  never mutate shared state.
* **Tiering** (:mod:`dlti_tpu_torch.serving.prefix_tiers`): with a
  :class:`~dlti_tpu_torch.serving.prefix_tiers.TieredBlockStore` attached, an
  evicted block's KV payload demotes HBM → host RAM → disk instead of
  being discarded, and a ``match_prefix`` chain that runs past the HBM
  blocks continues into the tiers — the engine restores those blocks
  with a host→device scatter (charged as a *restore*, not a re-prefill)
  and they re-enter the HBM cache pinned for the admitting sequence.

Engine contract: ``match_prefix`` is a pure lookup; call :meth:`acquire`
*before* allocating the suffix blocks (so the matched blocks can't be
evicted to satisfy that very allocation) and :meth:`release` to undo on
allocation failure.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dlti_tpu_torch.serving.block_manager import BlockManager
from dlti_tpu_torch.telemetry.registry import Counter, Gauge

# Exposition names: the reference's (pinned in tests/test_bench_contract.py
# for the JAX server). All tier-labeled: tier="hbm" |
# "host" | "disk".
PREFIX_CACHE_METRIC_NAMES = (
    "dlti_prefix_cache_hits_total",
    "dlti_prefix_cache_misses_total",
    "dlti_prefix_cache_evictions_total",
    "dlti_prefix_cache_promotions_total",
    "dlti_prefix_cache_demotions_total",
    "dlti_prefix_cache_blocks",
)

hits_total = Counter(
    PREFIX_CACHE_METRIC_NAMES[0],
    help="admissions that reused cached prefix blocks (by serving tier)",
    labelnames=("tier",))
misses_total = Counter(
    PREFIX_CACHE_METRIC_NAMES[1],
    help="admissions that found no reusable blocks in a tier",
    labelnames=("tier",))
evictions_total = Counter(
    PREFIX_CACHE_METRIC_NAMES[2],
    help="blocks evicted from a tier under budget pressure",
    labelnames=("tier",))
promotions_total = Counter(
    PREFIX_CACHE_METRIC_NAMES[3],
    help="blocks promoted back to HBM from a lower tier (restores)",
    labelnames=("tier",))
demotions_total = Counter(
    PREFIX_CACHE_METRIC_NAMES[4],
    help="evicted blocks demoted into a lower tier instead of dropped",
    labelnames=("tier",))
blocks_gauge = Gauge(
    PREFIX_CACHE_METRIC_NAMES[5],
    help="blocks currently cached per tier",
    labelnames=("tier",))


class _Entry:
    __slots__ = ("block", "key", "refcount")

    def __init__(self, block: int, key: tuple):
        self.block = block
        self.key = key
        self.refcount = 0


class PrefixCachingAllocator:
    """Wraps a :class:`BlockManager` with content-addressed block reuse.

    All engine allocation/free traffic must flow through this object so
    refcounts stay consistent.
    """

    def __init__(self, block_manager: BlockManager, tier_store=None,
                 kv_fetch: Optional[Callable[[int], dict]] = None):
        self.bm = block_manager
        self.block_size = block_manager.block_size
        self._by_key: Dict[tuple, _Entry] = {}
        self._by_block: Dict[int, _Entry] = {}
        # refcount-0 entries in LRU order (oldest first) — the evictables.
        self._lru: "collections.OrderedDict[int, _Entry]" = collections.OrderedDict()
        self.stats = {"hits": 0, "hit_tokens": 0, "evictions": 0,
                      # Tier traffic (0 without a tier store, so the
                      # /stats schema is stable either way).
                      "restored_blocks": 0, "restored_tokens": 0,
                      "demotions": 0, "tier_corrupt_dropped": 0}
        # Lower tiers (prefix_tiers.TieredBlockStore) + the engine-owned
        # device→host block fetch used at demotion time. Both optional:
        # without them eviction discards payloads (the legacy behavior).
        self.tier_store = tier_store
        self.kv_fetch = kv_fetch

    # ------------------------------------------------------------------
    @staticmethod
    def _chain_keys(tokens: Sequence[int], block_size: int,
                    ns: Optional[str] = None) -> List[tuple]:
        """Content key for each full block of ``tokens``.

        ``ns`` namespaces the whole chain (multi-LoRA serving: a block's
        KV is a function of the *adapter* as well as the token chain, so
        the same prompt under different adapters must never alias). The
        namespace seeds the chain's root key; ``None``/"" produces the
        legacy keys byte-identical, so adapter-off engines and base
        requests share one namespace."""
        keys, prev = [], (() if not ns else ("adapter", ns))
        for i in range(len(tokens) // block_size):
            prev = (prev, tuple(tokens[i * block_size:(i + 1) * block_size]))
            keys.append(prev)
        return keys

    # ------------------------------------------------------------------
    def match_prefix(self, tokens: Sequence[int],
                     ns: Optional[str] = None) -> Tuple[List[int], int]:
        """Longest cached chain of full blocks covering a prefix of
        ``tokens``; at most ``len(tokens) - 1`` tokens match so prefill
        always has at least one token to process (its logits produce the
        next token). Pure lookup (no stats, no refcounts) — admission may
        be retried many times before it succeeds. ``ns`` is the adapter
        namespace (see :meth:`_chain_keys`). Returns
        (block_ids, n_tokens_covered).
        """
        usable = len(tokens) - 1
        blocks: List[int] = []
        for key in self._chain_keys(tokens[:usable] if usable > 0 else [],
                                    self.block_size, ns):
            entry = self._by_key.get(key)
            if entry is None:
                break
            blocks.append(entry.block)
        return blocks, len(blocks) * self.block_size

    def match_tiers(self, tokens: Sequence[int], start_block: int,
                    ns: Optional[str] = None) -> List[tuple]:
        """Continue a :meth:`match_prefix` chain into the lower tiers:
        chain keys for blocks ``start_block, start_block+1, ...`` that the
        tier store *indexes* (a disk entry may still fail verification at
        fetch time). Pure index lookup, no payload I/O."""
        if self.tier_store is None:
            return []
        usable = len(tokens) - 1
        keys = self._chain_keys(tokens[:usable] if usable > 0 else [],
                                self.block_size, ns)
        out: List[tuple] = []
        for key in keys[start_block:]:
            if self.tier_store.tier_of(key) is None:
                break
            out.append(key)
        return out

    def fetch_restore(self, key: tuple):
        """Pop ``key``'s payload from the tiers for promotion to HBM.

        Returns ``(payload, tier)`` or ``(None, None)`` — a corrupt disk
        block was quarantined by the store and reads as a miss here."""
        if self.tier_store is None:
            return None, None
        before = self.tier_store.stats["corrupt_dropped"]
        payload, tier = self.tier_store.fetch(key)
        dropped = self.tier_store.stats["corrupt_dropped"] - before
        if dropped:
            self.stats["tier_corrupt_dropped"] += dropped
            misses_total.labels(tier="disk").inc(dropped)
        if payload is not None:
            promotions_total.labels(tier=tier).inc()
        return payload, tier

    def register_restored(self, key: tuple, block: int) -> None:
        """Adopt a tier-restored block into the HBM cache, already pinned
        (refcount 1) for the admitting sequence — the engine has scattered
        the payload into physical ``block`` before any program reads it."""
        e = _Entry(block, key)
        e.refcount = 1
        self._by_key[key] = e
        self._by_block[block] = e
        self.stats["restored_blocks"] += 1
        self.stats["restored_tokens"] += self.block_size
        self._set_block_gauges()

    def record_hit(self, block_ids: List[int]) -> None:
        """Count a *successful* admission's reuse (an admission may retry
        acquire/release many times while head-of-line blocked)."""
        if block_ids:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += len(block_ids) * self.block_size

    def record_admission(self, hbm_blocks: List[int],
                         restored_by_tier: Dict[str, int]) -> None:
        """Per-tier hit/miss accounting for one *successful* admission
        (counted once, after allocation succeeded — retries while
        head-of-line blocked don't inflate the series)."""
        self.record_hit(hbm_blocks)
        if hbm_blocks:
            hits_total.labels(tier="hbm").inc()
        else:
            misses_total.labels(tier="hbm").inc()
        if self.tier_store is not None:
            for tier in ("host", "disk"):
                n = restored_by_tier.get(tier, 0)
                if n > 0:
                    hits_total.labels(tier=tier).inc()
                elif not hbm_blocks:
                    # Tier probed (the HBM chain broke at block 0) and
                    # found nothing: a real lower-tier miss. A chain fully
                    # covered by upper levels is not a miss down here.
                    misses_total.labels(tier=tier).inc()

    def acquire(self, block_ids: List[int]) -> None:
        """Take a reference on matched blocks (pins them against eviction).

        Call before allocating the suffix, undo with :meth:`release` if
        that allocation fails. Raises ``ValueError`` if a block is no
        longer cached (matched, then evicted before the acquire — only
        possible if a caller breaks the match→acquire atomicity contract
        by allocating in between)."""
        for i, b in enumerate(block_ids):
            entry = self._by_block.get(b)
            if entry is None:
                # Undo the refs already taken so the failed acquire is
                # all-or-nothing, like BlockManager.free.
                self.release(block_ids[:i])
                raise ValueError(
                    f"acquire of block {b} which is not cached (evicted "
                    "between match_prefix and acquire? callers must not "
                    "allocate between the two)")
            entry.refcount += 1
            self._lru.pop(b, None)

    def release(self, block_ids: List[int]) -> None:
        """Drop references taken by :meth:`acquire` (blocks stay cached).
        Raises ``ValueError`` on a release without a matching acquire —
        a silent refcount underflow would strand the block outside the
        LRU (unevictable) or let a shared block be evicted under a live
        sequence."""
        for b in block_ids:
            entry = self._by_block.get(b)
            if entry is None:
                raise ValueError(f"release of block {b} which is not cached")
            if entry.refcount <= 0:
                raise ValueError(
                    f"release of block {b} without a matching acquire "
                    "(refcount would go negative)")
            entry.refcount -= 1
            if entry.refcount == 0:
                self._lru[b] = entry
                self._lru.move_to_end(b)

    # ------------------------------------------------------------------
    def allocate(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` fresh blocks, evicting LRU cached blocks if the
        pool is dry. Returns None when even eviction can't satisfy it."""
        if n == 0:
            return []
        while not self.bm.can_allocate(n):
            if not self._evict_one():
                return None
        return self.bm.allocate(n)

    def _evict_one(self) -> bool:
        if not self._lru:
            return False
        block, entry = self._lru.popitem(last=False)  # oldest
        del self._by_key[entry.key]
        del self._by_block[block]
        if self.tier_store is not None and self.kv_fetch is not None:
            # Demote instead of discard: fetch the block's KV device→host
            # (the engine's fetcher stages it through pinned host memory)
            # and hand it to the tier hierarchy. The payload is read BEFORE the physical block returns to the
            # pool, so a later allocation can't overwrite it first.
            payload = self.kv_fetch(block)
            if payload is not None:
                tier = self.tier_store.put(entry.key, payload)
                if tier is not None:
                    self.stats["demotions"] += 1
                    demotions_total.labels(tier=tier).inc()
        self.bm.free([block])
        self.stats["evictions"] += 1
        evictions_total.labels(tier="hbm").inc()
        self._set_block_gauges()
        return True

    def _set_block_gauges(self) -> None:
        """Point-in-time per-tier block counts. With replicas each
        engine's allocator overwrites the shared gauge (last writer
        wins); the event counters above aggregate exactly."""
        blocks_gauge.labels(tier="hbm").set(len(self._by_block))
        if self.tier_store is not None:
            blocks_gauge.labels(tier="host").set(
                self.tier_store.num_host_blocks)
            blocks_gauge.labels(tier="disk").set(
                self.tier_store.num_disk_blocks)

    # ------------------------------------------------------------------
    def release_sequence(self, tokens: Sequence[int],
                         blocks: List[int],
                         ns: Optional[str] = None) -> None:
        """Return a retiring sequence's blocks.

        Full blocks are registered for reuse (or deduplicated against an
        existing registration); partial/extra blocks go straight back to
        the allocator. ``blocks[i]`` must hold tokens
        ``tokens[i*bs:(i+1)*bs]`` — computed under the same ``ns`` the
        sequence matched with, or cross-adapter aliasing serves one
        adapter's KV to another.
        """
        keys = self._chain_keys(tokens, self.block_size, ns)
        for i, block in enumerate(blocks):
            entry = self._by_block.get(block)
            if entry is not None:
                # A block we were sharing: drop our reference.
                self.release([block])
                continue
            if i < len(keys):
                key = keys[i]
                if key in self._by_key:
                    # Same content already cached under another block
                    # (two requests prefilling the same prompt
                    # concurrently): keep the registered one, free ours.
                    self.bm.free([block])
                    continue
                e = _Entry(block, key)
                self._by_key[key] = e
                self._by_block[block] = e
                self._lru[block] = e
            else:
                self.bm.free([block])
        self._set_block_gauges()

    # ------------------------------------------------------------------
    @property
    def num_cached_blocks(self) -> int:
        return len(self._by_block)

    @property
    def num_free(self) -> int:
        """Free now, without eviction (see also :meth:`num_reclaimable`)."""
        return self.bm.num_free

    @property
    def num_reclaimable(self) -> int:
        return len(self._lru)
