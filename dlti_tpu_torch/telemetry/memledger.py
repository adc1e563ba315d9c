"""Device-memory ledger: per-owner attribution with conservation by
construction, the port of ``dlti_tpu/telemetry/memledger.py`` on PyTorch's
caching allocator.

**Model.** Subsystems register named *owners* (``params``,
``kv_block_pool``, ``prefix_cache_hbm``, ``decode_state_cache``,
``lora_adapters``, ...) with their tensors (a tensor, a module, or a
dict/list/tuple of them, or a zero-arg callable returning one). A
:meth:`MemoryLedger.snapshot` sums each owner's tensor payloads
(``numel * element_size``, each tensor counted once across owners) and
emits buckets that sum to ``bytes_in_use`` exactly.

**Definitions on a CUDA device** (one card: the ledger's device). Neither
reading waits on the device's queued work (the admission gate snapshots
while a decode window is in flight) or walks the garbage collector, and
neither is a CUDA runtime call: the card's memory comes from NVML
(``nvmlDeviceGetMemoryInfo`` through ``ctypes``, the driver's count that
``nvidia-smi`` shows), so the sampler thread's snapshots issue no CUDA call
beside the stepper's:

* ``capacity_bytes``: the card's total memory, as NVML reports it;
* ``bytes_in_use``: what the card holds minus what the caching allocator
  holds free: ``total - free - (reserved - allocated)``, where
  ``allocated``/``reserved`` are the allocator's current
  ``allocated_bytes``/``reserved_bytes`` (``torch.cuda.memory_stats``).
  Cached free blocks are not in use: any allocation of this process may
  take them, so ``headroom_bytes = capacity - bytes_in_use`` is the
  driver's free memory plus the allocator's cached free bytes;
* owners: their tensors' payload bytes on the device;
* ``untracked``: ``allocated`` minus the owners' bytes: live allocator
  blocks no owner claimed (activations, CUDA graph private pools' live
  blocks, cuBLAS workspaces, other engines' tensors, and the allocator's
  rounding of the owners' own blocks);
* ``residual``: ``bytes_in_use`` minus ``allocated``: device memory
  outside this process's caching allocator (the driver's reserve, the CUDA
  context, libraries' own allocations, other processes on the card).

So owners + ``untracked`` + ``residual`` = ``bytes_in_use``, integers, no
rounding. A negative ``untracked`` or ``residual`` (a reading racing a
free on another thread) is clamped to 0 and shaved off the largest bucket,
as the reference does. Two engines on one card each see the whole card,
and each other's tensors as untracked. A CUDA ledger reads the allocator
or raises: it never reports 0 bytes or an unknown capacity.

**On the CPU** (the tests' path) there is no device allocator: the
ledger takes ``bytes_in_use`` := the owners' bytes (``source:
"owners"``; untracked and residual 0) and the capacity from the
configured budget (unknown, so headroom gating off, without one).

``to_dict(top_k)`` (``GET /debug/memory``) also lists the largest live
tensors on the device that no owner claimed; that walk of the garbage
collector runs only there, never in :meth:`snapshot`.

:class:`MemoryBalloon` is the ``hbm-squeeze`` injector that proves the
engine's defer-don't-fault admission without a real OOM. A disabled
ledger's ``snapshot()``/``scalars()``/``headroom_bytes()`` return at once.
"""

from __future__ import annotations

import ctypes
import gc
import threading
import time
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from dlti_tpu_torch.telemetry.registry import Gauge

# Canonical owner names (a label catalog, not a closed set).
MEMORY_OWNERS = (
    "params",
    "optimizer_state",
    "grad_buffers",
    "kv_block_pool",
    "prefix_cache_hbm",
    "decode_state_cache",
    "prefetch_buffers",
    "kv_handoff_staging",
    "lora_adapters",
    "chaos_balloon",
)

UNTRACKED_BUCKET = "untracked"
RESIDUAL_BUCKET = "residual"

MEMLEDGER_METRIC_NAMES = (
    "dlti_hbm_bytes",
    "dlti_hbm_peak_bytes",
    "dlti_hbm_headroom_bytes",
    "dlti_hbm_untracked_bytes",
)

# Module-level, as in the reference: every ledger in the process (two
# replicas on one card included) refreshes the same series.
hbm_bytes_gauge = Gauge(
    MEMLEDGER_METRIC_NAMES[0],
    help="device bytes attributed per registered owner (owner label)",
    labelnames=("owner",))
hbm_peak_gauge = Gauge(
    MEMLEDGER_METRIC_NAMES[1],
    help="peak observed device bytes in use")
hbm_headroom_gauge = Gauge(
    MEMLEDGER_METRIC_NAMES[2],
    help="capacity minus bytes in use (0 when capacity unknown)")
hbm_untracked_gauge = Gauge(
    MEMLEDGER_METRIC_NAMES[3],
    help="live device bytes owned by no registered owner")


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    """Every tensor of a tensor, module, dict, list or tuple (nested)."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_nbytes(tree: Any) -> int:
    """Payload bytes of every tensor in a tree (each tensor once)."""
    seen: set = set()
    total = 0
    for t in _tensors(tree):
        if id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    return total


def is_oom_error(exc: BaseException) -> bool:
    """Is ``exc`` a device out-of-memory (``torch.OutOfMemoryError``, a
    CUDA "out of memory" runtime error) or a host ``MemoryError``?"""
    if isinstance(exc, (MemoryError, torch.OutOfMemoryError)):
        return True
    msg = f"{type(exc).__name__}: {exc}".lower()
    return ("resource_exhausted" in msg or "resource exhausted" in msg
            or "out of memory" in msg or "out_of_memory" in msg
            or "allocation failure" in msg)


class _NvmlMemory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


_nvml_lock = threading.Lock()
_nvml: Optional[tuple] = None  # (library, {CUDA device index: NVML handle})


def _nvml_handle(index: int) -> tuple:
    """(NVML library, handle) of CUDA device ``index``, matched by its UUID
    (NVML numbers the cards its own way); NVML is initialized once."""
    global _nvml
    with _nvml_lock:
        if _nvml is None:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
            rc = lib.nvmlInit_v2()
            if rc != 0:
                raise RuntimeError(f"nvmlInit_v2 failed with NVML error {rc}")
            _nvml = (lib, {})
        lib, handles = _nvml
        if index not in handles:
            uuid = "GPU-" + str(torch.cuda.get_device_properties(index).uuid)
            handle = ctypes.c_void_p()
            rc = lib.nvmlDeviceGetHandleByUUID(uuid.encode(), ctypes.byref(handle))
            if rc != 0:
                raise RuntimeError(f"NVML has no device {uuid} (error {rc})")
            handles[index] = handle
        return lib, handles[index]


def device_memory(device: torch.device) -> Dict[str, int]:
    """The CUDA readings a snapshot reconciles against: the allocator's
    ``allocated``/``reserved``/``peak_allocated`` bytes and the card's
    ``free``/``total`` bytes from NVML. Neither waits on the device's queued
    work. Raises off a CUDA device, or where NVML cannot read the card."""
    if device.type != "cuda":
        raise ValueError(f"device_memory reads a CUDA device, not {device}")
    # The nested form: memory_stats() flattens it in Python, at several
    # times the cost.
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    lib, handle = _nvml_handle(device.index)
    mem = _NvmlMemory()
    rc = lib.nvmlDeviceGetMemoryInfo(handle, ctypes.byref(mem))
    if rc != 0:
        raise RuntimeError(f"nvmlDeviceGetMemoryInfo failed with NVML error {rc}")
    free, total = mem.free, mem.total
    allocated = stats.get("allocated_bytes", {}).get("all", {})
    return {"allocated": int(allocated.get("current", 0)),
            "reserved": int(stats.get("reserved_bytes", {}).get("all", {}).get("current", 0)),
            "peak_allocated": int(allocated.get("peak", 0)),
            "free": int(free), "total": int(total)}


class MemoryLedger:
    """Per-owner device-memory attribution with exact conservation, on one
    device (``cpu`` or a CUDA card).

    ``register``/``unregister`` happen at wiring time; ``snapshot`` may run
    concurrently on the stepper thread, the sampler thread and HTTP
    handlers, so the owner map and the peaks share one lock. Owner handles
    are read without copying."""

    def __init__(self, enabled: bool = True, capacity_bytes: int = 0,
                 device: Any = "cpu"):
        self.enabled = enabled
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # A configured budget: the capacity where the device reports none
        # (the CPU); a card's own total wins, as in the reference.
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        self._owners: Dict[str, Any] = {}
        # owner -> (parent owner, bytes_fn): sub-owners carved out of a
        # parent's bytes (register_carve).
        self._carves: Dict[str, Any] = {}
        self._peak = 0
        self._owner_peaks: Dict[str, int] = {}
        # The last owner walk: (key, owner bytes, owned ids, trees).
        self._walk: Optional[tuple] = None

    # -- wiring ---------------------------------------------------------
    def register(self, owner: str, handle: Any) -> None:
        """Attach ``handle`` (tensors, or a zero-arg callable returning
        them) under ``owner``; re-registering replaces."""
        if not self.enabled:
            return
        with self._lock:
            self._owners[owner] = handle
            self._walk = None

    def register_carve(self, owner: str, parent: str,
                       bytes_fn: Callable[[], int]) -> None:
        """Attribute a slice of ``parent``'s bytes to ``owner`` without
        double counting (prefix-cache blocks inside the KV pool): at
        snapshot time ``min(bytes_fn(), parent bytes)`` moves from parent
        to owner."""
        if not self.enabled:
            return
        with self._lock:
            self._carves[owner] = (parent, bytes_fn)

    def unregister(self, owner: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._owners.pop(owner, None)
            self._carves.pop(owner, None)
            self._owner_peaks.pop(owner, None)
            self._walk = None

    def owners(self) -> List[str]:
        with self._lock:
            return sorted(self._owners)

    def set_capacity(self, capacity_bytes: int) -> None:
        self.capacity_bytes = int(capacity_bytes)

    # -- snapshot -------------------------------------------------------
    def _owned(self) -> tuple:
        """(owner -> bytes on this device, ids of every owned tensor);
        a tensor two owners hold counts for the first registered.

        The walk is the snapshot's cost (a 7B engine's ~650 tensors), so it
        runs again only when an owner's handle returns another object, a
        container of another length, or is registered anew; an object
        whose tensors are swapped in place must be re-registered."""
        with self._lock:
            items = list(self._owners.items())
        trees, key = [], []
        for owner, handle in items:
            try:
                # A module is callable too: it is a handle, not a provider.
                provider = callable(handle) and not isinstance(handle, torch.nn.Module)
                tree = handle() if provider else handle
            except Exception:
                tree = None
            trees.append(tree)
            key.append((owner, id(tree), len(tree)
                        if isinstance(tree, (list, tuple, dict)) else -1))
        key = tuple(key)
        cached = self._walk
        if cached is not None and cached[0] == key:
            return dict(cached[1]), cached[2]
        seen: set = set()
        out: Dict[str, int] = {}
        dev = self.device
        for (owner, _), tree in zip(items, trees):
            total = 0
            for t in _tensors(tree):
                if id(t) in seen or t.device != dev:
                    continue
                seen.add(id(t))
                total += _nbytes(t)
            out[owner] = total
        # The trees stay referenced by the key's ids only while cached: a
        # freed object's id could be reused, so the cache holds the trees.
        self._walk = (key, dict(out), seen, trees)
        return out, seen

    def snapshot(self, top_k: int = 0) -> dict:
        """The reconciliation: ``buckets`` (owners + ``untracked`` +
        ``residual``) sum to ``bytes_in_use`` exactly (see the module
        docstring for each term). ``top_k`` > 0 adds the largest live
        tensors no owner claimed (a garbage-collector walk)."""
        if not self.enabled:
            return {}
        owned, owned_ids = self._owned()
        owners: Dict[str, dict] = {o: {"bytes": b, "per_device": {str(self.device): b}}
                                   for o, b in owned.items()}
        tracked_total = sum(owned.values())
        with self._lock:
            carves = list(self._carves.items())
        for owner, (parent, bytes_fn) in carves:
            if parent not in owners:
                continue
            try:
                want = max(0, int(bytes_fn()))
            except Exception:
                want = 0
            moved = min(want, owners[parent]["bytes"])
            owners[parent]["bytes"] -= moved
            owners[owner] = {"bytes": moved, "per_device": {},
                             "carved_from": parent}

        dev_stats: Dict[str, Dict[str, int]] = {}
        if self.device.type == "cuda":
            m = device_memory(self.device)
            source = "device"
            bytes_in_use = m["total"] - m["free"] - (m["reserved"] - m["allocated"])
            untracked = m["allocated"] - tracked_total
            residual = bytes_in_use - m["allocated"]
            device_peak = m["peak_allocated"] + max(0, residual)
            capacity = m["total"]
            dev_stats[str(self.device)] = {
                "bytes_in_use": bytes_in_use, "allocated_bytes": m["allocated"],
                "reserved_bytes": m["reserved"], "free_bytes": m["free"],
                "bytes_limit": m["total"], "peak_allocated_bytes": m["peak_allocated"]}
        else:
            source = "owners"
            bytes_in_use = tracked_total
            untracked = residual = device_peak = 0
            capacity = self.capacity_bytes

        buckets: Dict[str, int] = {o: d["bytes"] for o, d in owners.items()}
        buckets[UNTRACKED_BUCKET] = max(0, untracked)
        buckets[RESIDUAL_BUCKET] = max(0, residual)
        overshoot = min(0, untracked) + min(0, residual)
        if overshoot < 0:
            # Conservation over raw fidelity: shave the overshoot off the
            # largest bucket so the map sums to bytes_in_use.
            top = max(buckets, key=lambda k: buckets[k])
            buckets[top] = max(0, buckets[top] + overshoot)

        with self._lock:
            self._peak = max(self._peak, bytes_in_use, device_peak)
            peak = self._peak
            for o, d in owners.items():
                self._owner_peaks[o] = max(self._owner_peaks.get(o, 0), d["bytes"])
            owner_peaks = dict(self._owner_peaks)

        snap = {
            "source": source,
            "device": str(self.device),
            "bytes_in_use": bytes_in_use,
            "peak_bytes": peak,
            "capacity_bytes": capacity,
            "headroom_bytes": (max(0, capacity - bytes_in_use) if capacity else None),
            "tracked_bytes": tracked_total,
            "untracked_bytes": buckets[UNTRACKED_BUCKET],
            "residual_bytes": buckets[RESIDUAL_BUCKET],
            "owners": owners,
            "owner_peak_bytes": owner_peaks,
            "buckets": buckets,
            # The reference's compiled-step estimate: the trainer's, not ported.
            "activation_peak": {},
            "device_stats": dev_stats,
        }
        if top_k > 0:
            snap["top_untracked_tensors"] = self._top_untracked(owned_ids, top_k)
        return snap

    def _top_untracked(self, owned_ids: set, k: int) -> List[dict]:
        """The ``k`` largest live tensors on this device no owner holds."""
        found: Dict[int, torch.Tensor] = {}
        with warnings.catch_warnings():
            # Deprecated module attributes warn when isinstance reads them.
            warnings.simplefilter("ignore")
            for obj in gc.get_objects():
                try:
                    if (isinstance(obj, torch.Tensor) and obj.device == self.device
                            and id(obj) not in owned_ids):
                        found[id(obj)] = obj
                except Exception:  # objects that fail isinstance/device reads
                    continue
        ranked = sorted(found.values(), key=lambda t: -_nbytes(t))[:k]
        return [{"shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", ""),
                 "nbytes": _nbytes(t), "per_device": {str(self.device): _nbytes(t)}}
                for t in ranked]

    # -- reads ----------------------------------------------------------
    def headroom_bytes(self, snap: Optional[dict] = None) -> Optional[int]:
        """Capacity minus bytes in use; None when disabled or the capacity
        is unknown (callers then skip headroom gating)."""
        if not self.enabled:
            return None
        if snap is None:
            snap = self.snapshot()
        return snap.get("headroom_bytes")

    def scalars(self) -> Dict[str, float]:
        """``hbm_*`` keys for the time-series ring / ``/debug/vars``, and
        the refresh point of the module-level gauges."""
        if not self.enabled:
            return {}
        snap = self.snapshot()
        out: Dict[str, float] = {
            "hbm_bytes_in_use": snap["bytes_in_use"],
            "hbm_tracked_bytes": snap["tracked_bytes"],
            "hbm_untracked_bytes": snap["untracked_bytes"],
            "hbm_peak_bytes": snap["peak_bytes"],
        }
        for o, d in snap["owners"].items():
            out[f"hbm_owner_{o}_bytes"] = d["bytes"]
        headroom = snap.get("headroom_bytes")
        cap = snap.get("capacity_bytes", 0)
        if headroom is not None:
            out["hbm_headroom_bytes"] = headroom
            if cap:
                out["hbm_headroom_frac"] = round(headroom / cap, 6)
        hbm_peak_gauge.set(snap["peak_bytes"])
        hbm_untracked_gauge.set(snap["untracked_bytes"])
        hbm_headroom_gauge.set(headroom or 0)
        for o, d in snap["owners"].items():
            hbm_bytes_gauge.labels(owner=o).set(d["bytes"])
        return out

    def to_dict(self, top_k: int = 8) -> dict:
        """The ``GET /debug/memory`` payload."""
        if not self.enabled:
            return {}
        snap = self.snapshot(top_k=top_k)
        snap["ts"] = time.time()
        return snap


class MemoryBalloon:
    """A deterministic device-memory squeeze: allocate ``n`` bytes on the
    ledger's device and register them as ``chaos_balloon``, so the
    headroom shrinks by exactly what the ledger sees; ``deflate()``
    releases the bytes (back to the caching allocator, which counts them
    as headroom again) and the owner."""

    OWNER = "chaos_balloon"

    def __init__(self, ledger: Optional[MemoryLedger] = None, device: Any = None):
        self.ledger = ledger
        self.device = torch.device(device) if device is not None else (
            ledger.device if ledger is not None else torch.device("cpu"))
        self._tensors: List[torch.Tensor] = []

    @property
    def nbytes(self) -> int:
        return sum(_nbytes(t) for t in self._tensors)

    def inflate(self, nbytes: int) -> int:
        """Allocate ~``nbytes`` more (float32 zeros, written). Returns the
        balloon's new total size."""
        n = max(1, int(nbytes) // 4)
        self._tensors.append(torch.zeros((n,), dtype=torch.float32, device=self.device))
        if self.ledger is not None:
            self.ledger.register(self.OWNER, lambda: self._tensors)
        return self.nbytes

    def deflate(self) -> None:
        self._tensors = []
        if self.ledger is not None:
            self.ledger.unregister(self.OWNER)


# Process-global accessor: chaos injectors reach the live ledger without
# plumbing.
_current: Optional[MemoryLedger] = None


def install(ledger: Optional[MemoryLedger]) -> None:
    global _current
    _current = ledger


def get_ledger() -> Optional[MemoryLedger]:
    return _current
