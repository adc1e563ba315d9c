"""Multi-LoRA serving: the adapter catalog and the device pool, the port of
``dlti_tpu/serving/adapters.py``.

One base model stays on the card and each request's low-rank adapter is
applied per batch row inside the same forward (S-LoRA/Punica's design), so
a decode batch where every row wears a different adapter is still one
call, and one CUDA graph.

* :class:`AdapterCatalog` — the process-wide name -> checkpoint-directory
  registry. Registration verifies the checkpoint through the digest store
  (``checkpoint.store``); a corrupt one is quarantined and the name stays
  unknown, so the server answers 404 and the engine never faults on it.
* :class:`AdapterPool` — an engine's stacked adapter rows on the card: per
  targeted projection ``a (P, in, r)``, ``b (P, r, out)`` and ``s (P,)``
  in float32, ``P = slots + 1``, row 0 all zero (the base: its delta is
  exactly +0.0). The tensors are allocated once and never rebound, so the
  engine's captured graphs keep reading them at fixed addresses; a load
  writes one row in place on the current stream from pinned host memory,
  without a host sync. Rows are refcounted LRU.
* :func:`save_adapter` / :func:`extract_adapter_weights` — the adapter
  checkpoint: a ``save_pytree`` directory holding ``{"meta": {"alpha"},
  "weights": {<params path>: {"lora_a", "lora_b"}}}`` (the JAX tree's
  paths, ``model/layers_0/attn/q_proj``), byte-identical to the JAX
  package's. Targets are implicit in the tree and the rank in the shapes.

Metric names are the reference's (``ADAPTER_METRIC_NAMES``); the server
registers the module-level series for ``/metrics``. The reference's memory
ledger owner (``lora_adapters``) waits for ``telemetry/memledger.py``.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dlti_tpu_torch.checkpoint.store import (
    CheckpointCorruptError, load_pytree, quarantine_step, save_pytree,
)
from dlti_tpu_torch.models.interop import jax_path
from dlti_tpu_torch.telemetry.registry import Counter, Gauge
from dlti_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("dlti_tpu_torch.serving.adapters")

ADAPTER_METRIC_NAMES = (
    "dlti_adapter_loads_total",
    "dlti_adapter_evictions_total",
    "dlti_adapter_pool_hits_total",
    "dlti_adapter_pool_misses_total",
    "dlti_adapter_pool_slots",
    "dlti_adapter_pool_bytes",
)

loads_total = Counter(
    ADAPTER_METRIC_NAMES[0],
    help="adapter checkpoints loaded from the store into the device pool")
evictions_total = Counter(
    ADAPTER_METRIC_NAMES[1],
    help="idle adapters LRU-evicted from the device pool")
pool_hits_total = Counter(
    ADAPTER_METRIC_NAMES[2],
    help="acquisitions served by an already-resident adapter")
pool_misses_total = Counter(
    ADAPTER_METRIC_NAMES[3],
    help="acquisitions that had to load from the checkpoint store")
pool_slots_gauge = Gauge(
    ADAPTER_METRIC_NAMES[4],
    help="adapter slots in the device pool (row 0, the base no-op, excluded)")
pool_bytes_gauge = Gauge(
    ADAPTER_METRIC_NAMES[5],
    help="bytes of the stacked A/B adapter pool on device")

METRICS = (loads_total, evictions_total, pool_hits_total, pool_misses_total,
           pool_slots_gauge, pool_bytes_gauge)
# The projections an adapter may target.
TARGETABLE = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
              "down_proj")


class AdapterError(Exception):
    """Unknown, corrupt or incompatible adapter: always a request-scoped
    failure (the server answers 404 at admission, the engine fails the one
    request that named it)."""


# ----------------------------------------------------------------------
# Checkpoint format
# ----------------------------------------------------------------------

def extract_adapter_weights(params: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """The LoRA factors of a parameter dict as the ``weights`` subtree of the
    adapter checkpoint: nested by the JAX tree's path, ``{"lora_a",
    "lora_b"}`` at each projection, host tensors. The base kernels stay
    behind."""
    out: Dict[str, dict] = {}
    for name, t in params.items():
        if not name.endswith(".lora_a"):
            continue
        b = params.get(name[:-len("lora_a")] + "lora_b")
        if b is None:
            continue
        *parents, module, _ = jax_path(name)
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[module] = {"lora_a": t.detach().cpu(), "lora_b": b.detach().cpu()}
    return out


def save_adapter(directory: str, params: Mapping, alpha: float = 32.0) -> str:
    """Write an adapter checkpoint (the digest-verified store format,
    through the ``adapter`` path class) from a trained parameter dict;
    returns the directory. A save that fails part way quarantines what it
    staged and raises. Raises ``ValueError`` when ``params`` holds no LoRA
    factors."""
    weights = extract_adapter_weights(params)
    if not weights:
        raise ValueError("params tree holds no lora_a/lora_b factors; "
                         "train with LoRAConfig.enabled first")
    return save_pytree(directory, {
        "meta": {"alpha": torch.tensor(alpha, dtype=torch.float32)},
        "weights": weights,
    }, path_class="adapter")


def _load_verified(name: str, directory: str) -> dict:
    """Load and digest-verify one adapter checkpoint. A corrupt one is
    quarantined whole (``store.quarantine_step``); every failure surfaces as
    :class:`AdapterError`."""
    try:
        tree = load_pytree(directory, verify=True)
    except CheckpointCorruptError as e:
        parent, base = os.path.split(os.path.normpath(directory))
        dst = quarantine_step(parent or ".", base, reason=f"adapter {name!r}: {e}")
        raise AdapterError(
            f"adapter {name!r} checkpoint is corrupt"
            f"{' (quarantined to ' + dst + ')' if dst else ''}: {e}") from e
    except (OSError, ValueError) as e:
        raise AdapterError(f"adapter {name!r} unreadable at {directory}: {e}") from e
    if (not isinstance(tree, dict) or not isinstance(tree.get("weights"), dict)
            or not tree["weights"] or "meta" not in tree
            or "alpha" not in tree["meta"]):
        raise AdapterError(
            f"adapter {name!r} at {directory} is not an adapter checkpoint "
            "(expected {'meta': {'alpha'}, 'weights': {...}})")
    return tree


def _flatten_lora(weights: dict, path: Tuple[str, ...] = ()
                  ) -> Dict[Tuple[str, ...], dict]:
    out: Dict[Tuple[str, ...], dict] = {}
    for k, v in weights.items():
        if not isinstance(v, dict):
            continue
        if "lora_a" in v and "lora_b" in v:
            out[path + (k,)] = v
        else:
            out.update(_flatten_lora(v, path + (k,)))
    return out


# ----------------------------------------------------------------------
# Process-wide catalog
# ----------------------------------------------------------------------

class AdapterCatalog:
    """Thread-safe name -> verified checkpoint directory. Process-wide
    (:func:`get_catalog`), so every engine resolves the same names; an
    engine's pool loads from it at admission."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._dirs: Dict[str, str] = {}

    def register(self, name: str, directory: str) -> str:
        """Verify and register; returns the name. Raises
        :class:`AdapterError` for a bad name or a corrupt or unreadable
        checkpoint (a corrupt one is quarantined), and the name is then not
        registered."""
        if not name or not isinstance(name, str) or any(c in name for c in " \t\n/\\"):
            raise AdapterError(f"invalid adapter name {name!r}")
        directory = os.path.abspath(directory)
        _load_verified(name, directory)
        with self._lock:
            self._dirs[name] = directory
        logger.info("adapter %r registered from %s", name, directory)
        return name

    def unregister(self, name: str) -> bool:
        with self._lock:
            return self._dirs.pop(name, None) is not None

    def directory(self, name: str) -> Optional[str]:
        with self._lock:
            return self._dirs.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._dirs)

    def clear(self) -> None:
        with self._lock:
            self._dirs.clear()

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._dirs


_CATALOG = AdapterCatalog()


def get_catalog() -> AdapterCatalog:
    return _CATALOG


def register_adapter(name: str, directory: str) -> str:
    """Register an adapter checkpoint process-wide: every engine's pool can
    load it from its next admission on, without a restart."""
    return _CATALOG.register(name, directory)


def unregister_adapter(name: str) -> bool:
    return _CATALOG.unregister(name)


# ----------------------------------------------------------------------
# Device pool
# ----------------------------------------------------------------------

_LAYER = re.compile(r"^model\.layers\.(\d+)\.(attn|mlp)\.(\w+)\.kernel(\.q)?$")


def _target_shapes(params: Mapping[str, torch.Tensor], targets: Sequence[str]
                   ) -> Dict[str, Tuple[int, int]]:
    """``{module name: (in_features, out_features)}`` of every targeted
    projection in a parameter dict (an int8 kernel's ``.q`` keeps the
    shape), e.g. ``"model.layers.0.attn.q_proj": (4096, 4096)``."""
    out: Dict[str, Tuple[int, int]] = {}
    for name, t in params.items():
        m = _LAYER.match(name)
        if m and m.group(3) in targets:
            out[name[:name.index(".kernel")]] = (int(t.shape[0]), int(t.shape[1]))
    return out


def plan_pool_bytes(model_cfg, targets: Sequence[str], rank: int, num_slots: int) -> int:
    """The pool's size (float32): ``(slots + 1) x layers x sum over targets
    of (in*r + r*out + 1) x 4``."""
    h = model_cfg.hidden_size
    hd = model_cfg.resolved_head_dim
    m = model_cfg.intermediate_size
    dims = {
        "q_proj": (h, model_cfg.num_heads * hd),
        "k_proj": (h, model_cfg.num_kv_heads * hd),
        "v_proj": (h, model_cfg.num_kv_heads * hd),
        "o_proj": (model_cfg.num_heads * hd, h),
        "gate_proj": (h, m), "up_proj": (h, m), "down_proj": (m, h),
    }
    per_layer = 0
    for t in targets:
        if t not in dims:
            raise ValueError(f"unknown adapter target {t!r}")
        din, dout = dims[t]
        per_layer += din * rank + rank * dout + 1
    return (int(num_slots) + 1) * model_cfg.num_layers * per_layer * 4


class AdapterPool:
    """The stacked adapter rows of one engine, on its device.

    :attr:`layers` is what the model takes (``adapters=``): per layer
    ``{projection: (a, b, s)}``. :meth:`acquire` pins a name into a row
    and returns the row the engine carries in its resident decode state;
    a miss loads the verified checkpoint into one row. Rows pinned by
    in-flight requests are never evicted; acquiring from a pool of pinned
    rows returns ``(-1, False)`` and the engine defers the request, as it
    does when KV blocks run out.
    """

    def __init__(self, params: Mapping[str, torch.Tensor], num_slots: int, rank: int,
                 targets: Sequence[str], device=None,
                 catalog: Optional[AdapterCatalog] = None):
        if num_slots < 1:
            raise ValueError("adapter pool needs at least 1 slot")
        if rank < 1:
            raise ValueError("adapter rank must be >= 1")
        unknown = sorted(set(targets) - set(TARGETABLE))
        if unknown:
            raise ValueError(f"unknown adapter target(s) {unknown}")
        self.num_slots = int(num_slots)
        self.rank = int(rank)
        self.targets = tuple(targets)
        self.device = resolve_device(device)
        self._catalog = catalog if catalog is not None else get_catalog()
        self._lock = threading.Lock()
        self._shapes = _target_shapes(params, self.targets)
        if not self._shapes:
            raise ValueError(f"no adapter targets {self.targets} found in the params "
                             "— wrong target names for this model?")
        P = self.num_slots + 1
        # module name -> (a, b, s); allocated once, written row by row.
        self.tensors: Dict[str, Tuple[torch.Tensor, ...]] = {}
        num_layers = 1 + max(int(n.split(".")[2]) for n in self._shapes)
        self.layers: List[Dict[str, tuple]] = [{} for _ in range(num_layers)]
        for name, (din, dout) in self._shapes.items():
            abs_ = (torch.zeros((P, din, self.rank), dtype=torch.float32, device=self.device),
                    torch.zeros((P, self.rank, dout), dtype=torch.float32, device=self.device),
                    torch.zeros((P,), dtype=torch.float32, device=self.device))
            self.tensors[name] = abs_
            self.layers[int(name.split(".")[2])][name.rsplit(".", 1)[1]] = abs_
        self._names: List[Optional[str]] = [None] * P
        self._refs = [0] * P
        self._last_used = [0] * P
        self._tick = 0
        self._by_name: Dict[str, int] = {}
        pool_slots_gauge.set(self.num_slots)
        pool_bytes_gauge.set(self.nbytes)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for abs_ in self.tensors.values()
                   for t in abs_)

    def resident(self, name: str) -> bool:
        with self._lock:
            return name in self._by_name

    def loaded_names(self) -> List[str]:
        with self._lock:
            return sorted(self._by_name)

    # -- acquire / release ---------------------------------------------
    def acquire(self, name: str) -> Tuple[int, bool]:
        """Pin ``name`` into a row; returns ``(row, loaded)``, ``loaded``
        True when this call read the checkpoint. ``(-1, False)`` when every
        row is pinned (the caller defers). Raises :class:`AdapterError` for
        an unknown name, or for a checkpoint that fails verification or
        does not fit the pool at load time, which is then also quarantined
        (if corrupt) and unregistered, so later requests 404 at admission
        instead of retrying the load."""
        with self._lock:
            self._tick += 1
            idx = self._by_name.get(name)
            if idx is not None:
                self._refs[idx] += 1
                self._last_used[idx] = self._tick
                pool_hits_total.inc()
                return idx, False
            pool_misses_total.inc()
            directory = self._catalog.directory(name)
            if directory is None:
                raise AdapterError(f"unknown adapter {name!r} (register it first)")
            idx = self._free_slot()
            if idx is None:
                return -1, False
            try:
                rows = self._rows_from(name, _load_verified(name, directory))
            except AdapterError:
                self._catalog.unregister(name)
                raise
            self._write_row(idx, rows)
            self._names[idx] = name
            self._refs[idx] = 1
            self._last_used[idx] = self._tick
            self._by_name[name] = idx
            loads_total.inc()
            return idx, True

    def release(self, idx: int) -> None:
        """Unpin one acquisition of row ``idx`` (0 or negative: no-op). The
        row stays resident for later hits until the LRU needs it."""
        if idx <= 0:
            return
        with self._lock:
            if self._refs[idx] > 0:
                self._refs[idx] -= 1

    def _free_slot(self) -> Optional[int]:
        # Never-used rows first (already zero), then the least recently
        # used unpinned one.
        for i in range(1, self.num_slots + 1):
            if self._names[i] is None and self._refs[i] == 0:
                return i
        victim = None
        for i in range(1, self.num_slots + 1):
            if self._refs[i] == 0 and (
                    victim is None or self._last_used[i] < self._last_used[victim]):
                victim = i
        if victim is None:
            return None
        evicted = self._names[victim]
        if evicted is not None:
            del self._by_name[evicted]
            self._names[victim] = None
            evictions_total.inc()
        return victim

    # -- rows ------------------------------------------------------------
    def _rows_from(self, name: str, ckpt: dict) -> Dict[str, tuple]:
        """One row per targeted module: the adapter's factors zero-padded
        from its rank to the pool's (exact: padded columns meet zero rows)
        and scale alpha / r; a target the adapter did not train gets a zero
        row. Rank and targets are checked here."""
        alpha = float(ckpt["meta"]["alpha"])
        flat = {".".join(p).replace("layers_", "layers."): w
                for p, w in _flatten_lora(ckpt["weights"]).items()}
        unknown = sorted(set(flat) - set(self._shapes))
        if unknown:
            raise AdapterError(f"adapter {name!r} targets modules outside this pool "
                               f"(targets={self.targets}): {unknown[:8]}")
        ranks = {int(w["lora_a"].shape[-1]) for w in flat.values()}
        if len(ranks) != 1:
            raise AdapterError(f"adapter {name!r} has mixed ranks {sorted(ranks)}")
        r = ranks.pop()
        if not 1 <= r <= self.rank:
            raise AdapterError(f"adapter {name!r} rank {r} exceeds the pool rank "
                               f"{self.rank}")
        rows: Dict[str, tuple] = {}
        for mod, (din, dout) in self._shapes.items():
            a = torch.zeros((din, self.rank), dtype=torch.float32)
            b = torch.zeros((self.rank, dout), dtype=torch.float32)
            s = 0.0
            w = flat.get(mod)
            if w is not None:
                la, lb = w["lora_a"].float(), w["lora_b"].float()
                if tuple(la.shape) != (din, r) or tuple(lb.shape) != (r, dout):
                    raise AdapterError(
                        f"adapter {name!r} shape mismatch at {mod}: a{tuple(la.shape)} "
                        f"b{tuple(lb.shape)} vs module ({din}, {dout}) rank {r}")
                a[:, :r] = la
                b[:r, :] = lb
                s = float(np.float32(alpha / r))
            rows[mod] = (a, b, torch.tensor(s, dtype=torch.float32))
        return rows

    def _write_row(self, idx: int, rows: Dict[str, tuple]) -> None:
        """Copy one row of every module into place, on the current stream:
        from pinned host memory without blocking on the card (the copies
        queue behind whatever the stream already runs)."""
        cuda = self.device.type == "cuda"
        for mod, host in rows.items():
            for dst, src in zip(self.tensors[mod], host):
                if cuda:
                    src = src.pin_memory()
                dst[idx].copy_(src, non_blocking=cuda)
