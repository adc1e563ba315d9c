"""Device-resident decode state: the port of
``dlti_tpu/serving/decode_state.py``.

The engine keeps six per-slot host mirrors (block tables, slot seeds,
generated counts, temperature, top-k, top-p), appended after them each
slot's adapter-pool row with multi-LoRA serving (``adapter_ids``, as the
reference appends it) and each slot's token history with speculative
decode. This cache keeps their device twins and maintains them
incrementally:

* The engine marks a slot dirty at admission, release (retire, preempt,
  abort), block-table growth and prefill completion. :meth:`sync` then
  scatters just the dirty rows into the device tensors with
  ``index_copy_``, the row count padded to a power of two as the reference
  pads it (duplicates repeat the first dirty row, so they carry identical
  values). The rows are staged in pinned memory and copied without
  blocking, so a sync never waits on the card.
* A **clean step uploads nothing**: every decode dispatch between
  scheduling events reuses the resident tensors as they are.
* Generated counts advance on the device: after a window of k steps
  :meth:`bump_gen_counts` adds k to every row (a slot that finished inside
  the window was released, which marks it dirty).
* Rows named in ``masked_rows`` upload their block table as the trash
  block, so a decode call cannot write KV those slots hold.

Unlike the reference, which rebinds fresh arrays on every update, the
tensors here are updated **in place** and never rebound: they are inputs
of the engine's captured CUDA graph, which reads them at fixed addresses.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dlti_tpu_torch.parallel.tensor import mirrored
from dlti_tpu_torch.utils.device import upload

# Mirror names in the decode iteration's argument order; any further
# mirrors ("adapter_ids", the spec rounds' "spec_hist") follow them.
FIELDS = ("block_tables", "slot_seeds", "gen_counts",
          "temperature", "top_k", "top_p")
STAT_KEYS = ("decode_state_uploads", "decode_state_rows",
             "decode_state_clean_syncs")


class DecodeStateCache:
    """Persistent device twins of the engine's per-slot host mirrors."""

    def __init__(self, mirrors: Dict[str, np.ndarray], device: torch.device,
                 stats: Optional[dict] = None):
        self.fields = tuple(mirrors)
        if self.fields[:len(FIELDS)] != FIELDS:
            raise ValueError(f"mirrors must start with {FIELDS}, got {self.fields}")
        self._num_slots = len(mirrors[FIELDS[0]])
        self._device = device
        # Allocated once; sync() writes into them.
        self.tensors: Tuple[torch.Tensor, ...] = tuple(
            torch.zeros(mirrors[f].shape, dtype=torch.from_numpy(mirrors[f]).dtype,
                        device=device) for f in self.fields)
        self._dirty: set = set()
        self._all_dirty = True
        self.stats = stats if stats is not None else {}
        for k in STAT_KEYS:
            self.stats.setdefault(k, 0)
        # A tensor-parallel engine's parallel.tensor.HostMirror: the
        # leader's writes reach the followers' twins.
        self.mirror = None

    @property
    def gen_counts(self) -> torch.Tensor:
        return self.tensors[FIELDS.index("gen_counts")]

    def field(self, name: str, tensors: Optional[Sequence[torch.Tensor]] = None
              ) -> Optional[torch.Tensor]:
        """Field ``name`` of ``tensors`` (in :attr:`fields` order; the
        resident tensors by default), or None when this cache has none."""
        if name not in self.fields:
            return None
        return (tensors if tensors is not None else self.tensors)[self.fields.index(name)]

    def mark_dirty(self, slot_id: int) -> None:
        self._dirty.add(slot_id)

    def mark_all_dirty(self) -> None:
        """Resident state is stale as a whole; upload every row at the next
        sync."""
        self._all_dirty = True

    def sync(self, mirrors: Dict[str, np.ndarray],
             masked_rows: Sequence[int] = ()) -> Tuple[torch.Tensor, ...]:
        """Bring the device tensors up to date with the host ``mirrors`` and
        return them in :attr:`fields` order."""
        if self._all_dirty:
            self.reupload(mirrors, masked_rows)
            self.stats["decode_state_uploads"] += 1
            self.stats["decode_state_rows"] += self._num_slots
        elif self._dirty:
            idx = sorted(self._dirty)
            npad = 1
            while npad < len(idx):
                npad *= 2
            self._write(mirrors, idx, min(npad, self._num_slots), masked_rows)
            self.stats["decode_state_uploads"] += 1
            self.stats["decode_state_rows"] += len(idx)
        else:
            self.stats["decode_state_clean_syncs"] += 1
        self._all_dirty = False
        self._dirty.clear()
        return self.tensors

    def reupload(self, mirrors: Dict[str, np.ndarray],
                 masked_rows: Sequence[int] = ()) -> None:
        """Write every row, uncounted: the engine's path with the cache off
        (the reference re-uploads every mirror then, and its counters stay
        0)."""
        self._write(mirrors, list(range(self._num_slots)), self._num_slots,
                    masked_rows)

    @mirrored("state.")
    def _write(self, mirrors, idx: list, npad: int, masked_rows) -> None:
        """Scatter mirror rows ``idx`` into the device tensors, padded to
        ``npad`` rows with repeats of the first."""
        rows_idx = np.full((npad,), idx[0], np.int64)
        rows_idx[:len(idx)] = idx
        masked = np.isin(rows_idx, list(masked_rows))
        dev_idx = upload(rows_idx, self._device)
        for f, t in zip(self.fields, self.tensors):
            rows = np.ascontiguousarray(mirrors[f][rows_idx])
            if f == "block_tables" and masked.any():
                rows[masked] = 0
            t.index_copy_(0, dev_idx, upload(rows, self._device))

    @mirrored("state.")
    def bump_gen_counts(self, k: int) -> None:
        """Advance the resident generated counts by ``k`` decode steps, on
        the device."""
        if k > 0:
            self.gen_counts.add_(k)
