"""Input pipeline: tokenize -> truncate/pad or pack -> train-step batches.
This package's copy of ``dlti_tpu/data/pipeline.py``'s numpy functions: the
batches are the same arrays, in the same order, as the JAX package's.

Under data parallelism (an initialized ``torch.distributed`` group, one
process per device) each process materializes its slice of every step, by
the reference's world-size-invariant schedule: one seeded global
permutation chunked ``micro_batch_size * grad_accum_steps`` rows per step;
local element (a, b) of rank p is global chunk row ``a*bs + p*bs_local +
b``, ``bs_local = micro_batch_size // world``. ``micro_batch_size`` is the
global microbatch.

Batches are dicts of int32 numpy arrays shaped (accum, micro_bs, seq_len):
``input_ids`` and ``loss_mask``, plus ``segment_ids`` and ``positions`` when
packing. Rows are right-padded to ``seq_len`` (loss mask 0 on padding), or
packed several documents to a row with per-document segment ids (0 =
padding) and positions that restart at every document.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from dlti_tpu_torch.data.tokenizer import Tokenizer


def tokenize_and_truncate(texts: Sequence[str], tokenizer: Tokenizer,
                          max_seq_len: int = 512,
                          add_eos: bool = True) -> List[List[int]]:
    """Tokenize each text with BOS (and EOS), truncated to ``max_seq_len``."""
    return [tokenizer.encode(t, add_bos=True, add_eos=add_eos)[:max_seq_len]
            for t in texts]


def pad_to_batch(seqs: List[List[int]], seq_len: int, pad_id: int) -> tuple:
    """Right-pad to (len(seqs), seq_len); loss_mask 1 on real tokens."""
    n = len(seqs)
    ids = np.full((n, seq_len), pad_id, dtype=np.int32)
    mask = np.zeros((n, seq_len), dtype=np.int32)
    for i, s in enumerate(seqs):
        n_tok = min(len(s), seq_len)
        ids[i, :n_tok] = s[:n_tok]
        mask[i, :n_tok] = 1
    return ids, mask


def pack_sequences(seqs: List[List[int]], seq_len: int, pad_id: int,
                   open_rows: int = 64) -> tuple:
    """Greedy windowed first-fit packing: (ids, loss_mask, segment_ids).

    Each document goes to the oldest of the last ``open_rows`` open rows it
    fits in, else starts a new row; segment ids are 1-based per row, 0 on
    padding. Empty documents are dropped.
    """
    seqs = [s for s in seqs if s]
    rows: List[List[int]] = []
    row_segs: List[List[int]] = []
    open_idx: List[int] = []  # indices of still-open rows, oldest first
    for s in seqs:
        s = s[:seq_len]
        placed = False
        for oi, i in enumerate(open_idx):
            if len(rows[i]) + len(s) <= seq_len:
                seg_id = row_segs[i][-1] + 1
                rows[i].extend(s)
                row_segs[i].extend([seg_id] * len(s))
                if len(rows[i]) == seq_len:
                    open_idx.pop(oi)
                placed = True
                break
        if not placed:
            rows.append(list(s))
            row_segs.append([1] * len(s))
            open_idx.append(len(rows) - 1)
            if len(open_idx) > open_rows:
                open_idx.pop(0)
    n = len(rows)
    ids = np.full((n, seq_len), pad_id, dtype=np.int32)
    segs = np.zeros((n, seq_len), dtype=np.int32)
    for i, (row, seg) in enumerate(zip(rows, row_segs)):
        ids[i, :len(row)] = row
        segs[i, :len(seg)] = seg
    return ids, (segs > 0).astype(np.int32), segs


def packed_loss_mask(segment_ids: np.ndarray) -> np.ndarray:
    """Target position p is trained iff it is in a document and p - 1 is in
    the same one (a document's last token never predicts the next's first)."""
    mask = np.zeros_like(segment_ids)
    mask[:, 1:] = (segment_ids[:, 1:] > 0) & (segment_ids[:, 1:] == segment_ids[:, :-1])
    return mask.astype(np.int32)


def packed_positions(segment_ids: np.ndarray) -> np.ndarray:
    """Per-document positions: RoPE restarts at 0 for each packed document."""
    n, length = segment_ids.shape
    idx = np.broadcast_to(np.arange(length, dtype=np.int32), (n, length))
    is_start = np.ones((n, length), dtype=bool)
    is_start[:, 1:] = ((segment_ids[:, 1:] != segment_ids[:, :-1])
                       | (segment_ids[:, 1:] == 0))
    start_idx = np.maximum.accumulate(np.where(is_start, idx, 0), axis=1)
    return (idx - start_idx).astype(np.int32)


class HostShardedSchedule:
    """The epoch schedule over rows: one seeded global permutation per
    epoch (``shuffle_seed + epoch``), chunked ``samples_per_step`` rows per
    optimizer step, of which this process takes its batch-column slice (see
    the module docstring); ``skip_steps`` resumes mid-epoch. The schedule
    does not depend on the world size. Subclasses call :meth:`_init_procs`,
    then :meth:`_init_host_shard` with their row count (or set ``_n_rows``),
    and implement ``_gather(rows) -> {field: (n, seq_len)}``. Shared by
    :class:`TokenBatchDataset` and ``data.streaming.StreamingTokenDataset``,
    so the in-memory and the disk-backed paths take the same rows."""

    def _init_procs(self, shard_by_host: bool) -> None:
        on = shard_by_host and dist.is_available() and dist.is_initialized()
        self._procs = dist.get_world_size() if on else 1
        self._proc_id = dist.get_rank() if on else 0

    def shard_rows(self, rank: int, world: int) -> None:
        """Take batch-column slice ``rank`` of ``world`` instead of the
        process group's: the batch axes' rank and extent when ranks beside
        them (the tensor or the expert axis) share rows."""
        if self.micro_batch_size % world != 0:
            raise ValueError(
                f"global micro_batch_size {self.micro_batch_size} must be "
                f"divisible by the batch extent {world}")
        self._procs, self._proc_id = world, rank

    def _init_host_shard(self, n_rows: int, shard_by_host: bool) -> None:
        if not hasattr(self, "_procs"):
            self._init_procs(shard_by_host)
        self._n_rows = n_rows

    @property
    def samples_per_step(self) -> int:
        """Global samples consumed per optimizer step."""
        return self.micro_batch_size * self.grad_accum_steps

    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return self._n_rows // self.samples_per_step
        return -(-self._n_rows // self.samples_per_step)

    def _pad_partial(self, fields: dict, present: np.ndarray) -> dict:
        """Pad a partial final step to the full step shape with all-pad rows
        (loss mask, segment ids and positions 0), placed in global batch
        coordinates, so the padded step does not depend on the world size."""
        out = {}
        for k, v in fields.items():
            fill = self.pad_id if k == "input_ids" else 0
            full = np.full((present.shape[0],) + v.shape[1:], fill, v.dtype)
            full[present] = v
            out[k] = full
        return out

    def epoch(self, epoch_idx: int = 0, skip_steps: int = 0) -> Iterator[dict]:
        order = np.arange(self._n_rows)
        if self.shuffle_seed is not None:
            np.random.default_rng(self.shuffle_seed + epoch_idx).shuffle(order)
        step_rows = self.samples_per_step
        bs = self.micro_batch_size
        if bs % self._procs != 0:
            # Checked here, not at construction: a trainer with tensor or
            # expert ranks re-slices by the batch axes first (shard_rows).
            raise ValueError(
                f"global micro_batch_size {bs} must be divisible by the batch "
                f"extent {self._procs}")
        bs_local = bs // self._procs
        shape = (self.grad_accum_steps, bs_local, self.seq_len)
        g_idx = (np.arange(self.grad_accum_steps)[:, None] * bs
                 + self._proc_id * bs_local + np.arange(bs_local)[None, :]).ravel()
        for step_i, start in enumerate(range(0, self._n_rows, step_rows)):
            chunk = order[start:start + step_rows]
            if len(chunk) < step_rows and self.drop_remainder:
                break
            if step_i < skip_steps:
                continue
            present = g_idx < len(chunk)
            fields = self._gather(chunk[g_idx[present]])
            if not present.all():
                fields = self._pad_partial(fields, present)
            yield {k: v.reshape(shape) for k, v in fields.items()}


@dataclasses.dataclass
class TokenBatchDataset(HostShardedSchedule):
    """In-memory tokenized dataset yielding train-step-shaped batches
    (see the module docstring). ``drop_remainder=False`` keeps each epoch's
    partial last step, padded with all-pad rows."""

    sequences: List[List[int]]
    seq_len: int
    pad_id: int
    micro_batch_size: int
    grad_accum_steps: int = 1
    shuffle_seed: Optional[int] = 0
    shard_by_host: bool = True
    drop_remainder: bool = True
    pack: bool = False

    def __post_init__(self) -> None:
        self._init_procs(self.shard_by_host)
        if self.pack:
            # Pack once over the (seed-shuffled) corpus; epochs reshuffle rows.
            order = np.arange(len(self.sequences))
            if self.shuffle_seed is not None:
                np.random.default_rng(self.shuffle_seed).shuffle(order)
            ids, _, segs = pack_sequences([self.sequences[j] for j in order],
                                          self.seq_len, self.pad_id)
            self._packed = (ids, packed_loss_mask(segs), segs, packed_positions(segs))
            self._n_rows = ids.shape[0]
        else:
            self._packed = None
            self._n_rows = len(self.sequences)

    def _gather(self, row_indices: np.ndarray) -> dict:
        if self._packed is not None:
            ids, mask, segs, pos = self._packed
            return {"input_ids": ids[row_indices], "loss_mask": mask[row_indices],
                    "segment_ids": segs[row_indices], "positions": pos[row_indices]}
        ids, mask = pad_to_batch([self.sequences[j] for j in row_indices],
                                 self.seq_len, self.pad_id)
        return {"input_ids": ids, "loss_mask": mask}


def make_batches(texts: Sequence[str], tokenizer: Tokenizer, seq_len: int = 512,
                 micro_batch_size: int = 1, grad_accum_steps: int = 1,
                 shuffle_seed: Optional[int] = 0, shard_by_host: bool = True,
                 pack: bool = False) -> TokenBatchDataset:
    """Tokenize ``texts`` and wrap them in a :class:`TokenBatchDataset`."""
    return TokenBatchDataset(
        sequences=tokenize_and_truncate(texts, tokenizer, seq_len),
        seq_len=seq_len, pad_id=tokenizer.pad_id,
        micro_batch_size=micro_batch_size, grad_accum_steps=grad_accum_steps,
        shuffle_seed=shuffle_seed, shard_by_host=shard_by_host, pack=pack)
