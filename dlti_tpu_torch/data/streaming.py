"""Disk-backed (memory-mapped) token store: the port of
``dlti_tpu/data/streaming.py`` (``write_token_store``,
``StreamingTokenDataset``), file for file the JAX package's format.

* :func:`write_token_store` streams documents (an iterator of token lists)
  into flat binary row files, padding or packing one bounded chunk at a
  time, so the writer never holds the corpus.
* :class:`StreamingTokenDataset` memory-maps the row files and yields
  batches through the same schedule as the in-memory dataset
  (``data.pipeline.HostShardedSchedule``: per-rank slices, seeded epoch
  shuffle, ``skip_steps`` resume), holding only the epoch permutation in
  host memory. Unpacked batches equal the in-memory dataset's; packed rows
  are built in arrival order (the in-memory packer shuffles first).

Store layout (``<dir>/``)::

    meta.json     {"n_rows", "seq_len", "pad_id", "packed", "version",
                   "max_doc_len"[, "tokenizer"]}
    ids.bin       int32 (n_rows, seq_len) row tokens (padded)
    lengths.bin   int32 (n_rows,)         real-token count   [unpacked]
    segs.bin      int32 (n_rows, seq_len) segment ids        [packed]
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, List, Optional

import numpy as np

from dlti_tpu_torch.data.pipeline import (
    HostShardedSchedule, pack_sequences, packed_loss_mask, packed_positions, pad_to_batch,
)

_VERSION = 1


def is_token_store(path: str) -> bool:
    """Whether ``path`` is a token store's directory (holds ``meta.json``)."""
    return os.path.isfile(os.path.join(path, "meta.json"))


def write_token_store(token_docs: Iterable[List[int]], directory: str, *,
                      seq_len: int, pad_id: int, pack: bool = False,
                      chunk_docs: int = 8192, tokenizer: Optional[str] = None) -> dict:
    """Stream ``token_docs`` into a memory-mappable row store, one chunk of
    ``chunk_docs`` documents at a time (packed mode packs each chunk on its
    own). Returns the meta dict."""
    os.makedirs(directory, exist_ok=True)
    ids_path = os.path.join(directory, "ids.bin")
    aux_path = os.path.join(directory, "segs.bin" if pack else "lengths.bin")
    n_rows = 0
    max_doc_len = 0
    with open(ids_path, "wb") as f_ids, open(aux_path, "wb") as f_aux:
        chunk: List[List[int]] = []

        def flush():
            nonlocal n_rows
            if not chunk:
                return
            if pack:
                ids, _, segs = pack_sequences(chunk, seq_len, pad_id)
                f_aux.write(np.ascontiguousarray(segs, np.int32).tobytes())
            else:
                ids, mask = pad_to_batch(chunk, seq_len, pad_id)
                f_aux.write(mask.sum(1, dtype=np.int32).tobytes())
            f_ids.write(np.ascontiguousarray(ids, np.int32).tobytes())
            n_rows += ids.shape[0]
            chunk.clear()

        for doc in token_docs:
            # The packer drops empty documents; unpacked mode keeps them as
            # all-pad rows, so its row count is the in-memory dataset's.
            if pack and not doc:
                continue
            chunk.append(list(doc))
            max_doc_len = max(max_doc_len, min(len(doc), seq_len))
            if len(chunk) >= chunk_docs:
                flush()
        flush()

    meta = {"n_rows": n_rows, "seq_len": seq_len, "pad_id": pad_id,
            "packed": pack, "version": _VERSION,
            # Bound on any (truncated) document's tokens: packed training
            # can run banded attention of exactly this window.
            "max_doc_len": max_doc_len}
    if tokenizer is not None:
        meta["tokenizer"] = tokenizer
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta


@dataclasses.dataclass
class StreamingTokenDataset(HostShardedSchedule):
    """Memory-mapped counterpart of ``data.pipeline.TokenBatchDataset``:
    the same batch shapes and schedule, rows read from disk on demand.
    ``expect_tokenizer``: when the store recorded the tokenizer it was
    written with, a different one raises here (ids of the wrong vocabulary
    would be read silently)."""

    directory: str
    micro_batch_size: int
    grad_accum_steps: int = 1
    shuffle_seed: Optional[int] = 0
    shard_by_host: bool = True
    expect_tokenizer: Optional[str] = None
    # False pads the final partial step with all-pad rows instead of
    # dropping it, as in TokenBatchDataset.
    drop_remainder: bool = True

    def __post_init__(self) -> None:
        with open(os.path.join(self.directory, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("version") != _VERSION:
            raise ValueError(f"unknown token-store version {meta.get('version')}")
        self.tokenizer_name = meta.get("tokenizer")
        self.max_doc_len = int(meta.get("max_doc_len", 0))
        if (self.expect_tokenizer is not None and self.tokenizer_name is not None
                and self.tokenizer_name != self.expect_tokenizer):
            raise ValueError(
                f"token store at {self.directory!r} was written with tokenizer "
                f"{self.tokenizer_name!r} but the run expects {self.expect_tokenizer!r}; "
                f"ids from the wrong vocab would be read silently")
        self.seq_len = int(meta["seq_len"])
        self.pad_id = int(meta["pad_id"])
        self.packed = bool(meta["packed"])
        n_rows = int(meta["n_rows"])
        if n_rows == 0:
            raise ValueError(f"token store at {self.directory!r} is empty (n_rows=0)")
        self._ids = np.memmap(os.path.join(self.directory, "ids.bin"), np.int32, "r",
                              shape=(n_rows, self.seq_len))
        if self.packed:
            self._segs = np.memmap(os.path.join(self.directory, "segs.bin"), np.int32,
                                   "r", shape=(n_rows, self.seq_len))
            self._lens = None
        else:
            self._segs = None
            self._lens = np.memmap(os.path.join(self.directory, "lengths.bin"),
                                   np.int32, "r", shape=(n_rows,))
        self._init_host_shard(n_rows, self.shard_by_host)

    @property
    def pack(self) -> bool:
        """The in-memory dataset's name for :attr:`packed` (the trainer's
        checkpoint sidecar reads it)."""
        return self.packed

    def _gather(self, row_indices: np.ndarray) -> dict:
        rows = np.sort(row_indices)  # monotone reads off the memmap
        unsort = np.argsort(np.argsort(row_indices))
        ids = np.asarray(self._ids[rows])[unsort]
        fields = {"input_ids": ids}
        if self.packed:
            segs = np.asarray(self._segs[rows])[unsort]
            fields["loss_mask"] = packed_loss_mask(segs)
            fields["segment_ids"] = segs
            fields["positions"] = packed_positions(segs)
        else:
            lens = np.asarray(self._lens[rows])[unsort]
            fields["loss_mask"] = (np.arange(self.seq_len)[None, :]
                                   < lens[:, None]).astype(np.int32)
        return fields
