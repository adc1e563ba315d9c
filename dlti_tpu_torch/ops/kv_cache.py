"""Paged KV cache, device side: the port of ``dlti_tpu/ops/kv_cache.py``.

* One physical pool per layer: ``(num_blocks, block_size, kv_heads,
  head_dim)``, allocated once for the engine's lifetime.
* ``block_tables`` ``(batch, max_blocks_per_seq)`` int32 maps a sequence's
  logical block ``i`` to a physical block; token position ``p`` lives at
  row ``block_tables[b, p // bs]``, offset ``p % bs``.
* :func:`paged_update` writes the new K/V rows **in place** into the pool
  (``index_copy_``). The reference returns fresh pools and relies on JAX
  buffer donation to reuse the memory; here the pool tensors themselves
  are mutated and nothing is returned to rebind.
* Writes whose slot is out of range (padding tokens at position -1) are
  dropped, as the reference's ``mode="drop"`` scatter drops them.
* :func:`paged_gather` reads a sequence's blocks back into a contiguous
  logical window; the caller's position mask hides unwritten rows. The
  paged decode kernel (``ops.paged_attention``) reads blocks in place
  instead.

The host-side block allocator is ``dlti_tpu_torch.serving.block_manager``.
"""

from __future__ import annotations

from typing import List

import torch


def init_paged_cache(
    num_layers: int,
    num_blocks: int,
    block_size: int,
    num_kv_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device=None,
) -> List[dict]:
    """Allocate the physical block pools, one ``{"k", "v"}`` dict per layer."""
    if dtype == "int8" or dtype == torch.int8:
        raise NotImplementedError(
            "int8 KV pools are not ported yet (see ROADMAP.md, 'int8 KV'); "
            "use a float32 or bfloat16 pool")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported KV pool dtype {dtype}")
    shape = (num_blocks, block_size, num_kv_heads, head_dim)
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(num_layers)
    ]


def slot_mapping(block_tables: torch.Tensor, positions: torch.Tensor,
                 block_size: int, num_blocks: int) -> torch.Tensor:
    """Flat physical slot index (int64) for each (batch, seq) token.

    Negative positions (padding) map to ``num_blocks * block_size``, one
    past the end, which :func:`paged_update` drops.
    """
    pos = positions.long()
    clamped = pos.clamp(min=0)
    phys = torch.gather(block_tables.long(), 1, clamped // block_size)
    slots = phys * block_size + clamped % block_size
    return torch.where(pos >= 0, slots, num_blocks * block_size)


def paged_update(layer_cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 slots: torch.Tensor) -> None:
    """Write new K/V rows into the layer's pools, in place.

    ``k_new``/``v_new``: (batch, s, kv_heads, head_dim); ``slots``:
    (batch, s) from :func:`slot_mapping`. Rows whose slot lies outside the
    pool are filtered out before the copy.
    """
    k_pool, v_pool = layer_cache["k"], layer_cache["v"]
    nb, bs, kvh, hd = k_pool.shape
    flat = slots.reshape(-1)
    keep = (flat >= 0) & (flat < nb * bs)
    idx = flat[keep]
    k_pool.view(nb * bs, kvh, hd).index_copy_(
        0, idx, k_new.reshape(-1, kvh, hd)[keep].to(k_pool.dtype))
    v_pool.view(nb * bs, kvh, hd).index_copy_(
        0, idx, v_new.reshape(-1, kvh, hd)[keep].to(v_pool.dtype))


def paged_gather(layer_cache: dict, block_tables: torch.Tensor):
    """Gather each sequence's logical KV window from the pool.

    Returns (k, v) of shape (batch, max_blocks * block_size, kv_heads,
    head_dim) in logical order; rows past a sequence's written length hold
    whatever the pool held and must be masked by the caller.
    """
    k_pool, v_pool = layer_cache["k"], layer_cache["v"]
    nb, bs, kvh, hd = k_pool.shape
    b, max_blk = block_tables.shape
    idx = block_tables.long()
    k = k_pool[idx].reshape(b, max_blk * bs, kvh, hd)
    v = v_pool[idx].reshape(b, max_blk * bs, kvh, hd)
    return k, v
