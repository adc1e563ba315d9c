"""Paged KV cache, device side: the port of ``dlti_tpu/ops/kv_cache.py``.

* One physical pool per layer: ``(num_blocks, block_size, kv_heads,
  head_dim)``, allocated once for the engine's lifetime, float32, bfloat16
  or float16, or int8 with one float32 scale per (token, kv head) row in
  ``k_scale``/``v_scale`` ``(num_blocks, block_size, kv_heads)``: symmetric
  absmax quantization over head_dim, at half a bf16 pool's bytes.
* ``block_tables`` ``(batch, max_blocks_per_seq)`` int32 maps a sequence's
  logical block ``i`` to a physical block; token position ``p`` lives at
  row ``block_tables[b, p // bs]``, offset ``p % bs``.
* :func:`paged_update` writes the new K/V rows **in place** into the pool
  (``index_copy_``); an int8 pool quantizes them once, here, and writes
  payloads and scales to the same slots. The reference returns fresh
  pools and relies on JAX buffer donation to reuse the memory; here the
  pool tensors themselves are mutated and nothing is returned to rebind.
* Padding tokens (position -1) write to the trash block (block 0, which
  the block manager never hands out) where the reference's ``mode="drop"``
  scatter drops them: every row is written, with no mask, so a write never
  waits on the host. A dense model never reads the trash block back. A
  mixture of experts does (padding and free decode rows attend over it, are
  routed, and take expert capacity), so its calls pass the ``drop`` mask
  and every row landing on slot 0 writes what the reference leaves there,
  whatever order a CUDA scatter lands duplicates in: an eager and a
  graphed engine cannot part.
* :func:`paged_gather` reads a sequence's blocks back into a contiguous
  logical window (an int8 pool's dequantized to float32); the caller's
  position mask hides unwritten rows. The paged decode kernel
  (``ops.paged_attention``) reads blocks in place instead.

The host-side block allocator is ``dlti_tpu_torch.serving.block_manager``.
"""

from __future__ import annotations

from typing import List, Optional

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
    """Allocate the physical block pools, one ``{"k", "v"}`` dict per layer.

    ``dtype="int8"`` selects the quantized layout: int8 payloads plus
    ``{"k_scale", "v_scale"}`` float32 tensors of shape ``(num_blocks,
    block_size, kv_heads)``, all zero-filled.
    """
    shape = (num_blocks, block_size, num_kv_heads, head_dim)
    if dtype == "int8":
        sshape = (num_blocks, block_size, num_kv_heads)
        return [
            {"k": torch.zeros(shape, dtype=torch.int8, device=device),
             "v": torch.zeros(shape, dtype=torch.int8, device=device),
             "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
             "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device)}
            for _ in range(num_layers)
        ]
    if dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"unsupported KV pool dtype {dtype}")
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(num_layers)
    ]


def _quantize_rows(x: torch.Tensor):
    """Per-(token, kv_head) symmetric int8 over the trailing head_dim.

    Rounds as the reference does, bit for bit: ``x32 / scale`` (not a
    multiply by the reciprocal), half to even, clipped to +-127; a row of
    zeros gets scale 1."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def slot_mapping(block_tables: torch.Tensor, positions: torch.Tensor,
                 block_size: int) -> torch.Tensor:
    """Flat physical slot index (int64) for each (batch, seq) token.

    Negative positions (padding) map to slot 0, in the trash block.
    """
    pos = positions.long()
    clamped = pos.clamp(min=0)
    phys = torch.gather(block_tables.long(), 1, clamped // block_size)
    slots = phys * block_size + clamped % block_size
    return torch.where(pos >= 0, slots, 0)


def paged_update(layer_cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 slots: torch.Tensor, drop: Optional[torch.Tensor] = None) -> None:
    """Write new K/V rows into the layer's pools, in place.

    ``k_new``/``v_new``: (batch, s, kv_heads, head_dim); ``slots``:
    (batch, s) from :func:`slot_mapping`. Without ``drop`` every row is
    written and padding rows collide in the trash block in no fixed order.
    ``drop`` (batch, s) bool, for a model that reads the trash block back,
    marks the padding rows (position -1, which :func:`slot_mapping` sends
    to slot 0), whose writes are dropped (all False for one-token decode):
    every row that writes slot 0 (padding, and free decode slots, whose
    tables are all zero) then writes the last row there not dropped, or
    the slot's own values when every one is dropped, as the reference's
    scatter leaves it. An int8 pool gets the rows quantized and their
    scales written to the same slots.
    """
    k_pool, v_pool = layer_cache["k"], layer_cache["v"]
    nb, bs, kvh, hd = k_pool.shape
    idx = slots.reshape(-1)
    if drop is not None:
        to_zero = idx == 0
        live = to_zero & ~drop.reshape(-1)
        order = torch.arange(1, idx.shape[0] + 1, device=idx.device)
        last = (live.long() * order).argmax()  # the last live row to slot 0
        any_live = live.any()

    def write(pool: torch.Tensor, rows: torch.Tensor) -> None:
        flat = pool.view(nb * bs, *pool.shape[2:])
        rows = rows.reshape(idx.shape[0], *pool.shape[2:]).to(pool.dtype)
        if drop is not None:
            shape = (-1,) + (1,) * (rows.dim() - 1)
            # index_select: indexing by a 0-d tensor would read it on the host.
            final = torch.where(any_live, rows.index_select(0, last.reshape(1)), flat[:1])
            rows = torch.where(to_zero.view(shape), final, rows)
        flat.index_copy_(0, idx, rows)

    if k_pool.dtype == torch.int8:
        k_new, ks = _quantize_rows(k_new)
        v_new, vs = _quantize_rows(v_new)
        write(layer_cache["k_scale"], ks)
        write(layer_cache["v_scale"], vs)
    write(k_pool, k_new)
    write(v_pool, v_new)


def paged_gather(layer_cache: dict, block_tables: torch.Tensor):
    """Gather each sequence's logical KV window from the pool.

    Returns (k, v) of shape (batch, max_blocks * block_size, kv_heads,
    head_dim) in logical order; rows past a sequence's written length hold
    whatever the pool held and must be masked by the caller. An int8 pool
    returns the float32 dequantized window: the caller casts it to its
    compute dtype, as the reference's callers do.
    """
    k_pool, v_pool = layer_cache["k"], layer_cache["v"]
    nb, bs, kvh, hd = k_pool.shape
    b, max_blk = block_tables.shape
    idx = block_tables.long()
    k = k_pool[idx].reshape(b, max_blk * bs, kvh, hd)
    v = v_pool[idx].reshape(b, max_blk * bs, kvh, hd)
    if k_pool.dtype == torch.int8:
        ks = layer_cache["k_scale"][idx].reshape(b, max_blk * bs, kvh, 1)
        vs = layer_cache["v_scale"][idx].reshape(b, max_blk * bs, kvh, 1)
        k = k.float() * ks
        v = v.float() * vs
    return k, v
