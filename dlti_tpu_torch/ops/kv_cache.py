"""Paged KV cache, device side: the port of ``dlti_tpu/ops/kv_cache.py``.

* One physical pool per layer: ``(num_blocks, block_size, kv_heads,
  head_dim)``, allocated once for the engine's lifetime, float32 or
  bfloat16, or int8 with one float32 scale per (token, kv head) row in
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
  the block manager never hands out, so nothing reads it back) where the
  reference's ``mode="drop"`` scatter drops them: every row is written,
  with no mask, so a write never waits on the host.
* :func:`paged_gather` reads a sequence's blocks back into a contiguous
  logical window (an int8 pool's dequantized to float32); the caller's
  position mask hides unwritten rows. The paged decode kernel
  (``ops.paged_attention``) reads blocks in place instead.

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
    if dtype == torch.float16:
        raise NotImplementedError(
            "float16 KV pools are not ported (see ROADMAP.md, queue 1): the "
            "paged decode kernel takes float32, bfloat16 and int8 pools")
    if dtype not in (torch.float32, torch.bfloat16):
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
                 slots: torch.Tensor) -> None:
    """Write new K/V rows into the layer's pools, in place.

    ``k_new``/``v_new``: (batch, s, kv_heads, head_dim); ``slots``:
    (batch, s) from :func:`slot_mapping`. Every row is written; padding rows
    all land in the trash block, where duplicate indices only collide with
    each other. An int8 pool gets the rows quantized and their scales
    written to the same slots.
    """
    k_pool, v_pool = layer_cache["k"], layer_cache["v"]
    nb, bs, kvh, hd = k_pool.shape
    idx = slots.reshape(-1)
    if k_pool.dtype == torch.int8:
        k_new, ks = _quantize_rows(k_new)
        v_new, vs = _quantize_rows(v_new)
        layer_cache["k_scale"].view(nb * bs, kvh).index_copy_(
            0, idx, ks.reshape(-1, kvh))
        layer_cache["v_scale"].view(nb * bs, kvh).index_copy_(
            0, idx, vs.reshape(-1, kvh))
    k_pool.view(nb * bs, kvh, hd).index_copy_(
        0, idx, k_new.reshape(-1, kvh, hd).to(k_pool.dtype))
    v_pool.view(nb * bs, kvh, hd).index_copy_(
        0, idx, v_new.reshape(-1, kvh, hd).to(v_pool.dtype))


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
