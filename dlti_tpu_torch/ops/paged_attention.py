"""Paged decode attention: the port of the TPU kernel
``dlti_tpu/ops/pallas/paged_attention.py`` (``_decode_kernel``, launched by
``paged_decode_attention``), for float pools (float32, bfloat16 or float16,
with a float32, bfloat16 or float16 query whatever the pool's dtype) and
for int8 pools with per-(token, kv head) float32 scales (the kernel's
``quantized`` program).

* :func:`paged_decode_attention_reference` — the plain PyTorch version:
  gather each sequence's window by block table (dequantized in float32 on
  an int8 pool), zero the rows outside the live range, mask by position
  (and window), float32 softmax, zeros for ``seq_len == 0``.
* :func:`paged_decode_attention` — the wrapper. A CPU tensor takes the
  plain version; a CUDA tensor launches the hand-written kernel
  ``csrc/paged_attention.cu`` (built on first use by ``ops._build``) or
  raises. There is no fallback from the kernel to the plain version.
* :func:`split_plan` — how the kernel splits each sequence's tokens
  (split-K), chosen from static shapes only, never from ``seq_lens``.
* ``launches`` / ``launches_int8`` — how many times the wrapper launched
  the kernel on a float pool / on an int8 pool (one per call; each call
  also launches the combine kernel). ``last_plan`` — the ``(splits,
  chunk)`` of the wrapper's last launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from dlti_tpu_torch.ops import _build

KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 3}
_INT8_CODE = 2  # pools only

# Split-K: the kernel walks its tokens in tiles of TILE_TOKENS and serves up
# to MAX_HEADS_PER_BLOCK query heads a block (kTile, kMaxHeads in the
# source, which the library reports and _kernel_library checks); the host
# aims for SPLIT_BLOCKS_PER_SM blocks per SM (several waves, so that no SM
# waits on one long sequence), with splits of at least MIN_SPLIT_TOKENS.
TILE_TOKENS = 32
MAX_HEADS_PER_BLOCK = 8
SPLIT_BLOCKS_PER_SM = 8
MIN_SPLIT_TOKENS = 64

# Kernel launches made by paged_decode_attention (plain CPU calls excluded):
# on float pools, and on int8 pools.
launches = 0
launches_int8 = 0
last_plan: Optional[Tuple[int, int]] = None


def _check_scales(k_pool, k_scale, v_scale) -> None:
    """The reference's rule: scales are required iff the pools are int8."""
    if k_pool.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 KV pools require k_scale/v_scale")
    elif k_scale is not None or v_scale is not None:
        raise ValueError(f"k_scale/v_scale belong to int8 pools, not a "
                         f"{k_pool.dtype} pool")


def paged_decode_attention_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch.

    q: (batch, 1, heads, d); pools: (num_blocks, block_size, kv_heads, d),
    float, or int8 with ``k_scale``/``v_scale`` (num_blocks, block_size,
    kv_heads) float32; block_tables: (batch, max_blocks), entries clamped
    into the pool; seq_lens: (batch,) = query position + 1. Returns
    (batch, 1, heads, d) in q's dtype. Rows outside ``[seq_len - window,
    seq_len)`` are zeroed before any product, so stale pool rows (or NaN
    scales of rows never written) cannot leak.
    """
    _check_scales(k_pool, k_scale, v_scale)
    batch, _, num_heads, d = q.shape
    nb, bs, kvh, _ = k_pool.shape
    hpg = num_heads // kvh
    f32 = torch.float32
    bt = block_tables.long().clamp(0, nb - 1)
    max_len = bt.shape[1] * bs
    k = k_pool[bt].reshape(batch, max_len, kvh, d).to(f32)
    v = v_pool[bt].reshape(batch, max_len, kvh, d).to(f32)
    if k_pool.dtype == torch.int8:
        k = k * k_scale[bt].reshape(batch, max_len, kvh, 1)
        v = v * v_scale[bt].reshape(batch, max_len, kvh, 1)
    pos = torch.arange(max_len, device=q.device)[None, :]
    lens = seq_lens.long()[:, None]
    valid = pos < lens
    if window:
        valid &= pos >= lens - window                       # (b, L)
    live = valid[:, :, None, None]
    k = torch.where(live, k, torch.zeros_like(k))
    v = torch.where(live, v, torch.zeros_like(v))
    qg = q[:, 0].to(f32).reshape(batch, kvh, hpg, d)
    s = torch.einsum("bghd,blgd->bghl", qg, k) * d ** -0.5
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)                                    # 0 where masked
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bghl,blgd->bghd", p, v) / torch.where(l > 0, l, 1.0)
    return o.reshape(batch, 1, num_heads, d).to(q.dtype)


def _check_kernel_inputs(q, k_pool, v_pool, block_tables, seq_lens,
                         k_scale=None, v_scale=None):
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "seq_lens": seq_lens}
    if k_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (batch, 1, heads, d), got {tuple(q.shape)}")
    batch, _, num_heads, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("k_pool and v_pool must share one 4-d shape")
    nb, bs, kvh, pd = k_pool.shape
    if pd != d or num_heads % kvh:
        raise ValueError(f"pool head shape {(kvh, pd)} does not fit q's "
                         f"{(num_heads, d)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel is built for head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPE_CODES or v_pool.dtype != k_pool.dtype or not (
            k_pool.dtype in _DTYPE_CODES or k_pool.dtype == torch.int8):
        raise ValueError(f"unsupported dtypes q={q.dtype} pool={k_pool.dtype}"
                         f"/{v_pool.dtype}; the kernel takes float32/bfloat16/"
                         f"float16 queries and float32/bfloat16/float16/int8 pools")
    if k_scale is not None:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != (nb, bs, kvh):
                raise ValueError(f"{name} must be float32 {(nb, bs, kvh)}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("block_tables and seq_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != batch \
            or tuple(seq_lens.shape) != (batch,):
        raise ValueError("block_tables must be (batch, max_blocks) and "
                         "seq_lens (batch,)")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned")


def split_plan(batch: int, num_heads: int, kv_heads: int, max_len: int,
               sm_count: int) -> Tuple[int, int]:
    """``(splits, chunk)``: split s of every sequence covers tokens
    ``[s * chunk, (s + 1) * chunk)``; ``splits * chunk >= max_len``, the
    table's ``max_blocks * block_size``. Static shapes only: the kernel
    cuts each split to the live window itself, so no launch reads
    ``seq_lens`` on the host."""
    blocks = batch * kv_heads * -(-(num_heads // kv_heads) // MAX_HEADS_PER_BLOCK)
    want = -(-SPLIT_BLOCKS_PER_SM * sm_count // blocks)
    chunk = max(MIN_SPLIT_TOKENS, -(-max_len // want))
    chunk = -(-chunk // TILE_TOKENS) * TILE_TOKENS
    return -(-max_len // chunk), chunk


def _kernel_library() -> ctypes.CDLL:
    lib = _build.load_library("paged_attention")
    fn = lib.dlti_paged_decode_attention
    if fn.argtypes is None:
        built = (lib.dlti_paged_decode_tile_tokens(),
                 lib.dlti_paged_decode_heads_per_block())
        if built != (TILE_TOKENS, MAX_HEADS_PER_BLOCK):
            raise RuntimeError(f"the kernel's (tile tokens, heads per block) {built} "
                               f"differ from split_plan's "
                               f"{(TILE_TOKENS, MAX_HEADS_PER_BLOCK)}")
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.dlti_paged_decode_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.dlti_paged_decode_smem_bytes.restype = ctypes.c_longlong
        lib.dlti_paged_decode_stages.argtypes = [ctypes.c_int] * 2
        lib.dlti_paged_decode_stages.restype = ctypes.c_int
        lib.dlti_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dlti_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _device_limits(device: torch.device) -> Tuple[int, int]:
    """(SM count, shared memory a block may opt into) of a card."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def kernel_design(pool_dtype: torch.dtype, head_dim: int) -> str:
    """The program the kernel runs on a pool of this dtype and head_dim, as
    ``chip_smoke.py`` prints it. Loads (and, the first time, builds) the
    library."""
    code = _INT8_CODE if pool_dtype == torch.int8 else _DTYPE_CODES.get(pool_dtype)
    if code is None or head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"no kernel for a {pool_dtype} pool at head_dim {head_dim}")
    stages = _kernel_library().dlti_paged_decode_stages(head_dim, code)
    return f"split-K + combine, cp.async {stages}-stage ring, fp32 CUDA cores"


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One-token-per-sequence attention over the paged KV pool.

    Same arguments as the reference's ``paged_decode_attention``: q
    ``(batch, 1, heads, d)``; pools ``(num_blocks, block_size, kv_heads,
    d)``; block_tables ``(batch, max_blocks)`` int32 (entries past a
    sequence's length may hold anything); seq_lens ``(batch,)`` int32 =
    query position + 1; ``window`` keeps the last ``window`` positions.
    ``k_scale``/``v_scale`` ``(num_blocks, block_size, kv_heads)`` float32
    are an int8 pool's row scales: required iff the pools are int8
    (``ValueError`` otherwise). Returns ``(batch, 1, heads, d)`` in q's
    dtype.

    A CPU tensor goes to :func:`paged_decode_attention_reference`; a CUDA
    tensor launches the kernel or raises.
    """
    global launches, launches_int8, last_plan
    _check_scales(k_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, seq_lens, k_scale=k_scale,
            v_scale=v_scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check_kernel_inputs(q, k_pool, v_pool, block_tables, seq_lens,
                         k_scale, v_scale)
    quantized = k_pool.dtype == torch.int8
    batch, _, num_heads, d = q.shape
    nb, bs, kvh, _ = k_pool.shape
    hpg = num_heads // kvh
    lib = _kernel_library()
    kv_code = _INT8_CODE if quantized else _DTYPE_CODES[k_pool.dtype]
    smem = lib.dlti_paged_decode_smem_bytes(hpg, d, kv_code)
    sm_count, limit = _device_limits(q.device)
    if smem > limit:
        raise ValueError(f"heads per kv head {hpg} at head_dim {d} need {smem} B "
                         f"of shared memory; the card allows {limit}")
    max_blocks = block_tables.shape[1]
    splits, chunk = split_plan(batch, num_heads, kvh, max_blocks * bs, sm_count)
    out = torch.empty_like(q)
    # (m, l) then acc per (row, head, split); the kernel writes every record.
    records = batch * num_heads * splits
    ws = torch.empty(records * (d + 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dlti_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            ws.data_ptr(), ws.data_ptr() + 4 * 2 * records,
            batch, num_heads, kvh, d, nb, bs, max_blocks, int(window or 0), splits,
            chunk, d ** -0.5, _DTYPE_CODES[q.dtype], kv_code, stream)
    if err != 0:
        raise RuntimeError("paged decode kernel launch failed: "
                           + lib.dlti_cuda_error_string(err).decode())
    last_plan = (splits, chunk)
    if quantized:
        launches_int8 += 1
    else:
        launches += 1
    return out
