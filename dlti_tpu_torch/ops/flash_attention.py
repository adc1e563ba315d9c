"""Flash attention, forward and backward: the port of the TPU kernels in
``dlti_tpu/ops/pallas/flash_attention.py`` (``_flash_fwd``'s ``_fwd_kernel``
and ``_flash_bwd``'s ``_dq_kernel`` / ``_dkv_kernel``).

* :func:`flash_attention` — the public function, with the JAX entry's
  arguments and layout: q ``(b, sq, h, d)``, k/v ``(b, skv, h_kv, d)``. It is
  a ``torch.autograd.Function``: the forward saves q, k, v, o and the
  per-row logsumexp; the backward computes ``D = rowsum(dO * o)`` in PyTorch
  (as the JAX package leaves it to XLA) and then dq, dk and dv.
* On a CPU tensor both directions run the plain versions,
  :func:`flash_attention_reference` and
  :func:`flash_attention_backward_reference`. On a CUDA tensor they launch
  the hand-written kernels of ``csrc/flash_attention.cu`` (K1 forward, K2
  dq, K3 dk/dv) or raise; nothing falls back from a kernel to a plain
  version. In bfloat16, K1 and K3 (at head_dim 64 and 128) run on the
  tensor cores (wgmma); :func:`kernel_design` names the program a call
  takes.
* ``fwd_launches``, ``dq_launches``, ``dkv_launches`` — how many times each
  kernel was launched.

What the plain versions compute is what the kernels compute, which is the
Pallas kernels' semantics, not ``reference_attention``'s: a query row with
no allowed key (segment id 0, or everything masked) gives output 0 and
logsumexp +1e30, where ``reference_attention`` gives a uniform average.
The causal mask is top-left aligned (key j <= query i) and the window
applies under ``causal`` only, as in the Pallas kernels.

``ModelConfig.flash_block_q`` / ``flash_block_kv`` are the TPU kernel's
tiles; the CUDA kernels pick their own tiles and do not read them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from dlti_tpu_torch.ops import _build

KERNEL_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MASKED_LSE = 1e30  # logsumexp of a row with nothing to attend to
MAX_GROUP = 64     # query heads per kv head a kernel tile can hold

# Kernel launches (plain CPU calls excluded).
fwd_launches = 0
dq_launches = 0
dkv_launches = 0


def _allowed(b, sq, skv, causal, segment_ids, window, q_lo, q_hi, device):
    """(b, q_hi - q_lo, skv) bool mask of the query rows [q_lo, q_hi)."""
    qi = torch.arange(q_lo, q_hi, device=device)[:, None]
    kj = torch.arange(skv, device=device)[None, :]
    allowed = torch.ones(q_hi - q_lo, skv, dtype=torch.bool, device=device)
    if causal:
        allowed &= kj <= qi
        if window:
            allowed &= kj > qi - window
    allowed = allowed[None].expand(b, -1, -1)
    if segment_ids is not None:
        qs = segment_ids[:, q_lo:q_hi, None]
        ks = segment_ids[:, None, :]
        allowed = allowed & (qs == ks) & (ks != 0)
    return allowed


def _chunks(sq: int, q_chunk: Optional[int]):
    step = q_chunk or sq
    return [(lo, min(lo + step, sq)) for lo in range(0, sq, step)]


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    q_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K1 computes, in plain PyTorch (float32 arithmetic).

    Returns ``(o, lse)``: o ``(b, sq, h, d)`` in q's dtype and the
    logsumexp ``(b, h, sq)`` in float32 (+1e30 on rows with nothing
    allowed, where o is 0). ``q_chunk`` evaluates the query rows that many
    at a time, to bound the memory of the score matrix.
    """
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    f32 = torch.float32
    kf, vf = k.to(f32), v.to(f32)
    outs, lses = [], []
    for lo, hi in _chunks(sq, q_chunk):
        qg = q[:, lo:hi].to(f32).reshape(b, hi - lo, hkv, g, d)
        s = torch.einsum("bqngd,bknd->bngqk", qg, kf) * d ** -0.5
        allowed = _allowed(b, sq, skv, causal, segment_ids, window, lo, hi,
                           q.device)[:, None, None]
        s = s.masked_fill(~allowed, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)                       # 0 where masked
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bngqk,bknd->bqngd", p, vf)
        o = o / torch.where(l > 0, l, torch.ones_like(l)).permute(0, 3, 1, 2, 4)
        lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, MASKED_LSE))
        outs.append(o.reshape(b, hi - lo, h, d).to(q.dtype))
        lses.append(lse[..., 0].reshape(b, h, hi - lo))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    q_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What K2 and K3 compute, in plain PyTorch (float32 arithmetic): the
    flash backward from the saved logsumexp, p = exp(s - lse),
    ds = p (dO v^T - D) d^-1/2 with D = rowsum(dO * o); returns (dq, dk, dv)
    in the inputs' dtypes."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    f32 = torch.float32
    scale = d ** -0.5
    kf, vf = k.to(f32), v.to(f32)
    delta = backward_delta(o, do)                  # (b, h, sq)
    dqs = []
    dk = torch.zeros(b, skv, hkv, d, dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    for lo, hi in _chunks(sq, q_chunk):
        n = hi - lo
        qg = q[:, lo:hi].to(f32).reshape(b, n, hkv, g, d)
        dog = do[:, lo:hi].to(f32).reshape(b, n, hkv, g, d)
        allowed = _allowed(b, sq, skv, causal, segment_ids, window, lo, hi,
                           q.device)[:, None, None]
        s = torch.einsum("bqngd,bknd->bngqk", qg, kf) * scale
        ls = lse[:, :, lo:hi].reshape(b, hkv, g, n, 1)
        dl = delta[:, :, lo:hi].reshape(b, hkv, g, n, 1)
        p = torch.where(allowed, torch.exp(s - ls), torch.zeros_like(s))
        dp = torch.einsum("bqngd,bknd->bngqk", dog, vf)
        ds = torch.where(allowed, p * (dp - dl) * scale, torch.zeros_like(s))
        dqs.append(torch.einsum("bngqk,bknd->bqngd", ds, kf).reshape(b, n, h, d))
        dk += torch.einsum("bngqk,bqngd->bknd", ds, qg)
        dv += torch.einsum("bngqk,bqngd->bknd", p, dog)
    return (torch.cat(dqs, dim=1).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def backward_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * o) in float32, laid out (b, h, sq)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


# ----------------------------------------------------------------------
# The kernels
# ----------------------------------------------------------------------

def _check_kernel_inputs(q, k, v, segment_ids, extra=()):
    tensors = {"q": q, "k": k, "v": v, **dict(extra)}
    if segment_ids is not None:
        tensors["segment_ids"] = segment_ids
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (b, sq, h, d) and k/v one (b, skv, h_kv, d) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q's {tuple(q.shape)}")
    if h // k.shape[2] > MAX_GROUP:
        raise ValueError(f"{h // k.shape[2]} query heads per kv head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernels are built for head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPE_CODES or any(
            t.dtype != q.dtype for n, t in tensors.items()
            if n not in ("segment_ids", "lse", "delta")):
        raise ValueError(f"unsupported dtypes: the kernels take float32 or "
                         f"bfloat16 q/k/v of one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if segment_ids is not None:
        if segment_ids.dtype != torch.int32 or tuple(segment_ids.shape) != (b, sq):
            raise ValueError("segment_ids must be int32 (b, s)")
        if k.shape[1] != sq:
            raise ValueError("segment masking needs self-attention shapes "
                             f"(sq == skv), got sq={sq}, skv={k.shape[1]}")
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _kernel_library() -> ctypes.CDLL:
    lib = _build.load_library("flash_attention")
    if lib.dlti_flash_fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        dims = [i32] * 8 + [ctypes.c_float, i32, ptr]
        lib.dlti_flash_fwd.argtypes = [ptr] * 6 + dims
        lib.dlti_flash_bwd_dq.argtypes = [ptr] * 8 + dims
        lib.dlti_flash_bwd_dkv.argtypes = [ptr] * 9 + dims
        for fn in (lib.dlti_flash_fwd, lib.dlti_flash_bwd_dq, lib.dlti_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.dlti_flash_smem_bytes.argtypes = [i32, i32, i32]
        lib.dlti_flash_smem_bytes.restype = ctypes.c_longlong
        lib.dlti_flash_impl.argtypes = [i32, i32, i32]
        lib.dlti_flash_impl.restype = ctypes.c_char_p
        lib.dlti_flash_error_string.argtypes = [i32]
        lib.dlti_flash_error_string.restype = ctypes.c_char_p
    return lib


_KERNELS = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}


def kernel_design(name: str, dtype: torch.dtype, head_dim: int) -> str:
    """The program that kernel ``name`` ("flash_fwd", "flash_bwd_dq",
    "flash_bwd_dkv") runs for this dtype and head_dim, as the CUDA source
    names it: "wgmma bf16 hi/lo, cp.async 2-stage" (tensor cores) or
    "cuda-core fp32". Loads (and, the first time, builds) the library."""
    if dtype not in _DTYPE_CODES or head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"no kernel for {dtype} at head_dim {head_dim}")
    return _kernel_library().dlti_flash_impl(_KERNELS[name], head_dim,
                                             _DTYPE_CODES[dtype]).decode()


def _launch(name: str, q, k, args, window, causal):
    lib = _kernel_library()
    d = q.shape[3]
    smem = lib.dlti_flash_smem_bytes(_KERNELS[name], d, _DTYPE_CODES[q.dtype])
    limit = torch.cuda.get_device_properties(q.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"{name} at head_dim {d} needs {smem} B of shared "
                         f"memory; the card allows {limit}")
    b, sq, h, _ = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"dlti_{name}")(
            *args, b, sq, k.shape[1], h, k.shape[2], d, int(causal),
            int(window or 0), d ** -0.5, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.dlti_flash_error_string(err).decode())


def _seg_ptr(segment_ids):
    return segment_ids.data_ptr() if segment_ids is not None else None


def flash_fwd(q, k, v, *, causal=True, segment_ids=None, window=None):
    """K1 on CUDA tensors: ``(o, lse)`` as :func:`flash_attention_reference`."""
    global fwd_launches
    _check_kernel_inputs(q, k, v, segment_ids)
    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, k,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(segment_ids),
             o.data_ptr(), lse.data_ptr()], window, causal)
    fwd_launches += 1
    return o, lse


def _check_bwd_inputs(q, k, v, do, lse, delta, segment_ids):
    _check_kernel_inputs(q, k, v, segment_ids,
                         extra=(("do", do), ("lse", lse), ("delta", delta)))
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name} must be float32 (b, h, sq) = {want}")


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal=True, segment_ids=None,
                 window=None):
    """K2 on CUDA tensors: dq from the saved logsumexp and D = rowsum(dO*o)
    (both float32, (b, h, sq))."""
    global dq_launches
    _check_bwd_inputs(q, k, v, do, lse, delta, segment_ids)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", q, k,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), _seg_ptr(segment_ids),
             dq.data_ptr()], window, causal)
    dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal=True, segment_ids=None,
                  window=None):
    """K3 on CUDA tensors: (dk, dv), each block owning one kv tile."""
    global dkv_launches
    _check_bwd_inputs(q, k, v, do, lse, delta, segment_ids)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv", q, k,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), _seg_ptr(segment_ids),
             dk.data_ptr(), dv.data_ptr()], window, causal)
    dkv_launches += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, *, causal=True, segment_ids=None, window=None):
    """D = rowsum(dO * o) in PyTorch, then K2 and K3 on CUDA tensors:
    ``(dq, dk, dv)`` as :func:`flash_attention_backward_reference`."""
    delta = backward_delta(o, do)
    kw = dict(causal=causal, segment_ids=segment_ids, window=window)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, window):
        if q.device.type == "cuda":
            o, lse = flash_fwd(q, k, v, causal=causal, segment_ids=segment_ids,
                               window=window)
        elif q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, causal=causal,
                                               segment_ids=segment_ids,
                                               window=window)
        else:
            raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        kw = dict(causal=ctx.causal, segment_ids=segment_ids, window=ctx.window)
        if q.device.type == "cuda":
            dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), **kw)
        else:
            dq, dk, dv = flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention, differentiable in q, k and v. q ``(b, sq, h, d)``;
    k/v ``(b, skv, h_kv, d)``; ``segment_ids`` ``(b, s)`` (0 = padding, which
    attends to nothing and gives 0); ``window`` keeps the last ``window``
    positions under ``causal``. Returns ``(b, sq, h, d)`` in q's dtype."""
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                 segment_ids, bool(causal), int(window or 0))
