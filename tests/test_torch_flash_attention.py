"""The port's flash attention on the CPU (its plain versions, forward and
backward) against the JAX package's Pallas kernel in interpret mode, on the
cases of ``tests/test_flash_attention.py``.

Inputs are float32 from a numpy seed, fed to both. Tolerances are that
file's own: outputs atol 2e-5 / rtol 1e-3, grads atol 1e-4 (the two sum in
different orders and tiles). Outputs are compared on every row, padding
rows included: both give exactly 0 on a row with nothing to attend to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_packed_segments
from dlti_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from dlti_tpu_torch.ops import flash_attention as tfa
from dlti_tpu_torch.ops.attention import multi_head_attention, reference_attention

OUT_TOL = dict(atol=2e-5, rtol=1e-3)
GRAD_ATOL = 1e-4


def _qkv(b=2, s=256, h=4, hkv=4, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))


def _both(q, k, v, *, causal=True, segs=None, window=None, block=(128, 128)):
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     segment_ids=None if segs is None else jnp.asarray(segs),
                     block_q=block[0], block_kv=block[1], window=window,
                     interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              segment_ids=None if segs is None else torch.from_numpy(segs),
                              window=window)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("block", [(128, 128), (64, 128), (128, 64), (256, 256)])
def test_plain_matches_pallas_at_every_block_shape(block):
    got, want = _both(*_qkv(), block=block)
    np.testing.assert_allclose(got, want, **OUT_TOL)


@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 2), (4, 1)])
def test_plain_matches_pallas_gqa(h, hkv):
    got, want = _both(*_qkv(h=h, hkv=hkv))
    np.testing.assert_allclose(got, want, **OUT_TOL)


def test_plain_matches_pallas_noncausal():
    got, want = _both(*_qkv(s=128), causal=False, block=(64, 64))
    np.testing.assert_allclose(got, want, **OUT_TOL)


@pytest.mark.parametrize("h,hkv,s,n_docs,block", [
    (4, 4, 256, 3, (64, 64)),
    (8, 2, 256, 3, (64, 64)),
    (2, 2, 192, 2, (128, 128)),   # unaligned sequence: bounds compose with segments
])
def test_plain_matches_pallas_segments_and_zero_rows(h, hkv, s, n_docs, block):
    b = 2 if s == 256 else 1
    segs = np.array(make_packed_segments(b, s, n_docs=n_docs))
    assert (segs == 0).any()  # trailing padding rows: nothing to attend to
    got, want = _both(*_qkv(b=b, s=s, h=h, hkv=hkv), segs=segs, block=block)
    np.testing.assert_allclose(got, want, **OUT_TOL)
    assert not got[segs == 0].any()  # exactly 0, not a uniform average


@pytest.mark.parametrize("seq,window,block", [
    (256, 96, 64),
    (512, 96, 64),    # the TPU kernel's windowed grid
    (512, 100, 64),   # window not a multiple of the block
    (448, 96, 64),    # unaligned sequence + windowed grid
    (512, 64, 128),   # window smaller than one block
])
def test_plain_matches_pallas_window(seq, window, block):
    got, want = _both(*_qkv(b=1, s=seq, h=2, hkv=2), window=window,
                      block=(block, block))
    np.testing.assert_allclose(got, want, **OUT_TOL)


def test_plain_matches_pallas_window_and_segments():
    segs = np.array(make_packed_segments(1, 256))
    got, want = _both(*_qkv(b=1, s=256, h=2, hkv=2), segs=segs, window=64,
                      block=(64, 64))
    np.testing.assert_allclose(got, want, **OUT_TOL)


@pytest.mark.parametrize("case", ["causal", "gqa", "window", "segments"])
def test_plain_grads_match_pallas(case):
    h, hkv = (4, 2) if case in ("gqa", "segments") else (2, 2)
    q, k, v = _qkv(b=1, s=128, h=h, hkv=hkv, d=64)
    window = 48 if case == "window" else None
    segs = (np.array(make_packed_segments(1, 128, n_docs=2))
            if case == "segments" else None)
    valid = np.ones((1, 128, 1, 1), np.float32) if segs is None else \
        (segs != 0).astype(np.float32)[:, :, None, None]

    def jax_loss(q, k, v):
        out = jax_flash(q, k, v, causal=True, block_q=64, block_kv=64,
                        window=window, interpret=True,
                        segment_ids=None if segs is None else jnp.asarray(segs))
        return jnp.sum((out * valid) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, window=window,
                              segment_ids=None if segs is None else torch.from_numpy(segs))
    (out * torch.from_numpy(valid)).pow(2).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=GRAD_ATOL)


def test_plain_lse_and_backward_formulas_hold_on_masked_rows():
    """lse is +1e30 on rows with nothing allowed, and the written-out
    backward equals autograd through the plain forward."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, s=64, h=4, hkv=2, d=64))
    segs = torch.from_numpy(np.array(make_packed_segments(1, 64, n_docs=2)))
    o, lse = tfa.flash_attention_reference(q, k, v, segment_ids=segs, window=20,
                                           q_chunk=24)
    pad = (segs[0] == 0)
    assert (lse[0][:, pad] == tfa.MASKED_LSE).all()
    assert (lse[0][:, ~pad] < 100).all()
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(1))
    dq, dk, dv = tfa.flash_attention_backward_reference(
        q, k, v, o, lse, do, segment_ids=segs, window=20, q_chunk=24)
    aq, ak, av = (t.clone().requires_grad_() for t in (q, k, v))
    out, _ = tfa.flash_attention_reference(aq, ak, av, segment_ids=segs, window=20)
    out.backward(do)
    for got, want in ((dq, aq.grad), (dk, ak.grad), (dv, av.grad)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["reference", "flash", "auto"])
def test_multi_head_attention_dispatch(impl):
    """On a CPU tensor "auto" takes the reference path (the kernel needs
    the card; on a CUDA tensor it takes flash, see test_torch_cuda.py),
    "flash" the plain flash version; both agree with the reference where no
    row is fully masked."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, s=128, h=4, hkv=2, d=128))
    got = multi_head_attention(q, k, v, impl=impl)
    want = reference_attention(q, k, v)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-3)
    with pytest.raises(ValueError, match="impl"):
        multi_head_attention(q, k, v, impl="pallas")


# ----------------------------------------------------------------------
# The 2-byte tensor-core kernels' arithmetic, emulated in plain torch
# ----------------------------------------------------------------------

# chip_smoke.py's FLASH_TOL: |got - want| <= atol + rtol |want|; float16
# keeps 3 more bits than bf16, and its rtol is 8x tighter.
PHASE6_TOL = {torch.bfloat16: (1e-3, 2.0 ** -7), torch.float16: (1e-3, 2.0 ** -10)}
PHASE6_ATOL, PHASE6_RTOL = PHASE6_TOL[torch.bfloat16]
# The split must use at most this share of that limit: 20x margin.
SPLIT_SHARE = 0.05
# float16 kernels: p (at most 1) enters the split times 2**14.
F16_P_SCALE = 2.0 ** 14


def _split(x, dtype=torch.bfloat16):
    """hi = dtype(x), lo = dtype(x - hi), both back in float32."""
    hi = x.to(dtype).float()
    return hi, (x - hi).to(dtype).float()


def _split_f16(x):
    return _split(x, torch.float16)


def _round_f16(x):
    return (x.to(torch.float16).float(),)


def _ds_row_scale(ds, dims):
    """The float16 kernels' power of two per accumulator row: the row's
    largest |ds| lands in [2**14, 2**15), the exponent within [-30, 64]
    (2**64 for a row of zeros)."""
    m = ds.abs().amax(dim=dims, keepdim=True)
    e = torch.where(m > 0, 14 - torch.floor(torch.log2(m)), torch.full_like(m, 64.0))
    return torch.exp2(e.clamp(-30, 64))


def _bf16_kernel_emulation(q, k, v, do, *, segment_ids, window, p_operand,
                           f16_scaling=False):
    """What bf16 K1, K2 and K3 compute: q, k, v, dO bf16; q k^T and dO v^T
    summed in float32 (a product of two bf16 values is exact there); the
    float32 operand of p v, ds k, p^T dO and ds^T q turned into bf16
    tensor-core operands by ``p_operand`` (the kernels' hi/lo split: two
    products into one float32 sum). The online softmax over kv tiles is
    written as one softmax: the same sum in another order. Returns float32
    o, dq, dk, dv. ``f16_scaling`` adds the float16 kernels' exact powers of
    two around the split: p times 2**14, and ds by row (K2: per query row;
    K3: per key row, over the group's heads), taken as the row's final
    scale (the kernels' scale of a row only falls, so tiles before its
    largest |ds| keep a larger one)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = d ** -0.5
    qg, kf, vf, dog = (t.float() for t in (q, k, v, do))
    qg, dog = qg.reshape(b, s, hkv, h // hkv, d), dog.reshape(b, s, hkv, h // hkv, d)
    allowed = tfa._allowed(b, s, s, True, segment_ids, window, 0, s, "cpu")[:, None, None]
    p_mul = F16_P_SCALE if f16_scaling else 1.0

    def prod(eq, x, y):  # sum of the operand's 2-byte parts times y, in float32
        return sum(torch.einsum(eq, part, y) for part in p_operand(x))

    sc = torch.einsum("bqngd,bknd->bngqk", qg, kf).masked_fill(~allowed, float("-inf")) * scale
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(-1, keepdim=True)
    o = prod("bngqk,bknd->bqngd", p * p_mul, vf) / p_mul
    o = o / torch.where(l > 0, l, 1.0).permute(0, 3, 1, 2, 4)
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, tfa.MASKED_LSE))
    o = o.reshape(b, s, h, d)
    delta = tfa.backward_delta(o, do).reshape(b, hkv, h // hkv, s, 1)
    p = torch.where(allowed, torch.exp(sc - lse), torch.zeros_like(sc))
    dp = torch.einsum("bqngd,bknd->bngqk", dog, vf)
    ds = torch.where(allowed, p * (dp - delta) * scale, torch.zeros_like(sc))
    r2 = _ds_row_scale(ds, (-1,)) if f16_scaling else torch.ones_like(ds[..., :1])
    r3 = _ds_row_scale(ds, (2, 3)) if f16_scaling else torch.ones_like(ds[:, :, :1, :1])
    dq = prod("bngqk,bknd->bngqd", ds * r2, kf) / r2            # (b, n, g, q, d)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    dk = (prod("bngqk,bqngd->bnkd", ds * r3, qg) / r3[:, :, 0, 0, :, None])
    dv = prod("bngqk,bqngd->bknd", p * p_mul, dog) / p_mul
    return o, dq, dk.permute(0, 2, 1, 3), dv


_SPLIT_CASES = {
    # rows 1 and 2 attend to two and three keys: p far from 0 and 1
    "early_causal_rows": dict(b=1, s=64, h=4, hkv=4),
    "gqa_8_2": dict(b=2, s=128, h=8, hkv=2),
    "segments_zero_rows": dict(b=2, s=128, h=4, hkv=2, segments=True),
    "window_24": dict(b=1, s=128, h=4, hkv=2, window=24),
}


def _phase6_share(case, p_operand, dtype=torch.bfloat16, do_scale=1.0):
    """Largest |emulation - reference| over the phase-6 limit of ``dtype``
    (in units of ``do_scale``, dO's size), for o, dq, dk and dv; the
    reference is the plain versions on the same ``dtype`` values in float32,
    compared before either rounds its output."""
    c = _SPLIT_CASES[case]
    rng = np.random.default_rng(7)
    shapes = [(c["b"], c["s"], c["h"], 64), (c["b"], c["s"], c["hkv"], 64)]
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shapes[i]).astype(np.float32))
                   .to(dtype) for i in (0, 1, 1, 0))
    do = (do.float() * do_scale).to(dtype)
    segs = (torch.from_numpy(np.array(make_packed_segments(c["b"], c["s"], n_docs=2)))
            if c.get("segments") else None)
    kw = dict(segment_ids=segs, window=c.get("window"))
    got = _bf16_kernel_emulation(q, k, v, do, p_operand=p_operand,
                                 f16_scaling=dtype == torch.float16, **kw)
    ro, rlse = tfa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    rdq, rdk, rdv = tfa.flash_attention_backward_reference(
        q.float(), k.float(), v.float(), ro, rlse, do.float(), **kw)
    atol, rtol = PHASE6_TOL[dtype]
    units = (1.0, do_scale, do_scale, do_scale)
    return max(((g - w).abs() / u / (atol + rtol * w.abs() / u)).max().item()
               for g, w, u in zip(got, (ro, rdq, rdk, rdv), units))


@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_bf16_hi_lo_split_stays_far_inside_the_phase6_limit(case):
    """The split carries ~16 bits of p and ds: error ~2**-17 relative."""
    assert _phase6_share(case, _split) <= SPLIT_SHARE


@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_bf16_rounding_p_alone_would_break_the_phase6_limit(case):
    """Known-wrong control: p and ds rounded once to bf16 (FlashAttention-2's
    numerics) move o, dq, dk and dv past the same limit, which is why the
    kernels split them."""
    assert _phase6_share(case, lambda x: (x.to(torch.bfloat16).float(),)) > 1.0


# dO's size: unit, a gradient of 2**-6 (small ds fall toward float16's
# subnormals without the row scale), and one of 2**-4 under the default loss
# scale 2**16.
F16_DO_SCALES = [1.0, 2.0 ** -6, 2.0 ** 12]


@pytest.mark.parametrize("do_scale", F16_DO_SCALES)
@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_f16_hi_lo_split_stays_far_inside_the_phase6_limit(case, do_scale):
    """float16, with p times 2**14 and ds scaled by row: the split carries
    ~22 bits of p and ds whatever dO's size."""
    assert _phase6_share(case, _split_f16, torch.float16, do_scale) <= SPLIT_SHARE


@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_f16_rounding_p_alone_leaves_no_margin_under_the_phase6_limit(case):
    """Why float16 keeps p's lo half: p rounded once to float16 (ds still
    split) takes 48-100% of the float16 limit in these cases, more than
    100x what the split takes."""

    def p_once(x):  # the p operands lie in [0, 2**14]; ds rows are wider
        return _round_f16(x) if x.abs().max() <= F16_P_SCALE else _split_f16(x)

    once = _phase6_share(case, p_once, torch.float16)
    assert once > 0.4 and once > 100 * _phase6_share(case, _split_f16, torch.float16)


def test_f16_without_the_ds_row_scale_small_gradients_lose_bits():
    """Known-wrong control for the row scale: with dO at 2**-6 and ds
    split unscaled, small ds fall into float16's subnormals and dq, dk use
    a larger share of the limit than with the scale."""
    case, do_scale = "gqa_8_2", 2.0 ** -6
    scaled = _phase6_share(case, _split_f16, torch.float16, do_scale)
    c = _SPLIT_CASES[case]
    rng = np.random.default_rng(7)
    shapes = [(c["b"], c["s"], c["h"], 64), (c["b"], c["s"], c["hkv"], 64)]
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shapes[i]).astype(np.float32))
                   .half() for i in (0, 1, 1, 0))
    do = (do.float() * do_scale).half()
    # p keeps its 2**14 (o and dv as the kernels), ds unscaled: the row
    # scale of an all-ones ratio is the same as no scale.
    got = _bf16_kernel_emulation(q, k, v, do, segment_ids=None, window=None,
                                 p_operand=_split_f16, f16_scaling=False)
    ro, rlse = tfa.flash_attention_reference(q.float(), k.float(), v.float())
    _, rdk, _ = tfa.flash_attention_backward_reference(q.float(), k.float(), v.float(),
                                                       ro, rlse, do.float())
    atol, rtol = PHASE6_TOL[torch.float16]
    unscaled = ((got[2] - rdk).abs() / do_scale
                / (atol + rtol * rdk.abs() / do_scale)).max().item()
    assert unscaled > 10 * scaled
