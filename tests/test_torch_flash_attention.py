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
