"""The paged decode kernel on the card, against its plain version.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false, as on a CPU-only host. On a machine with the card and without JAX,
run this file alone, without the suite's JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: 1e-5 for float32 (sums in another
order); 2**-6 for bfloat16 (both versions round an fp32 result below
|x| = 4 to bf16, at most one bf16 step apart).
"""

import pytest
import torch

from dlti_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, batch, heads, kv_heads, d, dtype, block_size=16, num_blocks=64,
            max_blocks=8, lens=None):
    dev = torch.device("cuda")
    q = torch.randn(batch, 1, heads, d, device=dev, generator=gen).to(dtype)
    k = torch.randn(num_blocks, block_size, kv_heads, d, device=dev, generator=gen).to(dtype)
    v = torch.randn(num_blocks, block_size, kv_heads, d, device=dev, generator=gen).to(dtype)
    tables = torch.randint(0, num_blocks, (batch, max_blocks), device=dev, generator=gen,
                           dtype=torch.int32)
    if lens is None:
        lens = torch.randint(0, max_blocks * block_size + 1, (batch,), device=dev,
                             generator=gen, dtype=torch.int32)
    else:
        lens = torch.tensor(lens, device=dev, dtype=torch.int32)
    return q, k, v, tables, lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("heads,kv_heads", [(8, 8), (8, 2), (4, 1)])
@pytest.mark.parametrize("window", [None, 20])
def test_kernel_matches_plain(gen, dtype, d, heads, kv_heads, window):
    q, k, v, tables, lens = _inputs(gen, 5, heads, kv_heads, d, dtype,
                                    lens=[0, 1, 17, 100, 128])
    before = tpa.launches
    out = tpa.paged_decode_attention(q, k, v, tables, lens, window=window)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    ref = tpa.paged_decode_attention_reference(q, k, v, tables, lens, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert not out[0].any()  # seq_len 0 gives zeros
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)


def test_nan_in_rows_past_seq_len_never_leaks(gen):
    q, k, v, tables, lens = _inputs(gen, 3, 8, 2, 128, torch.bfloat16, lens=[5, 40, 0])
    tables[:, 4:] = 3  # garbage past every sequence's blocks
    live = torch.zeros(k.shape[:2], dtype=torch.bool, device="cuda")
    for b, n in enumerate(lens.tolist()):
        for t in range(n):
            live[tables[b, t // 16], t % 16] = True
    k[~live] = float("nan")
    v[~live] = float("nan")
    out = tpa.paged_decode_attention(q, k, v, tables, lens)
    ref = tpa.paged_decode_attention_reference(q, k, v, tables, lens)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[torch.bfloat16], rtol=0)


def test_kernel_refuses_what_it_was_not_built_for(gen):
    q, k, v, tables, lens = _inputs(gen, 2, 4, 4, 96, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_decode_attention(q, k, v, tables, lens)
    q, k, v, tables, lens = _inputs(gen, 2, 4, 4, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_decode_attention(q, k.transpose(0, 1), v.transpose(0, 1), tables, lens)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_decode_attention(q, k, v, tables.long(), lens)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpa.paged_decode_attention(q, k.to(torch.int8), v.to(torch.int8), tables, lens,
                                   k_scale=torch.ones(k.shape[:3], device="cuda"),
                                   v_scale=torch.ones(k.shape[:3], device="cuda"))
