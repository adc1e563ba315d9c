"""The CUDA kernels on the card, against their plain versions: the paged
decode kernel (K4) on float and int8 pools and flash attention's forward
(K1), dq (K2) and dk/dv (K3).

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false, as on a CPU-only host. On a machine with the card and without JAX,
run this file alone, without the suite's JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``. K4: 1e-5 for float32 (sums in another
order); 2**-6 for bfloat16 (both versions round an fp32 result below
|x| = 4 to bf16, at most one bf16 step apart). Flash: see ``FLASH_TOL``.
"""

import pytest
import torch

from dlti_tpu_torch.ops import flash_attention as tfa
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
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
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
    with pytest.raises(ValueError, match="require k_scale"):
        tpa.paged_decode_attention(q, k.to(torch.int8), v.to(torch.int8), tables, lens)
    ones = torch.ones(k.shape[:3], device="cuda")
    with pytest.raises(ValueError, match="belong to int8 pools"):
        tpa.paged_decode_attention(q, k, v, tables, lens, k_scale=ones, v_scale=ones)
    with pytest.raises(ValueError, match="k_scale must be float32"):
        tpa.paged_decode_attention(q, k.to(torch.int8), v.to(torch.int8), tables, lens,
                                   k_scale=ones.double(), v_scale=ones)
    with pytest.raises(ValueError, match="v_scale must be float32"):
        tpa.paged_decode_attention(q, k.to(torch.int8), v.to(torch.int8), tables, lens,
                                   k_scale=ones, v_scale=ones[:, :8].contiguous())


def _int8_inputs(gen, *args, **kw):
    """As ``_inputs``, with the pools quantized as ``paged_update`` stores
    them: int8 payloads and float32 row scales."""
    from dlti_tpu_torch.ops.kv_cache import _quantize_rows

    q, k, v, tables, lens = _inputs(gen, *args, **kw)
    kq, ks = _quantize_rows(k)
    vq, vs = _quantize_rows(v)
    return q, kq, vq, tables, lens, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("heads,kv_heads", [(8, 8), (8, 2), (4, 1)])
@pytest.mark.parametrize("window", [None, 20])
def test_int8_kernel_matches_plain(gen, dtype, d, heads, kv_heads, window):
    q, k, v, tables, lens, ks, vs = _int8_inputs(gen, 5, heads, kv_heads, d, dtype,
                                                 lens=[0, 1, 17, 100, 128])
    before, before_float = tpa.launches_int8, tpa.launches
    out = tpa.paged_decode_attention(q, k, v, tables, lens, k_scale=ks, v_scale=vs,
                                     window=window)
    torch.cuda.synchronize()
    assert (tpa.launches_int8, tpa.launches) == (before + 1, before_float)
    ref = tpa.paged_decode_attention_reference(q, k, v, tables, lens, k_scale=ks,
                                               v_scale=vs, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert not out[0].any()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)


def test_int8_nan_scales_of_dead_rows_never_leak(gen):
    q, k, v, tables, lens, ks, vs = _int8_inputs(gen, 3, 8, 2, 128, torch.bfloat16,
                                                 lens=[5, 40, 0])
    tables[:, 4:] = 3  # garbage past every sequence's blocks
    live = torch.zeros(k.shape[:2], dtype=torch.bool, device="cuda")
    for b, n in enumerate(lens.tolist()):
        for t in range(n):
            live[tables[b, t // 16], t % 16] = True
    ref = tpa.paged_decode_attention_reference(q, k, v, tables, lens, k_scale=ks,
                                               v_scale=vs)
    ks[~live] = float("nan")
    vs[~live] = float("nan")
    out = tpa.paged_decode_attention(q, k, v, tables, lens, k_scale=ks, v_scale=vs)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[torch.bfloat16], rtol=0)


def test_int8_engine_decode_launches_the_int8_kernel_per_layer(gen):
    """An engine on an int8 pool on the card: every decode step launches the
    int8 program once per layer and the float program never."""
    from dlti_tpu_torch.config import MODEL_PRESETS
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams

    cfg = MODEL_PRESETS["llama_tiny"]
    engine = InferenceEngine(cfg, init_params(cfg, seed=0, device="cuda"),
                             EngineConfig(max_seqs=4, block_size=16, num_blocks=32,
                                          max_model_len=128, cache_dtype="int8",
                                          eos_token_id=-1), device="cuda")
    tpa.launches = tpa.launches_int8 = 0
    out = engine.generate([[1, 2, 3], [4] * 40], SamplingParams(temperature=0.0,
                                                                max_tokens=6))
    torch.cuda.synchronize()
    assert [len(r.output_token_ids) for r in out] == [6, 6]
    assert tpa.launches == 0
    assert tpa.launches_int8 == cfg.num_layers * engine.stats["decode_steps"] > 0


def test_server_on_an_engine_built_with_device_cuda_answers(gen):
    """``device="cuda"`` (no index, as ``--device cuda`` passes it): the
    server's stepper selects the card and serves a completion."""
    import http.client
    import json
    import threading

    from dlti_tpu_torch.config import MODEL_PRESETS
    from dlti_tpu_torch.data import ByteTokenizer
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, ServerConfig, make_server

    cfg = MODEL_PRESETS["llama_tiny"]
    engine = InferenceEngine(cfg, init_params(cfg, seed=0, device="cuda"),
                             EngineConfig(max_seqs=2, block_size=16, num_blocks=32,
                                          max_model_len=128, cache_dtype="int8",
                                          eos_token_id=-1), device="cuda")
    assert engine.device.index is not None
    httpd, aeng = make_server(engine, ByteTokenizer(),
                              ServerConfig(host="127.0.0.1", port=0, request_timeout_s=60))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("GET", "/health")
        health = conn.getresponse()
        assert (health.status, health.read()) == (200, b'{"status": "ok"}')
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": "hello", "max_tokens": 4, "temperature": 0.0}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200, body
        assert body["usage"]["completion_tokens"] == 4
        assert body["choices"][0]["finish_reason"] == "length"
        assert not aeng.dead
    finally:
        httpd.shutdown()
        aeng.shutdown()
        httpd.server_close()


# ----------------------------------------------------------------------
# Flash attention (K1 forward, K2 dq, K3 dk/dv) against its plain version
# ----------------------------------------------------------------------

# Forward output and grads, kernel against plain version on identical
# inputs. Both compute in float32 and sum in different orders: float32
# agrees to 1e-4 (absolute and relative) at these O(1)-O(10) magnitudes. In
# bfloat16 both round a float32 result to bf16, whose relative spacing is
# 2**-7, so they may land one step apart: rtol 2**-7, atol 1e-3 near zero.
FLASH_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
             torch.bfloat16: dict(atol=1e-3, rtol=2.0 ** -7)}


def _segments(b, s, n_docs=3, seed=0):
    """Contiguous documents 1..n_docs with random cuts, trailing padding 0
    (the layout of the JAX suite's make_packed_segments)."""
    gen = torch.Generator().manual_seed(seed)
    segs = torch.zeros(b, s, dtype=torch.int32)
    for row in range(b):
        cuts = sorted((torch.randperm(s - 8, generator=gen)[:n_docs] + 4).tolist())
        prev = 0
        for i, c in enumerate(cuts):
            segs[row, prev:c] = i + 1
            prev = c
    return segs.cuda()


def _flash_case(gen, b, s, h, hkv, d, dtype, *, causal=True, window=None,
                segments=False):
    dev = torch.device("cuda")
    q = torch.randn(b, s, h, d, device=dev, generator=gen).to(dtype)
    k = torch.randn(b, s, hkv, d, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, s, hkv, d, device=dev, generator=gen).to(dtype)
    do = torch.randn(b, s, h, d, device=dev, generator=gen).to(dtype)
    segs = _segments(b, s) if segments else None
    return q, k, v, do, dict(causal=causal, window=window, segment_ids=segs)


def _check_flash(q, k, v, do, kw):
    tol = FLASH_TOL[q.dtype]
    counts = (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches)
    o, lse = tfa.flash_fwd(q, k, v, **kw)
    dq, dk, dv = tfa.flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches) == tuple(
        c + 1 for c in counts)
    ro, rlse = tfa.flash_attention_reference(q, k, v, **kw)
    rdq, rdk, rdv = tfa.flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
    assert o.dtype == q.dtype and dq.dtype == q.dtype and dk.dtype == k.dtype
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    # lse: +1e30 on exactly the same (fully masked) rows, close elsewhere.
    assert torch.equal(lse == tfa.MASKED_LSE, rlse == tfa.MASKED_LSE)
    live = rlse != tfa.MASKED_LSE
    torch.testing.assert_close(lse[live], rlse[live], atol=1e-4, rtol=1e-5)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 2), (4, 1)])
def test_flash_kernels_match_plain(gen, dtype, d, h, hkv):
    _check_flash(*_flash_case(gen, 2, 256, h, hkv, d, dtype))


@pytest.mark.parametrize("s", [192, 200, 1000])
@pytest.mark.parametrize("variant", ["causal", "noncausal", "window", "segments",
                                     "window+segments"])
def test_flash_kernels_edges(gen, s, variant):
    _check_flash(*_flash_case(gen, 2, s, 8, 2, 128, torch.bfloat16,
                              causal=variant != "noncausal",
                              window=96 if "window" in variant else None,
                              segments="segments" in variant))


def test_flash_autograd_function_launches_all_three(gen):
    q, k, v, do, _ = _flash_case(gen, 1, 128, 4, 2, 64, torch.float32)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counts = (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches)
    out = tfa.flash_attention(q, k, v)
    out.backward(do)
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches) == tuple(
        c + 1 for c in counts)
    ref = tfa.flash_attention_reference(q.detach(), k.detach(), v.detach())[0]
    torch.testing.assert_close(out.detach(), ref, **FLASH_TOL[torch.float32])
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize("s,d,causal", [(1000, 128, True), (200, 64, True),
                                        (192, 256, False)])
def test_auto_attention_launches_the_kernels_at_any_length(gen, s, d, causal):
    """impl="auto" on the card takes the kernels for unaligned lengths,
    head_dim 64/256 and non-causal attention, forward and backward."""
    from dlti_tpu_torch.ops.attention import multi_head_attention

    q, k, v, do, _ = _flash_case(gen, 1, s, 8, 2, d, torch.bfloat16, causal=causal)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counts = (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches)
    out = multi_head_attention(q, k, v, causal=causal, impl="auto")
    out.backward(do)
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches) == tuple(
        c + 1 for c in counts)
    ref = tfa.flash_attention_reference(q.detach(), k.detach(), v.detach(),
                                        causal=causal)[0]
    torch.testing.assert_close(out.detach().float(), ref.float(),
                               **FLASH_TOL[torch.bfloat16])


def test_auto_attention_raises_where_the_kernels_do_not_reach(gen):
    from dlti_tpu_torch.ops.attention import multi_head_attention

    q, k, v, _, _ = _flash_case(gen, 1, 64, 4, 4, 32, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        multi_head_attention(q, k, v, impl="auto")


def test_flash_kernels_refuse_what_they_were_not_built_for(gen):
    q, k, v, _, _ = _flash_case(gen, 1, 64, 4, 4, 96, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd(q, k, v)
    q, k, v, _, _ = _flash_case(gen, 1, 64, 4, 4, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_fwd(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="segment_ids"):
        tfa.flash_fwd(q, k, v, segment_ids=torch.ones(1, 64, dtype=torch.int64,
                                                      device="cuda"))
    with pytest.raises(ValueError, match="does not fit"):
        tfa.flash_fwd(q, k[:, :, :3].contiguous(), v[:, :, :3].contiguous())
