"""The CUDA kernels on the card, against their plain versions: the paged
decode kernel (K4) on float and int8 pools and flash attention's forward
(K1), dq (K2) and dk/dv (K3); then the decode step's host path (the decode
window as a CUDA graph, no host sync in its dispatch, the LM head's bf16
GEMM); then checkpoints of a train state on the card (placement on restore,
a bit-equal resume, the one wait on the card a save adds to its step); then
the train step's host path (the step as a CUDA graph, bit-equal to the
eager step with dropout on, no host sync in a window's replays, K1-K3
counted per replay).

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


# ----------------------------------------------------------------------
# Split-K: tables up to 256 blocks (4,096 tokens), lengths at the split
# boundaries the host's plan picks for this card, windows past a split.
# ----------------------------------------------------------------------

def _plan(batch, heads, kv_heads, max_len):
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    return tpa.split_plan(batch, heads, kv_heads, max_len, sm)


def _check_pool(gen, pool, batch, heads, kv_heads, d, lens, max_blocks, window=None,
                num_blocks=64):
    """K4 (float pools) or K4q (int8) against the plain version on bf16
    queries: absolute 2**-6, and 2**-7 relative to each row's largest |out|."""
    make = _int8_inputs if pool == "int8" else _inputs
    dtype = torch.float32 if pool == "float32" else torch.bfloat16
    got = make(gen, batch, heads, kv_heads, d, dtype, max_blocks=max_blocks, lens=lens,
               num_blocks=num_blocks)
    q, k, v, tables, lens_t = got[:5]
    kw = dict(window=window)
    if pool == "int8":
        kw.update(k_scale=got[5], v_scale=got[6])
    out = tpa.paged_decode_attention(q, k, v, tables, lens_t, **kw)
    torch.cuda.synchronize()
    ref = tpa.paged_decode_attention_reference(q, k, v, tables, lens_t, **kw)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)
    if dtype == torch.bfloat16:
        err = (out.float() - ref.float()).abs().flatten(1).amax(1)
        top = ref.float().abs().flatten(1).amax(1)
        assert (err <= 2.0 ** -7 * top).all(), (err, top)
    for row, n in enumerate(lens):
        if n == 0:
            assert not out[row].any()


@pytest.mark.parametrize("pool", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("heads,kv_heads", [(32, 8), (8, 1)])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_split_k_one_row_at_a_split_boundary(gen, pool, d, heads, kv_heads, delta):
    splits, chunk = _plan(1, heads, kv_heads, 256 * 16)
    assert splits > 1
    _check_pool(gen, pool, 1, heads, kv_heads, d, [chunk + delta], max_blocks=256)


@pytest.mark.parametrize("pool", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("heads,kv_heads", [(32, 8), (8, 1)])
def test_split_k_batch_of_eight_across_splits(gen, pool, d, heads, kv_heads):
    splits, chunk = _plan(8, heads, kv_heads, 256 * 16)
    assert splits > 1
    lens = [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, 4095, 4096]
    _check_pool(gen, pool, 8, heads, kv_heads, d, lens, max_blocks=256)


@pytest.mark.parametrize("pool", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("batch,heads,kv_heads,max_blocks", [(5, 8, 8, 4), (40, 32, 32, 64)])
def test_split_k_plans_of_one_split(gen, pool, batch, heads, kv_heads, max_blocks):
    """A 64-token table, and llama2_7b's 32 kv heads at batch 40 (more
    blocks than the plan's target): one split a row, which still goes
    through the workspace and the combine kernel."""
    max_len = max_blocks * 16
    assert _plan(batch, heads, kv_heads, max_len)[0] == 1
    lens = [0, 1, max_len] + [(37 * i) % (max_len + 1) for i in range(3, batch)]
    _check_pool(gen, pool, batch, heads, kv_heads, 128, lens, max_blocks=max_blocks)
    assert tpa.last_plan[0] == 1


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_split_k_window_4096_over_lengths_to_8192(gen, pool):
    """mistral_7b's window: the leading splits of the long rows are empty."""
    lens = [0, 5, 100, 4095, 4097, 5000, 6000, 8192]
    _check_pool(gen, pool, 8, 32, 8, 128, lens, max_blocks=512, window=4096,
                num_blocks=128)


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_split_k_nan_in_dead_rows_with_rows_of_empty_splits(gen, pool):
    """NaN in every dead pool row (on an int8 pool: in the dead rows'
    scales), garbage table entries past every sequence, a row of length 0
    (every split empty) and rows whose later splits lie wholly past
    seq_len: the output is finite and matches the plain version on clean
    data."""
    _, chunk = _plan(4, 32, 8, 256 * 16)
    lens = [0, 5, chunk + 1, 3 * chunk]
    if pool == "int8":
        q, k, v, tables, lens_t, ks, vs = _int8_inputs(gen, 4, 32, 8, 128, torch.bfloat16,
                                                       max_blocks=256, lens=lens,
                                                       num_blocks=512)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        q, k, v, tables, lens_t = _inputs(gen, 4, 32, 8, 128, torch.bfloat16, max_blocks=256,
                                          lens=lens, num_blocks=512)
        scales = {}
    live = torch.zeros(k.shape[:2], dtype=torch.bool, device="cuda")
    for b, n in enumerate(lens):
        for t in range(n):
            live[tables[b, t // 16], t % 16] = True
    ref = tpa.paged_decode_attention_reference(q, k, v, tables, lens_t, **scales)
    for t in (scales.values() if scales else (k, v)):
        t[~live] = float("nan")
    out = tpa.paged_decode_attention(q, k, v, tables, lens_t, **scales)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and not out[0].any()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[torch.bfloat16], rtol=0)


def test_split_k_launches_the_split_and_combine_kernels(gen):
    """One count a wrapper call; on the card, the split kernel and the
    combine kernel."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, tables, lens = _inputs(gen, 8, 32, 8, 128, torch.bfloat16, max_blocks=256,
                                    lens=[4096] * 8)
    before = tpa.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            tpa.paged_decode_attention(q, k, v, tables, lens)
        torch.cuda.synchronize()
    assert tpa.launches == before + 2
    names = {e.key for e in prof.key_averages()}
    assert any("paged_decode_kernel" in n for n in names), names
    assert any("paged_decode_combine_kernel" in n for n in names), names
    assert "split-K" in tpa.kernel_design(torch.bfloat16, 128)


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
    # Captures the decode graph, whose warm-up iteration launches the
    # kernel once per layer outside any decode step (as the serve CLI does
    # before traffic).
    engine.warmup_decode_ladder()
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
    if segments == "padded_row":  # the last batch row is all padding
        segs[-1] = 0
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


# bf16 K1 and K3 run on the tensor cores (wgmma; K3 at d 256 stays on the
# CUDA cores): the edges their 64-row tiles and GQA packing create. s 1, 63
# and 65 put the end inside or just past one tile; 64/1 packs 64 heads of
# one position into a tile.
@pytest.mark.parametrize("s", [1, 63, 65, 200, 1000])
@pytest.mark.parametrize("h,hkv", [(32, 32), (32, 8), (8, 1), (64, 1)])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_bf16_flash_kernels_at_tile_edges(gen, s, h, hkv, d):
    _check_flash(*_flash_case(gen, 1, s, h, hkv, d, torch.bfloat16))


# Non-causal; a window smaller than a tile; packed segments whose last batch
# row is all padding (every row of it fully masked: o = 0, lse = +1e30).
@pytest.mark.parametrize("s", [65, 1000])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("variant", ["noncausal", "window40", "segments_padded_row"])
def test_bf16_flash_kernels_masks(gen, s, d, variant):
    q, k, v, do, kw = _flash_case(gen, 2, s, 8, 2, d, torch.bfloat16,
                                  causal=variant != "noncausal",
                                  window=40 if variant == "window40" else None,
                                  segments="padded_row" if "segments" in variant else False)
    _check_flash(q, k, v, do, kw)
    if kw["segment_ids"] is not None:
        o, lse = tfa.flash_fwd(q, k, v, **kw)
        assert not o[-1].any() and (lse[-1] == tfa.MASKED_LSE).all()


def test_bf16_flash_reaches_the_tensor_core_kernels(gen):
    """bf16 K1, K2 and K3 (d 64/128) name the wgmma program and the
    profiler sees their kernels; float32 and K3 at d 256 keep the CUDA
    cores."""
    from torch.profiler import ProfilerActivity, profile

    wgmma = "wgmma bf16 hi/lo, cp.async 2-stage"
    for d in (64, 128, 256):
        assert tfa.kernel_design("flash_fwd", torch.bfloat16, d) == wgmma
        assert tfa.kernel_design("flash_bwd_dkv", torch.bfloat16, d) == (
            wgmma if d <= 128 else "cuda-core fp32")
        assert tfa.kernel_design("flash_bwd_dq", torch.bfloat16, d) == wgmma
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert tfa.kernel_design(name, torch.float32, d) == "cuda-core fp32"
    q, k, v, do, _ = _flash_case(gen, 1, 256, 8, 2, 128, torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            tfa.flash_attention(q, k, v).backward(do)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert any("flash_fwd_wgmma_kernel" in n for n in names), names
    assert any("flash_bwd_dkv_wgmma_kernel" in n for n in names), names
    assert any("flash_bwd_dq_wgmma_kernel" in n for n in names), names
    assert not any("flash_fwd_kernel" in n or "flash_bwd_dq_kernel" in n
                   for n in names), names


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


# ----------------------------------------------------------------------
# The decode step's host path: the decode window as a CUDA graph, with no
# host sync inside the dispatch; the LM head's bf16 GEMM
# ----------------------------------------------------------------------

def _tiny_bf16_cfg():
    import dataclasses

    from dlti_tpu_torch.config import MODEL_PRESETS

    return dataclasses.replace(MODEL_PRESETS["llama_tiny"], dtype="bfloat16",
                               param_dtype="bfloat16")


def _card_engine(pool="bfloat16", k=8, graphs=True, max_seqs=4):
    """llama_tiny in bf16 on the card; ``graphs=False`` runs the decode
    iteration eagerly through the executor's constructor argument."""
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine
    from dlti_tpu_torch.serving.engine import EngineExecutor

    cfg = _tiny_bf16_cfg()
    params = init_params(cfg, seed=0, device="cuda")
    ec = EngineConfig(max_seqs=max_seqs, block_size=16, num_blocks=64, max_model_len=128,
                      cache_dtype=pool, eos_token_id=-1, steps_per_sync=k)
    ex = EngineExecutor(cfg, params, ec, device="cuda", cuda_graphs=graphs)
    return InferenceEngine(cfg, params, ec, device="cuda", executor=ex)


def _mixed_requests(engine):
    from dlti_tpu_torch.serving import SamplingParams

    reqs = [engine.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=21)),
            engine.submit([4] * 40, SamplingParams(temperature=0.9, top_k=50, top_p=0.9,
                                                   max_tokens=17, seed=5)),
            engine.submit([7, 8], SamplingParams(temperature=0.7, max_tokens=30, seed=9))]
    return reqs


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_decode_window_and_prefill_never_sync_the_host(gen, pool):
    """``set_sync_debug_mode("error")`` around a graphed 8-step window's
    dispatch (greedy and sampling rows, one slot free) and around the
    executor's prefill and first-token sampling: nothing waits on the card."""
    import numpy as np

    engine = _card_engine(pool)
    engine.warmup_decode_ladder()
    _mixed_requests(engine)
    engine.step()  # admission and prefill
    ex = engine.executor
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = engine._decode_dispatch()
        ids = np.arange(1, 33, dtype=np.int64).reshape(2, 16)
        pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
        pos[1, 9:] = -1
        logits = ex.prefill(ids, pos, np.zeros((2, 1), np.int32), np.array([15, 8], np.int32))
        ex.sample(logits, np.array([3, 4], np.int64), np.array([0, 2], np.int32),
                  np.array([0.0, 1.0], np.float32), np.array([0, 5], np.int32),
                  np.array([1.0, 0.9], np.float32))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pending[1] == 8
    engine._decode_complete(pending)
    while engine.has_work:
        engine.step()
    assert engine.block_manager.num_free == 63


@pytest.mark.parametrize("k", [1, 8])
def test_graphed_decode_equals_eager(gen, k):
    """The same requests through the captured graph and through the eager
    iteration on the card: identical tokens and logprobs."""
    runs = []
    for graphs in (False, True):
        engine = _card_engine("bfloat16", k, graphs)
        reqs = _mixed_requests(engine)
        while engine.has_work:
            engine.step()
        assert (engine.executor.graph is not None) == graphs
        runs.append([(r.output_token_ids, r.output_logprobs) for r in reqs])
    assert runs[0] == runs[1]
    assert [len(t) for t, _ in runs[0]] == [21, 17, 30]


def test_rewarm_keeps_one_graph_and_replays_count_launches(gen):
    """``warmup_decode_ladder`` is idempotent (one graph), and K4's counter
    grows by layers x device steps although replays bypass the wrapper."""
    engine = _card_engine("bfloat16", 8)
    engine.warmup_decode_ladder()
    graph = engine.executor.graph
    engine.warmup_decode_ladder()
    assert engine.executor.graph is graph
    tpa.launches = tpa.launches_int8 = 0
    _mixed_requests(engine)
    windows = 0
    while engine.has_work:
        windows += engine.num_active > 0
        engine.step()
    torch.cuda.synchronize()
    steps = engine.stats["decode_steps"]
    assert engine.executor.graph is graph
    assert steps > windows
    assert tpa.launches == engine.model_cfg.num_layers * steps and tpa.launches_int8 == 0


def test_lm_head_runs_a_bf16_gemm_with_float32_output(gen):
    """The head of a bf16 model multiplies bf16 operands on the card
    (``aten::mm`` with an out_dtype, bf16 inputs in the profile) and returns
    float32 logits equal to the float32 product up to summation order; its
    gradient with respect to x is the float32 product's."""
    from torch.profiler import ProfilerActivity, profile

    from dlti_tpu_torch.models.llama import lm_head_logits

    x = torch.randn(8, 1, 256, device="cuda", generator=gen).to(torch.bfloat16)
    w = (0.05 * torch.randn(256, 512, device="cuda", generator=gen)).to(torch.bfloat16)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        got = lm_head_logits(x, w)
        torch.cuda.synchronize()
    want = x.float() @ w.float()
    assert got.dtype == torch.float32 and got.shape == (8, 1, 512)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    mms = [e for e in prof.events() if e.name == "aten::mm"]
    assert mms and all(e.input_shapes[:2] == [[8, 256], [256, 512]] for e in mms)
    dtypes = getattr(mms[0], "input_dtypes", None)
    if dtypes is not None:
        assert "BFloat16" in str(dtypes[0]) and "BFloat16" in str(dtypes[1]), dtypes

    xg = x.clone().requires_grad_()
    xf = x.clone().requires_grad_()
    g = torch.randn(8, 1, 512, device="cuda", generator=gen)
    lm_head_logits(xg, w).backward(g)
    (xf.float() @ w.float()).backward(g)
    assert xg.grad.dtype == torch.bfloat16
    torch.testing.assert_close(xg.grad, xf.grad, atol=0, rtol=0)


# ----------------------------------------------------------------------
# Checkpoints of a train state on the card
# ----------------------------------------------------------------------

def _card_train_state(preset, layers=None, lora_r=16):
    import dataclasses

    from dlti_tpu_torch.config import MODEL_PRESETS, LoRAConfig, OptimizerConfig
    from dlti_tpu_torch.models import init_params, load_model
    from dlti_tpu_torch.training import build_optimizer, create_train_state

    cfg = MODEL_PRESETS[preset]
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    lora = LoRAConfig(r=lora_r, alpha=2 * lora_r)
    params = init_params(cfg, seed=0, device="cuda", lora=lora)
    model = load_model(cfg, params, "cuda", lora=lora, trainable_lora=True)
    return create_train_state(model, build_optimizer(OptimizerConfig(warmup_steps=1)))


def test_restore_places_every_leaf_on_the_card_with_the_templates_dtype(gen, tmp_path):
    from dlti_tpu_torch.checkpoint import restore_train_state, save_train_state
    from dlti_tpu_torch.training.state import load_state_leaves, state_leaves

    state = _card_train_state("llama_300m", layers=2)
    state.step = 3
    state.opt_state.count.fill_(3)
    with torch.no_grad():
        for t in [*state.trainable().values(), *state.opt_state.mu.values()]:
            t.normal_(generator=gen)
    save_train_state(str(tmp_path), 3, state_leaves(state), async_save=False)
    template = _card_train_state("llama_300m", layers=2)
    leaves = restore_train_state(str(tmp_path), 3, state_leaves(template))
    for (name, got), (_, want) in zip(leaves, state_leaves(template)):
        assert got.device == want.device and got.dtype == want.dtype, name
    load_state_leaves(template, leaves)
    assert template.step == 3 and template.opt_state.count == 3
    for (name, got), (_, want) in zip(state_leaves(template), state_leaves(state)):
        assert got.device == want.device and torch.equal(got, want), name
    assert all(m.dtype == torch.float32 and m.is_cuda for m in template.opt_state.mu.values())
    on_card = [n for n, t in leaves if t.is_cuda]
    assert len(on_card) == len(leaves) - 1  # all but the step


def _texts(n=48):
    import numpy as np

    rng = np.random.default_rng(2)
    return ["".join(chr(97 + c) for c in rng.integers(0, 26, rng.integers(40, 300)))
            for _ in range(n)]


def test_two_step_resume_on_llama_300m_is_bit_equal(gen, tmp_path):
    """4 steps uninterrupted against 2 steps, a checkpoint, and a fresh
    trainer resuming for 2 more: the same losses and grad norms, bit for
    bit (the kernels use no atomics; dropout seeds depend on the step)."""
    from dlti_tpu_torch.config import (
        MODEL_PRESETS, CheckpointConfig, Config, DataConfig, LoRAConfig, OptimizerConfig,
        TrainConfig,
    )
    from dlti_tpu_torch.data import ByteTokenizer, make_batches
    from dlti_tpu_torch.training import Trainer

    def cfg(max_steps, strategy):
        return Config(model=MODEL_PRESETS["llama_300m"], lora=LoRAConfig(),
                      optimizer=OptimizerConfig(warmup_steps=1, learning_rate=1e-3),
                      data=DataConfig(max_seq_len=256, tokenizer="byte"),
                      checkpoint=CheckpointConfig(output_dir=str(tmp_path / "ck"),
                                                  save_strategy=strategy, save_steps=2),
                      train=TrainConfig(micro_batch_size=2, grad_accum_steps=2,
                                        max_steps=max_steps, logging_steps=100))

    ds = make_batches(_texts(), ByteTokenizer(), seq_len=256, micro_batch_size=2,
                      grad_accum_steps=2)
    _, ref = Trainer(cfg(4, "no"), device="cuda").train(dataset=ds)
    _, first = Trainer(cfg(2, "steps"), device="cuda").train(dataset=ds)
    _, rest = Trainer(cfg(4, "steps"), device="cuda").train(dataset=ds)
    assert first.losses == ref.losses[:2] and first.save_steps == [2]
    assert rest.resumed_from == 2 and rest.save_steps == [4]
    assert rest.losses == ref.losses[2:] and rest.grad_norms == ref.grad_norms[2:]


def _syncs(fn):
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def test_a_save_adds_one_wait_on_the_card_to_its_step(gen, tmp_path):
    """``set_sync_debug_mode``: a train step waits on the card never, and a
    train step with a save (cold, then with the frozen base's host copy
    kept) once: the snapshot's one stream synchronisation."""
    from dlti_tpu_torch.checkpoint import HostCache, save_train_state, wait_for_saves
    from dlti_tpu_torch.training import make_train_step
    from dlti_tpu_torch.training.state import frozen_param_keys, state_leaves

    state = _card_train_state("llama_300m", layers=2)
    step = make_train_step(state.model, accum_steps=1)
    batch = {"input_ids": torch.randint(3, 32000, (1, 2, 128), device="cuda",
                                        generator=gen, dtype=torch.int32)}
    step(state, batch, 1)  # warm
    cache = HostCache(frozen_param_keys(state))

    def step_and_save():
        step(state, batch, 2)
        save_train_state(str(tmp_path), state.step, state_leaves(state), cache=cache)

    plain = _syncs(lambda: step(state, batch, 2))
    cold = _syncs(step_and_save)
    warm = _syncs(step_and_save)
    wait_for_saves(str(tmp_path))
    assert (plain, cold, warm) == (0, 1, 1)
    assert len(cache) == len(frozen_param_keys(state))


# ----------------------------------------------------------------------
# The train step's host path: the step as a CUDA graph
# ----------------------------------------------------------------------

def _window_case(gen, graphs, layers=2, accum=2):
    """llama_300m (head_dim 64, which K1-K3 take) cut to ``layers``, LoRA
    r=16 with its default dropout 0.05, remat on, and a ``StepWindow`` over
    it."""
    from dlti_tpu_torch.training import StepWindow

    state = _card_train_state("llama_300m", layers=layers)
    assert state.model.model.layers[0].attn.q_proj.lora_dropout == 0.05
    window = StepWindow(state.model, accum_steps=accum, seed=43, capacity=4,
                        cuda_graphs=graphs)
    return state, window


def _host_batches(n, accum=2, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(3, 32000, (accum, 2, 256)).astype(np.int32),
             "loss_mask": (rng.random((accum, 2, 256)) > 0.1).astype(np.int32)}
            for _ in range(n)]


def test_graphed_train_steps_equal_eager_with_dropout(gen):
    """The same 4 steps (two windows of 2) through the captured step and
    through the eager step on the card, from the same state, dropout on:
    equal losses and grad norms, and equal LoRA factors and moments after,
    bit for bit (the same kernels in the same order)."""
    from dlti_tpu_torch.utils.device import to_host

    batches = _host_batches(4)
    runs = []
    for graphs in (False, True):
        state, window = _window_case(gen, graphs)
        rows = [to_host(window.run(state, batches[i:i + 2], i + 1))[0] for i in (0, 2)]
        assert (window.graph is not None) == graphs and state.step == 4
        runs.append((rows, [t.clone() for t in state.trainable().values()],
                     [t.clone() for t in state.opt_state.mu.values()]))
        window.release()
    (eager, pe, me), (graphed, pg, mg) = runs
    for a, b in zip(eager, graphed):
        assert (a == b).all(), (a, b)
    assert all(torch.equal(a, b) for a, b in zip(pe + me, pg + mg))


def test_train_window_replays_never_sync_the_host(gen):
    """``set_sync_debug_mode("error")`` around a captured window of 3
    steps: the uploads into the static inputs and the replays wait on
    nothing (the capture, in the first window, does)."""
    from dlti_tpu_torch.utils.device import to_host

    state, window = _window_case(gen, True)
    batches = _host_batches(4, seed=1)
    to_host(window.run(state, batches[:1], 1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = window.run(state, batches[1:], 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rows = to_host(out)[0]
    assert rows.shape == (3, 5) and state.step == 4 and window.captures == 1
    assert all(abs(x) < float("inf") for x in rows[:, 0])


def test_train_window_counts_k1_k3_per_replay(gen):
    """After the capture, a window of 3 steps adds per-step launches x 3 to
    K1-K3's counters (K1 twice per layer per microbatch under remat, K2 and
    K3 once), though replays bypass the wrappers; a batch of another shape
    captures a second graph."""
    from dlti_tpu_torch.utils.device import to_host

    layers, accum = 2, 2
    state, window = _window_case(gen, True, layers, accum)
    batches = _host_batches(4, accum, seed=2)
    to_host(window.run(state, batches[:1], 1))
    tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
    to_host(window.run(state, batches[1:], 2))
    per_step = layers * accum
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches) == (
        2 * per_step * 3, per_step * 3, per_step * 3)
    # A batch of another shape captures again (one eager warm-up step).
    short = [{k: v[..., :128] for k, v in batches[0].items()}]
    rows = to_host(window.run(state, short, 5))[0]
    assert window.captures == 2 and state.step == 5 and abs(rows[0, 0]) < float("inf")
    assert tfa.dq_launches == per_step * 5
