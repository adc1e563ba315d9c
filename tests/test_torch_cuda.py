"""The CUDA kernels on the card, against their plain versions: the paged
decode kernel (K4) on float and int8 pools and flash attention's forward
(K1), dq (K2) and dk/dv (K3); then the decode step's host path (the decode
window as a CUDA graph, no host sync in its dispatch, the LM head's bf16
GEMM); then checkpoints of a train state on the card (placement on restore,
a bit-equal resume, the one wait on the card a save adds to its step); then
the train step's host path (the step as a CUDA graph, bit-equal to the
eager step with dropout on, no host sync in a window's replays, K1-K3
counted per replay); then the fp16 path (K1-K4 in float16, the |ds| >
65504 case, the graphed fp16 step with the loss scaler across an overflow);
then the int8 frozen base and int8 serving weights (the dequantization on
the card, the graphed int8 step equal to the eager one and under ZeRO-3
and offload, its peak, each block's expanded weights freed inside the
train and decode graphs, a decode window that never syncs the host); then
multi-LoRA serving (the decode and spec graphs over a mixed batch of base
and adapter rows equal to the eager iterations, the pool's addresses fixed
across loads, a row load that never syncs the host); then Mixtral's routed
experts at full width on an int8 base (the graphed step equal to the eager
one with K1-K3 at GQA 32/8, each layer's expanded experts freed inside the
step's graph, the decode graph equal to eager decode with K4 once a layer,
a decode window that never syncs the host); then sequence and pipeline
parallelism over NCCL across four cards (graphed steps against one card's;
skipped with fewer cards); then the replica fleet (two replicas on one card
failing over and migrating KV with K4/K4q, the serve CLI's fleet behind the
gateway over HTTP, and one replica a card on two to four cards, skipped
with fewer).

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false, as on a CPU-only host. On a machine with the card and without JAX,
run this file alone, without the suite's JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``. K4: 1e-5 for float32 (sums in another
order); 2**-6 for bfloat16 and 2**-9 for float16 (both versions round an
fp32 result below |x| = 4 to the output's type, at most one step of it
apart: float16 keeps 3 more bits than bf16). Flash: see ``FLASH_TOL``.
"""

import pytest
import torch

from dlti_tpu_torch.ops import flash_attention as tfa
from dlti_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -9}
# One step of the output's type relative to each batch row's largest |out|.
ROW_REL_TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
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


@pytest.mark.parametrize("q_dtype,pool_dtype", [
    (torch.float16, torch.bfloat16), (torch.bfloat16, torch.float16),
    (torch.float32, torch.float16), (torch.float16, torch.float32)])
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_takes_a_query_of_another_dtype_than_the_pool(gen, q_dtype, pool_dtype, d):
    """The engine pairs the model's dtype (q) with ``cache_dtype`` (the
    pool) freely: the output is in q's dtype, within q's tolerance."""
    q, k, v, tables, lens = _inputs(gen, 5, 8, 2, d, pool_dtype, lens=[0, 1, 17, 100, 128])
    q = q.to(q_dtype)
    out = tpa.paged_decode_attention(q, k, v, tables, lens)
    ref = tpa.paged_decode_attention_reference(q, k, v, tables, lens)
    assert out.dtype == q_dtype and not out[0].any()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[q_dtype], rtol=0)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
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
    queries (float16 on a float16 pool): absolute ``TOL``, and one step of
    the type relative to each row's largest |out|."""
    make = _int8_inputs if pool == "int8" else _inputs
    dtype = {"float32": torch.float32, "float16": torch.float16}.get(pool, torch.bfloat16)
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
    if dtype in ROW_REL_TOL:
        err = (out.float() - ref.float()).abs().flatten(1).amax(1)
        top = ref.float().abs().flatten(1).amax(1)
        assert (err <= ROW_REL_TOL[dtype] * top).all(), (err, top)
    for row, n in enumerate(lens):
        if n == 0:
            assert not out[row].any()


@pytest.mark.parametrize("pool", ["bfloat16", "float16", "float32", "int8"])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("heads,kv_heads", [(32, 8), (8, 1)])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_split_k_one_row_at_a_split_boundary(gen, pool, d, heads, kv_heads, delta):
    splits, chunk = _plan(1, heads, kv_heads, 256 * 16)
    assert splits > 1
    _check_pool(gen, pool, 1, heads, kv_heads, d, [chunk + delta], max_blocks=256)


@pytest.mark.parametrize("pool", ["bfloat16", "float16", "float32", "int8"])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("heads,kv_heads", [(32, 8), (8, 1)])
def test_split_k_batch_of_eight_across_splits(gen, pool, d, heads, kv_heads):
    splits, chunk = _plan(8, heads, kv_heads, 256 * 16)
    assert splits > 1
    lens = [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, 4095, 4096]
    _check_pool(gen, pool, 8, heads, kv_heads, d, lens, max_blocks=256)


@pytest.mark.parametrize("pool", ["bfloat16", "float16", "float32", "int8"])
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


def test_memory_ledger_reads_the_allocator_and_sums_exactly(gen):
    """On the card the ledger reads the caching allocator and the driver:
    its buckets sum to bytes in use exactly, the capacity is the card's,
    and a balloon's bytes leave the headroom and come back."""
    from dlti_tpu_torch.telemetry.memledger import MemoryBalloon, MemoryLedger

    led = MemoryLedger(device="cuda")
    held = torch.zeros(1 << 20, device="cuda")
    led.register("params", held)
    snap = led.snapshot()
    assert sum(snap["buckets"].values()) == snap["bytes_in_use"]
    assert snap["source"] == "device"
    # NVML's total: the whole card, the driver's reserve included.
    assert snap["capacity_bytes"] >= torch.cuda.mem_get_info(0)[1]
    assert snap["owners"]["params"]["bytes"] == 4 << 20
    assert snap["bytes_in_use"] >= torch.cuda.memory_allocated() >= 4 << 20
    balloon = MemoryBalloon(led)
    before = led.headroom_bytes()
    balloon.inflate(64 << 20)
    assert before - led.headroom_bytes() >= (64 << 20) - (2 << 20)
    balloon.deflate()
    assert abs(led.headroom_bytes() - before) <= 2 << 20


def test_engine_ledger_owners_are_their_tensors_bytes_on_the_card(gen):
    """A CUDA engine's ledger: params and the int8 pool as counted from
    their shapes, and the sum exact."""
    from dlti_tpu_torch.config import MODEL_PRESETS
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams

    cfg = MODEL_PRESETS["llama_tiny"]
    engine = InferenceEngine(cfg, init_params(cfg, seed=0, device="cuda"),
                             EngineConfig(max_seqs=2, block_size=16, num_blocks=32,
                                          max_model_len=128, cache_dtype="int8",
                                          eos_token_id=-1, admit_min_headroom_frac=0.01),
                             device="cuda")
    engine.generate([[1, 2, 3]], SamplingParams(max_tokens=3, temperature=0.0))
    snap = engine.memledger.to_dict(top_k=2)
    assert sum(snap["buckets"].values()) == snap["bytes_in_use"]
    assert snap["owners"]["params"]["bytes"] == sum(
        p.numel() * p.element_size() for p in engine.model.parameters())
    assert snap["owners"]["kv_block_pool"]["bytes"] == sum(
        t.numel() * t.element_size() for layer in engine.cache for t in layer.values())
    assert len(snap["top_untracked_tensors"]) == 2
    assert engine.stats["hbm_deferred_admissions"] == 0


def test_debug_profile_records_the_decode_kernels_of_a_live_server(gen, tmp_path):
    """``POST /debug/profile`` from a handler thread while the stepper
    replays the decode graph: the capture's Chrome trace holds the paged
    decode kernel's launches; a second POST meanwhile gets 409."""
    import http.client
    import json
    import threading
    import time

    from dlti_tpu_torch.config import MODEL_PRESETS, TelemetryConfig
    from dlti_tpu_torch.data import ByteTokenizer
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, ServerConfig, make_server

    cfg = MODEL_PRESETS["llama_tiny"]
    engine = InferenceEngine(cfg, init_params(cfg, seed=0, device="cuda"),
                             EngineConfig(max_seqs=4, block_size=16, num_blocks=64,
                                          max_model_len=256, cache_dtype="int8",
                                          eos_token_id=-1, steps_per_sync=8), device="cuda")
    engine.warmup_decode_ladder()
    httpd, aeng = make_server(engine, ByteTokenizer(), ServerConfig(
        host="127.0.0.1", port=0, telemetry=TelemetryConfig(trace_dir=str(tmp_path))))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    stop = threading.Event()

    def post(path, body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = (resp.status, resp.read())
        conn.close()
        return out

    def traffic():
        while not stop.is_set():
            post("/v1/completions", {"prompt": "profile me", "max_tokens": 200,
                                     "temperature": 0.0})

    workers = [threading.Thread(target=traffic) for _ in range(3)]
    for w in workers:
        w.start()
    try:
        time.sleep(1.0)
        first = {}
        capture = threading.Thread(target=lambda: first.update(r=post(
            "/debug/profile", {"seconds": 1.5})))
        capture.start()
        time.sleep(0.5)
        second = post("/debug/profile", {"seconds": 1})
        capture.join(timeout=120)
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=120)
        httpd.shutdown()
        aeng.shutdown()
        httpd.server_close()
    assert second[0] == 409
    status, data = first["r"]
    assert status == 200, data
    with open(json.loads(data)["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert sum("paged_decode_kernel" in k for k in kernels) > 0, len(kernels)


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
# float16 keeps 3 more bits: rtol 2**-10, 8x tighter; atol stays 1e-3, since
# near zero it covers the float32 sums' order (a GQA 64/1 dk or dv at s 1000
# sums 64,000 products), which does not depend on the output's type.
FLASH_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
             torch.bfloat16: dict(atol=1e-3, rtol=2.0 ** -7),
             torch.float16: dict(atol=1e-3, rtol=2.0 ** -10)}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
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


WGMMA_KERNELS = {"flash_fwd": "flash_fwd_wgmma_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_wgmma_kernel"}


def _flash_launches(gen, dtype, d):
    """A forward and backward at (1, 256, 8/2, d) that checks, after each
    call, the kernel each entry point launched as the library reports it
    (``last_kernel``); returns the call and what it launched."""
    q, k, v, do, _ = _flash_case(gen, 1, 256, 8, 2, d, dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    tfa.last_kernel.clear()

    def run():
        tfa.flash_attention(q, k, v).backward(do)
        return dict(tfa.last_kernel)

    return run


# The profile of _profiled_kernel_names, in a process of its own: after the
# file's earlier tests CUPTI has dropped the profiled region's first kernel
# records in the test process (F3; in every whole-file run on some
# machines), never in a fresh one.
_PROFILE_SCRIPT = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from dlti_tpu_torch.ops import flash_attention as tfa

dtype, d = getattr(torch, sys.argv[1]), int(sys.argv[2])
gen = torch.Generator(device="cuda").manual_seed(0)
q, do = (torch.randn(1, 256, 8, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
k, v = (torch.randn(1, 256, 2, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
q, k, v = (t.requires_grad_() for t in (q, k, v))

def run():
    tfa.flash_attention(q, k, v).backward(do)
    return dict(tfa.last_kernel)

launched = run()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    run()
    torch.cuda.synchronize()
print(json.dumps({"launched": launched, "names": sorted({e.key for e in prof.key_averages()})}))
"""


def _profiled_kernel_names(dtype, d) -> list:
    """The kernel names the profiler records for ``_flash_launches``' call at
    ``dtype`` and head_dim ``d`` (a forward and backward at (1, 256, 8/2,
    d)), in a fresh process on this card. One warm-up call runs outside the
    profiled region first, so neither the kernels' first loading nor
    CUPTI's first records fall inside it; it must launch ``WGMMA_KERNELS``.
    The full list is printed (pytest shows it when an assertion on it
    fails)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _PROFILE_SCRIPT, str(dtype).split(".")[1],
                          str(d)], cwd=root, env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["launched"] == WGMMA_KERNELS, got["launched"]
    print("profiled kernel names:", *got["names"], sep="\n  ")
    return got["names"]


def test_bf16_flash_reaches_the_tensor_core_kernels(gen):
    """bf16 K1, K2 and K3 (d 64/128) name the wgmma program, launch the
    wgmma kernels (the library's report, after every call) and the profiler
    sees them; float32 and K3 at d 256 keep the CUDA cores."""
    wgmma = "wgmma bf16 hi/lo, cp.async 2-stage"
    for d in (64, 128, 256):
        assert tfa.kernel_design("flash_fwd", torch.bfloat16, d) == wgmma
        assert tfa.kernel_design("flash_bwd_dkv", torch.bfloat16, d) == (
            wgmma if d <= 128 else "cuda-core fp32")
        assert tfa.kernel_design("flash_bwd_dq", torch.bfloat16, d) == wgmma
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert tfa.kernel_design(name, torch.float32, d) == "cuda-core fp32"
    assert _flash_launches(gen, torch.bfloat16, 256)() == {
        **WGMMA_KERNELS, "flash_bwd_dkv": "flash_bwd_dkv_kernel"}
    assert _flash_launches(gen, torch.float32, 128)() == {
        "flash_fwd": "flash_fwd_kernel", "flash_bwd_dq": "flash_bwd_dq_kernel",
        "flash_bwd_dkv": "flash_bwd_dkv_kernel"}
    run = _flash_launches(gen, torch.bfloat16, 128)
    for _ in range(2):
        assert run() == WGMMA_KERNELS
    names = _profiled_kernel_names(torch.bfloat16, 128)
    assert any("flash_fwd_wgmma_kernel" in n for n in names), names
    assert any("flash_bwd_dkv_wgmma_kernel" in n for n in names), names
    assert any("flash_bwd_dq_wgmma_kernel" in n for n in names), names
    assert not any("flash_fwd_kernel" in n or "flash_bwd_dq_kernel" in n
                   for n in names), names


# float16 runs the 2-byte tensor-core programs too: the tile edges, masks
# and GQA packing of the bf16 cases above.
@pytest.mark.parametrize("s", [1, 65, 1000])
@pytest.mark.parametrize("h,hkv", [(32, 32), (8, 1), (64, 1)])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_f16_flash_kernels_at_tile_edges(gen, s, h, hkv, d):
    _check_flash(*_flash_case(gen, 1, s, h, hkv, d, torch.float16))


@pytest.mark.parametrize("variant", ["noncausal", "window40", "segments_padded_row"])
@pytest.mark.parametrize("d", [64, 256])
def test_f16_flash_kernels_masks(gen, variant, d):
    _check_flash(*_flash_case(gen, 2, 1000, 8, 2, d, torch.float16,
                              causal=variant != "noncausal",
                              window=40 if variant == "window40" else None,
                              segments="padded_row" if "segments" in variant else False))


# dO of a gradient of 2**-4 under the default loss scale 2**16, v at 2**5 and
# q, k at 2**-4 (near-uniform p): rows of ds pass float16's 65504 while dq,
# dk and dv stay within it (the plain version read |ds| up to 1.04e5, dq
# 2.2e4 at b 2, s 512, h 8). Compared in units of dO's scale (dividing both
# by 2**12 is exact), where the float16 limits apply as at unit scale.
DS_CASE_SCALES = dict(do=2.0 ** 12, v=2.0 ** 5, qk=2.0 ** -4)


def _ds_case(gen, b=2, s=512, h=8, hkv=8, d=128):
    dev = torch.device("cuda")
    sc = DS_CASE_SCALES
    q = (torch.randn(b, s, h, d, device=dev, generator=gen) * sc["qk"]).half()
    k = (torch.randn(b, s, hkv, d, device=dev, generator=gen) * sc["qk"]).half()
    v = (torch.randn(b, s, hkv, d, device=dev, generator=gen) * sc["v"]).half()
    do = (torch.randn(b, s, h, d, device=dev, generator=gen) * sc["do"]).half()
    return q, k, v, do


def _max_abs_ds(q, k, v, do, o, lse):
    """max |ds| of the plain version's float32 backward (causal)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, s, hkv, h // hkv, d)
    sc = torch.einsum("bqngd,bknd->bngqk", qg, k.float()) * d ** -0.5
    allowed = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.where(allowed, torch.exp(sc - lse.reshape(b, hkv, h // hkv, s, 1)), 0.0)
    dp = torch.einsum("bqngd,bknd->bngqk", do.float().reshape(b, s, hkv, h // hkv, d),
                      v.float())
    delta = tfa.backward_delta(o, do).reshape(b, hkv, h // hkv, s, 1)
    return (p * (dp - delta) * d ** -0.5).abs().max().item()


@pytest.mark.parametrize("hkv", [8, 2])
def test_f16_flash_backward_rescales_ds_past_float16_range(gen, hkv):
    """|ds| above 65504 is no overflow: K2 and K3 bring each accumulator
    row's ds into range by a power of two before the float16 split, so dq,
    dk and dv are the plain version's finite values."""
    q, k, v, do = _ds_case(gen, hkv=hkv)
    o, lse = tfa.flash_fwd(q, k, v)
    dq, dk, dv = tfa.flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert _max_abs_ds(q, k, v, do, o, lse) > 65504
    rdq, rdk, rdv = tfa.flash_attention_backward_reference(q, k, v, o, lse, do)
    unit = DS_CASE_SCALES["do"]
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert torch.isfinite(want).all() and torch.isfinite(got).all()
        torch.testing.assert_close(got.float() / unit, want.float() / unit,
                                   **FLASH_TOL[torch.float16])


def test_f16_flash_reaches_the_tensor_core_kernels(gen):
    """float16 K1, K2 and K3 (d 64/128) name the float16 wgmma program,
    launch the wgmma kernels (the library's report, after every call), and
    the profiler sees their kernels in a forward and backward."""
    wgmma = "wgmma f16 hi/lo, power-of-2 scaled, cp.async 2-stage"
    for d in (64, 128, 256):
        assert tfa.kernel_design("flash_fwd", torch.float16, d) == wgmma
        assert tfa.kernel_design("flash_bwd_dq", torch.float16, d) == wgmma
        assert tfa.kernel_design("flash_bwd_dkv", torch.float16, d) == (
            wgmma if d <= 128 else "cuda-core fp32")
    run = _flash_launches(gen, torch.float16, 128)
    for _ in range(2):
        assert run() == WGMMA_KERNELS
    names = _profiled_kernel_names(torch.float16, 128)
    for kernel in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                   "flash_bwd_dkv_wgmma_kernel"):
        assert any(kernel in n and "half" in n for n in names), names


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
        tfa.flash_fwd(q.double(), k.double(), v.double())
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


def _check_half_head(gen, dtype, name):
    """The head of a ``dtype`` (bf16 or float16) model multiplies ``dtype``
    operands on the card (``aten::mm`` with an out_dtype, ``name`` inputs
    in the profile) and returns float32 logits equal to the float32 product
    up to summation order; its gradient with respect to x is the float32
    product's."""
    from torch.profiler import ProfilerActivity, profile

    from dlti_tpu_torch.models.llama import lm_head_logits

    x = torch.randn(8, 1, 256, device="cuda", generator=gen).to(dtype)
    w = (0.05 * torch.randn(256, 512, device="cuda", generator=gen)).to(dtype)
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
        assert name in str(dtypes[0]) and name in str(dtypes[1]), dtypes

    xg = x.clone().requires_grad_()
    xf = x.clone().requires_grad_()
    g = torch.randn(8, 1, 512, device="cuda", generator=gen)
    lm_head_logits(xg, w).backward(g)
    (xf.float() @ w.float()).backward(g)
    assert xg.grad.dtype == dtype
    torch.testing.assert_close(xg.grad, xf.grad, atol=0, rtol=0)


def test_lm_head_runs_a_bf16_gemm_with_float32_output(gen):
    _check_half_head(gen, torch.bfloat16, "BFloat16")


def test_lm_head_runs_a_float16_gemm_with_float32_output(gen):
    """``torch.mm(..., out_dtype=torch.float32)`` takes float16 operands
    too: the fp16 model's head (the reference's preferred_element_type)."""
    _check_half_head(gen, torch.float16, "Half")


# ----------------------------------------------------------------------
# Checkpoints of a train state on the card
# ----------------------------------------------------------------------

def _card_train_state(preset, layers=None, lora_r=16, fp16_initial_scale=None):
    """``fp16_initial_scale``: a float16 model (compute and base) under the
    loss scaler, as ``cli.train --fp16`` builds it."""
    import dataclasses

    from dlti_tpu_torch.config import MODEL_PRESETS, LoRAConfig, OptimizerConfig
    from dlti_tpu_torch.models import init_params, load_model
    from dlti_tpu_torch.training import build_optimizer, create_train_state

    cfg = MODEL_PRESETS[preset]
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if fp16_initial_scale is not None:
        cfg = dataclasses.replace(cfg, dtype="float16", param_dtype="float16")
    lora = LoRAConfig(r=lora_r, alpha=2 * lora_r)
    params = init_params(cfg, seed=0, device="cuda", lora=lora)
    model = load_model(cfg, params, "cuda", lora=lora, trainable_lora=True)
    return create_train_state(model, build_optimizer(OptimizerConfig(warmup_steps=1)),
                              fp16_initial_scale=fp16_initial_scale)


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
    from dlti_tpu_torch.training.step import METRICS
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
    assert rows.shape == (3, len(METRICS)) and state.step == 4 and window.captures == 1
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


# ----------------------------------------------------------------------
# The fp16 path: the step under the dynamic loss scaler as a CUDA graph
# ----------------------------------------------------------------------

def _fp16_window_case(gen, graphs):
    """``_window_case`` in float16 under the loss scaler from 2**10, with a
    scale window of 2 (the scale doubles after two good steps)."""
    from dlti_tpu_torch.training import StepWindow

    state = _card_train_state("llama_300m", layers=2, fp16_initial_scale=2.0 ** 10)
    assert state.model.model.embed_tokens.dtype == torch.float16
    window = StepWindow(state.model, accum_steps=2, seed=43, capacity=4,
                        cuda_graphs=graphs, fp16_scale_window=2)
    return state, window


def _fp16_batches(poison=2, seed=3):
    """Four host batches with float loss masks; batch ``poison`` has a NaN in
    its mask, so its gradient norm is not finite: an overflow."""
    import numpy as np

    out = []
    for i, b in enumerate(_host_batches(4, seed=seed)):
        b = dict(b, loss_mask=b["loss_mask"].astype(np.float32))
        if i == poison:
            b["loss_mask"][0, 0, 5] = np.nan
        out.append(b)
    return out


def test_graphed_fp16_steps_equal_eager_across_an_overflow(gen):
    """Four fp16 steps (two windows of 2), the third overflowing, through
    the captured step and the eager step from the same state: equal
    metrics, LoRA factors, moments and scaler tensors, bit for bit; the
    scale doubled after two good steps and the hysteresis absorbed the
    overflow (the scale read from its tensor on every replay)."""
    import numpy as np

    from dlti_tpu_torch.training.step import METRICS
    from dlti_tpu_torch.utils.device import to_host

    batches = _fp16_batches()
    runs = []
    for graphs in (False, True):
        state, window = _fp16_window_case(gen, graphs)
        rows = [to_host(window.run(state, batches[i:i + 2], i + 1))[0] for i in (0, 2)]
        assert (window.graph is not None) == graphs and state.step == 4
        runs.append((rows, [t.clone() for t in state.trainable().values()],
                     [t.clone() for t in state.opt_state.mu.values()],
                     {k: t.clone() for k, t in state.scaler.items()}))
        window.release()
    (eager, pe, me, se), (graphed, pg, mg, sg) = runs
    for a, b in zip(eager, graphed):  # the overflowing step's loss is NaN in both
        assert np.array_equal(a, b, equal_nan=True), (a, b)
    assert all(torch.equal(a, b) for a, b in zip(pe + me, pg + mg))
    assert all(torch.equal(se[k], sg[k]) for k in se)
    rows = torch.cat([torch.as_tensor(r) for r in graphed])
    col = {name: rows[:, i].tolist() for i, name in enumerate(METRICS)}
    assert col["overflow"] == col["skipped_update"] == [0.0, 0.0, 1.0, 0.0]
    assert col["loss_scale"] == [1024.0, 2048.0, 2048.0, 2048.0]
    assert (int(sg["good_steps"]), int(sg["hysteresis_left"])) == (1, 1)


def test_fp16_train_window_replays_never_sync_the_host(gen):
    """``set_sync_debug_mode("error")`` around a captured fp16 window of 3
    steps, one of them overflowing: the scaler's update waits on nothing."""
    from dlti_tpu_torch.utils.device import to_host

    state, window = _fp16_window_case(gen, True)
    batches = _fp16_batches(poison=2, seed=4)
    to_host(window.run(state, batches[:1], 1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = window.run(state, batches[1:], 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rows = to_host(out)[0]
    assert state.step == 4 and window.captures == 1
    assert rows[:, -1].tolist() == [0.0, 1.0, 0.0]  # overflow



# ----------------------------------------------------------------------
# ZeRO on one card: a NCCL group of one, the step as a CUDA graph
# ----------------------------------------------------------------------

@pytest.fixture
def nccl_group(gen):
    """A NCCL process group of one on the current card, destroyed after the
    test (so later tests run without one)."""
    import socket

    import torch.distributed as dist

    if not dist.is_initialized():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
    yield
    dist.destroy_process_group()


def _zero_window_case(stage, graphs, offload=False, layers=2, fp16_initial_scale=None,
                      tensor_group=False):
    """``_window_case``'s model and dropout under ``stage`` in the group of
    one (both host offloads with ``offload``), its window over the layout;
    with ``fp16_initial_scale``, ``_fp16_window_case``'s float16 model and
    scaler; with ``tensor_group``, on the tensor-parallel path (a tensor
    group of one)."""
    from dlti_tpu_torch.config import OptimizerConfig, ParallelConfig, ZeROStage
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.parallel.sharding import shard_model
    from dlti_tpu_torch.training import StepWindow, build_optimizer, create_train_state

    state = _card_train_state("llama_300m", layers=layers,
                              fp16_initial_scale=fp16_initial_scale)
    par = ParallelConfig(zero_stage=ZeROStage(stage), offload_optimizer=offload,
                         offload_params=offload)
    mesh = build_mesh(par, torch.device("cuda", torch.cuda.current_device()),
                      tensor_group=tensor_group)
    if tensor_group:  # at extent 1 a rank's parts are the whole leaves
        state.model.set_tensor_axis(mesh.tensor)
    layout = shard_model(state.model, mesh, True)
    state = create_train_state(state.model, build_optimizer(OptimizerConfig(warmup_steps=1)),
                               fp16_initial_scale=fp16_initial_scale, layout=layout)
    fp16 = {"fp16_scale_window": 2} if fp16_initial_scale is not None else {}
    window = StepWindow(state.model, accum_steps=2, seed=43, capacity=4,
                        cuda_graphs=graphs, **fp16)
    return state, window


def _run_windows(state, window, batches):
    from dlti_tpu_torch.utils.device import to_host

    rows = [to_host(window.run(state, batches[i:i + 2], i + 1))[0] for i in (0, 2)]
    out = (rows, [t.detach().clone() for t in state.trainable().values()],
           [t.clone() for t in state.opt_state.mu.values()])
    window.release()
    return out


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_graphed_steps_in_a_nccl_group_of_one_equal_the_plain_step(gen, nccl_group, stage):
    """Four steps (two windows of 2, dropout on) of each strategy with its
    collectives inside the captured step, in a NCCL group of one, against
    the plain single-device graphed step: bit-equal metrics, LoRA factors
    and moments (at a world of 1 every collective is a copy), and K1-K3
    launched as many times."""
    batches = _host_batches(4, seed=5)
    state, window = _window_case(gen, True)
    tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
    plain = _run_windows(state, window, batches)
    plain_counts = (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches)
    del state, window
    state, window = _zero_window_case(stage, True)
    assert state.layout.mesh.distributed and window.cuda_graphs
    tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
    zero = _run_windows(state, window, batches)
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches) == plain_counts
    for a, b in zip(plain[0], zero[0]):
        assert (a == b).all(), (stage, a, b)
    assert all(torch.equal(a, b.to(a.device)) for a, b in zip(plain[1] + plain[2],
                                                              zero[1] + zero[2]))


def test_offloaded_leaves_are_pinned_and_the_graphed_step_equals_the_plain_one(
        gen, nccl_group):
    """ZeRO-3 with both offloads: every frozen leaf and every moment is a
    pinned host tensor (a pageable one would copy synchronously and could
    not be captured), the base is streamed into the captured step, and
    four steps are bit-equal to the plain graphed step's."""
    batches = _host_batches(4, seed=6)
    state, window = _window_case(gen, True)
    plain = _run_windows(state, window, batches)
    del state, window
    state, window = _zero_window_case(3, True, offload=True)
    frozen = [p for n, p in state.model.named_parameters()
              if not n.endswith(("lora_a", "lora_b"))]
    moments = [*state.opt_state.mu.values(), *state.opt_state.nu.values()]
    assert frozen and all(t.device.type == "cpu" and t.is_pinned() for t in frozen + moments)
    assert all(p.is_cuda for n, p in state.model.named_parameters()
               if n.endswith(("lora_a", "lora_b")))
    zero = _run_windows(state, window, batches)
    for a, b in zip(plain[0], zero[0]):
        assert (a == b).all(), (a, b)
    assert all(torch.equal(a, b.to(a.device)) for a, b in zip(plain[1] + plain[2],
                                                              zero[1] + zero[2]))


def test_zero_train_window_replays_never_sync_the_host(gen, nccl_group):
    """``set_sync_debug_mode("error")`` around a captured ZeRO-3 window of 3
    steps with both offloads: the collectives and the host copies of the
    base and the moments run inside the replays and wait on nothing."""
    from dlti_tpu_torch.utils.device import to_host

    state, window = _zero_window_case(3, True, offload=True)
    batches = _host_batches(4, seed=7)
    to_host(window.run(state, batches[:1], 1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = window.run(state, batches[1:], 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rows = to_host(out)[0]
    assert state.step == 4 and window.captures == 1
    assert all(abs(x) < float("inf") for x in rows[:, 0])


def test_offloaded_base_is_its_own_checkpoint_host_copy(gen, nccl_group, tmp_path):
    """Under ``offload_params`` the frozen base already rests in pinned host
    memory: a save's host cache keeps those very tensors (no second host
    copy of the base), the checkpoint verifies, and a restore into another
    offloaded state gives the same leaves."""
    from dlti_tpu_torch.checkpoint import store
    from dlti_tpu_torch.training.state import frozen_param_keys, load_state_leaves, state_leaves

    state, window = _zero_window_case(3, False, offload=True)
    cache = store.HostCache(frozen_param_keys(state))
    leaves = state_leaves(state)
    store.save_train_state(str(tmp_path), 0, leaves, async_save=False, cache=cache)
    frozen = dict(leaves)
    for name in cache.names:
        entry = cache.lookup(name, frozen[name])
        assert entry is not None and entry.host.data_ptr() == frozen[name].data_ptr(), name
    assert store.verify_checkpoint(str(tmp_path), 0) == (True, "ok")
    other, _ = _zero_window_case(3, False, offload=True)
    restored = store.restore_train_state(str(tmp_path), 0, state_leaves(other))
    load_state_leaves(other, restored)
    for (n, a), (_, b) in zip(state_leaves(state), state_leaves(other)):
        assert torch.equal(a.cpu(), b.cpu()), n


def test_an_offloaded_export_merges_the_base_on_the_host(gen, nccl_group, tmp_path):
    """Under ``offload_params`` the export merges each base kernel where it
    rests, in pinned host memory: the card's memory does not grow by the
    base while the export runs, and the merged weights equal those of the
    same state held on the card."""
    import dataclasses

    from dlti_tpu_torch.checkpoint import export_merged_model, manifest_digest
    from dlti_tpu_torch.config import MODEL_PRESETS, CheckpointConfig, Config, LoRAConfig
    from dlti_tpu_torch.training import whole_params

    plain = _card_train_state("llama_300m", layers=2)
    offloaded, _ = _zero_window_case(3, False, offload=True)
    with torch.no_grad():
        for st in (plain, offloaded):  # nonzero factors, the same in both
            for n, p in st.model.named_parameters():
                if n.endswith("lora_b"):
                    p.copy_(torch.linspace(-0.1, 0.1, p.numel()).reshape(p.shape))
    cfg = Config(model=dataclasses.replace(MODEL_PRESETS["llama_300m"], num_layers=2),
                 lora=LoRAConfig(r=16, alpha=32),
                 checkpoint=CheckpointConfig(save_strategy="no"))
    export_merged_model(str(tmp_path / "plain"), whole_params(plain), cfg)
    base = sum(p.numel() * p.element_size() for p in offloaded.model.parameters()
               if not p.is_cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    params = whole_params(offloaded)
    assert all(p.is_pinned() for n, p in params.items() if not n.endswith(("lora_a", "lora_b")))
    export_merged_model(str(tmp_path / "offloaded"), params, cfg)
    assert torch.cuda.max_memory_allocated() - before < base / 4
    assert (manifest_digest(str(tmp_path / "offloaded" / "model"))
            == manifest_digest(str(tmp_path / "plain" / "model")))


@pytest.mark.parametrize("stage", [1, 3])
def test_zero_fp16_graphed_steps_across_an_overflow_equal_the_plain_step(
        gen, nccl_group, stage):
    """``_fp16_window_case``'s four float16 steps, the third overflowing,
    under ZeRO in the group of one: the scaler decides on the global norm
    inside the graph, and metrics, LoRA factors, moments and scaler equal
    the plain graphed step's bit for bit."""
    import numpy as np

    batches = _fp16_batches(seed=8)
    runs = []
    for build in (lambda: _fp16_window_case(gen, True),
                  lambda: _zero_window_case(stage, True, fp16_initial_scale=2.0 ** 10)):
        state, window = build()
        rows, params, moments = _run_windows(state, window, batches)
        runs.append((rows, params, moments, {k: t.clone() for k, t in state.scaler.items()}))
        del state, window
    (plain, pp, mp, sp), (zero, pz, mz, sz) = runs
    for a, b in zip(plain, zero):
        assert np.array_equal(a, b, equal_nan=True), (a, b)
    assert all(torch.equal(a, b) for a, b in zip(pp + mp, pz + mz))
    assert all(torch.equal(sp[k], sz[k]) for k in sp)
    assert [r[-1] for r in np.concatenate(zero)] == [0.0, 0.0, 1.0, 0.0]  # overflow


# ----------------------------------------------------------------------
# The int8 frozen base and int8 serving weights
# ----------------------------------------------------------------------

def test_dequantize_on_the_card_is_bit_equal_to_the_two_step_form(gen):
    """``models.quantization.dequantize`` (one ``torch.mul`` into a bf16 or
    float16 output) rounds the float32 product once, as
    ``(q.float() * scale).to(dtype)`` does, on the card too."""
    from dlti_tpu_torch.models.quantization import dequantize, quantize_int8

    w = torch.randn(4096, 1024, generator=gen, device="cuda") * 0.03
    q, scale = quantize_int8(w)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        got = dequantize(q, scale, dtype)
        want = (q.float() * scale).to(dtype)
        assert got.dtype == dtype and torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _int8_train_state(layers=8, quantized=True, parallel=None):
    """llama_300m (head_dim 64) cut to ``layers``, LoRA r=16 (dropout 0.05),
    remat off, with the base int8 (``quantized``) or bf16; under
    ``parallel`` placed by its strategy (a process group must exist)."""
    import dataclasses

    from dlti_tpu_torch.config import MODEL_PRESETS, LoRAConfig, OptimizerConfig
    from dlti_tpu_torch.models import init_params, load_model
    from dlti_tpu_torch.models.quantization import quantize_params_int8
    from dlti_tpu_torch.training import build_optimizer, create_train_state

    cfg = dataclasses.replace(MODEL_PRESETS["llama_300m"], num_layers=layers, remat=False)
    lora = LoRAConfig(r=16, alpha=32)
    params = init_params(cfg, seed=0, device="cuda", lora=lora)
    if quantized:
        params = quantize_params_int8(params, donate=True)
    model = load_model(cfg, params, "cuda", lora=lora, trainable_lora=True)
    del params
    layout = None
    if parallel is not None:
        from dlti_tpu_torch.parallel.mesh import build_mesh
        from dlti_tpu_torch.parallel.sharding import shard_model

        mesh = build_mesh(parallel, torch.device("cuda", torch.cuda.current_device()))
        layout = shard_model(model, mesh, True)
    return create_train_state(model, build_optimizer(OptimizerConfig(warmup_steps=1)),
                              layout=layout)


def _int8_run(state, graphs, batches):
    from dlti_tpu_torch.training import StepWindow

    window = StepWindow(state.model, accum_steps=2, seed=43, capacity=4, cuda_graphs=graphs)
    return _run_windows(state, window, batches)


def _frozen_bytes(model, dtype_bytes=None):
    """The bytes of the quantized kernels (``dtype_bytes`` per element when
    given: their expanded size) of the first block, and of the head."""
    from dlti_tpu_torch.models.quantization import QuantizedWeight

    block = sum(m.kernel.q.numel() for m in model.model.layers[0].modules()
                if isinstance(getattr(m, "kernel", None), QuantizedWeight))
    return block * dtype_bytes, model.lm_head.q.numel() * dtype_bytes


def test_graphed_int8_base_steps_equal_eager(gen):
    """Four steps (two windows of 2, dropout on, no remat) of an int8 base
    through the captured step and eagerly on the card: bit-equal metrics,
    LoRA factors and moments, and the int8 leaves untouched."""
    batches = _host_batches(4, seed=11)
    runs = []
    for graphs in (False, True):
        state = _int8_train_state(layers=2)
        before = {n: p.clone() for n, p in state.model.named_parameters()
                  if p.dtype == torch.int8}
        runs.append(_int8_run(state, graphs, batches))
        assert before and all(torch.equal(p, before[n]) for n, p
                              in state.model.named_parameters() if n in before)
        del state
    (eager, pe, me), (graphed, pg, mg) = runs
    for a, b in zip(eager, graphed):
        assert (a == b).all(), (a, b)
    assert all(torch.equal(a, b) for a, b in zip(pe + me, pg + mg))


def _step_memory(quantized, layers=8):
    """(bytes the state adds to the card, peak bytes above it during the
    graph's capture and two replays, and for an int8 base the expanded
    bytes of a block's kernels and of the head) of the no-remat step; the
    state is gone on return."""
    import gc

    gc.collect()
    # cuBLAS keeps a workspace (32 MiB on Hopper) for each stream it ran on,
    # from the caching allocator; the capture's streams come from a pool the
    # file's earlier tests have cycled, so without this one run of the pair
    # could reuse a workspace the other allocates inside its window.
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    state = _int8_train_state(layers=layers, quantized=quantized)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _int8_run(state, True, _host_batches(4, seed=12))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    frozen = _frozen_bytes(state.model, 2) if quantized else None
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return resident - before, peak - resident, frozen


def test_int8_step_peaks_below_the_bf16_step_and_frees_each_layers_weights(gen):
    """The same no-remat step on an 8-block model, graphed: the int8 base's
    peak is below the bf16 base's, and above its smaller resident state the
    int8 step holds at most two blocks' expanded kernels and the expanded
    head more than the bf16 step does: each block's weights are expanded at
    use and freed within the graph's pool, never all blocks at once (which
    would be 8 blocks' worth)."""
    res_bf16, transient_bf16, _ = _step_memory(False)
    res_int8, transient_int8, (block, head) = _step_memory(True)
    assert res_int8 + transient_int8 < res_bf16 + transient_bf16
    assert res_bf16 - res_int8 > 4 * block  # 8 blocks at one byte an element less
    assert transient_int8 - transient_bf16 < 2 * block + head, (
        transient_int8 - transient_bf16, block, head)


def _int8_engine(quantization="int8", k=8, graphs=True):
    """llama_300m cut to 8 blocks (head_dim 64), bf16, int8 weights (or
    not), a bf16 pool; ``graphs=False`` runs the decode iteration eagerly."""
    import dataclasses

    from dlti_tpu_torch.config import MODEL_PRESETS
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine
    from dlti_tpu_torch.serving.engine import EngineExecutor

    cfg = dataclasses.replace(MODEL_PRESETS["llama_300m"], num_layers=8)
    params = init_params(cfg, seed=0, device="cuda")
    ec = EngineConfig(max_seqs=4, block_size=16, num_blocks=64, max_model_len=128,
                      cache_dtype="bfloat16", eos_token_id=-1, steps_per_sync=k,
                      quantization=quantization)
    ex = EngineExecutor(cfg, params, ec, device="cuda", cuda_graphs=graphs,
                        donate_params=True)
    return InferenceEngine(cfg, None, ec, device="cuda", executor=ex)


def test_int8_decode_graph_frees_each_layers_weights(gen):
    """The decode iteration's capture (and its eager warm-up) with int8
    weights holds at most two blocks' expanded kernels and the expanded head
    above what the bf16-weight capture holds, and its weights rest at about
    half the bf16 bytes."""
    import gc

    out = {}
    for quantization in ("none", "int8"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        engine = _int8_engine(quantization)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine.warmup_decode_ladder()
        torch.cuda.synchronize()
        out[quantization] = (resident - before, torch.cuda.max_memory_allocated() - resident)
        if quantization == "int8":
            block, head = _frozen_bytes(engine.executor.model, 2)
        del engine
    assert out["none"][0] - out["int8"][0] > 4 * block
    assert out["int8"][1] - out["none"][1] < 2 * block + head, (out["int8"][1],
                                                                out["none"][1])


def test_int8_weight_engine_decode_window_never_syncs_the_host(gen):
    """``set_sync_debug_mode("error")`` around a graphed 8-step window's
    dispatch on int8 weights; the window's tokens then equal the eager
    iteration's."""
    engine = _int8_engine()
    engine.warmup_decode_ladder()
    reqs = _mixed_requests(engine)
    engine.step()  # admission and prefill
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = engine._decode_dispatch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pending[1] == 8
    engine._decode_complete(pending)
    while engine.has_work:
        engine.step()
    graphed = [r.output_token_ids for r in reqs]
    eager = _int8_engine(graphs=False)
    reqs = _mixed_requests(eager)
    while eager.has_work:
        eager.step()
    assert [r.output_token_ids for r in reqs] == graphed
    assert [len(t) for t in graphed] == [21, 17, 30]


@pytest.mark.parametrize("stage,offload", [(3, False), (3, True)])
def test_int8_base_under_zero3_and_offload_equals_the_plain_int8_step(gen, nccl_group,
                                                                      stage, offload):
    """ZeRO-3 (and its host offload) on an int8 base in the group of one:
    ``q`` and ``scale`` are placed like the kernels (pinned host tensors
    under offload), fetched into the captured step, and four steps equal
    the plain graphed int8 step bit for bit."""
    from dlti_tpu_torch.config import ParallelConfig, ZeROStage

    batches = _host_batches(4, seed=13)
    plain = _int8_run(_int8_train_state(layers=2), True, batches)
    state = _int8_train_state(layers=2, parallel=ParallelConfig(
        zero_stage=ZeROStage(stage), offload_optimizer=offload, offload_params=offload))
    q = [p for n, p in state.model.named_parameters() if p.dtype == torch.int8]
    assert q and all((p.device.type == "cpu" and p.is_pinned()) == offload for p in q)
    zero = _int8_run(state, True, batches)
    for a, b in zip(plain[0], zero[0]):
        assert (a == b).all(), (a, b)
    assert all(torch.equal(a, b.to(a.device)) for a, b in zip(plain[1] + plain[2],
                                                              zero[1] + zero[2]))


# ----------------------------------------------------------------------
# Speculative decode, prefix-tier block transport and chunked prefill: the
# spec rounds as CUDA graphs equal to the eager rounds, no host sync in a
# spec dispatch, fetch -> restore bit-equal on every pool, chunked bf16
# prefill against one call
# ----------------------------------------------------------------------

# chip_smoke.py's limit for logits of one function reached two ways in bf16.
LOGITS_REL_TOL = 5e-2


def _spec_engine(graphs, pool="bfloat16", k=4, rounds=4):
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine
    from dlti_tpu_torch.serving.engine import EngineExecutor

    cfg = _tiny_bf16_cfg()
    params = init_params(cfg, seed=0, device="cuda")
    ec = EngineConfig(max_seqs=4, block_size=16, num_blocks=64, max_model_len=128,
                      cache_dtype=pool, eos_token_id=-1, steps_per_sync=rounds,
                      speculative="ngram", num_draft_tokens=k, spec_min_acceptance=0.0)
    ex = EngineExecutor(cfg, params, ec, device="cuda", cuda_graphs=graphs)
    return InferenceEngine(cfg, params, ec, device="cuda", executor=ex)


def _spec_requests(engine):
    from dlti_tpu_torch.serving import SamplingParams

    return [engine.submit([6, 6, 7, 7] * 3, SamplingParams(temperature=0.0, max_tokens=40)),
            engine.submit([1, 2, 3], SamplingParams(temperature=0.8, top_p=0.9,
                                                    max_tokens=25, seed=4)),
            engine.submit([5, 5, 5, 5], SamplingParams(temperature=0.0, max_tokens=33))]


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_spec_graph_replays_equal_eager_rounds(gen, pool):
    """One spec round per draft length captured and replayed round by
    round gives the eager rounds' tokens and logprobs; the spec rounds run
    no K4 (the verify takes the gather path) and the plain windows between
    them launch it once per layer per step."""
    runs = []
    for graphs in (False, True):
        engine = _spec_engine(graphs, pool)
        engine.warmup_decode_ladder()
        tpa.launches = tpa.launches_int8 = 0
        reqs = _spec_requests(engine)
        while engine.has_work:
            engine.step()
        torch.cuda.synchronize()
        assert bool(engine.executor.spec_graphs) == graphs
        assert engine.stats["spec_accepted"] > 0
        runs.append([(r.output_token_ids, r.output_logprobs) for r in reqs])
    assert runs[0] == runs[1]
    assert [len(t) for t, _ in runs[0]] == [40, 25, 33]


def test_spec_dispatch_never_syncs_the_host(gen):
    engine = _spec_engine(True)
    engine.warmup_decode_ladder()
    _spec_requests(engine)
    engine.step()  # admission and prefill
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = engine._decode_dispatch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pending[0] == "spec"
    engine._decode_complete(pending)
    while engine.has_work:
        engine.step()
    assert engine.block_manager.num_free == 63


@pytest.mark.parametrize("pool", ["bfloat16", "float16", "int8"])
def test_fetch_and_restore_block_round_trip_bit_equal_on_the_card(gen, pool):
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.serving import EngineConfig
    from dlti_tpu_torch.serving.engine import EngineExecutor

    cfg = _tiny_bf16_cfg()
    ec = EngineConfig(max_seqs=2, block_size=16, num_blocks=32, max_model_len=128,
                      cache_dtype=pool, eos_token_id=-1)
    ex = EngineExecutor(cfg, init_params(cfg, seed=0, device="cuda"), ec, device="cuda")
    for layer in ex.cache:
        for t in layer.values():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, device="cuda", generator=gen,
                                      dtype=torch.int8))
            else:
                t.copy_(torch.randn(t.shape, device="cuda", generator=gen).to(t.dtype))
    payload = ex.fetch_block_kv(5)
    rows = [r for layer in payload.values() for r in layer.values()]
    assert all(r.device.type == "cpu" and r.is_pinned() for r in rows)
    before = [{k: t.clone() for k, t in layer.items()} for layer in ex.cache]
    ex.restore_block(9, payload)
    torch.cuda.synchronize()
    for layer, old in zip(ex.cache, before):
        for k, t in layer.items():
            assert torch.equal(t[9], old[k][5]) and torch.equal(t[5], old[k][5])
            others = [b for b in range(t.shape[0]) if b != 9]
            assert torch.equal(t[others], old[k][others])


def test_chunked_bf16_prefill_logits_match_one_call(gen):
    """A 100-token prompt prefilled in one call and in chunks of 16 at their
    offsets (each chunk attending to the keys the earlier ones wrote): the
    last logits agree within chip_smoke.py's bf16 limit."""
    import numpy as np

    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.serving import EngineConfig
    from dlti_tpu_torch.serving.engine import EngineExecutor

    cfg = _tiny_bf16_cfg()
    ec = EngineConfig(max_seqs=2, block_size=16, num_blocks=32, max_model_len=128,
                      eos_token_id=-1)
    ex = EngineExecutor(cfg, init_params(cfg, seed=0, device="cuda"), ec, device="cuda")
    tokens = np.random.default_rng(0).integers(3, cfg.vocab_size, size=100)
    n = len(tokens)

    def table(first):
        bt = np.zeros((1, ec.max_blocks_per_seq), np.int32)
        bt[0, :7] = np.arange(first, first + 7)
        return bt

    whole = ex.prefill(tokens[None].astype(np.int32), np.arange(n, dtype=np.int32)[None],
                       table(1), np.array([n - 1], np.int32))
    for start in range(0, n, 16):
        piece = tokens[start:start + 16]
        ids = np.zeros((1, 16), np.int32)
        pos = np.full((1, 16), -1, np.int32)
        ids[0, :len(piece)] = piece
        pos[0, :len(piece)] = np.arange(start, start + len(piece))
        last = ex.prefill(ids, pos, table(8), np.array([len(piece) - 1], np.int32))
    scale = whole.abs().max().item()
    assert (last - whole).abs().max().item() <= LOGITS_REL_TOL * scale


@pytest.mark.parametrize("pool,dtype", [("int8", torch.bfloat16), ("bfloat16", torch.bfloat16),
                                        ("float16", torch.float16)])
@pytest.mark.parametrize("kv_heads", [32, 8])
def test_paged_window_attention_matches_the_reference_path(gen, pool, dtype, kv_heads):
    """The card's multi-position paged attention (half-precision GEMMs with
    float32 output over a window gathered once in q's dtype) against the
    reference path (``paged_gather`` + ``reference_attention`` in float32)
    at a verify's shape: 28 slots x 5 positions over 2048-token tables. The
    two sum in another order and round the output to q's type: one step of
    it apart (``TOL``)."""
    from dlti_tpu_torch.ops.attention import paged_window_attention, reference_attention
    from dlti_tpu_torch.ops.kv_cache import init_paged_cache, paged_gather

    cache = init_paged_cache(1, 512, 16, kv_heads, 128,
                             "int8" if pool == "int8" else getattr(torch, pool),
                             device="cuda")[0]
    for name in ("k", "v"):
        t = cache[name]
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, device="cuda", generator=gen,
                                  dtype=torch.int8))
            cache[name + "_scale"].copy_(torch.rand(cache[name + "_scale"].shape,
                                                    device="cuda", generator=gen) * 0.02)
        else:
            t.copy_(torch.randn(t.shape, device="cuda", generator=gen).to(t.dtype))
    tables = torch.randint(1, 512, (28, 128), device="cuda", generator=gen, dtype=torch.int32)
    start = torch.randint(0, 2043, (28, 1), device="cuda", generator=gen)
    pos = (start + torch.arange(5, device="cuda")).to(torch.int32)
    q = torch.randn(28, 5, 32, 128, device="cuda", generator=gen).to(dtype)
    got = paged_window_attention(q, cache, tables, pos)
    k, v = paged_gather(cache, tables)
    want = reference_attention(q, k.to(dtype), v.to(dtype), causal=True, q_positions=pos)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)


# ----------------------------------------------------------------------
# Multi-LoRA serving on the card: the pool's rows reach every captured
# graph, loads keep the pool's addresses and never wait on the card
# ----------------------------------------------------------------------

def _adapter_engine(tmp_path, graphs, spec=False, pool="bfloat16"):
    """llama_tiny in bf16 with a 2-row adapter pool (rank 4), and two seeded
    adapters registered as "a" and "b"."""
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine
    from dlti_tpu_torch.serving import adapters as ad
    from dlti_tpu_torch.serving.engine import EngineExecutor

    cfg = _tiny_bf16_cfg()
    params = init_params(cfg, seed=0, device="cuda")
    g = torch.Generator().manual_seed(3)
    for name in ("a", "b"):
        tree = {n.replace("kernel", leaf): torch.randn(
                    (t.shape[0], 4) if leaf == "lora_a" else (4, t.shape[1]), generator=g) * 0.3
                for n, t in params.items() if n.endswith("_proj.kernel") and ".attn." in n
                for leaf in ("lora_a", "lora_b")}
        ad.save_adapter(str(tmp_path / name), tree, alpha=8.0)
        ad.register_adapter(name, str(tmp_path / name))
    extra = (dict(speculative="ngram", num_draft_tokens=4, spec_min_acceptance=0.0)
             if spec else {})
    ec = EngineConfig(max_seqs=4, block_size=16, num_blocks=64, max_model_len=128,
                      cache_dtype=pool, eos_token_id=-1, steps_per_sync=4,
                      adapter_slots=2, adapter_rank=4, **extra)
    ex = EngineExecutor(cfg, params, ec, device="cuda", cuda_graphs=graphs)
    return InferenceEngine(cfg, params, ec, device="cuda", executor=ex)


@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_adapter_graphs_equal_eager_and_keep_pool_addresses(gen, tmp_path, spec, pool):
    """The decode graph (and with speculation the spec graphs) replayed
    over a mixed batch of base and adapter rows gives the eager iteration's
    tokens and logprobs; the same prompt under each adapter and the base
    gives three streams; the pool's tensors keep their addresses across
    the loads."""
    from dlti_tpu_torch.serving import SamplingParams
    from dlti_tpu_torch.serving import adapters as ad

    runs = []
    try:
        for graphs in (False, True):
            ad.get_catalog().clear()
            engine = _adapter_engine(tmp_path / str(graphs), graphs, spec, pool)
            engine.warmup_decode_ladder()
            ptrs = [t.data_ptr() for abs_ in engine.adapter_pool.tensors.values()
                    for t in abs_]
            sp = SamplingParams(temperature=0.0, max_tokens=30)
            reqs = [engine.submit([6, 6, 7, 7] * 3, sp, adapter=a) for a in ("", "a", "b")]
            reqs.append(engine.submit([1, 2, 3], SamplingParams(
                temperature=0.8, max_tokens=20, seed=4), adapter="a"))
            while engine.has_work:
                engine.step()
            torch.cuda.synchronize()
            assert ptrs == [t.data_ptr() for abs_ in engine.adapter_pool.tensors.values()
                            for t in abs_]
            assert engine.adapter_pool.loaded_names() == ["a", "b"]
            runs.append([(r.output_token_ids, r.output_logprobs) for r in reqs])
    finally:
        ad.get_catalog().clear()
    assert runs[0] == runs[1]
    tokens = [t for t, _ in runs[1][:3]]
    assert tokens[0] != tokens[1] and tokens[0] != tokens[2] and tokens[1] != tokens[2]


def test_adapter_row_load_never_syncs_the_host(gen, tmp_path):
    """``set_sync_debug_mode("error")`` around a pool miss: the checkpoint's
    rows reach the card through pinned memory without a wait; the next
    window reads them."""
    from dlti_tpu_torch.serving import SamplingParams
    from dlti_tpu_torch.serving import adapters as ad

    try:
        engine = _adapter_engine(tmp_path, True)
        engine.warmup_decode_ladder()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            row, loaded = engine.adapter_pool.acquire("b")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert (row, loaded) == (1, True)
        engine.adapter_pool.release(row)
        want = {m: [t[row].cpu() for t in abs_]
                for m, abs_ in engine.adapter_pool.tensors.items()}
        req = engine.submit([5, 4, 3], SamplingParams(temperature=0.0, max_tokens=8),
                            adapter="b")
        while engine.has_work:
            engine.step()
        assert req.finish_reason == "length"
        got = {m: [t[row].cpu() for t in abs_]
               for m, abs_ in engine.adapter_pool.tensors.items()}
        assert all(torch.equal(x, y) for m in want for x, y in zip(want[m], got[m]))
        assert any(bool(a.any()) for a, _, _ in got.values())
    finally:
        ad.get_catalog().clear()


# ----------------------------------------------------------------------
# Mixtral: the routed-expert block at Mixtral-8x7B's width
# ----------------------------------------------------------------------

def _mixtral_cfg(layers):
    """Mixtral-8x7B (hidden 4096, 8 experts of 14336, top 2, GQA 32/8 at
    head_dim 128, remat, bf16) cut to ``layers`` blocks."""
    import dataclasses

    from dlti_tpu_torch.config import MODEL_PRESETS

    return dataclasses.replace(MODEL_PRESETS["mixtral_8x7b"], num_layers=layers)


def _moe_train_state(layers=2):
    """LoRA r=16 (dropout 0.05) on q/k/v/o over an int8 base drawn leaf by
    leaf (``init_params_int8``)."""
    from dlti_tpu_torch.config import LoRAConfig, OptimizerConfig
    from dlti_tpu_torch.models import init_params_int8, load_model
    from dlti_tpu_torch.training import build_optimizer, create_train_state

    lora = LoRAConfig(r=16, alpha=32)
    cfg = _mixtral_cfg(layers)
    model = load_model(cfg, init_params_int8(cfg, seed=0, device="cuda", lora=lora),
                       "cuda", lora=lora, trainable_lora=True)
    return create_train_state(model, build_optimizer(OptimizerConfig(warmup_steps=1)))


def test_graphed_moe_steps_equal_eager_and_launch_k1_k3_at_gqa_32_8(gen):
    """Four steps (two windows of 2, dropout on, remat) of Mixtral's block
    on an int8 base through the captured step and eagerly: bit-equal
    metrics (the load-balance loss among them), LoRA factors and moments;
    K1 twice per layer per microbatch and K2/K3 once at GQA 32/8, d 128,
    the capture's warm-up step once more."""
    from dlti_tpu_torch.training import StepWindow
    from dlti_tpu_torch.training.step import MOE_METRICS

    layers, accum = 2, 2
    batches = _host_batches(4, accum, seed=21)
    runs, counts = [], []
    for graphs in (False, True):
        state = _moe_train_state(layers)
        window = StepWindow(state.model, accum_steps=accum, seed=43, capacity=4,
                            cuda_graphs=graphs)
        assert window.metrics == MOE_METRICS
        tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
        runs.append(_run_windows(state, window, batches))
        counts.append((tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches))
        del state, window
    (eager, pe, me), (graphed, pg, mg) = runs
    for a, b in zip(eager, graphed):
        assert (a == b).all(), (a, b)
        aux = a[:, MOE_METRICS.index("aux_loss")] / layers
        assert ((aux > 0.9) & (aux < 1.6)).all(), aux  # finite, near 1 a layer
    assert all(torch.equal(a, b) for a, b in zip(pe + me, pg + mg))
    n = layers * accum
    assert counts == [(2 * n * 4, n * 4, n * 4), (2 * n * 5, n * 5, n * 5)]


def test_moe_step_frees_each_layers_expanded_experts(gen):
    """The graphed step (remat on, the preset's) on a 4-block int8 base
    holds less than two layers' expanded experts above
    its resident state: each expert weight is expanded at its use and let
    go, in the forward, the recompute and the backward (all four layers'
    would be 11.3 GB)."""
    import gc

    from dlti_tpu_torch.training import StepWindow

    cfg = _mixtral_cfg(4)
    layer_experts = 3 * cfg.num_experts * cfg.hidden_size * cfg.intermediate_size * 2
    gc.collect()
    torch.cuda.empty_cache()
    state = _moe_train_state(4)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    window = StepWindow(state.model, accum_steps=2, seed=43, capacity=4)
    _run_windows(state, window, _host_batches(4, 2, seed=22))
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - resident
    del state, window
    assert transient < 2 * layer_experts, (transient, layer_experts)


def _moe_engine(k=8, graphs=True, layers=2):
    from dlti_tpu_torch.models import init_params_int8
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine
    from dlti_tpu_torch.serving.engine import EngineExecutor

    cfg = _mixtral_cfg(layers)
    ec = EngineConfig(max_seqs=4, block_size=16, num_blocks=64, max_model_len=128,
                      cache_dtype="bfloat16", eos_token_id=-1, steps_per_sync=k,
                      quantization="int8")
    ex = EngineExecutor(cfg, init_params_int8(cfg, seed=0, device="cuda"), ec,
                        device="cuda", cuda_graphs=graphs, donate_params=True)
    return InferenceEngine(cfg, None, ec, device="cuda", executor=ex)


def test_moe_decode_graph_equals_eager_decode_and_launches_k4_per_layer(gen):
    """Greedy and seeded requests through Mixtral's block on int8 weights:
    the decode iteration graphed equals it eager at k 1, a free slot among
    the rows (its trash-slot writes ordered, the dispatch and combine
    without atomics), K4 once a layer a decode step at GQA 32/8; and k 8
    graphed equals k 1 graphed on a batch whose every slot is busy at every
    step (a free or finished slot routes tokens of its own inside a window,
    which under a dropping capacity moves the others')."""
    from dlti_tpu_torch.serving import SamplingParams

    def run(k, graphs, full):
        engine = _moe_engine(k, graphs)
        engine.warmup_decode_ladder()
        tpa.launches = 0
        if full:
            reqs = [engine.submit(list(range(3 + i, 9 + 5 * i)), SamplingParams(
                temperature=0.0 if i % 2 else 0.8, max_tokens=17, seed=i)) for i in range(4)]
        else:
            reqs = _mixed_requests(engine)
        while engine.has_work:
            engine.step()
        torch.cuda.synchronize()
        assert tpa.launches == 2 * engine.stats["decode_steps"]
        return [(r.output_token_ids, r.output_logprobs) for r in reqs]

    staggered = [run(1, False, False), run(1, True, False)]
    assert staggered[0] == staggered[1]
    assert [len(t) for t, _ in staggered[0]] == [21, 17, 30]
    assert run(1, True, True) == run(8, True, True)


def test_moe_decode_window_never_syncs_the_host(gen):
    """``set_sync_debug_mode("error")`` around a graphed 8-step window's
    dispatch over Mixtral's routed experts: routing, capacity and the
    dispatch are static shapes, nothing reads the card back."""
    engine = _moe_engine()
    engine.warmup_decode_ladder()
    _mixed_requests(engine)
    engine.step()  # admission and prefill
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = engine._decode_dispatch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pending[1] == 8
    engine._decode_complete(pending)
    while engine.has_work:
        engine.step()



# ----------------------------------------------------------------------
# Tensor parallelism on one card: the tensor path in a NCCL group of one
# ----------------------------------------------------------------------

def test_tensor_path_graphed_steps_in_a_nccl_group_of_one_equal_the_plain_step(
        gen, nccl_group):
    """Four steps (two windows of 2, dropout on) with every tensor
    collective issued on a tensor group of one and captured in the step's
    graph: bit-equal to the plain single-device graphed step, K1-K3 as
    many times."""
    batches = _host_batches(4, seed=7)
    state, window = _window_case(gen, True)
    tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
    plain = _run_windows(state, window, batches)
    plain_counts = (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches)
    del state, window
    state, window = _zero_window_case(0, True, tensor_group=True)
    assert state.layout.mesh.tensor_parallel and state.model.model.tp is not None
    tfa.fwd_launches = tfa.dq_launches = tfa.dkv_launches = 0
    tp = _run_windows(state, window, batches)
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches) == plain_counts
    for a, b in zip(plain[0], tp[0]):
        assert (a == b).all(), (a, b)
    assert all(torch.equal(a, b) for a, b in zip(plain[1] + plain[2], tp[1] + tp[2]))


def test_tensor_path_decode_graph_in_a_nccl_group_of_one_equals_the_plain_engine(
        nccl_group):
    """The engine on a tensor group of one (its pools' heads, the embedding,
    the head and o/down all through the tensor collectives, captured in the
    decode graph): tokens and logprobs equal to the plain graphed engine's,
    K4 once a layer a step."""
    from dlti_tpu_torch.config import MODEL_PRESETS, ParallelConfig
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.serving import EngineConfig, InferenceEngine, SamplingParams

    cfg = MODEL_PRESETS["llama_300m"]
    ec = EngineConfig(max_seqs=4, block_size=16, num_blocks=64, max_model_len=256,
                      steps_per_sync=4, eos_token_id=-1)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = build_mesh(ParallelConfig(), dev, tensor_group=True)

    def run(mesh):
        engine = InferenceEngine(cfg, init_params(cfg, seed=0, device="cuda"), ec,
                                 device="cuda", mesh=mesh)
        engine.warmup_decode_ladder()
        tpa.launches = 0
        reqs = [engine.submit(list(range(3, 3 + n)), SamplingParams(
                    temperature=0.0 if i % 2 else 0.8, max_tokens=12, seed=i))
                for i, n in enumerate((5, 40, 17))]
        while engine.has_work:
            engine.step()
        torch.cuda.synchronize()
        assert tpa.launches == cfg.num_layers * engine.stats["decode_steps"]
        return [(r.output_token_ids, r.output_logprobs) for r in reqs]

    assert run(None) == run(mesh)


def test_graphs_under_a_gloo_group_on_the_card_raise(gen, monkeypatch):
    """Two ranks on one card run gloo (``launcher --one-device``), which a
    CUDA graph cannot capture: the decode graph and the step graph refuse
    it by name instead of capturing host collectives."""
    import socket

    import torch.distributed as dist

    from dlti_tpu_torch.config import MODEL_PRESETS, ParallelConfig
    from dlti_tpu_torch.models.interop import init_params
    from dlti_tpu_torch.parallel.mesh import build_mesh
    from dlti_tpu_torch.serving import EngineConfig
    from dlti_tpu_torch.serving.engine import EngineExecutor

    monkeypatch.setenv("DLTI_ONE_DEVICE", "1")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        mesh = build_mesh(ParallelConfig(), dev, tensor_group=True)
        cfg = MODEL_PRESETS["llama_tiny"]
        params = init_params(cfg, seed=0, device="cuda")
        ec = EngineConfig(max_seqs=2, block_size=16, num_blocks=16, max_model_len=64)
        with pytest.raises(ValueError, match="needs NCCL"):
            EngineExecutor(cfg, dict(params), ec, device=dev, mesh=mesh)
        EngineExecutor(cfg, dict(params), ec, device=dev, mesh=mesh, cuda_graphs=False)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# Sequence and pipeline parallelism over NCCL across cards
# ----------------------------------------------------------------------

# name -> (world, parallel): graphed SP/PP steps and ZeRO-3 on its fsdp axis
# beside each model axis, a rank a card ("expert" cases on the mixture of
# experts at the same widths).
ACROSS_CARDS = {
    "sequence2": (2, dict(sequence=2)),
    "pipe2": (2, dict(pipe=2)),
    "data2_sequence2": (4, dict(data=2, sequence=2)),
    "zero1_pipe2_data2": (4, dict(zero_stage=1, pipe=2, data=2)),
    "zero3_fsdp2_tensor2": (4, dict(zero_stage=3, fsdp=2, tensor=2)),
    "zero3_fsdp2_expert2": (4, dict(zero_stage=3, fsdp=2, expert=2)),
    "zero3_fsdp2_sequence2": (4, dict(zero_stage=3, fsdp=2, sequence=2)),
    "zero3_fsdp2_pipe2": (4, dict(zero_stage=3, fsdp=2, pipe=2)),
    "zero3_data2_fsdp2": (4, dict(zero_stage=3, data=2, fsdp=2)),
}
ACROSS_MODEL = dict(num_layers=4, vocab_size=512, dtype="float32", param_dtype="float32")
ACROSS_MOE = dict(ACROSS_MODEL, num_experts=4, num_experts_per_tok=2)
ACROSS_LORA = dict(r=8, alpha=16, dropout=0.05)


@pytest.fixture(scope="module")
def across_cards(tmp_path_factory):
    """The cases' graphed steps in NCCL worlds of 2 and 4, one rank a card
    (llama_300m's widths at 4 layers, float32, LoRA with dropout; the
    expert cases a mixture of 4 experts at those widths), and the same
    steps on one card, eager, in this process."""
    import numpy as np

    import torch_dist_worker as W
    from dlti_tpu_torch.config import MODEL_PRESETS, LoRAConfig
    from dlti_tpu_torch.models import init_params

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (one rank a card over NCCL)")
    import dataclasses

    lora = LoRAConfig(**ACROSS_LORA)
    rng = np.random.default_rng(3)
    shape = (4, 4, 256)
    batches = [{"input_ids": rng.integers(3, 512, shape).astype(np.int32),
                "loss_mask": (rng.random(shape) > 0.2).astype(np.int32)} for _ in range(2)]
    kws = {}
    for kind, model in (("dense", ACROSS_MODEL), ("moe", ACROSS_MOE)):
        cfg = dataclasses.replace(MODEL_PRESETS["llama_300m"], **model)
        params = {n: t.numpy() for n, t in init_params(cfg, seed=0, device="cpu",
                                                         lora=lora).items()}
        kws[kind] = dict(params=params, batches=batches, lora=ACROSS_LORA,
                         opt=dict(warmup_steps=1), model=model, preset="llama_300m", seed=5,
                         accum=4)
    # Build the kernels once before the ranks load them.
    tfa.flash_attention(*(torch.zeros(1, 64, 2, 64, device="cuda") for _ in range(3)))
    tmp = tmp_path_factory.mktemp("across")
    worlds = {w: W.spawn_world(w, [(n, "steps", dict(kws[_across_kind(n)], parallel=par,
                                                      device="cuda", graphs=True))
                                   for n, (wn, par) in ACROSS_CARDS.items() if wn == w],
                               str(tmp), backend="nccl") for w in (2, 4)}
    one = {kind: W.steps(parallel={}, device="cuda", **kw) for kind, kw in kws.items()}
    return worlds, one


def _across_kind(name):
    return "moe" if "expert" in name else "dense"


@pytest.mark.parametrize("name", list(ACROSS_CARDS))
def test_sequence_and_pipe_graphed_steps_across_cards_equal_one_card(across_cards, name):
    """Each rank a card over NCCL, the step captured as a CUDA graph (the
    ring's permutes and skips, the pipeline's ticks and hand-run backward,
    ZeRO-3's gathers issued a block ahead and its reduce-scatters, their
    collectives inside): losses, grad norms and LoRA factors equal one
    card's eager steps on the same rows within 1e-4 (float32: the ring sums
    in another order than K1), every rank reporting the same metrics."""
    import numpy as np

    worlds, ones = across_cards
    world, _ = ACROSS_CARDS[name]
    one = ones[_across_kind(name)]
    got = worlds[world][0][name]
    assert got["captures"] == 1
    for g, w in zip(got["metrics"], one["metrics"]):
        np.testing.assert_allclose([g["loss"], g["grad_norm"]], [w["loss"], w["grad_norm"]],
                                   rtol=1e-4, err_msg=name)
    for n, t in got["trainable"].items():
        np.testing.assert_allclose(t, one["trainable"][n], rtol=1e-4, atol=1e-6, err_msg=n)
    for rank_out in worlds[world][1:]:
        assert rank_out[name]["metrics"] == got["metrics"]


# ----------------------------------------------------------------------
# The replica fleet on the card: failover and live KV migration between
# replicas that each own their weights, pool and decode graph
# ----------------------------------------------------------------------

def _debug_cfg(dtype):
    import dataclasses

    from dlti_tpu_torch.config import MODEL_PRESETS

    return dataclasses.replace(MODEL_PRESETS["llama_debug"], dtype=dtype, param_dtype=dtype)


def _card_fleet(cfg, pool, devices, fault=""):
    """llama_debug replicas on ``devices`` (a repeat shares a card), the
    decode graphs captured, self-healing on; K4/K4q counted from here."""
    from dlti_tpu_torch.config import ReplicaLifecycleConfig
    from dlti_tpu_torch.models import init_params
    from dlti_tpu_torch.serving import EngineConfig, ReplicatedEngine

    ec = EngineConfig(max_seqs=4, block_size=16, num_blocks=64, max_model_len=128,
                      cache_dtype=pool, eos_token_id=-1, steps_per_sync=4)
    fleet = ReplicatedEngine(cfg, init_params(cfg, seed=0, device=devices[0]), ec,
                             replicas=len(devices), devices=devices, fault_inject_step=fault,
                             lifecycle_cfg=ReplicaLifecycleConfig(enabled=True,
                                                                  probation_initial_s=0.0),
                             donate_params=True)
    fleet.warmup_decode_ladder()
    tpa.launches = tpa.launches_int8 = 0
    return fleet


def _fleet_waves(fleet, n_replicas):
    """Three waves of requests (greedy and seeded), a fleet step after each,
    then steps until the fleet is idle and healed; returns the requests."""
    from dlti_tpu_torch.serving import SamplingParams

    reqs = []
    for w in range(3):
        for i in range(n_replicas):
            sp = (SamplingParams(temperature=0.0, max_tokens=12) if i % 2 == 0 else
                  SamplingParams(temperature=0.8, top_k=40, max_tokens=12, seed=10 * w + i))
            reqs.append(fleet.submit([3 + w, 5 + i, 7, 11 + w * i][:2 + (i + w) % 3], sp))
        fleet.step()
    for _ in range(500):
        if not fleet.has_work and not fleet.lifecycle_pending:
            break
        fleet.step()
    return reqs


def _check_fleet_against(fleet, reqs, ref, replicas, mode, pool):
    tokens = [r.output_token_ids for r in reqs]
    assert all(r.finish_reason == "length" for r in reqs)
    assert fleet.lifecycle_counts() == {"live": replicas, "quarantined": 0, "draining": 0,
                                        "dead": 0}
    assert fleet.lifecycle.counters["reinstates"] == 1
    if mode == "raise":
        # A failed-over request is recomputed on its survivor: float32, held
        # to the unfaulted run's tokens.
        assert any(r.num_retries for r in reqs)
        assert tokens == ref
    else:
        # A migrated decode carries its KV and its draws: byte-equal.
        moved = [i for i, r in enumerate(reqs) if r.num_migrations]
        assert moved and all(tokens[i] == ref[i] for i in moved)
    counted = tpa.launches_int8 if pool == "int8" else tpa.launches
    assert counted > 0 and (tpa.launches if pool == "int8" else tpa.launches_int8) == 0


@pytest.mark.parametrize("mode,pool", [("raise", "float32"), ("preempt", "bfloat16"),
                                       ("preempt", "int8")])
def test_two_replicas_on_one_card_fail_over_and_migrate(gen, mode, pool):
    """Two replicas on cuda:0, each owning its weights, pool and graphs: a
    ``raise`` at replica 1's third step fails its requests over to replica 0
    (float32, the unfaulted fleet's tokens), a ``preempt`` migrates its
    decodes' KV to replica 0 (bf16 K4 and int8 K4q pools, the migrated
    requests byte-equal to the unfaulted fleet's); the replica heals."""
    cfg = _debug_cfg("float32" if pool == "float32" else "bfloat16")
    devices = [torch.device("cuda", 0)] * 2
    ref = [r.output_token_ids for r in _fleet_waves(_card_fleet(cfg, pool, devices), 2)]
    fleet = _card_fleet(cfg, pool, devices, f"1:3:{mode}")
    reqs = _fleet_waves(fleet, 2)
    _check_fleet_against(fleet, reqs, ref, 2, mode, pool)


def test_two_replicas_on_one_card_serve_http_through_the_cli_with_the_gateway(gen):
    """``cli.serve --replicas 2 --device cuda:0 --gateway``'s builder behind
    ``make_server``: two replicas on the card answer through the gateway,
    and ``/health`` counts them."""
    import http.client
    import json
    import threading

    from dlti_tpu_torch.cli import serve as cli
    from dlti_tpu_torch.serving import ReplicatedEngine, make_server

    args = cli.parse_args(["--random-init", "llama_debug", "--tokenizer", "byte",
                           "--device", "cuda:0", "--port", "0", "--host", "127.0.0.1",
                           "--max-model-len", "128", "--num-blocks", "64",
                           "--kv-cache-dtype", "int8", "--replicas", "2", "--gateway"])
    engine, tok, sc = cli.build(args)
    assert isinstance(engine, ReplicatedEngine)
    assert [e.device for e in engine.engines] == [torch.device("cuda", 0)] * 2
    engine.warmup_decode_ladder()
    httpd, aeng = make_server(engine, tok, sc)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    addr = ("127.0.0.1", httpd.server_address[1])
    try:
        out = []

        def go(i):
            conn = http.client.HTTPConnection(*addr, timeout=120)
            conn.request("POST", "/v1/completions", json.dumps(
                {"prompt": f"hello {i}", "max_tokens": 6, "temperature": 0}))
            resp = conn.getresponse()
            out.append((resp.status, json.loads(resp.read())))

        threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(s == 200 and b["usage"]["completion_tokens"] == 6 for s, b in out), out
        conn = http.client.HTTPConnection(*addr, timeout=60)
        conn.request("GET", "/health")
        assert json.loads(conn.getresponse().read()) == {
            "status": "ok", "live": 2, "quarantined": 0, "draining": 0, "dead": 0}
        assert all(e.stats["requests"] > 0 for e in engine.engines)
        assert tpa.launches_int8 > 0
    finally:
        httpd.shutdown()
        httpd.gateway.shutdown()
        aeng.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("mode,pool", [("raise", "float32"), ("preempt", "bfloat16"),
                                       ("preempt", "int8")])
def test_replica_fleet_across_cards_fails_over_and_migrates_as_on_one_card(gen, mode, pool):
    """One replica a card (up to four): a ``raise`` fails replica 1's
    requests over to another card, a ``preempt`` migrates its decodes' KV
    device -> host -> another card, held to the same fleet's tokens with
    every replica on one card (float32 for the recomputed failover; the
    migrated requests byte-equal)."""
    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs 2 or more CUDA devices (one replica a card)")
    cfg = _debug_cfg("float32" if pool == "float32" else "bfloat16")
    one = [torch.device("cuda", 0)] * n
    ref = [r.output_token_ids for r in _fleet_waves(_card_fleet(cfg, pool, one), n)]
    apart = [torch.device("cuda", i) for i in range(n)]
    fleet = _card_fleet(cfg, pool, apart, f"1:3:{mode}")
    assert [e.device for e in fleet.engines] == apart
    reqs = _fleet_waves(fleet, n)
    _check_fleet_against(fleet, reqs, ref, n, mode, pool)
    if mode == "preempt":
        assert any(fleet.engines[r.replica].device != apart[1] for r in reqs
                   if r.num_migrations)
