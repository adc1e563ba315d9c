"""The port's paged decode attention (its plain version, which the wrapper
takes for CPU tensors) against the JAX Pallas kernel run with
``interpret=True``, as ``tests/test_paged_attention.py`` runs it.

Tolerance: 1e-5 absolute in float32 — the Pallas kernel's online softmax
and the plain version's one-pass softmax sum in different orders. On
float16 pools with a float16 query the Pallas kernel writes float16: one
float16 step below |x| = 4, 2**-9. On int8
pools the Pallas kernel folds the scales into the scores and
probabilities while the plain version dequantizes first, so the products
round differently: atol 2e-5, rtol 2e-4, the tolerance of the JAX suite's
own int8 case (``tests/test_paged_attention.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlti_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention,
)
from dlti_tpu_torch.ops import paged_attention as tpa

ATOL = 1e-5
F16_ATOL = 2.0 ** -9


def _setup(seed, batch, num_heads, kv_heads, head_dim, block_size, num_blocks,
           max_blocks, seq_lens, garbage_tables=False):
    """Pool plus disjoint random block tables; entries past each sequence's
    length are -1, or random ids when ``garbage_tables``."""
    rng = np.random.default_rng(seed)
    shape = (num_blocks, block_size, kv_heads, head_dim)
    k_pool = rng.standard_normal(shape).astype(np.float32)
    v_pool = rng.standard_normal(shape).astype(np.float32)
    perm = rng.permutation(num_blocks)
    tables = np.full((batch, max_blocks), -1, np.int32)
    if garbage_tables:
        tables = rng.integers(0, num_blocks, (batch, max_blocks)).astype(np.int32)
    nxt = 0
    for b in range(batch):
        need = -(-seq_lens[b] // block_size)
        tables[b, :need] = perm[nxt:nxt + need]
        nxt += need
    q = rng.standard_normal((batch, 1, num_heads, head_dim)).astype(np.float32)
    return q, k_pool, v_pool, tables


def _both(q, k_pool, v_pool, tables, seq_lens, window=None):
    want = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(seq_lens), window=window,
        interpret=True)
    got = tpa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_pool), torch.from_numpy(v_pool),
        torch.from_numpy(tables), torch.from_numpy(seq_lens), window=window)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("num_heads,kv_heads", [(8, 8), (8, 2), (4, 1)])
def test_plain_matches_pallas_interpret(num_heads, kv_heads):
    seq_lens = np.array([5, 37, 16], np.int32)  # ragged tail / multi / exact
    q, k, v, bt = _setup(0, 3, num_heads, kv_heads, 64, 16, 16, 4, seq_lens)
    got, want = _both(q, k, v, bt, seq_lens)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_window_and_zero_length():
    """A sliding window skipping whole blocks, a window cutting inside a
    block, and a seq_len of 0 (zeros out)."""
    seq_lens = np.array([45, 29, 0, 7], np.int32)
    q, k, v, bt = _setup(1, 4, 4, 2, 32, 8, 24, 6, seq_lens)
    got, want = _both(q, k, v, bt, seq_lens, window=12)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert not got[2].any()


def test_poisoned_rows_and_garbage_tables_never_leak():
    """Every pool block outside the live tables, and the tail rows past
    seq_len in each last block, hold 1e9; table entries past seq_len point
    at random (poisoned) blocks. The output must match the clean Pallas
    result on the same live data."""
    batch, block_size, nb = 3, 8, 12
    seq_lens = np.array([3, 9, 20], np.int32)
    q, k, v, bt = _setup(2, batch, 4, 2, 32, block_size, nb, 4, seq_lens,
                         garbage_tables=True)
    live = {int(bt[b, j]) for b in range(batch)
            for j in range(-(-seq_lens[b] // block_size))}
    kp, vp = k.copy(), v.copy()
    for blk in range(nb):
        if blk not in live:
            kp[blk] = 1e9
            vp[blk] = 1e9
    for b in range(batch):
        last = int(bt[b, (seq_lens[b] - 1) // block_size])
        tail = seq_lens[b] % block_size
        if tail:
            kp[last, tail:] = 1e9
            vp[last, tail:] = 1e9
    got, _ = _both(q, kp, vp, bt, seq_lens)
    clean_tables = bt.copy()
    for b in range(batch):
        clean_tables[b, -(-seq_lens[b] // block_size):] = -1
    _, want = _both(q, k, v, clean_tables, seq_lens)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_cpu_tensors_never_count_as_launches():
    tpa.launches = 0
    seq_lens = np.array([4, 11], np.int32)
    q, k, v, bt = _setup(3, 2, 4, 4, 64, 8, 8, 2, seq_lens)
    tpa.paged_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(bt),
                               torch.from_numpy(seq_lens))
    assert tpa.launches == 0


INT8_CASES = {
    "mha": dict(num_heads=4, kv_heads=4, window=None),
    "gqa": dict(num_heads=8, kv_heads=2, window=None),
    "window": dict(num_heads=4, kv_heads=2, window=12),
}


def _int8_pools(k_pool, v_pool):
    """int8 payloads and float32 row scales, quantized as ``paged_update``
    stores them (the port's ``_quantize_rows``, equal to the JAX package's
    bit for bit)."""
    from dlti_tpu_torch.ops.kv_cache import _quantize_rows

    kq, ks = _quantize_rows(torch.from_numpy(k_pool))
    vq, vs = _quantize_rows(torch.from_numpy(v_pool))
    return kq.numpy(), ks.numpy(), vq.numpy(), vs.numpy()


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_pools_match_pallas_interpret(case):
    """K4's int8 program: the plain version against the Pallas kernel with
    ``k_scale``/``v_scale``, including a window cutting inside a block and
    a seq_len of 0."""
    c = INT8_CASES[case]
    seq_lens = np.array([5, 17, 32, 0], np.int32)
    q, k, v, bt = _setup(7, 4, c["num_heads"], c["kv_heads"], 32, 8, 20, 4, seq_lens)
    kq, ks, vq, vs = _int8_pools(k, v)
    want = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(bt),
        jnp.asarray(seq_lens), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        window=c["window"], interpret=True)
    got = tpa.paged_decode_attention(
        *map(torch.from_numpy, (q, kq, vq, bt, seq_lens)),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs),
        window=c["window"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-4)
    assert not got.numpy()[3].any()


def test_int8_nan_scales_of_dead_rows_never_leak():
    """NaN in the scales of every row outside the live range, and garbage
    table entries past each sequence: the plain version equals itself on
    clean scales. (The Pallas kernel multiplies whole blocks by their
    scales, so this case is held against the plain version only.)"""
    seq_lens = np.array([3, 9, 20], np.int32)
    q, k, v, bt = _setup(8, 3, 4, 2, 32, 8, 12, 4, seq_lens, garbage_tables=True)
    kq, ks, vq, vs = _int8_pools(k, v)
    live = np.zeros(ks.shape[:2], bool)
    for b, n in enumerate(seq_lens):
        for t in range(n):
            live[bt[b, t // 8], t % 8] = True
    ks_nan, vs_nan = ks.copy(), vs.copy()
    ks_nan[~live] = np.nan
    vs_nan[~live] = np.nan
    args = [torch.from_numpy(a) for a in (q, kq, vq, bt, seq_lens)]
    got = tpa.paged_decode_attention(*args, k_scale=torch.from_numpy(ks_nan),
                                     v_scale=torch.from_numpy(vs_nan))
    want = tpa.paged_decode_attention(*args, k_scale=torch.from_numpy(ks),
                                      v_scale=torch.from_numpy(vs))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_int8_scale_arguments_are_checked():
    """Scales are required iff the pools are int8, as in the reference."""
    seq_lens = np.array([4], np.int32)
    q, k, v, bt = map(torch.from_numpy, _setup(4, 1, 2, 2, 64, 8, 4, 1, seq_lens))
    lens = torch.from_numpy(seq_lens)
    scales = dict(k_scale=torch.ones(4, 8, 2), v_scale=torch.ones(4, 8, 2))
    with pytest.raises(ValueError, match="require k_scale"):
        tpa.paged_decode_attention(q, k.to(torch.int8), v.to(torch.int8), bt, lens)
    with pytest.raises(ValueError, match="require k_scale"):
        tpa.paged_decode_attention(q, k.to(torch.int8), v.to(torch.int8), bt, lens,
                                   k_scale=scales["k_scale"])
    with pytest.raises(ValueError, match="belong to int8 pools"):
        tpa.paged_decode_attention(q, k, v, bt, lens, **scales)
    tpa.launches = tpa.launches_int8 = 0
    tpa.paged_decode_attention(q, k.to(torch.int8), v.to(torch.int8), bt, lens,
                               **scales)
    assert tpa.launches == tpa.launches_int8 == 0  # CPU: the plain version


# ----------------------------------------------------------------------
# Split-K, the kernel's arithmetic on the card, emulated in plain torch
# ----------------------------------------------------------------------

def _split_k_emulation(q, k_pool, v_pool, tables, seq_lens, splits, chunk, *,
                       k_scale=None, v_scale=None, window=None):
    """What ``csrc/paged_attention.cu`` computes: split s of a row covers
    tokens ``[s * chunk, (s + 1) * chunk)`` cut to the live window and keeps
    (m, l, acc) in log2 units, reading live rows only (the k scale on the
    score, the v scale on p, l the unscaled p); then the combine,
    ``o = sum 2^(m_s - m*) acc_s / sum 2^(m_s - m*) l_s`` over splits with
    l > 0, zeros where there is none. Tiles and warps inside a split only
    reorder its sums."""
    q, k_pool, v_pool = (torch.as_tensor(a) for a in (q, k_pool, v_pool))
    batch, _, heads, d = q.shape
    nb, bs, kvh, _ = k_pool.shape
    hpg = heads // kvh
    qs = q[:, 0].float().reshape(batch, kvh, hpg, d) * (d ** -0.5 * np.log2(np.e))
    out = torch.zeros(batch, heads, d)
    for b in range(batch):
        n = int(seq_lens[b])
        start = max(0, n - window) if window else 0
        end = min(n, tables.shape[1] * bs)
        records = []
        for s in range(splits):
            lo, hi = max(start, s * chunk), min(end, (s + 1) * chunk)
            if lo >= hi:
                records.append(None)  # an empty split: l = 0, skipped
                continue
            t = torch.arange(lo, hi)
            phys = torch.as_tensor(tables[b])[t // bs].long().clamp(0, nb - 1)
            k = k_pool[phys, t % bs].float()                  # (n, kvh, d)
            v = v_pool[phys, t % bs].float()
            x = torch.einsum("ghd,tgd->ght", qs[b], k)
            if k_scale is not None:
                x = x * torch.as_tensor(k_scale)[phys, t % bs].T[:, None, :]
            m = x.amax(-1, keepdim=True)
            p = torch.exp2(x - m)
            pv = p if v_scale is None else p * torch.as_tensor(v_scale)[phys, t % bs].T[:, None, :]
            records.append((m, p.sum(-1, keepdim=True), torch.einsum("ght,tgd->ghd", pv, v)))
        live = [r for r in records if r is not None]
        if not live:
            continue
        m_star = torch.stack([m for m, _, _ in live]).amax(0)
        l = sum(torch.exp2(m - m_star) * ls for m, ls, _ in live)
        o = sum(torch.exp2(m - m_star) * acc for m, _, acc in live)
        out[b] = (o / l).reshape(heads, d)
    return out.reshape(batch, 1, heads, d).numpy()


@pytest.mark.parametrize("batch,heads,kvh,max_len,want", [
    (8, 32, 32, 1024, 5), (8, 32, 8, 1024, 16), (40, 32, 32, 1024, 1), (5, 8, 8, 64, 1)])
def test_split_plan_covers_the_table_from_static_shapes(batch, heads, kvh, max_len, want):
    """The llama2_7b and llama3_8b engine states, a wide batch and a short
    table on a 132-SM card: whole tiles, no split wholly past the table."""
    splits, chunk = tpa.split_plan(batch, heads, kvh, max_len, 132)
    assert splits == want and (splits - 1) * chunk < max_len <= splits * chunk
    assert chunk % tpa.TILE_TOKENS == 0 and chunk >= tpa.MIN_SPLIT_TOKENS


def _clean_tables(tables, seq_lens, block_size):
    clean = tables.copy()
    for b, n in enumerate(seq_lens):
        clean[b, -(-int(n) // block_size):] = -1
    return clean


# (batch, heads, kv_heads, head_dim, block_size, num_blocks, max_blocks).
_SPLIT_SHAPE = (4, 4, 2, 32, 8, 96, 40)


def _split_case(case, pool):
    """Inputs, split plan and window for one case; the chunk is the host's
    plan for these shapes on a 132-SM card (MIN_SPLIT_TOKENS here)."""
    batch, heads, kvh, d, bs, nb, mb = _SPLIT_SHAPE
    splits, chunk = tpa.split_plan(batch, heads, kvh, mb * bs, 132)
    assert splits > 2 and chunk == tpa.MIN_SPLIT_TOKENS
    window = None
    if case == "one_split":                # a short table's or a wide batch's plan
        splits, chunk = 1, mb * bs
        lens = [0, 1, 3 * tpa.MIN_SPLIT_TOKENS + 5, mb * bs]
    elif case == "zero_and_boundaries":    # seq_len 0; C - 1, C, C + 1
        lens = [0, chunk - 1, chunk, chunk + 1]
    elif case == "window_empties_leading_splits":
        lens, window = [3 * chunk + 5, 2 * chunk + 1, 40, 0], chunk - 7
    elif case == "tables_much_longer_than_live":   # 40 blocks, at most 3 live
        lens = [1, 9, 17, 20]
    else:                                  # NaN in every dead row / its scales
        lens = [0, 3, chunk + 2, 2 * chunk - 1]
    seq_lens = np.array(lens, np.int32)
    q, k, v, bt = _setup(11, batch, heads, kvh, d, bs, nb, mb, seq_lens,
                         garbage_tables=case == "nan_dead_rows")
    scales = {}
    if pool == "int8":
        k, ks, v, vs = _int8_pools(k, v)
        scales = dict(k_scale=ks, v_scale=vs)
    elif pool == "float16":
        q, k, v = (a.astype(np.float16) for a in (q, k, v))
    return q, k, v, bt, seq_lens, splits, chunk, window, scales


@pytest.mark.parametrize("pool", ["float32", "float16", "int8"])
@pytest.mark.parametrize("case", ["zero_and_boundaries", "window_empties_leading_splits",
                                  "tables_much_longer_than_live", "nan_dead_rows",
                                  "one_split"])
def test_split_k_emulation_matches_pallas_interpret(case, pool):
    """The kernel's split-K arithmetic against the Pallas kernel in
    interpret mode, 1e-5 absolute. For ``nan_dead_rows`` every pool row
    outside the live windows (on an int8 pool: its scales) holds NaN, table
    entries past each sequence are garbage and the last splits lie wholly
    past seq_len: the emulation, reading live rows only, must equal the
    Pallas kernel on the clean pool and tables."""
    q, k, v, bt, lens, splits, chunk, window, scales = _split_case(case, pool)
    bs = k.shape[1]
    want = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(_clean_tables(bt, lens, bs)), jnp.asarray(lens), window=window,
        interpret=True, **{n: jnp.asarray(a) for n, a in scales.items()})
    if case == "nan_dead_rows":
        live = np.zeros(k.shape[:2], bool)
        for b, n in enumerate(lens):
            for t in range(n):
                live[bt[b, t // bs], t % bs] = True
        for name in (("k_scale", "v_scale") if scales else ()):
            scales[name] = scales[name].copy()
            scales[name][~live] = np.nan
        if not scales:
            k, v = k.copy(), v.copy()
            k[~live] = np.nan
            v[~live] = np.nan
    got = _split_k_emulation(q, k, v, bt, lens, splits, chunk, window=window, **scales)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=F16_ATOL if pool == "float16" else ATOL, rtol=0)
    for b, n in enumerate(lens):
        if n == 0:
            assert not got[b].any()
