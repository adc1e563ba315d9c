"""The port's RoPE, reference attention and paged KV ops against the JAX
package's, on the same numpy inputs (fp32, CPU).

Tolerances: 1e-6 absolute for RoPE (the same float32 formulas), 1e-5 for
attention (float32 sums taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlti_tpu.ops import attention as jattn
from dlti_tpu.ops import kv_cache as jkv
from dlti_tpu.ops import rope as jrope
from dlti_tpu_torch.ops import attention as tattn
from dlti_tpu_torch.ops import kv_cache as tkv
from dlti_tpu_torch.ops import rope as trope

T = torch.from_numpy


@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (128, 500000.0)])
def test_rope_frequencies_match_jax(head_dim, theta):
    want = jrope.rope_frequencies(head_dim, 300, theta)
    got = trope.rope_frequencies(head_dim, 300, theta)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, -1], [9, 17, 30, 31, 5, 63]], np.int32)
    cos, sin = jrope.rope_frequencies(16, 32)  # position 63 clamps, -1 too
    want = jrope.apply_rope(jnp.asarray(x), cos, sin, jnp.asarray(pos))
    tcos, tsin = trope.rope_frequencies(16, 32)
    got = trope.apply_rope(T(x), tcos, tsin, T(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_rope_table_guard():
    trope.assert_rope_table_covers(8, 8)
    with pytest.raises(ValueError, match="RoPE table"):
        trope.assert_rope_table_covers(8, 9)


@pytest.mark.parametrize("window", [None, 3])
def test_make_causal_mask_matches_jax(window):
    want = jattn.make_causal_mask(4, 7, jnp.float32, window=window)
    got = tattn.make_causal_mask(4, 7, torch.float32, window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _qkv(rng, b, sq, skv, h, kvh, d):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, d)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, d)).astype(np.float32))


CASES = {
    "causal": dict(),
    "window": dict(window=3),
    "segments": dict(segments=True),
    "positions": dict(positions=True),
    "positions_window": dict(positions=True, window=4),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2)])
def test_reference_attention_matches_jax(case, h, kvh):
    opts = CASES[case]
    rng = np.random.default_rng(1)
    b, s, d = 2, 9, 8
    q, k, v = _qkv(rng, b, s, s, h, kvh, d)
    kw_j, kw_t = {}, {}
    if opts.get("window"):
        kw_j["window"] = kw_t["window"] = opts["window"]
    if opts.get("segments"):
        seg = np.array([[1, 1, 1, 2, 2, 2, 2, 0, 0], [1, 2, 2, 2, 3, 3, 3, 3, 3]],
                       np.int32)
        kw_j["segment_ids"], kw_t["segment_ids"] = jnp.asarray(seg), T(seg)
    if opts.get("positions"):
        # A decode-like query block at positions 5..6 over a 9-slot window.
        q = q[:, :2]
        qpos = np.array([[5, 6], [2, 3]], np.int32)
        kw_j["q_positions"], kw_t["q_positions"] = jnp.asarray(qpos), T(qpos)
    want = jattn.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True, **kw_j)
    got = tattn.reference_attention(T(q), T(k), T(v), causal=True, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_repeat_kv_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 3, 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(tattn.repeat_kv(T(x), 3).numpy(),
                                  np.asarray(jattn.repeat_kv(jnp.asarray(x), 3)))


def test_slot_mapping_matches_jax():
    """Real positions map to JAX's slots. Padding (position -1), which JAX
    maps one past the pool to be dropped, maps to slot 0 of the trash block
    here, so the write needs no mask."""
    bt = np.array([[3, 5, 1], [7, 2, 6]], np.int32)
    pos = np.array([[0, 3, 4, 9, -1], [11, 8, -1, -1, 2]], np.int32)
    want = np.asarray(jkv.slot_mapping(jnp.asarray(bt), jnp.asarray(pos), 4, 8))
    got = tkv.slot_mapping(T(bt), T(pos), 4).numpy()
    np.testing.assert_array_equal(got[pos >= 0], want[pos >= 0])
    assert (want[pos < 0] == 8 * 4).all() and (got[pos < 0] == 0).all()


def test_paged_update_and_gather_match_jax():
    """Writes land where JAX's land; position -1 writes, which JAX drops,
    land in the trash block 0 and nowhere else; the gathered window
    matches."""
    nb, bs, kvh, hd = 8, 4, 2, 4
    rng = np.random.default_rng(3)
    bt = np.array([[3, 5, 1], [7, 2, 6]], np.int32)
    pos = np.array([[0, 1, 2, 3, 4, -1], [0, 1, 2, -1, -1, -1]], np.int32)
    k_new = rng.standard_normal((2, 6, kvh, hd)).astype(np.float32)
    v_new = rng.standard_normal((2, 6, kvh, hd)).astype(np.float32)
    pool0 = rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32)

    jcache = {"k": jnp.asarray(pool0), "v": jnp.asarray(pool0)}
    jslots = jkv.slot_mapping(jnp.asarray(bt), jnp.asarray(pos), bs, nb)
    jcache = jkv.paged_update(jcache, jnp.asarray(k_new), jnp.asarray(v_new), jslots)

    tcache = tkv.init_paged_cache(1, nb, bs, kvh, hd, torch.float32)[0]
    tcache["k"].copy_(T(pool0))
    tcache["v"].copy_(T(pool0))
    tkv.paged_update(tcache, T(k_new), T(v_new), tkv.slot_mapping(T(bt), T(pos), bs))
    for name in ("k", "v"):
        np.testing.assert_array_equal(tcache[name].numpy()[1:],
                                      np.asarray(jcache[name])[1:])
    # Exactly the 5 + 3 real rows changed outside the trash block.
    changed = (tcache["k"].numpy()[1:] != pool0[1:]).any(axis=(2, 3)).sum()
    assert changed == 8

    jk, jv = jkv.paged_gather(jcache, jnp.asarray(bt))
    tk, tv = tkv.paged_gather(tcache, T(bt))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_bf16_pool_and_int8_pool():
    """Pool layouts, and the int8 pool's write and read against the JAX
    package's bit for bit: payloads and scales after ``paged_update``
    (position -1 in the trash block, which JAX drops), and the float32
    dequantized window of ``paged_gather``."""
    cache = tkv.init_paged_cache(2, 4, 2, 1, 8, torch.bfloat16)
    assert len(cache) == 2 and cache[0]["k"].dtype == torch.bfloat16
    assert tuple(cache[1]["v"].shape) == (4, 2, 1, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tkv.init_paged_cache(1, 4, 2, 1, 8, torch.float16)

    nb, bs, kvh, hd = 8, 4, 2, 16
    jcache = jkv.init_paged_cache(1, nb, bs, kvh, hd, "int8")[0]
    tcache = tkv.init_paged_cache(1, nb, bs, kvh, hd, "int8")[0]
    assert sorted(tcache) == sorted(jcache) == ["k", "k_scale", "v", "v_scale"]
    for name in tcache:
        assert tcache[name].dtype == {"k": torch.int8, "v": torch.int8}.get(
            name, torch.float32)
        np.testing.assert_array_equal(tcache[name].numpy(), np.asarray(jcache[name]))

    rng = np.random.default_rng(4)
    bt = np.array([[3, 5, 1], [7, 2, 6]], np.int32)
    pos = np.array([[0, 1, 2, 3, 4, -1], [0, 1, 2, -1, -1, -1]], np.int32)
    k_new = rng.standard_normal((2, 6, kvh, hd)).astype(np.float32)
    v_new = (3.0 * rng.standard_normal((2, 6, kvh, hd))).astype(np.float32)
    k_new[0, 2, 1] = 0.0  # an all-zero row: scale 1
    jslots = jkv.slot_mapping(jnp.asarray(bt), jnp.asarray(pos), bs, nb)
    jcache = jkv.paged_update(jcache, jnp.asarray(k_new), jnp.asarray(v_new), jslots)
    tkv.paged_update(tcache, T(k_new), T(v_new), tkv.slot_mapping(T(bt), T(pos), bs))
    for name in tcache:  # block 0 is the trash block: padding lands there
        np.testing.assert_array_equal(tcache[name].numpy()[1:],
                                      np.asarray(jcache[name])[1:])
    assert (tcache["k_scale"].numpy()[1:] != 0).any(axis=-1).sum() == 8  # 5 + 3 rows

    jk, jv = jkv.paged_gather(jcache, jnp.asarray(bt))
    tk, tv = tkv.paged_gather(tcache, T(bt))
    assert tk.dtype == tv.dtype == torch.float32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("scale", [1e-4, 1.0, 300.0])
def test_quantize_rows_matches_jax_bit_for_bit(scale):
    """Payloads and scales equal for random rows, a zero row, rows whose
    quotients land on .5 (half to even), and a single huge outlier."""
    rng = np.random.default_rng(5)
    x = (scale * rng.standard_normal((3, 5, 2, 64))).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 1, 0] = np.float32(scale) * (np.arange(64) - 31.5).astype(np.float32)
    x[2, 4, 1, 7] = 1e4 * scale
    jq, js = jkv._quantize_rows(jnp.asarray(x))
    tq, ts = tkv._quantize_rows(T(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0, 0] == 1.0 and int(tq.abs().max()) == 127
