"""The port's ``sample_tokens`` against the JAX package's (CPU).

Greedy rows are deterministic, so tokens and logprobs are compared directly
(logprobs within 1e-6: the same float32 logsumexp). Random draws differ by
construction (torch's generators vs JAX's threefry), so the sampled rows
are compared by what they may return: the support kept by top-k/top-p, and
the distribution over it (a chi-square test on many draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlti_tpu.serving.sampling import sample_tokens as jax_sample_tokens
from dlti_tpu_torch.serving.sampling import sample_tokens

T = torch.from_numpy


def _row_params(n, temperature, top_k, top_p):
    return (np.full((n,), temperature, np.float32),
            np.full((n,), top_k, np.int32),
            np.full((n,), top_p, np.float32))


def _draw_jax(logits_row, n, temperature, top_k, top_p, seed=0):
    logits = jnp.asarray(np.repeat(logits_row[None], n, axis=0))
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    t, k, p = _row_params(n, temperature, top_k, top_p)
    toks, _ = jax_sample_tokens(logits, keys, jnp.asarray(t), jnp.asarray(k),
                                jnp.asarray(p))
    return np.asarray(toks)


def _draw_torch(logits_row, n, temperature, top_k, top_p, seed=0):
    logits = T(np.repeat(logits_row[None], n, axis=0))
    t, k, p = _row_params(n, temperature, top_k, top_p)
    toks, _ = sample_tokens(logits, [seed * n + i for i in range(n)],
                            T(t), T(k), T(p))
    return toks.numpy()


def _masked_probs(logits_row, temperature, top_k, top_p):
    """The masked softmax both packages sample from, in numpy."""
    order = np.argsort(-logits_row, kind="stable")
    scaled = logits_row[order].astype(np.float64) / temperature
    probs = np.exp(scaled - scaled.max())
    probs /= probs.sum()
    keep = np.arange(len(order)) < (top_k or len(order))
    keep &= (np.cumsum(probs) - probs) < top_p
    out = np.zeros(len(order))
    out[order[keep]] = probs[keep] / probs[keep].sum()
    return out


def test_greedy_tokens_and_logprobs_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 512)).astype(np.float32) * 3
    logits[3, [7, 9]] = logits[3].max() + 1.0  # a tie: lower id wins in both
    t, k, p = (np.zeros((5,), np.float32), np.array([0, 5, 0, 1, 40], np.int32),
               np.array([1.0, 1.0, 0.3, 0.9, 0.5], np.float32))
    want_tok, want_lp = jax_sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0),
                                          jnp.asarray(t), jnp.asarray(k), jnp.asarray(p))
    got_tok, got_lp = sample_tokens(T(logits), [0] * 5, T(t), T(k), T(p))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-6, rtol=0)
    assert got_tok[3].item() == 7


def test_sampled_logprob_is_under_the_unscaled_distribution():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 64)).astype(np.float32)
    t, k, p = _row_params(3, 0.7, 8, 0.9)
    toks, lps = sample_tokens(T(logits), [1, 2, 3], T(t), T(k), T(p))
    logz = torch.logsumexp(T(logits), dim=-1)
    want = T(logits)[torch.arange(3), toks] - logz
    np.testing.assert_allclose(lps.numpy(), want.numpy(), atol=1e-6, rtol=0)


SUPPORT_CASES = {
    "top_k": (1.0, 5, 1.0),
    "top_p": (1.0, 0, 0.6),
    "top_k_top_p_hot": (1.7, 9, 0.8),
    "full": (0.8, 0, 1.0),
}


@pytest.mark.parametrize("case", list(SUPPORT_CASES))
def test_support_kept_by_top_k_top_p_matches_jax(case):
    """With 2000 draws over a 16-token vocabulary every kept token (p >=
    ~0.01 here) shows up in both packages; nothing outside shows up."""
    temperature, top_k, top_p = SUPPORT_CASES[case]
    row = np.random.default_rng(2).standard_normal(16).astype(np.float32)
    want = set(_draw_jax(row, 2000, temperature, top_k, top_p).tolist())
    got = set(_draw_torch(row, 2000, temperature, top_k, top_p).tolist())
    assert got == want
    assert got == set(np.nonzero(_masked_probs(row, temperature, top_k, top_p))[0])


def test_seeded_draws_are_reproducible():
    row = np.random.default_rng(3).standard_normal((4, 128)).astype(np.float32)
    t, k, p = _row_params(4, 1.0, 0, 1.0)
    a, _ = sample_tokens(T(row), [11, 12, 13, 14], T(t), T(k), T(p))
    b, _ = sample_tokens(T(row), [11, 12, 13, 14], T(t), T(k), T(p))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    # Each row's draw depends on its own seed only, not on its neighbours.
    c, _ = sample_tokens(T(row[2:3]), [13], T(t[:1]), T(k[:1]), T(p[:1]))
    assert c.item() == a[2].item()


@pytest.mark.parametrize("case", ["top_k_top_p_hot", "full"])
def test_draw_distribution_matches_masked_softmax(case):
    """Chi-square goodness of fit of 6000 seeded draws against the masked
    softmax. The statistic's 99.9% quantile bounds it; the seeds are fixed,
    so the outcome is too."""
    from scipy.stats import chi2

    temperature, top_k, top_p = SUPPORT_CASES[case]
    row = np.random.default_rng(4).standard_normal(16).astype(np.float32)
    probs = _masked_probs(row, temperature, top_k, top_p)
    n = 6000
    counts = np.bincount(_draw_torch(row, n, temperature, top_k, top_p, seed=5),
                         minlength=16)
    kept = probs > 0
    assert counts[~kept].sum() == 0
    expected = n * probs[kept]
    stat = ((counts[kept] - expected) ** 2 / expected).sum()
    assert stat < chi2.ppf(0.999, kept.sum() - 1)
