"""Token sampling with per-request parameters: the port of
``dlti_tpu/serving/sampling.py``.

One call handles the whole batch; every row carries its own temperature,
top-k and top-p. The vocabulary is sorted once (descending, stable, so ties
keep the lower token id first as ``lax.top_k`` does) and top-k/top-p become
rank and cumulative-probability masks in sorted space. A row with
``temperature == 0`` is greedy. The reported logprob is the chosen token's
under the unscaled, unmasked distribution (what the OpenAI API reports).

Random draws are Gumbel-max over the masked logits, with each uniform a
counter-based hash (``utils.hashing``) of (the slot's seed, its
generated-token count, the vocabulary index) in plain integer tensor ops on
the logits' device. A seeded stream therefore depends on (seed, count) alone: not on batch
company, preemption or the decode window, and it is the same bits on the
CPU and on the card. Nothing here reads a tensor back to the host, so a
sampling step never waits on the device and can be captured in a CUDA
graph. The bits differ from JAX's threefry draws; only the distribution is
the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from dlti_tpu_torch.utils.hashing import MASK32, fold_seed, mix32


@dataclass
class SamplingParams:
    """Per-request sampling knobs (OpenAI API semantics)."""

    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled (full vocab)
    top_p: float = 1.0
    max_tokens: int = 128
    stop_token_ids: Sequence[int] = field(default_factory=tuple)
    # Fixes the request's own draw stream whatever else shares the batch.
    seed: Optional[int] = None
    logprobs: bool = False

    def greedy(self) -> bool:
        return self.temperature == 0.0


def draw_keys(seeds: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Per-row 32-bit key of the ``counts``-th draw of each slot ``seeds``
    stream: the role ``jax.random.fold_in(key, count)`` plays in the
    reference."""
    return mix32(fold_seed(seeds.long()) ^ (counts.long() & MASK32))


def gumbel_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """(rows, vocab) float32 Gumbel noise, entry ``[r, v]`` a function of
    ``(keys[r], v)`` only. The uniform is the hash's 24 high bits plus one
    half over 2**24: strictly inside (0, 1), exact in float64."""
    v = torch.arange(vocab, device=keys.device)
    h = mix32(keys[:, None] ^ mix32(v ^ 0x85EBCA6B)[None, :])
    u = ((h >> 8).double() + 0.5) * 2.0 ** -24
    return (-torch.log(-torch.log(u))).float()


def sample_tokens(
    logits: torch.Tensor,
    seeds: torch.Tensor,
    counts: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> tuple:
    """Sample one token per row.

    Args:
      logits: (batch, vocab) float32.
      seeds: (batch,) int64, each row's stream seed.
      counts: (batch,) int, tokens the row has generated so far (which draw
        of its stream this is).
      temperature: (batch,) float32; 0 => greedy (the same code runs, and
        the row takes rank 0).
      top_k: (batch,) int; 0 => disabled.
      top_p: (batch,) float32; 1.0 => disabled.

    Returns (tokens (batch,) int64, logprobs (batch,) float32).
    """
    b, v = logits.shape
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, descending=True,
                                           stable=True)
    sampling = temperature > 0
    safe_t = torch.where(sampling, temperature, 1.0)[:, None]
    scaled = sorted_logits / safe_t

    ranks = torch.arange(v, device=logits.device)[None, :]
    k = torch.where(top_k > 0, top_k, v).long()[:, None]
    keep = ranks < k
    probs = torch.softmax(scaled, dim=-1)
    # Keep tokens while the probability mass before them is < top_p (the
    # head token always stays).
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep &= cum_before < top_p[:, None]
    masked = torch.where(keep, scaled, float("-inf"))

    # Noise by token id, moved into sorted order; greedy rows take rank 0.
    noise = torch.gather(gumbel_noise(draw_keys(seeds, counts), v), 1, sorted_idx)
    drawn = torch.argmax(masked + noise, dim=-1)
    rank = torch.where(sampling, drawn, 0)

    tokens = torch.gather(sorted_idx, 1, rank[:, None])[:, 0]
    logz = torch.logsumexp(sorted_logits, dim=-1)
    chosen = torch.gather(sorted_logits, 1, rank[:, None])[:, 0]
    return tokens, chosen - logz
