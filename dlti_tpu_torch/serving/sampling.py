"""Token sampling with per-request parameters: the port of
``dlti_tpu/serving/sampling.py``.

One call handles the whole batch; every row carries its own temperature,
top-k and top-p. The vocabulary is sorted once (descending, stable, so ties
keep the lower token id first as ``lax.top_k`` does) and top-k/top-p become
rank and cumulative-probability masks in sorted space. A row with
``temperature == 0`` is greedy. The reported logprob is the chosen token's
under the unscaled, unmasked distribution (what the OpenAI API reports).

Random draws: each sampling row draws from its own ``torch.Generator``
seeded with that row's seed (Gumbel-max over the masked logits), so a
request's stream does not depend on what else shares the batch. The bits
differ from JAX's threefry draws; only the distribution is the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch


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


def sample_tokens(
    logits: torch.Tensor,
    seeds: Sequence[int],
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> tuple:
    """Sample one token per row.

    Args:
      logits: (batch, vocab) float32.
      seeds: one seed per row for that row's generator (read only for rows
        with ``temperature > 0``).
      temperature: (batch,) float32; 0 => greedy.
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

    rank = torch.zeros(b, dtype=torch.long, device=logits.device)  # greedy: rank 0
    rows = sampling.nonzero().flatten().tolist()
    if rows:
        u = torch.empty((len(rows), v), dtype=torch.float32, device=logits.device)
        for i, r in enumerate(rows):
            gen = torch.Generator(device=logits.device).manual_seed(int(seeds[r]))
            u[i].uniform_(generator=gen)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        rank[rows] = torch.argmax(masked[rows] + gumbel, dim=-1)

    tokens = torch.gather(sorted_idx, 1, rank[:, None])[:, 0]
    logz = torch.logsumexp(sorted_logits, dim=-1)
    chosen = torch.gather(sorted_logits, 1, rank[:, None])[:, 0]
    return tokens, chosen - logz
