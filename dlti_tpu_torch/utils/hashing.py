"""The counter hash behind the port's random draws: sampling's Gumbel noise
(``serving.sampling``) and LoRA dropout's keep masks (``models.lora``).

A draw is a pure function of integers (a seed, a counter, an element's
index), computed with plain integer tensor ops on the tensor's device. So it
is the same bits on the CPU and on the card, it never reads a tensor back to
the host, and a CUDA graph that replays it with a new seed in a device
buffer draws new values. The bits differ from JAX's threefry draws; only
the distributions agree.
"""

from __future__ import annotations

from typing import TypeVar

import torch

MASK32 = 0xFFFFFFFF
# Multiplier of the 32-bit finalizer below; < 2**31, so a 32-bit lane times
# it stays inside int64 and no product overflows.
_MIX32 = 0x045D9F3B

IntOrTensor = TypeVar("IntOrTensor", int, torch.Tensor)


def mix32(x: IntOrTensor) -> IntOrTensor:
    """A bijective 32-bit integer hash of ``x``: a Python int or an int64
    tensor holding values in [0, 2**32). Every shift acts on a non-negative
    value, so torch's arithmetic ``>>`` is the logical one, and an int and a
    tensor holding the same value hash to the same value."""
    x = ((x >> 16) ^ x) * _MIX32 & MASK32
    x = ((x >> 16) ^ x) * _MIX32 & MASK32
    return (x >> 16) ^ x


def fold_seed(seed: IntOrTensor) -> IntOrTensor:
    """A seed (a Python int, or an int64 tensor of seeds) as a 32-bit key:
    both 32-bit halves of its low 64 bits mixed in."""
    k = mix32((seed & MASK32) ^ 0x9E3779B9)
    return mix32(k ^ ((seed >> 32) & MASK32))
