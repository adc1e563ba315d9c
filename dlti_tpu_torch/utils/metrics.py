"""Training throughput formulas: the port of ``dlti_tpu/utils/metrics.py``'s
``training_flops_per_token`` and ``compute_mfu``.

The peak is the card's own: ``H100_BF16_PEAK_FLOPS`` is the H100 SXM's dense
bf16 tensor-core rate from NVIDIA's data sheet (at its 700 W limit).
"""

from __future__ import annotations

from typing import Optional

H100_BF16_PEAK_FLOPS = 989e12


def training_flops_per_token(num_params: int,
                             trainable_params: Optional[int] = None) -> float:
    """Approximate FLOPs per token of one train step: 6N for a full
    fine-tune (forward 2N, backward 4N); 4N under LoRA, whose backward skips
    the frozen weights' dW."""
    if trainable_params is not None and trainable_params < 0.5 * num_params:
        return 4.0 * num_params
    return 6.0 * num_params


def compute_mfu(tokens_per_second_per_chip: float, num_params: int,
                chip_peak_flops: float = H100_BF16_PEAK_FLOPS,
                trainable_params: Optional[int] = None) -> float:
    """Model FLOPs utilization in percent."""
    achieved = tokens_per_second_per_chip * training_flops_per_token(
        num_params, trainable_params)
    return 100.0 * achieved / chip_peak_flops
