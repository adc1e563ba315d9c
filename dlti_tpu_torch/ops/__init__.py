"""Compute ops: RoPE, reference attention and its dispatch to flash
attention (forward and backward kernels), the paged KV cache and the paged
decode attention kernel."""

from dlti_tpu_torch.ops.rope import apply_rope, rope_frequencies  # noqa: F401
from dlti_tpu_torch.ops.attention import reference_attention  # noqa: F401
