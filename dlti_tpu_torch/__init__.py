"""PyTorch / CUDA port of ``dlti_tpu`` for NVIDIA Hopper (H100).

The JAX package ``dlti_tpu`` stays the reference; this package mirrors its
module layout (``config``, ``ops``, ``models``, ``serving``) so each
counterpart is found under the same name. It imports ``torch`` and numpy
only — never ``jax`` and nothing of ``dlti_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without an explicit device they raise.

Port so far: the paged-KV serving path (``serving.engine.InferenceEngine``)
with the paged decode attention as a hand-written CUDA kernel
(``ops.paged_attention``, source in ``csrc/paged_attention.cu``).
"""

from dlti_tpu_torch.config import MODEL_PRESETS, LoRAConfig, ModelConfig

__all__ = ["MODEL_PRESETS", "LoRAConfig", "ModelConfig"]
