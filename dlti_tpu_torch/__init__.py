"""PyTorch / CUDA port of ``dlti_tpu`` for NVIDIA Hopper (H100).

The JAX package ``dlti_tpu`` stays the reference; this package mirrors its
module layout (``config``, ``ops``, ``models``, ``serving``, ``data``,
``training``, ``checkpoint``) so each
counterpart is found under the same name. It imports ``torch`` and numpy
only — never ``jax`` and nothing of ``dlti_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without an explicit device they raise.

Port so far: the paged-KV serving path (``serving.engine.InferenceEngine``
on float32, bfloat16 or int8 KV pools, behind the OpenAI server
``serving.server``, CLI ``python -m dlti_tpu_torch.cli.serve``) with the
paged decode attention, float and int8, as a hand-written CUDA kernel
(``ops.paged_attention``, source in ``csrc/paged_attention.cu``), and
single-device LoRA training (``training.Trainer``, CLI
``python -m dlti_tpu_torch.cli.train``) with flash attention forward and
backward as hand-written CUDA kernels (``ops.flash_attention``, source in
``csrc/flash_attention.cu``), and its checkpoints, verified resume and
merged export in the JAX package's on-disk format (``checkpoint``, CLI
``python -m dlti_tpu_torch.cli.export``; ``cli.serve --model-dir`` serves
an export), ZeRO-1/2/3 under the launcher (``parallel``, ``launcher``), and
the Quickstart chain: data prep into token stores (``data.streaming``, CLI
``cli.prepare_dataset``), an int8 frozen base and int8 serving weights
(``models.quantization``), the metrics CSV and step log
(``utils.metrics``, ``telemetry.steplog``), the comparison and the
experiment matrix (``analysis``, ``orchestration``, CLIs
``cli.compare_training`` and ``cli.run_experiments``), and the Mixtral
family: the routed-expert MLP (``models.moe``), trained and served on int8
weights (``models.init_params_int8``), and the ``expert`` mesh axis
(``parallel``).
"""

from dlti_tpu_torch.config import MODEL_PRESETS, LoRAConfig, ModelConfig

__all__ = ["MODEL_PRESETS", "LoRAConfig", "ModelConfig"]
