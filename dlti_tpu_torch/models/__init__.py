"""Llama-family transformer, LoRA projections and weight interchange."""

from dlti_tpu_torch.models.llama import LlamaForCausalLM, LlamaModel  # noqa: F401
from dlti_tpu_torch.models.lora import (  # noqa: F401
    LoRADense, count_params, lora_param_mask, merge_lora_params,
)
from dlti_tpu_torch.models.interop import (  # noqa: F401
    init_params,
    load_model,
    params_from_jax,
    params_to_jax,
)
