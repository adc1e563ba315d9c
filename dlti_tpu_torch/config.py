"""Configuration: this package's copy of ``dlti_tpu/config.py``'s
``ModelConfig``, ``LoRAConfig``, ``MODEL_PRESETS`` and, for training,
``OptimizerConfig``, ``DataConfig``, ``CheckpointConfig``, ``TrainConfig``
and the root ``Config`` with its JSON form (``to_dict``/``from_dict``).

Field names, defaults and presets are the reference's, so a configuration
means the same thing in both packages. The training blocks carry the fields
the single-device LoRA path reads. Fields that select code the port has not
reached yet (mixture of experts, the other remat policies, the fp16 scaler,
the int8 frozen base) are kept for that parity; the modules that would read them
raise where the port stops. ``flash_block_q``/``flash_block_kv`` are the TPU
kernel's tiles: the CUDA flash kernels pick their own and do not read them.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    """Llama-family architecture hyperparameters."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32  # < num_heads => GQA
    head_dim: Optional[int] = None  # default hidden_size // num_heads
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attention_bias: bool = False        # Qwen2: bias on q/k/v (never o)
    sliding_window: Optional[int] = None  # Mistral: local attention window
    mlp_activation: str = "silu"        # "silu" | "gelu_tanh" | "gelu_exact"
    rmsnorm_offset: bool = False        # Gemma: normalize with (1 + weight)
    embedding_scale: bool = False       # Gemma: embed * sqrt(hidden_size)
    # Mixture of Experts: 0 = dense MLP (the only kind the port runs yet).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.02
    dtype: str = "bfloat16"        # compute dtype
    param_dtype: str = "bfloat16"  # storage dtype of the base params
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    remat_stride: int = 1
    attention_impl: str = "auto"  # "auto" | "reference" | "flash"
    flash_block_q: int = 512
    flash_block_kv: int = 512
    # Packed batches: an upper bound on any packed document's token count
    # (0 = unknown); with segment masking a window of this size is exact.
    packed_attention_window: int = 0
    # Serving decode over the paged cache: "auto" and "kernel" take the
    # paged decode kernel for one-token steps (its plain PyTorch version on
    # a CPU tensor); "gather" takes paged_gather + reference_attention.
    paged_attention_impl: str = "auto"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    def num_params(self, include_lm_head: bool = True) -> int:
        """Analytic parameter count of the dense model."""
        h, m, v = self.hidden_size, self.intermediate_size, self.vocab_size
        hd = self.resolved_head_dim
        attn = (h * self.num_heads * hd + 2 * h * self.num_kv_heads * hd
                + self.num_heads * hd * h)
        if self.attention_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        per_layer = attn + 3 * h * m + 2 * h
        total = v * h + self.num_layers * per_layer + h
        if include_lm_head and not self.tie_embeddings:
            total += h * v
        return total


@dataclass(frozen=True)
class LoRAConfig:
    """LoRA adapter config (the reference's ``LoRAConfig``): r=16, alpha=32,
    dropout 0.05 on the adapter input in training, on the q/k/v/o
    projections. Serving applies the adapter branch without dropout."""

    enabled: bool = True
    r: int = 16
    alpha: int = 32
    dropout: float = 0.05
    target_modules: tuple = ("q_proj", "k_proj", "v_proj", "o_proj")

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW + warmup schedule (the reference's ``OptimizerConfig``)."""

    learning_rate: float = 2e-4
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_steps: int = 100
    grad_clip: float = 1.0
    schedule: str = "warmup_constant"  # or "warmup_cosine"
    total_steps: int = 0  # used by cosine schedule; 0 = constant after warmup


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline config (the reference's ``DataConfig``, the fields the
    in-memory pipeline reads)."""

    dataset_path: str = "./data/glaive_code_full"
    tokenizer: str = "meta-llama/Llama-2-7b-hf"
    max_seq_len: int = 512  # the reference's truncation
    pack_sequences: bool = False
    shuffle_seed: int = 0


@dataclass(frozen=True)
class CheckpointConfig:
    """Checkpoint / resume policy (the reference's ``CheckpointConfig``):
    every ``save_steps`` steps keep the newest ``save_total_limit``, and
    resume from the newest checkpoint that verifies. Writes are async with
    a bounded retry; a save that fails is logged and training goes on.

    The defaults are the reference's, so a ``Trainer`` given no checkpoint
    config saves under, and resumes from, ``./checkpoints/run``."""

    output_dir: str = "./checkpoints/run"
    save_strategy: str = "steps"  # "steps" | "epoch" | "no"
    save_steps: int = 100
    save_total_limit: int = 3
    resume: bool = True
    async_save: bool = True
    save_retries: int = 3
    save_retry_backoff_s: float = 0.2


@dataclass(frozen=True)
class TrainConfig:
    """Training loop knobs (the reference's ``TrainConfig``): the fields
    of the single-device loop. ``eval_steps``: evaluate every so many steps
    (0 = never; at window boundaries, when a window crossed a multiple).
    ``loss_chunk``: the sequence-chunked loss (0 = off). ``steps_per_sync``:
    optimizer steps a host synchronisation. ``fp16`` and
    ``quantize_frozen_base`` are kept for parity and raise when set."""

    num_epochs: int = 1
    max_steps: int = 0  # 0 = derive from epochs * steps_per_epoch
    micro_batch_size: int = 1
    grad_accum_steps: int = 16
    logging_steps: int = 10
    seed: int = 42
    eval_steps: int = 0  # 0 = no eval
    fp16: bool = False
    loss_chunk: int = 0
    steps_per_sync: int = 1
    quantize_frozen_base: str = ""



MODEL_PRESETS: dict = {
    # Test-scale model: tiny but structurally identical (GQA, SwiGLU, RoPE).
    "llama_tiny": ModelConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, max_seq_len=128, remat=False,
        dtype="float32", param_dtype="float32",
    ),
    "llama_debug": ModelConfig(
        vocab_size=4096, hidden_size=256, intermediate_size=512, num_layers=4,
        num_heads=8, num_kv_heads=4, max_seq_len=512,
    ),
    "llama_300m": ModelConfig(
        vocab_size=32000, hidden_size=1024, intermediate_size=2816,
        num_layers=24, num_heads=16, num_kv_heads=16, max_seq_len=2048,
    ),
    "llama_1b": ModelConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_layers=22, num_heads=32, num_kv_heads=4, max_seq_len=2048,
    ),
    # Llama-2-7B (meta-llama/Llama-2-7b-hf).
    "llama2_7b": ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, num_kv_heads=32, max_seq_len=4096,
    ),
    "llama2_13b": ModelConfig(
        vocab_size=32000, hidden_size=5120, intermediate_size=13824,
        num_layers=40, num_heads=40, num_kv_heads=40, max_seq_len=4096,
    ),
    "llama3_8b": ModelConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=8192,
        rope_theta=500000.0,
    ),
    "mistral_7b": ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=8192,
        sliding_window=4096,
    ),
    "qwen2_7b": ModelConfig(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_layers=28, num_heads=28, num_kv_heads=4, max_seq_len=32768,
        rope_theta=1000000.0, attention_bias=True,
    ),
    "gemma_7b": ModelConfig(
        vocab_size=256000, hidden_size=3072, intermediate_size=24576,
        num_layers=28, num_heads=16, num_kv_heads=16, head_dim=256,
        max_seq_len=8192, rms_norm_eps=1e-6, tie_embeddings=True,
        mlp_activation="gelu_tanh", rmsnorm_offset=True, embedding_scale=True,
    ),
    "mixtral_8x7b": ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=8192,
        rope_theta=1000000.0, num_experts=8, num_experts_per_tok=2,
    ),
    "mixtral_tiny": ModelConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, max_seq_len=128, remat=False,
        dtype="float32", param_dtype="float32", num_experts=4,
        num_experts_per_tok=2,
    ),
}


_SECTIONS = {"model": ModelConfig, "lora": LoRAConfig,
             "optimizer": OptimizerConfig, "data": DataConfig,
             "checkpoint": CheckpointConfig, "train": TrainConfig}


@dataclass(frozen=True)
class Config:
    """Root config (the reference's ``Config``, without the blocks of code
    the port has not reached: parallel, telemetry, serving)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        """The sections as plain JSON values (tuples become lists), under
        the reference's names: the JAX package's ``Config.from_dict`` reads
        it back, taking its defaults for the sections the port lacks."""
        def convert(obj: Any) -> Any:
            if isinstance(obj, dict):
                return {k: convert(v) for k, v in obj.items()}
            if isinstance(obj, (tuple, list)):
                return [convert(v) for v in obj]
            return obj

        return convert(dataclasses.asdict(self))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """A config from :meth:`to_dict`'s form, or from the JAX package's
        (an export's ``config.json``). Sections and fields the port does not
        have are ignored, except in ``model``: a model field it does not
        know, or a mixture-of-experts model, raises, since the port cannot
        run that model."""
        model = d.get("model", {})
        known = {f.name for f in dataclasses.fields(ModelConfig)}
        unknown = sorted(set(model) - known)
        if unknown:
            raise ValueError(f"model config has fields the port does not know: "
                             f"{unknown}")
        if model.get("num_experts", 0) > 0:
            raise NotImplementedError("mixture-of-experts models are not ported "
                                      "yet (see ROADMAP.md)")
        kwargs = {}
        for name, section in _SECTIONS.items():
            if not isinstance(d.get(name), dict):
                continue
            fields = {f.name for f in dataclasses.fields(section)}
            kwargs[name] = section(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in d[name].items() if k in fields})
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))
