"""Configuration: this package's copy of ``dlti_tpu/config.py``'s
``ModelConfig``, ``LoRAConfig``, ``MODEL_PRESETS`` and, for training,
``OptimizerConfig``, ``ZeROStage``, ``ParallelConfig``, ``DataConfig``,
``CheckpointConfig``, ``TrainConfig``, for serving ``GatewayConfig`` and
``ReplicaLifecycleConfig`` (under ``ServingConfig``), the root ``Config`` with its JSON form
(``to_dict``/``from_dict``) and the strategy presets (:func:`preset`).

Field names, defaults and presets are the reference's, so a configuration
means the same thing in both packages. The training blocks carry the fields
the single-device LoRA path reads. Fields that select code the port has not
reached yet (the other remat policies) are kept for that parity; the
modules that would read them raise where the port stops. ``flash_block_q``/``flash_block_kv`` are the TPU
kernel's tiles: the CUDA flash kernels pick their own and do not read them.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import re
from dataclasses import dataclass, field
from typing import Any, Optional


class ZeROStage(enum.IntEnum):
    """ZeRO stage (the reference's): ``NONE`` replicated data parallelism
    (the baseline); ``ZERO1`` optimizer state sharded over ``data``;
    ``ZERO2`` gradients reduce-scattered to those shards too; ``ZERO3``
    parameters sharded over ``fsdp`` and gathered at use, with optional host
    offload (``configs/ds_config_zero{1,2,3}.json``)."""

    NONE = 0
    ZERO1 = 1
    ZERO2 = 2
    ZERO3 = 3


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
    # Mixture of Experts: 0 = dense MLP; > 0 routes each token to the top
    # num_experts_per_tok of num_experts SwiGLU experts (models.moe).
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
        """Analytic parameter count (for MFU and reporting)."""
        return self._count_params(include_lm_head, active_only=False)

    def num_active_params(self, include_lm_head: bool = True) -> int:
        """Parameters a token touches: :meth:`num_params` for a dense model;
        for a mixture of experts, k routed experts instead of all E (the
        count that drives FLOPs a token and MFU)."""
        return self._count_params(include_lm_head, active_only=True)

    def _count_params(self, include_lm_head: bool, active_only: bool) -> int:
        h, m, v = self.hidden_size, self.intermediate_size, self.vocab_size
        hd = self.resolved_head_dim
        attn = (h * self.num_heads * hd + 2 * h * self.num_kv_heads * hd
                + self.num_heads * hd * h)
        if self.attention_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        if self.num_experts > 0:
            n_ffn = self.num_experts_per_tok if active_only else self.num_experts
            mlp = n_ffn * 3 * h * m + h * self.num_experts  # experts + router
        else:
            mlp = 3 * h * m
        per_layer = attn + mlp + 2 * h
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
class ParallelConfig:
    """Mesh shape and strategy (the reference's ``ParallelConfig``, every
    field and default). The port runs all six axes, one process per device
    (``parallel.mesh``): ``data`` (DP, ZeRO-1/2), ``fsdp`` (ZeRO-3),
    ``tensor``, ``sequence`` (ring attention), ``pipe`` (GPipe stages) and
    ``expert`` (a mixture of experts' expert weights split over it); the
    combinations it does not run raise (``parallel.mesh.check_strategy``).
    ``offload_optimizer`` keeps the optimizer moments, ``offload_params``
    the frozen base, in pinned host memory
    (``configs/ds_config_zero3.json:19-27``)."""

    zero_stage: ZeROStage = ZeROStage.NONE
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    pipe: int = 1
    expert: int = 1
    offload_optimizer: bool = False
    offload_params: bool = False

    @property
    def num_devices(self) -> int:
        return (self.data * self.fsdp * self.tensor * self.sequence
                * self.pipe * self.expert)

    @property
    def dp_like_size(self) -> int:
        """Total batch-sharding degree (data * fsdp axes both carry batch)."""
        return self.data * self.fsdp


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline config (the reference's ``DataConfig``, the fields the
    in-memory pipeline reads)."""

    dataset_path: str = "./data/glaive_code_full"
    tokenizer: str = "meta-llama/Llama-2-7b-hf"
    max_seq_len: int = 512  # the reference's truncation
    pack_sequences: bool = False
    shuffle_seed: int = 0
    # Batches the trainer's prefetch thread prepares ahead of the step
    # (data.prefetch.HostPrefetcher); 0 reads them on the training thread.
    prefetch_depth: int = 2


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
    optimizer steps a host synchronisation. ``fp16`` turns on DeepSpeed's
    dynamic loss scaler (the reference's fp16 block,
    ``configs/ds_config_zero1.json``: initial scale 2^16, window 1000,
    hysteresis 2, min scale 1); pair it with a model whose ``dtype`` and
    ``param_dtype`` are ``"float16"``. ``quantize_frozen_base="int8"``
    keeps the frozen base as int8 weights with per-channel scales
    (``models.quantization``; LoRA only). ``metrics_csv``: rank 0 appends
    the run's reference-schema row there at the end of ``Trainer.train``
    (``utils.metrics.save_training_metrics``); the reference's default is
    ``results/training_metrics.csv``, which ``cli.train --metrics-csv``
    keeps, and the library writes none unless given a path (its tests and
    callers would otherwise append to the working directory).
    ``step_log_path``: rank 0's per-step JSONL stream
    (``telemetry.steplog``), the reference's ``telemetry.step_log_path``."""

    num_epochs: int = 1
    max_steps: int = 0  # 0 = derive from epochs * steps_per_epoch
    micro_batch_size: int = 1
    grad_accum_steps: int = 16
    logging_steps: int = 10
    seed: int = 42
    eval_steps: int = 0  # 0 = no eval
    fp16: bool = False
    fp16_initial_scale_power: int = 16
    fp16_scale_window: int = 1000
    fp16_hysteresis: int = 2
    fp16_min_scale: float = 1.0
    loss_chunk: int = 0
    steps_per_sync: int = 1
    quantize_frozen_base: str = ""
    metrics_csv: str = ""
    step_log_path: str = ""



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


@dataclass(frozen=True)
class GatewayConfig:
    """Admission gateway (``serving.gateway``): the scheduling front end
    between the HTTP layer and the engine(s). Disabled by default: the
    server then admits directly into the engine."""

    enabled: bool = False
    # Bounded admission queue: overflow is refused with HTTP 429 and a
    # Retry-After. 0 queued tokens = no token bound (the request-count bound
    # still applies).
    max_queued_requests: int = 256
    max_queued_tokens: int = 0
    # Per-tenant token-bucket rate limit (requests/s, sustained). 0 = off.
    # Burst is the bucket's capacity; 0 derives max(1, 2 * rps).
    rate_limit_rps: float = 0.0
    rate_limit_burst: float = 0.0
    # Weighted fair dequeue across tenants: "tenantA:4,tenantB:1" gives
    # tenantA 4x tenantB's dequeue share under contention. Unlisted tenants
    # weigh 1.
    tenant_weights: str = ""
    default_tenant: str = "default"
    # Tenant -> LoRA adapter routing ("tenantA:ad1,tenantB:ad2") for
    # requests that carry no X-Adapter header ("" = no mapping).
    adapter_map: str = ""
    # Retry-After (seconds) of queue-bound refusals (rate-limit refusals
    # derive theirs from the bucket's deficit).
    retry_after_s: float = 1.0
    # Replica failover: how many times one request may be resubmitted onto
    # a surviving replica after its replica's step faulted.
    max_retries: int = 2
    # Cache-affinity routing (serving.replicas): send each request to its
    # sticky rendezvous-hash replica (key: the X-Session header, else a
    # digest of the first affinity_prefix_tokens prompt ids); spill
    # least-loaded when the sticky replica's backlog exceeds its decode
    # slots by more than affinity_spill_threshold.
    affinity: bool = False
    affinity_spill_threshold: int = 4
    affinity_prefix_tokens: int = 32
    # Graceful drain: seconds SIGTERM waits for in-flight requests before
    # the server exits anyway.
    drain_grace_s: float = 30.0
    # Chaos hook "REPLICA:STEP[:MODE]": fail replica REPLICA at its STEP-th
    # step() (1-based). MODE "raise" (default) raises in place of a device
    # fault; "nan-logits" poisons the replica's weights with NaN so the
    # engine's numeric guard trips; "preempt" drains the replica by live KV
    # migration. Also settable through DLTI_GATEWAY_FAULT_INJECT.
    fault_inject_step: str = ""


@dataclass(frozen=True)
class ReplicaLifecycleConfig:
    """Serving replica self-healing (``serving.lifecycle``): a faulted
    replica is quarantined, its engine rebuilt from known-good weights and
    reinstated after a passing canary probe, with exponential probation
    backoff and a flap breaker (too many quarantines inside a window evict
    it for good). Off by default: a faulted replica then stays dead."""

    enabled: bool = False
    # Probation before the first probe, and the backoff per failed probe
    # (delay = initial * backoff**fails, capped at max).
    probation_initial_s: float = 2.0
    probation_backoff: float = 2.0
    probation_max_s: float = 60.0
    # Canary probe: a short greedy generation on the rebuilt replica,
    # checked against a digest pinned at fleet construction (and re-pinned
    # by a weight reload).
    canary_prompt_tokens: int = 8
    canary_max_tokens: int = 4
    # Flap breaker: more than flap_max_cycles quarantines within
    # flap_window_s seconds evict the replica permanently.
    flap_window_s: float = 300.0
    flap_max_cycles: int = 3


@dataclass(frozen=True)
class ServingConfig:
    """The serving blocks above the engine (the reference's
    ``ServingConfig``, with the blocks the port has: the gateway and the
    replica lifecycle)."""

    gateway: GatewayConfig = field(default_factory=GatewayConfig)
    lifecycle: ReplicaLifecycleConfig = field(default_factory=ReplicaLifecycleConfig)


_SECTIONS = {"model": ModelConfig, "lora": LoRAConfig,
             "optimizer": OptimizerConfig, "parallel": ParallelConfig,
             "data": DataConfig,
             "checkpoint": CheckpointConfig, "train": TrainConfig}


@dataclass(frozen=True)
class Config:
    """Root config (the reference's ``Config``, without the blocks of code
    the port has not reached: telemetry, and the serving blocks other than
    the gateway and the replica lifecycle)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    experiment_name: str = ""

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
            if isinstance(obj, enum.Enum):
                return obj.value
            return obj

        return convert(dataclasses.asdict(self))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """A config from :meth:`to_dict`'s form, or from the JAX package's
        (an export's ``config.json``). Sections and fields the port does not
        have are ignored, except in ``model``: a model field it does not
        know raises, since the port cannot run that model."""
        model = d.get("model", {})
        known = {f.name for f in dataclasses.fields(ModelConfig)}
        unknown = sorted(set(model) - known)
        if unknown:
            raise ValueError(f"model config has fields the port does not know: "
                             f"{unknown}")
        kwargs = {}
        for name, section in _SECTIONS.items():
            if not isinstance(d.get(name), dict):
                continue
            fields = {f.name for f in dataclasses.fields(section)}
            kwargs[name] = section(**{
                k: ZeROStage(v) if k == "zero_stage" else
                tuple(v) if isinstance(v, list) else v
                for k, v in d[name].items() if k in fields})
        serving = d.get("serving")
        if isinstance(serving, dict):
            kwargs["serving"] = ServingConfig(**{
                name: section(**{k: v for k, v in serving[name].items()
                                 if k in {f.name for f in dataclasses.fields(section)}})
                for name, section in (("gateway", GatewayConfig),
                                      ("lifecycle", ReplicaLifecycleConfig))
                if isinstance(serving.get(name), dict)})
        if isinstance(d.get("experiment_name"), str):
            kwargs["experiment_name"] = d["experiment_name"]
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))


def preset(name: str, **overrides: Any) -> Config:
    """A :class:`Config` from a strategy preset name (the reference's
    ``preset``): ``baseline`` or ``zero{1,2,3}[_Ndev]``. ZeRO-3 puts the
    extent on ``fsdp``, ZeRO-1/2 on ``data``; ``model`` may be a preset
    name. ``preset("zero3_4dev").parallel.fsdp == 4``."""
    model = overrides.pop("model", MODEL_PRESETS["llama2_7b"])
    if isinstance(model, str):
        model = MODEL_PRESETS[model]
    if name == "baseline":
        par = ParallelConfig(zero_stage=ZeROStage.NONE)
    else:
        m = re.fullmatch(r"zero([123])(?:_(\d+)dev)?", name)
        if not m:
            raise ValueError(f"unknown preset {name!r}; expected 'baseline' or "
                             f"'zero{{1,2,3}}[_Ndev]'")
        stage = ZeROStage(int(m.group(1)))
        n = int(m.group(2) or 1)
        par = (ParallelConfig(zero_stage=stage, fsdp=n) if stage == ZeROStage.ZERO3
               else ParallelConfig(zero_stage=stage, data=n))
    return Config(model=model, parallel=par, experiment_name=name, **overrides)
