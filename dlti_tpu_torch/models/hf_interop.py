"""Hugging Face checkpoints in and out: the port of
``dlti_tpu/models/hf_interop.py`` on this package's ``{name: tensor}``
parameter dicts.

* :func:`load_hf_checkpoint` / :func:`save_hf_checkpoint` — a whole model
  in HF Llama layout (``config.json`` plus ``model.safetensors``, or shards
  of at most 4 GiB with ``model.safetensors.index.json``), read and written
  through the package's own safetensors codec (``utils.safetensors``).
* :func:`load_peft_adapter` / :func:`save_peft_adapter` — PEFT LoRA
  adapters (``adapter_model.safetensors`` + ``adapter_config.json``) to and
  from the ``lora_a``/``lora_b`` leaves.
* :func:`config_from_hf` / :func:`config_to_hf` — ``config.json`` to and
  from :class:`~dlti_tpu_torch.config.ModelConfig` (llama, mistral, qwen2
  and gemma; MoE and per-layer windows raise by name).
* :func:`graft_base_params` — loaded base weights over a fresh tree whose
  LoRA factors keep their initialization (PEFT's ``get_peft_model`` on a
  pretrained model).

Names (HF stores ``(out, in)`` weights; this package's kernels are
``(in, out)``, as the JAX tree's, so each is transposed once):

====================================================  ==============================================
HF key                                                this package's name
====================================================  ==============================================
``model.embed_tokens.weight``                         ``model.embed_tokens``
``model.layers.{i}.self_attn.{q,k,v,o}_proj.weight``  ``model.layers.{i}.attn.*.kernel`` (T)
``model.layers.{i}.self_attn.{q,k,v}_proj.bias``      ``model.layers.{i}.attn.*.bias``
``model.layers.{i}.mlp.{gate,up,down}_proj.weight``   ``model.layers.{i}.mlp.*.kernel`` (T)
``model.layers.{i}.input_layernorm.weight``           ``model.layers.{i}.input_norm.scale``
``model.layers.{i}.post_attention_layernorm.weight``  ``model.layers.{i}.post_attn_norm.scale``
``model.norm.weight``                                 ``model.final_norm.scale``
``lm_head.weight``                                    ``lm_head`` (T; absent when tied)
====================================================  ==============================================

q and k need no RoPE permutation: the rotary layout is HF's (the JAX
mapping has none either).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from dlti_tpu_torch.config import LoRAConfig, ModelConfig
from dlti_tpu_torch.models.lora import is_lora_name
from dlti_tpu_torch.utils import durable_io
from dlti_tpu_torch.utils.device import resolve_device, resolve_dtype
from dlti_tpu_torch.utils.safetensors import load_file, save_file

_ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP_PROJS = ("gate_proj", "up_proj", "down_proj")
SINGLE_FILE = "model.safetensors"
INDEX_FILE = "model.safetensors.index.json"
PEFT_WEIGHTS = "adapter_model.safetensors"
PEFT_CONFIG = "adapter_config.json"
_PEFT_PREFIX = "base_model.model."


# ----------------------------------------------------------------------
# config.json <-> ModelConfig
# ----------------------------------------------------------------------

def config_from_hf(hf: Mapping[str, Any], **overrides) -> ModelConfig:
    """A :class:`ModelConfig` from an HF ``config.json`` dict; the
    ``overrides`` replace fields after the mapping."""
    num_heads = hf.get("num_attention_heads", 32)
    kw: Dict[str, Any] = dict(
        vocab_size=hf.get("vocab_size", 32000),
        hidden_size=hf.get("hidden_size", 4096),
        intermediate_size=hf.get("intermediate_size", 11008),
        num_layers=hf.get("num_hidden_layers", 32),
        num_heads=num_heads,
        num_kv_heads=hf.get("num_key_value_heads", num_heads),
        head_dim=hf.get("head_dim"),
        max_seq_len=hf.get("max_position_embeddings", 4096),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
    )
    torch_dtype = hf.get("torch_dtype")
    if torch_dtype in ("float32", "float16", "bfloat16"):
        kw["param_dtype"] = torch_dtype
        if torch_dtype == "float32":
            kw["dtype"] = "float32"
    model_type = hf.get("model_type", "llama")
    moe = ("mixture-of-experts checkpoints have no Hugging Face mapping (the "
           "reference maps the dense families only)")
    experts = hf.get("num_local_experts") or hf.get("num_experts")
    if model_type not in ("llama", "mistral", "qwen2", "gemma"):
        # A family without forward parity here (gemma2's softcapping, phi's
        # partial rotary, the MoE families) must fail, not load as a
        # subtly different model: the reference's error, naming MoE.
        raise NotImplementedError(f"model_type {model_type!r} not supported "
                                  f"(llama/mistral/qwen2/gemma)"
                                  + (f": {moe}" if experts else ""))
    if experts:
        raise NotImplementedError(moe)
    if model_type == "gemma":
        kw["rmsnorm_offset"] = True
        kw["embedding_scale"] = True
        kw["tie_embeddings"] = bool(hf.get("tie_word_embeddings", True))
    if hf.get("attention_bias") or model_type == "qwen2":
        kw["attention_bias"] = True
    if hf.get("sliding_window"):
        if model_type == "qwen2":
            # Qwen2 windows only layers >= max_window_layers, and only with
            # use_sliding_window: all or nothing is what runs here.
            if hf.get("use_sliding_window", False):
                mwl = hf.get("max_window_layers", kw["num_layers"])
                if mwl is None or mwl <= 0:
                    kw["sliding_window"] = int(hf["sliding_window"])
                elif mwl < kw["num_layers"]:
                    raise NotImplementedError(
                        "per-layer sliding window (qwen2 max_window_layers="
                        f"{mwl} of {kw['num_layers']}) is not supported; "
                        "only uniform windows")
        elif hf.get("use_sliding_window", True):
            kw["sliding_window"] = int(hf["sliding_window"])
    # transformers' Gemma reads hidden_activation and maps a missing one
    # (and the legacy "gelu") to gelu_pytorch_tanh.
    if model_type == "gemma":
        act = hf.get("hidden_activation") or "gelu_pytorch_tanh"
    else:
        act = hf.get("hidden_activation") or hf.get("hidden_act", "silu")
    kw["mlp_activation"] = {
        "silu": "silu", "gelu": "gelu_exact",
        "gelu_pytorch_tanh": "gelu_tanh", "gelu_new": "gelu_tanh",
    }.get(act)
    if kw["mlp_activation"] is None:
        raise NotImplementedError(f"unsupported hidden_act {act!r}")
    kw.update(overrides)
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unsupported = sorted(set(kw) - known)
    if unsupported:
        raise NotImplementedError(f"checkpoint needs ModelConfig fields not yet "
                                  f"supported: {unsupported}")
    return ModelConfig(**kw)


def config_to_hf(cfg: ModelConfig) -> Dict[str, Any]:
    """An HF ``config.json`` dict for ``cfg``, whose ``model_type`` names a
    transformers class that honours its features (qwen2: q/k/v bias;
    mistral: a window; gemma: the offset norm). A mixture of experts has
    no mapping, as in the reference, and raises."""
    if cfg.num_experts > 0:
        raise NotImplementedError("mixture-of-experts models have no Hugging Face "
                                  "mapping (the reference maps the dense families only)")
    if cfg.rmsnorm_offset:
        model_type, arch = "gemma", "GemmaForCausalLM"
    elif cfg.attention_bias:
        model_type, arch = "qwen2", "Qwen2ForCausalLM"
    elif cfg.sliding_window:
        model_type, arch = "mistral", "MistralForCausalLM"
    else:
        model_type, arch = "llama", "LlamaForCausalLM"
    act = {"silu": "silu", "gelu_exact": "gelu",
           "gelu_tanh": "gelu_pytorch_tanh"}[cfg.mlp_activation]
    out = {
        "architectures": [arch],
        "model_type": model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.resolved_head_dim,
        "max_position_embeddings": cfg.max_seq_len,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "hidden_act": act,
        "hidden_activation": act,  # what transformers' Gemma reads
        "torch_dtype": {"bfloat16": "bfloat16", "float16": "float16",
                        "float32": "float32"}[cfg.param_dtype],
    }
    if cfg.attention_bias:
        out["attention_bias"] = True
    if cfg.sliding_window:
        out["sliding_window"] = cfg.sliding_window
        # Qwen2 reads the window only with the flag, and from layer
        # max_window_layers on: 0 windows every layer.
        out["use_sliding_window"] = True
        out["max_window_layers"] = 0
    return out


# ----------------------------------------------------------------------
# state dicts
# ----------------------------------------------------------------------

def params_from_hf_state_dict(state_dict: Mapping[str, torch.Tensor],
                              cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """An HF state dict as this package's parameters, in
    ``cfg.param_dtype`` on the tensors' device. Raises ``KeyError`` for a
    missing weight and ``ValueError`` for one left over, so an architecture
    mismatch never loads quietly."""
    return _map_state_dict(dict(state_dict), cfg)


def _map_state_dict(sd: Dict[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """:func:`params_from_hf_state_dict`, popping each entry of ``sd`` as it
    is mapped, so a source is freed as its copy is made."""
    dt = resolve_dtype(cfg.param_dtype)

    def take(key: str, transpose: bool = False) -> torch.Tensor:
        w = sd.pop(key)
        if transpose:
            w = w.t()
        return w.to(dt).contiguous()

    out: Dict[str, torch.Tensor] = {"model.embed_tokens": take("model.embed_tokens.weight")}
    for i in range(cfg.num_layers):
        hf_l, ours = f"model.layers.{i}", f"model.layers.{i}"
        for p in _ATTN_PROJS:
            out[f"{ours}.attn.{p}.kernel"] = take(f"{hf_l}.self_attn.{p}.weight",
                                                  transpose=True)
            # Biases load iff the config declares them: declared but absent
            # raises KeyError here, present but undeclared is left over.
            if cfg.attention_bias and p != "o_proj":
                out[f"{ours}.attn.{p}.bias"] = take(f"{hf_l}.self_attn.{p}.bias")
        for p in _MLP_PROJS:
            out[f"{ours}.mlp.{p}.kernel"] = take(f"{hf_l}.mlp.{p}.weight", transpose=True)
        out[f"{ours}.input_norm.scale"] = take(f"{hf_l}.input_layernorm.weight")
        out[f"{ours}.post_attn_norm.scale"] = take(f"{hf_l}.post_attention_layernorm.weight")
    out["model.final_norm.scale"] = take("model.norm.weight")
    if not cfg.tie_embeddings:
        if "lm_head.weight" in sd:
            out["lm_head"] = take("lm_head.weight", transpose=True)
        else:
            # Some tied checkpoints omit lm_head under an untied config.
            out["lm_head"] = out["model.embed_tokens"].t().to(dt).contiguous()
    else:
        sd.pop("lm_head.weight", None)
    leftovers = [k for k in sd if "rotary_emb" not in k]
    if leftovers:
        raise ValueError(f"unconsumed HF weights (architecture mismatch?): "
                         f"{sorted(leftovers)[:8]} (+{max(0, len(leftovers) - 8)} more)")
    return out


def hf_state_dict_from_params(params: Mapping[str, torch.Tensor],
                              cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Merged (LoRA-free) parameters as an HF state dict, in the JAX
    writer's key order (embeddings, final norm, then each layer's
    attention, MLP and norms, then the head). Kernels come back as
    transposed views."""
    if any(is_lora_name(n) for n in params):
        raise ValueError("merge LoRA factors before HF export (merge_lora_params)")
    sd: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["model.embed_tokens"],
        "model.norm.weight": params["model.final_norm.scale"],
    }
    for i in range(cfg.num_layers):
        ours, hf_l = f"model.layers.{i}", f"model.layers.{i}"
        for p in _ATTN_PROJS:
            sd[f"{hf_l}.self_attn.{p}.weight"] = params[f"{ours}.attn.{p}.kernel"].t()
            bias = params.get(f"{ours}.attn.{p}.bias")
            if bias is not None:
                sd[f"{hf_l}.self_attn.{p}.bias"] = bias
        for p in _MLP_PROJS:
            sd[f"{hf_l}.mlp.{p}.weight"] = params[f"{ours}.mlp.{p}.kernel"].t()
        sd[f"{hf_l}.input_layernorm.weight"] = params[f"{ours}.input_norm.scale"]
        sd[f"{hf_l}.post_attention_layernorm.weight"] = params[f"{ours}.post_attn_norm.scale"]
    if not cfg.tie_embeddings and "lm_head" in params:
        sd["lm_head.weight"] = params["lm_head"].t()
    return sd


def graft_base_params(params: Dict[str, torch.Tensor],
                      base: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Put loaded base weights in place of a fresh tree's, in place: each
    leaf of ``base`` replaces ``params``' leaf of that name (shape checked,
    cast to its dtype and moved to its device), and leaves only in
    ``params`` (the ``lora_a``/``lora_b`` factors) keep their
    initialization. A base leaf the tree lacks is an architecture mismatch
    and raises. ``base``'s entries are popped as they are grafted, so each
    replaced leaf is freed as its successor arrives. Returns ``params``."""
    dropped = sorted(k for k in base if k not in params)
    if dropped:
        raise ValueError(f"base checkpoint has weights the model tree lacks "
                         f"(architecture mismatch?): {dropped[:8]}"
                         + (f" (+{len(dropped) - 8} more)" if len(dropped) > 8 else ""))
    for name in list(base):
        p = params[name]
        if tuple(base[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(base[name].shape)} != "
                             f"model shape {tuple(p.shape)} (wrong ModelConfig?)")
    for name in list(base):
        p = params[name]
        params[name] = base.pop(name).to(device=p.device, dtype=p.dtype)
        del p
    return params


# ----------------------------------------------------------------------
# directories
# ----------------------------------------------------------------------

def _shard_files(directory: str) -> list:
    index_path = os.path.join(directory, INDEX_FILE)
    if os.path.exists(index_path):
        with open(index_path) as f:
            return sorted(set(json.load(f)["weight_map"].values()))
    if os.path.exists(os.path.join(directory, SINGLE_FILE)):
        return [SINGLE_FILE]
    shards = sorted(f for f in os.listdir(directory) if f.endswith(".safetensors"))
    if not shards:
        raise FileNotFoundError(f"no .safetensors files under {directory}")
    return shards


def load_hf_checkpoint(directory: str, cfg: Optional[ModelConfig] = None,
                       device=None, **config_overrides
                       ) -> Tuple[Dict[str, torch.Tensor], ModelConfig]:
    """An HF checkpoint directory as ``(params, model_config)``, the
    parameters on ``device`` (the card unless named). ``cfg`` replaces
    ``config.json`` entirely; ``config_overrides`` change fields of it
    (``dtype="bfloat16"``, ``max_seq_len=512``). Not both."""
    if cfg is not None and config_overrides:
        raise ValueError(f"pass either cfg or config overrides, not both (got cfg "
                         f"plus {sorted(config_overrides)})")
    if cfg is None:
        with open(os.path.join(directory, "config.json")) as f:
            cfg = config_from_hf(json.load(f), **config_overrides)
    device = resolve_device(device)
    sd: Dict[str, torch.Tensor] = {}
    for shard in _shard_files(directory):
        sd.update(load_file(os.path.join(directory, shard), device=device))
    return _map_state_dict(sd, cfg), cfg


def save_hf_checkpoint(directory: str, params: Mapping[str, torch.Tensor],
                       cfg: ModelConfig, max_shard_bytes: int = 4 * 1024 ** 3) -> None:
    """Write merged parameters as an HF checkpoint: ``config.json`` and one
    ``model.safetensors``, or greedy shards of at most ``max_shard_bytes``
    in the state dict's key order (``model-XXXXX-of-XXXXX.safetensors``)
    with ``model.safetensors.index.json``: what ``transformers`` loads.
    Each file is written atomically and fsynced."""
    hf_config = config_to_hf(cfg)  # raises before anything is written
    os.makedirs(directory, exist_ok=True)
    sd = hf_state_dict_from_params(params, cfg)
    shards: list = [[]]
    sizes = [0]
    for key, t in sd.items():
        nbytes = t.numel() * t.element_size()
        if sizes[-1] + nbytes > max_shard_bytes and shards[-1]:
            shards.append([])
            sizes.append(0)
        shards[-1].append(key)
        sizes[-1] += nbytes
    meta = {"format": "pt"}
    if len(shards) == 1:
        save_file(sd, os.path.join(directory, SINGLE_FILE), meta)
    else:
        weight_map = {}
        n = len(shards)
        for idx, keys in enumerate(shards):
            fname = f"model-{idx + 1:05d}-of-{n:05d}.safetensors"
            save_file({k: sd[k] for k in keys}, os.path.join(directory, fname), meta)
            weight_map.update({k: fname for k in keys})
        _write_json(os.path.join(directory, INDEX_FILE),
                    {"metadata": {"total_size": sum(sizes)}, "weight_map": weight_map},
                    "checkpoint")
    _write_json(os.path.join(directory, "config.json"), hf_config, "checkpoint")


def _write_json(path: str, obj: Any, path_class: str) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    durable_io.write_bytes(tmp, json.dumps(obj, indent=2).encode(), path_class=path_class)
    durable_io.replace(tmp, path, path_class=path_class)


# ----------------------------------------------------------------------
# PEFT adapters
# ----------------------------------------------------------------------

def _hf_module(prefix: str) -> str:
    """``model.layers.3.attn.q_proj`` -> ``model.layers.3.self_attn.q_proj``."""
    return ".".join("self_attn" if part == "attn" else part for part in prefix.split("."))


def _our_module(hf_path: str) -> str:
    return ".".join("attn" if part == "self_attn" else part for part in hf_path.split("."))


def save_peft_adapter(directory: str, params: Mapping[str, torch.Tensor],
                      lora: LoRAConfig) -> None:
    """The ``lora_a``/``lora_b`` leaves as a PEFT adapter: what the
    reference's ``trainer.save_model`` writes for a PEFT-wrapped model
    (``lora_A`` ``(r, in)``, ``lora_B`` ``(out, r)`` under
    ``base_model.model.``), and its ``adapter_config.json``. Written
    through the ``adapter`` path class."""
    sd: Dict[str, torch.Tensor] = {}
    for name, t in params.items():
        if not name.endswith(".lora_a"):
            continue
        prefix = name[:-len(".lora_a")]
        b = params.get(f"{prefix}.lora_b")
        if b is None:
            continue
        key = f"{_PEFT_PREFIX}{_hf_module(prefix)}"
        sd[f"{key}.lora_A.weight"] = t.t()
        sd[f"{key}.lora_B.weight"] = b.t()
    if not sd:
        raise ValueError("no LoRA factors in params; nothing to export")
    os.makedirs(directory, exist_ok=True)
    save_file(sd, os.path.join(directory, PEFT_WEIGHTS), path_class="adapter")
    _write_json(os.path.join(directory, PEFT_CONFIG), {
        "peft_type": "LORA",
        "r": lora.r,
        "lora_alpha": lora.alpha,
        "lora_dropout": lora.dropout,
        "target_modules": list(lora.target_modules),
        "bias": "none",
        "task_type": "CAUSAL_LM",
    }, "adapter")


def load_peft_adapter(directory: str,
                      params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A PEFT adapter's factors in place of ``params``' ``lora_a``/``lora_b``
    leaves (each cast to the leaf's dtype, on its device). ``params`` must
    already hold those leaves at the adapter's rank. Returns ``params``."""
    sd = load_file(os.path.join(directory, PEFT_WEIGHTS))
    for key, w in sd.items():
        stripped = key[len(_PEFT_PREFIX):] if key.startswith(_PEFT_PREFIX) else key
        stripped = stripped.removesuffix(".weight")
        which = None
        for suffix, ours in ((".lora_A", "lora_a"), (".lora_B", "lora_b")):
            if stripped.endswith(suffix):
                stripped, which = stripped.removesuffix(suffix), ours
        if which is None:
            raise ValueError(f"unrecognized adapter key {key}")
        name = f"{_our_module(stripped)}.{which}"
        if name not in params:
            raise ValueError(f"param tree has no {which} at {stripped}; build the "
                             f"model with a matching LoRAConfig before loading the adapter")
        leaf = params[name]
        got = tuple(w.t().shape)
        if got != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {got} != expected {tuple(leaf.shape)}")
        params[name] = w.t().to(device=leaf.device, dtype=leaf.dtype).contiguous()
    return params
