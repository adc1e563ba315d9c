"""Consolidated model export: the port of ``dlti_tpu/checkpoint/export.py``.

Fold the LoRA factors into the base kernels
(:func:`~dlti_tpu_torch.models.lora.merge_lora_params`), and write one
manifest-verified params artifact (:func:`~dlti_tpu_torch.checkpoint.store.save_pytree`)
plus the run's ``config.json``, which ``cli.serve --model-dir`` (and the
JAX package's ``scripts/serve.py --model-dir``) load directly. The params
keep the JAX package's tree (``['model']['layers_0']...``), so either
package serves the other's export.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Tuple

import torch

from dlti_tpu_torch.checkpoint import store
from dlti_tpu_torch.config import Config
from dlti_tpu_torch.models.interop import params_to_jax
from dlti_tpu_torch.models.lora import merge_lora_params


def merged_tree(params: Mapping[str, torch.Tensor], cfg: Config,
                merge_lora: bool = True) -> dict:
    """The export's params tree: ``params`` (this package's names) with the
    LoRA pairs merged (when ``merge_lora`` and LoRA is on), as JAX's nested
    dict."""
    if merge_lora and cfg.lora.enabled:
        params = merge_lora_params(params, alpha=cfg.lora.alpha)
    return params_to_jax(params)


def export_merged_model(directory: str, params: Mapping[str, torch.Tensor],
                        cfg: Config, merge_lora: bool = True) -> str:
    """Write ``directory/model`` (manifest-verified params) and
    ``directory/config.json``. ``params`` is ``{name: tensor}`` on any
    device; the merge runs where the tensors are. Returns the export
    directory."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    with torch.no_grad():
        tree = merged_tree(params, cfg, merge_lora)
    store.save_pytree(os.path.join(directory, "model"), tree)
    del tree
    meta = cfg.to_dict()
    meta["lora"]["enabled"] = False if merge_lora else meta["lora"]["enabled"]
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    return directory


def export_params_host(checkpoint_dir: str, step: int, out_dir: str) -> str:
    """The ``.params`` subtree of a committed train-state checkpoint,
    straight from its manifest (no model, no optimizer state, no device),
    re-written as a :func:`~dlti_tpu_torch.checkpoint.store.save_pytree`
    artifact. Every leaf's SHA-256 is checked while reading, so a corrupt
    checkpoint raises instead of exporting garbage. Returns the export's
    manifest SHA-256."""
    root = os.path.join(os.path.abspath(checkpoint_dir), str(step))
    try:
        with open(os.path.join(root, "MANIFEST.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise store.CheckpointCorruptError(
            f"unreadable manifest for step {step} under {checkpoint_dir}: {e}") from e
    prefix = ".params"
    entries = [e for e in manifest.get("leaves", []) if e["name"].startswith(prefix + "[")]
    if not entries:
        raise ValueError(f"checkpoint step {step} under {checkpoint_dir} has no "
                         ".params leaves: not a train-state checkpoint?")
    keys = [store.parse_keys(e["name"][len(prefix):]) for e in entries]
    params: dict = {}
    for path, host in zip(keys, store._read_leaves(root, entries, pinned=False,
                                                  verify=True)):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = host
    out_dir = os.path.abspath(out_dir)
    store.save_pytree(out_dir, params)
    digest = store.manifest_digest(out_dir)
    if digest is None:
        raise store.CheckpointCorruptError(f"export {out_dir} has no committed "
                                           "manifest digest")
    return digest


def load_exported_model(directory: str, device=None) -> Tuple[dict, Config]:
    """Load a consolidated export (either package's) as ``(params tree,
    Config)``: the JAX package's nested dict of tensors, on the CPU unless
    ``device`` names another. An export written by the JAX package's
    earlier Orbax backend (no ``MANIFEST.json``) raises: the port has no
    Orbax."""
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "config.json")) as f:
        cfg = Config.from_dict(json.load(f))
    model_dir = os.path.join(directory, "model")
    if not os.path.isfile(os.path.join(model_dir, "MANIFEST.json")):
        raise ValueError(
            f"{model_dir} has no MANIFEST.json: a legacy Orbax export, which the "
            "port cannot read. Re-export it with the JAX package's "
            "scripts/export_from_checkpoint.py or this package's cli.export")
    return store.load_pytree(model_dir, device=device), cfg
