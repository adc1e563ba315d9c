"""Experiment naming and config introspection: the port of
``dlti_tpu/utils/experiment.py`` (the reference's ``training/utils.py``
``create_experiment_name`` and ``get_zero_stage_from_config``)."""

from __future__ import annotations

import json
from typing import Optional, Union

from dlti_tpu_torch.config import Config, ZeROStage


def create_experiment_name(num_devices: int,
                           zero_stage: Union[int, ZeROStage, None]) -> str:
    """``(num_devices, zero_stage)`` -> the experiment's name.

    >>> create_experiment_name(1, None)
    'baseline'
    >>> create_experiment_name(2, 1)
    'zero1_2dev'
    """
    stage = int(zero_stage) if zero_stage is not None else 0
    if stage == 0:
        return "baseline"
    return f"zero{stage}_{num_devices}dev"


def get_zero_stage_from_config(config_path: str) -> Optional[int]:
    """The ZeRO stage of a JSON config file: a DeepSpeed one
    (``{"zero_optimization": {"stage": N}}``) or a serialized
    :class:`~dlti_tpu_torch.config.Config` (``parallel.zero_stage``); None
    when the file has neither."""
    with open(config_path) as f:
        cfg = json.load(f)
    if "zero_optimization" in cfg:
        return cfg["zero_optimization"].get("stage")
    if "parallel" in cfg:
        return cfg["parallel"].get("zero_stage")
    return None


def experiment_name_from_config(cfg: Config) -> str:
    """``cfg.experiment_name`` when set, else the name of its strategy and
    device count (a pipeline run is named for its pipe)."""
    if cfg.experiment_name:
        return cfg.experiment_name
    if cfg.parallel.pipe > 1:
        return f"pipe{cfg.parallel.pipe}_{cfg.parallel.num_devices}dev"
    return create_experiment_name(cfg.parallel.num_devices, cfg.parallel.zero_stage)
