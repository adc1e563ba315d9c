"""Checkpoint, resume and export: the port of ``dlti_tpu/checkpoint``
(``store``, ``export``), byte-compatible with the JAX package's format.
"""

from dlti_tpu_torch.checkpoint.store import (  # noqa: F401
    CKPT_METRIC_NAMES,
    CheckpointCorruptError,
    HostCache,
    latest_step,
    latest_verified_step,
    list_checkpoint_steps,
    load_pytree,
    load_train_meta,
    manifest_digest,
    quarantine_step,
    restore_latest_verified,
    restore_train_state,
    save_pytree,
    save_train_state,
    verify_checkpoint,
    verify_pytree_dir,
    wait_for_saves,
)
from dlti_tpu_torch.checkpoint.export import (  # noqa: F401
    export_merged_model,
    export_params_host,
    load_exported_model,
)
