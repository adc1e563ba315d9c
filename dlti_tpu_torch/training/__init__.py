"""Single-device LoRA training: optimizer, train state, train step, loop."""

from dlti_tpu_torch.training.optimizer import build_optimizer, build_schedule  # noqa: F401
from dlti_tpu_torch.training.state import (  # noqa: F401
    TrainState, create_train_state, partition_params,
)
from dlti_tpu_torch.training.step import (  # noqa: F401
    causal_lm_loss, guard_nonfinite_update, make_train_step,
)
from dlti_tpu_torch.training.trainer import Trainer, TrainRecord  # noqa: F401
