"""LoRA training on one device or data parallel (ZeRO-1/2/3): optimizer,
train state, train step, loop."""

from dlti_tpu_torch.training.optimizer import build_optimizer, build_schedule  # noqa: F401
from dlti_tpu_torch.training.state import (  # noqa: F401
    TrainState, create_train_state, partition_params, whole_params,
)
from dlti_tpu_torch.training.step import (  # noqa: F401
    StepWindow, causal_lm_loss, chunked_causal_lm_loss, guard_nonfinite_update,
    make_eval_step, make_train_step, step_seed,
)
from dlti_tpu_torch.training.trainer import Trainer, TrainRecord  # noqa: F401
