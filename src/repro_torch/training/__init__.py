"""Training substrate: optimizer, train-step factory, checkpoints, compression."""

from repro_torch.training.optimizer import adamw_init, adamw_update  # noqa: F401
from repro_torch.training.train_loop import make_train_step, TrainStepConfig  # noqa: F401
from repro_torch.training.checkpoint import CheckpointManager  # noqa: F401
