"""Training substrate: optimizer, step builders, checkpointing, fault
tolerance, and the stream-fed training loop (the data plane is
:mod:`repro_torch.training.data`)."""

from repro_torch.training.optimizer import AdamW, adamw_init, adamw_update  # noqa: F401
from repro_torch.training.steps import make_train_step, make_serve_step  # noqa: F401
from repro_torch.training.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.training.train_loop import TrainLoop, TrainLoopConfig  # noqa: F401
from repro_torch.training import ft  # noqa: F401
