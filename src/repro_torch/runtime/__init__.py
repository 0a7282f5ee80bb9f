"""Runtime: train and serve steps, the single-device trainer, monitors."""
from .monitor import Heartbeat, PeerFailure, StragglerMonitor
from .steps import TrainHParams, build_serve_steps, build_train_step
from .trainer import Trainer, TrainerConfig

__all__ = [
    "build_train_step", "build_serve_steps", "TrainHParams",
    "Heartbeat", "PeerFailure", "StragglerMonitor", "Trainer",
    "TrainerConfig",
]
