"""Training subsystem: the trainer, checkpoints (the JAX package's ``.npz``
+ JSON format), metrics logging, tracing, step timing and evaluation."""

from .checkpoint import (load_checkpoint, restore_into,
                         restore_training_state, save_checkpoint)
from .evaluate import evaluate, load_model, parity_plot, predict
from .metrics import MetricsLogger
from .profiler import StepTimer, trace
from .trainer import RxnGraphTrainer, set_epoch_lr, sse_loss

__all__ = ["load_checkpoint", "restore_into", "restore_training_state",
           "save_checkpoint", "evaluate", "load_model", "parity_plot",
           "predict", "MetricsLogger", "StepTimer", "RxnGraphTrainer",
           "set_epoch_lr", "sse_loss", "trace"]
