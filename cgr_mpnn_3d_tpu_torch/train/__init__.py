"""Serving side of the training subsystem: checkpoints and evaluation (the
trainer itself is not ported yet)."""

from .checkpoint import load_checkpoint, restore_into, save_checkpoint
from .evaluate import evaluate, load_model, predict

__all__ = ["load_checkpoint", "restore_into", "save_checkpoint", "evaluate",
           "load_model", "predict"]
