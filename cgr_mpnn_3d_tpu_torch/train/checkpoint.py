"""Checkpoints in the JAX package's format: ``.npz`` of leaves + JSON sidecar.

The same files as ``cgr_mpnn_3d_tpu/train/checkpoint.py``: ``arr_i`` are the
state's leaves in JAX's pytree order (params first, in sorted-key order --
see :func:`models.cgr_mpnn.jax_leaf_names`; a JAX training checkpoint
appends optimizer state and the step after them), and ``<name>.json`` holds
the model config and ``num_leaves``.  A checkpoint saved by the JAX package
serves here, and one saved here loads there.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..models.cgr_mpnn import CGRMPNN, jax_leaf_names

__all__ = ["save_checkpoint", "load_checkpoint", "restore_into"]

_META_SUFFIX = ".json"


def save_checkpoint(path: str | Path, model: CGRMPNN,
                    meta: dict | None = None) -> Path:
    """Save the model's params (JAX leaf order) + JSON metadata."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = model.state_dict()
    leaves = [state[n].detach().cpu().numpy()
              for n in jax_leaf_names(model.cfg)]
    np.savez(path, *leaves)
    meta = dict(meta or {})
    meta["num_leaves"] = len(leaves)
    with open(path.with_suffix(_META_SUFFIX), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return path


def load_checkpoint(path: str | Path) -> tuple[list[np.ndarray], dict]:
    """Load raw leaves + metadata."""
    path = Path(path)
    with np.load(path) as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    meta_path = path.with_suffix(_META_SUFFIX)
    meta = {}
    if meta_path.exists():
        with open(meta_path) as f:
            meta = json.load(f)
    return leaves, meta


def restore_into(model: CGRMPNN, leaves: list[np.ndarray]) -> CGRMPNN:
    """Copy params leaves (JAX leaf order) into ``model``, in place."""
    names = jax_leaf_names(model.cfg)
    if len(names) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves but the model "
                         f"expects {len(names)}")
    state = model.state_dict()
    for name, leaf in zip(names, leaves):
        arr = np.asarray(leaf)
        if tuple(state[name].shape) != arr.shape:
            raise ValueError(f"checkpoint leaf {name} has shape {arr.shape}, "
                             f"expected {tuple(state[name].shape)}")
        state[name] = torch.as_tensor(arr, dtype=state[name].dtype)
    model.load_state_dict(state)
    return model
