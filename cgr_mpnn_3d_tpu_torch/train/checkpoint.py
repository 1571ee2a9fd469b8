"""Checkpoints in the JAX package's format: ``.npz`` of leaves + JSON sidecar.

The same files as ``cgr_mpnn_3d_tpu/train/checkpoint.py``: ``arr_i`` are the
state's leaves in JAX's pytree order, and ``<name>.json`` holds the model
config and ``num_leaves``.  A checkpoint saved by the JAX package serves and
resumes here, and one saved here loads there.

With P parameter leaves, a training checkpoint has 4P + 5 leaves, in the
leaf order of the JAX trainer's ``TrainState``:

* the params, in :func:`models.cgr_mpnn.jax_leaf_names` order;
* ``opt count`` (int32), ``learning_rate`` (f32), ``amsgrad count`` (int32);
* ``mu``, ``nu``, ``nu_max`` (P each, in the params' order) -- torch Adam's
  ``exp_avg``, ``exp_avg_sq`` and ``max_exp_avg_sq``;
* ``step`` (int32), ``rng`` (uint32[2]).

Weight decay adds no leaves.  In a checkpoint written here, ``rng`` is the
port's dropout seed stream (seed, draws) and the sidecar's ``seed_stream``
says so; the JAX trainer's ``rng`` is a PRNG key, which the port cannot
continue, so a JAX checkpoint resumes with its params, moments and step and
a fresh seed stream.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..models.cgr_mpnn import CGRMPNN, jax_leaf_names
from ..utils.tracing import count_copy_out

__all__ = ["save_checkpoint", "load_checkpoint", "restore_into",
           "restore_training_state", "SEED_STREAM"]

_META_SUFFIX = ".json"
# the sidecar's ``seed_stream`` value of a checkpoint written here
SEED_STREAM = "torch.Generator(seed, draws)"
_MOMENTS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")


def _host(t: torch.Tensor) -> np.ndarray:
    """A state tensor read back to a host array (``copy_out_bytes``)."""
    a = t.detach().cpu().numpy()
    count_copy_out(a.nbytes)
    return a


def _params(model: CGRMPNN) -> list[tuple[str, torch.nn.Parameter]]:
    named = dict(model.named_parameters())
    return [(n, named[n]) for n in jax_leaf_names(model.cfg)]


def _optimizer_leaves(model: CGRMPNN,
                      optimizer: torch.optim.Optimizer) -> list[np.ndarray]:
    params = [p for _, p in _params(model)]
    states = [optimizer.state.get(p, {}) for p in params]
    count = int(states[0]["step"]) if "step" in states[0] else 0
    leaves = [np.int32(count),
              np.float32(optimizer.param_groups[0]["lr"]),
              np.int32(count)]
    for key in _MOMENTS:
        leaves += [_host(st[key]) if key in st
                   else np.zeros(tuple(p.shape), np.float32)
                   for p, st in zip(params, states)]
    return leaves


def save_checkpoint(path: str | Path, model: CGRMPNN,
                    meta: dict | None = None,
                    optimizer: torch.optim.Optimizer | None = None,
                    step: int = 0, rng=(0, 0)) -> Path:
    """Save the model's params (JAX leaf order) + JSON metadata; with
    ``optimizer`` (torch Adam with amsgrad), the full training state."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = [_host(p) for _, p in _params(model)]
    meta = dict(meta or {})
    if optimizer is not None:
        leaves += _optimizer_leaves(model, optimizer)
        leaves += [np.int32(step), np.asarray(rng, np.uint32).reshape(2)]
        meta["seed_stream"] = SEED_STREAM
    np.savez(path, *leaves)
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


def restore_training_state(model: CGRMPNN, optimizer: torch.optim.Optimizer,
                           leaves: list[np.ndarray]) -> tuple[int, np.ndarray]:
    """Load a training checkpoint's 4P + 5 leaves into ``model`` and
    ``optimizer`` in place; returns (step, rng leaf)."""
    named = _params(model)
    P = len(named)
    if len(leaves) != 4 * P + 5:
        raise ValueError(f"a training checkpoint of this model has "
                         f"{4 * P + 5} leaves, this one {len(leaves)}")
    restore_into(model, leaves[:P])
    count = int(leaves[P])
    for group in optimizer.param_groups:
        group["lr"] = float(leaves[P + 1])
    moments = [leaves[P + 3 + k * P:P + 3 + (k + 1) * P] for k in range(3)]
    for i, (name, p) in enumerate(named):
        state = {"step": torch.tensor(float(count), dtype=torch.float32)}
        for key, m in zip(_MOMENTS, moments):
            arr = np.asarray(m[i], np.float32)
            if arr.shape != tuple(p.shape):
                raise ValueError(f"checkpoint {key} of {name} has shape "
                                 f"{arr.shape}, expected {tuple(p.shape)}")
            state[key] = torch.as_tensor(arr).to(p.device)
        optimizer.state[p] = state
    return int(leaves[4 * P + 3]), np.asarray(leaves[4 * P + 4], np.uint32)
