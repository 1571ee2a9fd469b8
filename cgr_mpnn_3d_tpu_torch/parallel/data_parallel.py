"""Data parallelism (``--dp N``) with every data-parallel group in this
process, on one device: the counterpart of
``cgr_mpnn_3d_tpu/parallel/data_parallel.py``.

A step takes ``n_dp`` packed batches, one a group, stacked on a leading
axis (:func:`stack_batches`), and runs them in group order, as JAX's
``shard_map`` body runs one on each device of the mesh.  JAX ``psum``s the
SSE and the gradients over the mesh; here the groups' SSEs and gradients
are summed in group order, so the update equals one step on the
concatenated batch:

* the whole-model configuration runs one launch of the training kernel
  (K2) per group and sums the groups' partial SSEs and weight gradients
  before writing them into ``.grad`` (the pattern of
  ``parallel/ep_pack.py``'s zero-cut step);
* otherwise autograd of each group's masked SSE, ``.grad`` accumulating
  over the groups after one ``zero_grad``.

Seeds are ``[n_dp, depth]``: one dropout seed per group and conv layer.
The optimizer step is the caller's.  There is no mesh: ``parallel/mesh.py``
and ``multihost.py`` come with torch.distributed (ROADMAP.md section 1.5).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.batch import PackedGraphBatch, PackSpec
from ..models.cgr_mpnn import (CGRMPNN, fused_train_sse_and_grads,
                               kernel_grads_to_params, sse_loss, sum_partials,
                               supports_fused_train)

__all__ = ["stack_batches", "groups_of", "make_dp_train_step",
           "make_dp_eval_step"]


def stack_batches(batches: list[PackedGraphBatch]) -> PackedGraphBatch:
    """Stack per-group batches on a new leading axis [n_dp, ...]."""
    return PackedGraphBatch(*(np.stack(xs, axis=0) for xs in zip(*batches)))


def groups_of(stacked: PackedGraphBatch) -> list[PackedGraphBatch]:
    """The groups of a stacked batch, in group order, as views."""
    return [PackedGraphBatch(*(t[g] for t in stacked))
            for g in range(stacked.labels.shape[0])]


def make_dp_train_step(model: CGRMPNN, spec: PackSpec):
    """``step(groups, seeds) -> SSE``: the data-parallel training step's
    compute over the stacked ``groups`` ([n_dp, ...] tensors), the summed
    gradients written into the parameters' ``.grad``.  ``seeds`` [n_dp,
    depth] turns on train-mode dropout."""
    if supports_fused_train(model.cfg):
        def step(groups, seeds=None):
            sse, grads = sum_partials(
                fused_train_sse_and_grads(model, b, spec,
                                          None if seeds is None else seeds[g])
                for g, b in enumerate(groups_of(groups)))
            kernel_grads_to_params(model, grads)
            return sse
        return step

    def step(groups, seeds=None):
        model.zero_grad(set_to_none=True)
        sse = None
        for g, b in enumerate(groups_of(groups)):
            s = sse_loss(model, b, spec, train=seeds is not None,
                         seeds=None if seeds is None else seeds[g])
            s.backward()
            sse = s.detach() if sse is None else sse + s.detach()
        return sse
    return step


def make_dp_eval_step(model: CGRMPNN, spec: PackSpec):
    """``eval(groups) -> SSE`` summed over the groups, in eval mode."""

    def evaluate(groups) -> torch.Tensor:
        sse = None
        with torch.no_grad():
            for b in groups_of(groups):
                s = sse_loss(model, b, spec)
                sse = s if sse is None else sse + s
        return sse
    return evaluate
