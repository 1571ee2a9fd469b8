"""Data parallelism (``--dp N``) and edge partitioning (``--ep N``) in the
pack-local layout, with every group and shard of a step in one process:
the data-parallel step, the host EP packer, the EP loader, the per-shard EP
step and the hop exchange K12 (the counterpart of
``cgr_mpnn_3d_tpu/parallel/``'s ``data_parallel``, ``ep_pack``,
``ep_loader``, ``rdma_exchange`` and the helpers of ``edge_partition`` it
needs)."""

from .data_parallel import (make_dp_eval_step, make_dp_train_step,
                            stack_batches)
from .edge_partition import EPOverflow
from .ep_loader import EPPackLoader
from .ep_pack import (EPPackedBatch, EPPackSpec, empty_ep_pack_batch,
                      ep_pack_forward, ep_shards, make_ep_pack_eval_step,
                      make_ep_pack_train_step, pack_shard_edges)
from .rdma_exchange import ring_exchange_rdma

__all__ = ["EPOverflow", "EPPackLoader", "EPPackedBatch", "EPPackSpec",
           "empty_ep_pack_batch", "ep_pack_forward", "ep_shards",
           "make_dp_eval_step", "make_dp_train_step",
           "make_ep_pack_eval_step", "make_ep_pack_train_step",
           "pack_shard_edges", "ring_exchange_rdma", "stack_batches"]
