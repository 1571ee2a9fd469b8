"""Data parallelism (``--dp N``) and edge partitioning (``--ep N``), every
group and shard of a step in one process or split over the ranks of a
torch.distributed (gloo) process group: the data-parallel step; the
pack-local EP packer, loader, per-shard step and hop exchange K12 (in one
process, and across ranks through CUDA IPC); the flat
EP layout (``shard_edges``, its forward and steps through K7, and
``EPLoader``); the ranks' launch, layouts and collectives (the counterpart
of ``cgr_mpnn_3d_tpu/parallel/``'s ``data_parallel``, ``edge_partition``,
``ep_pack``, ``ep_loader``, ``rdma_exchange`` and ``multihost``)."""

from .data_parallel import (make_dp_eval_step, make_dp_train_step,
                            stack_batches)
from .edge_partition import (EdgeShardedBatch, EPOverflow, ep_forward,
                             flat_shards, make_ep_eval_step,
                             make_ep_train_step, shard_edges)
from .ep_loader import EPLoader, EPPackLoader, empty_ep_batch_like
from .ep_pack import (EPPackedBatch, EPPackSpec, empty_ep_pack_batch,
                      ep_pack_forward, ep_shards, make_ep_pack_eval_step,
                      make_ep_pack_train_step, pack_shard_edges)
from .rdma_exchange import rank_exchange_rdma, ring_exchange_rdma

__all__ = ["EPLoader", "EPOverflow", "EPPackLoader", "EPPackedBatch",
           "EPPackSpec", "EdgeShardedBatch", "empty_ep_batch_like",
           "empty_ep_pack_batch", "ep_forward", "ep_pack_forward",
           "ep_shards", "flat_shards", "make_dp_eval_step",
           "make_dp_train_step", "make_ep_eval_step", "make_ep_train_step",
           "make_ep_pack_eval_step", "make_ep_pack_train_step",
           "pack_shard_edges", "rank_exchange_rdma", "ring_exchange_rdma",
           "shard_edges",
           "stack_batches"]
