"""Edge partitioning (``--ep N``) in the pack-local layout, with every shard
of a step in one process: the host packer, the EP loader, the per-shard
EP step and the hop exchange K12 (the counterpart of
``cgr_mpnn_3d_tpu/parallel/``'s ``ep_pack``, ``ep_loader``,
``rdma_exchange`` and the helpers of ``edge_partition`` it needs)."""

from .edge_partition import EPOverflow
from .ep_loader import EPPackLoader
from .ep_pack import (EPPackedBatch, EPPackSpec, empty_ep_pack_batch,
                      ep_pack_forward, ep_shards, make_ep_pack_eval_step,
                      make_ep_pack_train_step, pack_shard_edges)
from .rdma_exchange import ring_exchange_rdma

__all__ = ["EPOverflow", "EPPackLoader", "EPPackedBatch", "EPPackSpec",
           "empty_ep_pack_batch", "ep_pack_forward", "ep_shards",
           "make_ep_pack_eval_step", "make_ep_pack_train_step",
           "pack_shard_edges", "ring_exchange_rdma"]
