"""Compute primitives: plain-torch gather ops (the oracle), the kernels'
elementwise helpers, the whole-model kernels (forward, training step, VJP),
the layered kernels (gather-linear, conv stack, ELL gather-sum, each
forward and backward), capture mode's per-layer conv kernel (forward and
backward), the edge-partitioned conv layer and readout, and the
activation-chain probe's kernel, with their plain versions.  The launch
counts live on the modules, the kernels' wrappers adding through
``ops._launch.count_launch`` and the probes' on their own
(``ops._launch.launch_counts()`` is a snapshot of every nonzero one, and
``utils.tracing.counters()`` includes it):
``ops.fused_model.launches``, ``train_launches`` and ``vjp_launches`` (K3f,
K2, K3b), each with a ``bf16_`` twin;
``launches`` and ``bwd_launches`` of ``ops.gather_linear``,
``ops.conv_stack``, ``ops.onehot_spmm`` and ``ops.fused_conv``; the
edge-partitioned kernels' ``r_launches`` and ``rm_launches`` (K8, K9) of
``ops.fused_conv`` and ``r_launches`` and ``pool_launches`` (K10, K11) of
``ops.gather_linear``, each with its ``_bwd_`` twin;
``ops.act_chain.launches``; ``ops.mm_probe.launches`` and
``transpose_launches``.  The wrappers ``fused_model``,
``gather_linear``, ``conv_stack``, ``onehot_spmm`` and ``act_chain`` are
not re-exported here, where their names would hide the modules.
"""

from .act_chain import act_chain_ref
from .conv_stack import (conv_stack_backward, conv_stack_backward_ref,
                         conv_stack_forward, conv_stack_forward_ref)
from .fused_model import (fused_model_forward,
                          fused_model_forward_ref, fused_model_train,
                          fused_model_train_ref, fused_model_vjp,
                          fused_model_vjp_ref)
from .fused_conv import (fused_conv_backward, fused_conv_backward_ref,
                         fused_conv_forward, fused_conv_layer,
                         fused_conv_layer_ref)
from .gather_linear import (gather_linear_backward,
                            gather_linear_backward_ref,
                            gather_linear_forward, gather_linear_forward_ref)
from .kernel_math import (hash_bits, hash_dropout_keep_full, k_act, k_dact,
                          k_dropout_mask, mean_colscale)
from .onehot_spmm import onehot_spmm_ref, spmm
from .segment import (dmpnn_messages, ext_zero_row, gather_nodes,
                      graph_pool_sum, in_pack, node_incoming_sum,
                      pack_gather_sum)

__all__ = ["act_chain_ref", "fused_conv_backward", "fused_conv_backward_ref",
           "fused_conv_forward", "fused_conv_layer", "fused_conv_layer_ref",
           "conv_stack_backward", "conv_stack_backward_ref",
           "conv_stack_forward", "conv_stack_forward_ref",
           "gather_linear_backward", "gather_linear_backward_ref",
           "gather_linear_forward", "gather_linear_forward_ref",
           "onehot_spmm_ref", "spmm", "in_pack",
           "pack_gather_sum", "fused_model_forward", "fused_model_forward_ref",
           "fused_model_train", "fused_model_train_ref", "fused_model_vjp",
           "fused_model_vjp_ref", "hash_bits", "hash_dropout_keep_full",
           "k_act", "k_dact", "k_dropout_mask", "mean_colscale",
           "dmpnn_messages", "ext_zero_row", "gather_nodes",
           "graph_pool_sum", "node_incoming_sum"]
