"""Compute primitives: plain-torch gather ops (the oracle), the kernels'
elementwise helpers, and the whole-model kernels (forward, training step,
VJP) with their plain versions.  The launch counts live on the module:
``ops.fused_model.launches``, ``train_launches`` and ``vjp_launches``;
the autograd wrapper is ``ops.fused_model.fused_model`` (not re-exported
here, where its name would hide the module).
"""

from .fused_model import (fused_model_forward,
                          fused_model_forward_ref, fused_model_train,
                          fused_model_train_ref, fused_model_vjp,
                          fused_model_vjp_ref)
from .kernel_math import (hash_bits, hash_dropout_keep_full, k_act, k_dact,
                          k_dropout_mask, mean_colscale)
from .segment import (dmpnn_messages, ext_zero_row, gather_nodes,
                      graph_pool_sum, node_incoming_sum)

__all__ = ["fused_model_forward", "fused_model_forward_ref",
           "fused_model_train", "fused_model_train_ref", "fused_model_vjp",
           "fused_model_vjp_ref", "hash_bits", "hash_dropout_keep_full",
           "k_act", "k_dact", "k_dropout_mask", "mean_colscale",
           "dmpnn_messages", "ext_zero_row", "gather_nodes",
           "graph_pool_sum", "node_incoming_sum"]
