"""Compute primitives: plain-torch gather ops (the oracle), the kernels'
elementwise helpers, and the whole-model forward kernel with its plain
version.  The launch count lives on the module: ``ops.fused_model.launches``.
"""

from .fused_model import fused_model_forward, fused_model_forward_ref
from .kernel_math import k_act, mean_colscale
from .segment import (dmpnn_messages, ext_zero_row, gather_nodes,
                      graph_pool_sum, node_incoming_sum)

__all__ = ["fused_model_forward", "fused_model_forward_ref", "k_act",
           "mean_colscale", "dmpnn_messages", "ext_zero_row", "gather_nodes",
           "graph_pool_sum", "node_incoming_sum"]
