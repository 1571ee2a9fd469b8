"""Model family: CGR / CGR-MPNN-3D directed-bond message passing networks."""

from .cgr_mpnn import (ACTIVATIONS, CGRMPNN, CGRMPNNConfig, adjoint_inputs,
                       apply, fused_train_value_and_grad, init_params,
                       jax_leaf_names, kernel_grads_to_params, kernel_inputs,
                       kernel_seeds, params_from_jax, supports_fused_train)

__all__ = ["ACTIVATIONS", "CGRMPNN", "CGRMPNNConfig", "adjoint_inputs",
           "apply", "fused_train_value_and_grad", "init_params",
           "jax_leaf_names", "kernel_grads_to_params", "kernel_inputs",
           "kernel_seeds", "params_from_jax", "supports_fused_train"]
