"""Model family: CGR / CGR-MPNN-3D directed-bond message passing networks."""

from .cgr_mpnn import (ACTIVATIONS, CGRMPNN, CGRMPNNConfig, apply,
                       init_params, jax_leaf_names, kernel_inputs,
                       params_from_jax)

__all__ = ["ACTIVATIONS", "CGRMPNN", "CGRMPNNConfig", "apply", "init_params",
           "jax_leaf_names", "kernel_inputs", "params_from_jax"]
