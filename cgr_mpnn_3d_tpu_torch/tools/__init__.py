"""Measuring tools run as modules:

  python -m cgr_mpnn_3d_tpu_torch.tools.gelu_roofline   activation-chain probe
  python -m cgr_mpnn_3d_tpu_torch.tools.int8_microbench  matmul rate probe
  python -m cgr_mpnn_3d_tpu_torch.tools.bwd_registers    bf16 backward's
                                                        register budget A/B
  python -m cgr_mpnn_3d_tpu_torch.tools.k2_phases        the training
                                                        kernel, phase by phase
  python -m cgr_mpnn_3d_tpu_torch.tools.k12_host         the hop exchange's
                                                        host time, step by step
"""
