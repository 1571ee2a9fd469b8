"""Measuring tools run as modules:

  python -m cgr_mpnn_3d_tpu_torch.tools.gelu_roofline   activation-chain probe
"""
