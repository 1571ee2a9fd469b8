"""Command-line entry points:

  python -m cgr_mpnn_3d_tpu_torch.cli.predict   activation-energy prediction
"""
