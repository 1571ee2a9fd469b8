"""Command-line entry points:

  python -m cgr_mpnn_3d_tpu_torch.cli.train     training on one device
  python -m cgr_mpnn_3d_tpu_torch.cli.test      test-set evaluation
  python -m cgr_mpnn_3d_tpu_torch.cli.predict   activation-energy prediction
"""
