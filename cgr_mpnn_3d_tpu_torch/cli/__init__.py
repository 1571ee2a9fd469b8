"""Command-line entry points:

  python -m cgr_mpnn_3d_tpu_torch.cli.train      training (one process or
                                                 every rank of a launch)
  python -m cgr_mpnn_3d_tpu_torch.cli.test       test-set evaluation
  python -m cgr_mpnn_3d_tpu_torch.cli.predict    activation-energy prediction
  python -m cgr_mpnn_3d_tpu_torch.cli.sweep      hyperparameter sweeps
  python -m cgr_mpnn_3d_tpu_torch.cli.runbook    the T1x run-book with gates
  python -m cgr_mpnn_3d_tpu_torch.cli.bench_ops  kernel microbenchmarks
"""
