"""``python -m cgr_mpnn_3d_tpu_torch``: the port's entry points."""

import sys

HELP = """cgr-mpnn-3d-tpu-torch -- CGR reaction-graph MPNN in PyTorch with
hand-written CUDA kernels for Hopper (the port of cgr_mpnn_3d_tpu)

entry points (on the card; --device cpu, or bench_ops --cpu, for the CPU):
  python -m cgr_mpnn_3d_tpu_torch.cli.train      train a model
  python -m cgr_mpnn_3d_tpu_torch.cli.test       evaluate a checkpoint
  python -m cgr_mpnn_3d_tpu_torch.cli.predict    activation-energy inference
  python -m cgr_mpnn_3d_tpu_torch.cli.sweep      hyperparameter sweeps
  python -m cgr_mpnn_3d_tpu_torch.cli.runbook    T1x run-book with RMSE gates
  python -m cgr_mpnn_3d_tpu_torch.cli.bench_ops  kernel microbenchmarks
  python3 chip_smoke.py                          every path on one card

docs: README.md, PERF.md, ROADMAP.md
"""

if __name__ == "__main__":
    print(HELP)
    sys.exit(0 if len(sys.argv) <= 1 else 1)
