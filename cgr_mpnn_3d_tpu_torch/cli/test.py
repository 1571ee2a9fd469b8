"""Test/eval CLI: the counterpart of ``cgr_mpnn_3d_tpu/cli/test.py``, with
its flags plus ``--device`` (default ``cuda``).

Loads an npz checkpoint (model config from the JSON sidecar), evaluates the
test split, prints RMSE, optionally saves the parity plot and merges the
results into the hyperparameter-study JSON.  A missing split raises.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import torch


def test(name: str, path_trained_model: str, data_path: str = "datasets",
         plot_results: bool = True,
         save_plot: str = "predicted_vs_true_activation_energy.pdf",
         batch_size: int = 64,
         device: str | torch.device = "cuda") -> dict:
    """Test RMSE and MAE of a checkpoint on the ``test`` split.  The model
    computes in f32 whatever dtype it was trained in: a checkpoint carries
    none, as in the JAX package."""
    from ..data import plan_spec
    from ..train import evaluate, load_model
    from .train import split_dataset

    test_data = split_dataset(data_path, "test", name)
    model, _cfg, _meta = load_model(path_trained_model, device)
    test_data.prefeaturize()
    graphs = [test_data.graph(i) for i in range(len(test_data))]
    spec = plan_spec(graphs)

    res = evaluate(model, test_data, spec, batch_size=batch_size,
                   device=device,
                   plot_path=save_plot if (plot_results or save_plot)
                   else None)
    return {"test_losses": res["test_losses"], "test_mae": res["test_mae"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="CLI tool for testing the CGR MPNN 3D GNN (PyTorch, "
                    "CUDA kernel).")
    ap.add_argument("--path_trained_model", required=True)
    ap.add_argument("--data_path", default="datasets")
    ap.add_argument("--save_plot", default="")
    ap.add_argument("--plot_results", action="store_true")
    ap.add_argument("--save_result", action="store_true")
    ap.add_argument("--batch_size", default=64, type=int)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # model name inferred from the checkpoint's basename
    name = os.path.basename(args.path_trained_model).split("_")[0]
    if not Path(args.path_trained_model).exists():
        raise NameError(
            f"Invalid model data location at {args.path_trained_model}")

    out = test(name, args.path_trained_model, args.data_path,
               args.plot_results, args.save_plot, args.batch_size,
               args.device)

    if args.save_result:
        from ..utils import json_dumper
        d = Path("hyperparameter_study")
        d.mkdir(parents=True, exist_ok=True)
        json_dumper(str(d / f"{name}_hyperparameter_study.json"), out,
                    args.path_trained_model)
    return out


if __name__ == "__main__":
    main()
