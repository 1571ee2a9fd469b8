"""Serving and evaluation: load a checkpoint, predict in row order, RMSE,
and the predicted-vs-true parity plot.

The counterpart of ``cgr_mpnn_3d_tpu/train/evaluate.py``.  On the card every
batch goes through the whole-model forward kernel; ``device="cpu"`` takes
the plain PyTorch ops.  A checkpoint carries no compute dtype (as in the JAX
package): a loaded model computes in f32.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.batch import PackSpec, to_device
from ..data.dataset import ChemDataset
from ..data.loader import PackedLoader
from ..models.cgr_mpnn import CGRMPNN, CGRMPNNConfig, apply
from ..utils.device import resolve_device
from ..utils.tracing import count_copy_out, next_request_id, span
from .checkpoint import load_checkpoint, restore_into

__all__ = ["load_model", "model_config", "evaluate", "predict", "parity_plot"]


def load_model(ckpt_path: str | Path, device: str | torch.device = "cuda"
               ) -> tuple[CGRMPNN, CGRMPNNConfig, dict]:
    """Rebuild (model on ``device``, config, metadata) from a checkpoint's
    npz + sidecar; leaves after the params (optimizer state) are skipped."""
    leaves, meta = load_checkpoint(ckpt_path)
    cfg = model_config(meta)
    model = CGRMPNN(cfg)
    restore_into(model, leaves[:len(model.state_dict())])
    return model.to(resolve_device(device)).eval(), cfg, meta


def model_config(meta: dict) -> CGRMPNNConfig:
    """The model configuration a checkpoint's metadata describes."""
    mcfg = meta["model"]
    return CGRMPNNConfig(
        num_node_features=int(mcfg["num_node_features"]),
        num_edge_features=int(mcfg["num_edge_features"]),
        depth=int(mcfg["depth"]),
        hidden_sizes=tuple(mcfg["hidden_sizes"]),
        dropout_ps=tuple(mcfg["dropout_ps"]),
        activation=mcfg.get("activation", "ReLU"),
        aggr=mcfg.get("aggr", "add"),
        pooling=mcfg.get("pooling", "add"),
        use_learnable_skip=bool(mcfg.get("use_learnable_skip", False)),
    )


def predict(model: CGRMPNN, dataset: ChemDataset, spec: PackSpec,
            batch_size: int = 64,
            device: str | torch.device = "cuda") -> np.ndarray:
    """Predictions for every dataset row, in row order.  One call is one
    ``predict.request`` span with a request id that its ``predict.*``
    spans carry (``utils.tracing``)."""
    rid = next_request_id()
    with span("predict.request", request=rid):
        dev = resolve_device(device)
        model = model.to(dev)
        loader = PackedLoader(dataset, spec, batch_size=batch_size)
        batches = iter(loader)
        rows, preds = [], []
        with torch.no_grad():
            while True:
                # the last next() finds the loader's end
                with span("predict.pack", request=rid):
                    batch = next(batches, None)
                if batch is None:
                    break
                with span("predict.copy", request=rid):
                    db = to_device(batch, dev)
                with span("predict.forward", request=rid):
                    out = apply(model, db, loader.spec)
                with span("predict.readback", request=rid):
                    count_copy_out(out.nbytes)
                    out = out.cpu().numpy()
                mask = batch.graph_mask > 0
                preds.append(out[mask])
                rows.append(batch.row_ids[mask])
        with span("predict.order", request=rid):
            preds = np.concatenate(preds)
            rows = np.concatenate(rows)
            # slot order != input order (first-fit backfill); restore row
            # order
            out = np.empty_like(preds)
            out[rows] = preds
    return out


def evaluate(model: CGRMPNN, dataset: ChemDataset, spec: PackSpec,
             batch_size: int = 64, device: str | torch.device = "cuda",
             plot_path: str | None = None) -> dict:
    """Test-set RMSE and MAE of ``model`` on ``dataset`` (labelled rows);
    with ``plot_path``, the parity plot too."""
    preds = predict(model, dataset, spec, batch_size, device)
    true = dataset.labels[:len(preds)]
    rmse = float(np.sqrt(np.mean((preds - true) ** 2)))
    mae = float(np.mean(np.abs(preds - true)))
    print(f"Test loss: {rmse:.4f}\n")
    if plot_path:
        parity_plot(true, preds, plot_path)
    return {"test_losses": rmse, "test_mae": mae,
            "predictions": preds, "true_values": true}


def parity_plot(true: np.ndarray, preds: np.ndarray, path: str) -> None:
    """Predicted-vs-true scatter, host-side matplotlib; skipped with a
    message when matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("[evaluate] matplotlib unavailable; skipping parity plot")
        return
    fig, ax = plt.subplots(figsize=(10, 8))
    ax.scatter(true, preds, alpha=0.7, label="Predictions")
    lo, hi = float(np.min(true)), float(np.max(true))
    ax.plot([lo, hi], [lo, hi], color="red", linestyle="--",
            label="Identity Line")
    ax.set_xlabel("True Activation Energies [kcal/mol]", fontsize=16)
    ax.set_ylabel("Predicted Activation Energies [kcal/mol]", fontsize=16)
    ax.legend(fontsize=12, frameon=False)
    ax.grid(True, linestyle=":", linewidth=0.7, color="gray")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    print(f"Parity plot saved to {path}")
