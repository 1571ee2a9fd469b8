"""Serving and evaluation: load a checkpoint, predict in row order, RMSE.

The counterpart of ``cgr_mpnn_3d_tpu/train/evaluate.py``.  On the card every
batch goes through the whole-model forward kernel; ``device="cpu"`` takes
the plain PyTorch ops.
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
from .checkpoint import load_checkpoint, restore_into

__all__ = ["load_model", "evaluate", "predict"]


def load_model(ckpt_path: str | Path, device: str | torch.device = "cuda"
               ) -> tuple[CGRMPNN, CGRMPNNConfig, dict]:
    """Rebuild (model on ``device``, config, metadata) from a checkpoint's
    npz + sidecar; leaves after the params (optimizer state) are skipped."""
    leaves, meta = load_checkpoint(ckpt_path)
    mcfg = meta["model"]
    cfg = CGRMPNNConfig(
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
    model = CGRMPNN(cfg)
    restore_into(model, leaves[:len(model.state_dict())])
    return model.to(resolve_device(device)).eval(), cfg, meta


def predict(model: CGRMPNN, dataset: ChemDataset, spec: PackSpec,
            batch_size: int = 64,
            device: str | torch.device = "cuda") -> np.ndarray:
    """Predictions for every dataset row, in row order."""
    dev = resolve_device(device)
    model = model.to(dev)
    loader = PackedLoader(dataset, spec, batch_size=batch_size)
    rows, preds = [], []
    with torch.no_grad():
        for batch in loader:
            out = apply(model, to_device(batch, dev), loader.spec)
            mask = batch.graph_mask > 0
            preds.append(out.cpu().numpy()[mask])
            rows.append(batch.row_ids[mask])
    preds = np.concatenate(preds)
    rows = np.concatenate(rows)
    # slot order != input order (first-fit backfill); restore row order
    out = np.empty_like(preds)
    out[rows] = preds
    return out


def evaluate(model: CGRMPNN, dataset: ChemDataset, spec: PackSpec,
             batch_size: int = 64,
             device: str | torch.device = "cuda") -> dict:
    """Test-set RMSE and MAE of ``model`` on ``dataset`` (labelled rows)."""
    preds = predict(model, dataset, spec, batch_size, device)
    true = dataset.labels[:len(preds)]
    rmse = float(np.sqrt(np.mean((preds - true) ** 2)))
    mae = float(np.mean(np.abs(preds - true)))
    print(f"Test loss: {rmse:.4f}\n")
    return {"test_losses": rmse, "test_mae": mae,
            "predictions": preds, "true_values": true}
