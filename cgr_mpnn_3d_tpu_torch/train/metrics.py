"""Metrics logging: stdout + JSONL always; Weights & Biases when available.

The counterpart of ``cgr_mpnn_3d_tpu/train/metrics.py``: the same records in
the same JSONL file (``<log_dir>/<run_name>.jsonl``), with wandb attached
only when asked for and importable.  Histograms take a mapping of parameter
names (``convs.0.w``, ...) to tensors instead of a pytree.
"""

from __future__ import annotations

import json
import time
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, run_name: str, log_dir: str | Path = "runs",
                 config: dict | None = None, use_wandb: bool = False,
                 stdout: bool = True):
        self.run_name = run_name
        self.stdout = stdout
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / f"{run_name}.jsonl"
        self._f = open(self.path, "a")
        self._wandb = None
        if config:
            self._emit({"event": "config", **config})
        if use_wandb:
            try:
                import wandb  # noqa: deferred optional dependency
                self._wandb = wandb
                wandb.init(project="CGR-MPNN-3D-TPU", name=run_name,
                           config=config or {})
            except Exception as e:  # wandb missing or offline: degrade
                print(f"[metrics] wandb unavailable ({e}); using JSONL only")

    def _emit(self, rec: dict) -> None:
        rec = {"t": time.time(), **rec}
        self._f.write(json.dumps(rec, default=float) + "\n")
        self._f.flush()

    def log(self, log_dict: dict, commit: bool = True,
            step: int | None = None) -> None:
        rec = dict(log_dict)
        if step is not None:
            rec["step"] = step
        self._emit(rec)
        if self.stdout:
            kv = ", ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in rec.items() if k != "t")
            print(f"[{self.run_name}] {kv}")
        if self._wandb is not None:
            self._wandb.log(log_dict, commit=commit, step=step)

    def log_histograms(self, tag: str, tensors: Mapping[str, torch.Tensor],
                       epoch: int, bins: int = 24) -> None:
        """Per-parameter downsampled histograms (params or grads), one JSONL
        record per epoch with {name: {counts, lo, hi, nonfinite}}; mirrored
        to wandb as Histogram objects when attached.  Non-finite entries are
        counted, not binned."""
        hists = {}
        wandb_hists = {}
        for name, tsr in tensors.items():
            a = tsr.detach().float().cpu().numpy().ravel()
            if a.size == 0:
                continue
            finite = a[np.isfinite(a)]
            rec = {"nonfinite": int(a.size - finite.size)}
            if finite.size:
                counts, edges = np.histogram(finite, bins=bins)
                rec.update(counts=counts.tolist(),
                           lo=float(edges[0]), hi=float(edges[-1]))
                if self._wandb is not None:
                    wandb_hists[f"{tag}/{name}"] = self._wandb.Histogram(
                        np_histogram=(counts, edges))
            else:
                rec.update(counts=[], lo=0.0, hi=0.0)
            hists[name] = rec
        self._emit({"event": f"histograms/{tag}", "epoch": epoch,
                    "bins": bins, "hist": hists})
        if self._wandb is not None:
            self._wandb.log(wandb_hists, commit=False)

    def finish(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
