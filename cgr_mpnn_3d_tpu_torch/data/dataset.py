"""Reaction dataset: CSV + optional MACE-descriptor npz fusion.

The serving part of ``cgr_mpnn_3d_tpu/data/dataset.py`` with the
pure-Python CGR featurizer: column 0 = reaction SMILES, column 1 = label;
graphs are featurized once per unique SMILES and cached; an optional
``.npz`` holds per-row MACE descriptor blocks keyed ``arr_{i}`` that the
packer concatenates onto the node features.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from ..chem.featurize import GraphArrays, RxnGraph

__all__ = ["ChemDataset"]


class ChemDataset:
    def __init__(self, data_path: str, data_npz_path: str | None = None):
        self.data_path = Path(data_path)

        smiles, labels = [], []
        with open(self.data_path, newline="") as f:
            reader = csv.reader(f)
            first = next(reader, None) or []
            # sniff a header row on the label column, as the JAX package does
            has_header = len(first) > 1 and not _is_float(first[1])
            if not has_header:
                f.seek(0)
                reader = csv.reader(f)
            for row in reader:
                if not row:
                    continue
                smiles.append(row[0])
                labels.append(np.float32(row[1]) if len(row) > 1
                              else np.float32(0))
        self.smiles: list[str] = smiles
        self.labels = np.asarray(labels, dtype=np.float32)
        self._cache: dict[str, GraphArrays] = {}

        self.use_npz = data_npz_path is not None
        self.mace_features: dict[int, np.ndarray] = {}
        if self.use_npz:
            with np.load(data_npz_path) as npz:
                for key in npz.files:
                    self.mace_features[int(key.split("_")[-1])] = \
                        np.asarray(npz[key], np.float32)

    def __len__(self) -> int:
        return len(self.smiles)

    def graph(self, key: int) -> GraphArrays:
        """Featurized graph for row ``key`` (cached per unique SMILES)."""
        smi = self.smiles[key]
        g = self._cache.get(smi)
        if g is None:
            g = RxnGraph(smi).arrays
            self._cache[smi] = g
        return g

    def extra_feats(self, key: int) -> np.ndarray | None:
        """Per-atom MACE descriptor block for row ``key`` (or None)."""
        return self.mace_features[key] if self.use_npz else None

    @property
    def num_node_features(self) -> int:
        n = self.graph(0).node_feats.shape[1]
        if self.use_npz:
            n += self.mace_features[0].shape[1]
        return n

    @property
    def num_edge_features(self) -> int:
        return self.graph(0).edge_feats.shape[1]

    def prefeaturize(self) -> None:
        """Eagerly featurize every row (fills the cache)."""
        for i in range(len(self)):
            self.graph(i)


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False
