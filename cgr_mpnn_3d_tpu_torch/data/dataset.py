"""Reaction dataset: CSV + optional MACE-descriptor npz fusion.

The counterpart of ``cgr_mpnn_3d_tpu/data/dataset.py`` for reactions (the
JAX dataset's ``mode="mol"`` and ``has_header`` have no caller in the port's
entry points): column 0 = reaction SMILES, column 1 = label; graphs are
featurized once per unique SMILES and cached; an optional ``.npz`` holds
per-row MACE descriptor blocks keyed ``arr_{i}`` that the packer
concatenates onto the node features.

Featurization runs the native C++ featurizer (``native/``) unless the
caller passes ``use_native=False``, which takes the pure-Python ``chem/``
twin.  ``use_native=None`` means native: a library that does not build
raises, where the JAX package falls back to Python.

The featurized graphs persist in ``<csv>.featcache.npz`` beside the CSV
(:meth:`ChemDataset.save_feature_cache`): the same keys and version as the
JAX package's, so either package loads the other's.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path

import numpy as np

from ..chem.featurize import GraphArrays, RxnGraph

__all__ = ["ChemDataset"]


class ChemDataset:
    # bump when featurization semantics change (invalidates disk caches)
    FEAT_VERSION = 2  # v2: rev_edge_index persisted explicitly

    def __init__(self, data_path: str, data_npz_path: str | None = None,
                 use_native: bool | None = None):
        self.data_path = Path(data_path)
        self.use_native = use_native is None or bool(use_native)

        smiles, labels = [], []
        with open(self.data_path, newline="") as f:
            reader = csv.reader(f)
            first = next(reader, None) or []
            # sniff a header row on the label column, as the JAX package
            # does; a single-column file has no header
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
        self._row_tables = None

        self.use_npz = data_npz_path is not None
        self.mace_features: dict[int, np.ndarray] = {}
        if self.use_npz:
            with np.load(data_npz_path) as npz:
                for key in npz.files:
                    self.mace_features[int(key.split("_")[-1])] = \
                        np.asarray(npz[key], np.float32)

    def __len__(self) -> int:
        return len(self.smiles)

    def _featurize(self, smi: str) -> GraphArrays:
        if self.use_native:
            from .. import native
            return native.featurize(smi)
        return RxnGraph(smi).arrays

    def graph(self, key: int) -> GraphArrays:
        """Featurized graph for row ``key`` (cached per unique SMILES)."""
        smi = self.smiles[key]
        g = self._cache.get(smi)
        if g is None:
            g = self._featurize(smi)
            self._cache[smi] = g
        return g

    def extra_feats(self, key: int) -> np.ndarray | None:
        """Per-atom MACE descriptor block for row ``key`` (or None)."""
        if not self.use_npz:
            return None
        if key < 0:
            key = len(self.smiles) + key
        return self.mace_features[key]

    def row_tables(self):
        """The native packer's per-row tables (``native.RowTables``),
        built on first use from every row's graph (featurizing what is not
        yet) and descriptor block, then kept: what a window's one native
        call reads (``data.loader.PackedLoader``)."""
        if self._row_tables is None:
            from ..native import RowTables
            rows = range(len(self))
            self._row_tables = RowTables(
                [self.graph(i) for i in rows], self.labels,
                [self.extra_feats(i) for i in rows] if self.use_npz else None)
        return self._row_tables

    def __getitem__(self, key: int) -> tuple[GraphArrays, np.float32,
                                             np.ndarray | None]:
        return self.graph(key), self.labels[key], self.extra_feats(key)

    @property
    def num_node_features(self) -> int:
        n = self.graph(0).node_feats.shape[1]
        if self.use_npz:
            n += self.mace_features[0].shape[1]
        return n

    @property
    def num_edge_features(self) -> int:
        return self.graph(0).edge_feats.shape[1]

    def _cache_path(self) -> Path:
        return self.data_path.with_suffix(self.data_path.suffix
                                          + ".featcache.npz")

    def save_feature_cache(self) -> Path:
        """Write the featurized graphs next to the CSV so that later runs
        skip SMILES parsing."""
        smis = list(self._cache.keys())
        gs = [self._cache[s] for s in smis]
        payload = {
            "smiles": np.asarray(smis, dtype=object),
            "version": np.asarray([self.FEAT_VERSION]),
            "node_feats": np.concatenate([g.node_feats for g in gs], 0),
            "edge_feats": np.concatenate([g.edge_feats for g in gs], 0),
            "senders": np.concatenate([g.senders for g in gs]),
            "receivers": np.concatenate([g.receivers for g in gs]),
            "rev": np.concatenate([g.rev_edge_index for g in gs])
            if gs else np.zeros((0,), np.int32),
            "n_nodes": np.asarray([g.num_nodes for g in gs], np.int64),
            "n_edges": np.asarray([g.num_edges for g in gs], np.int64),
        }
        path = self._cache_path()
        # written beside and renamed over, so that a process reading it
        # (another rank featurizing the same split) never sees half a file;
        # savez pickles the object-dtype smiles array on its own (it takes
        # no allow_pickle argument: one would be written as an array)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.npz")
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)
        return path

    def load_feature_cache(self) -> bool:
        """Load a saved cache; False if it is absent, older than the CSV,
        of another FEAT_VERSION or unreadable, or misses a row's SMILES."""
        path = self._cache_path()
        if not path.exists() or path.stat().st_mtime < \
                self.data_path.stat().st_mtime:
            return False
        try:
            with np.load(path, allow_pickle=True) as z:
                if int(z["version"][0]) != self.FEAT_VERSION:
                    return False
                smis = list(z["smiles"])
                n_off = np.concatenate([[0], np.cumsum(z["n_nodes"])])
                e_off = np.concatenate([[0], np.cumsum(z["n_edges"])])
                arrays = {k: z[k] for k in ("node_feats", "edge_feats",
                                            "senders", "receivers", "rev")}
        except Exception:
            return False
        for i, smi in enumerate(smis):
            ns = slice(n_off[i], n_off[i + 1])
            es = slice(e_off[i], e_off[i + 1])
            self._cache[str(smi)] = GraphArrays(
                node_feats=arrays["node_feats"][ns].copy(),
                edge_feats=arrays["edge_feats"][es].copy(),
                senders=arrays["senders"][es].copy(),
                receivers=arrays["receivers"][es].copy(),
                rev_edge_index=arrays["rev"][es].copy())
        return set(self.smiles) <= set(self._cache)

    def prefeaturize(self, num_workers: int = 0, cache: bool = False) -> None:
        """Featurize every row now (fills the cache).

        With ``num_workers`` > 0 and the native featurizer, the unique
        SMILES are featurized on a thread pool (the ctypes calls release
        the GIL).  With ``cache``, the disk cache next to the CSV is loaded
        if it is fresh, and written after featurizing otherwise."""
        if cache and self.load_feature_cache():
            return
        if num_workers and self.use_native:
            from concurrent.futures import ThreadPoolExecutor
            unique = [s for s in dict.fromkeys(self.smiles)
                      if s not in self._cache]
            with ThreadPoolExecutor(num_workers) as ex:
                for smi, g in zip(unique, ex.map(self._featurize, unique)):
                    self._cache[smi] = g
        else:
            for i in range(len(self)):
                self.graph(i)
        if cache:
            self.save_feature_cache()


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False
