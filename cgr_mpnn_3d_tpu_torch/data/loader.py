"""Host-side batch loader: rows in order -> featurize (cached) -> pack.

The serving part of ``cgr_mpnn_3d_tpu/data/loader.py`` (its ``shuffle=False``
iteration) with the serial Python packer: every batch has identical array
shapes, and a window of graphs that overflows its packs shrinks, carrying
the remainder into the next batch -- the same window/carry sequence as the
JAX package's loader.  Shuffling waits for the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .batch import PackedGraphBatch, PackSpec, pack_graphs
from .dataset import ChemDataset

__all__ = ["PackedLoader"]


@dataclass
class PackedLoader:
    """Iterates a :class:`ChemDataset` as fixed-shape :class:`PackedGraphBatch`es.

    ``batch_size`` is the target number of graphs per batch; ``spec.p`` is
    derived from it once (ceil(batch_size / tb)) so shapes stay static.
    """
    dataset: ChemDataset
    spec: PackSpec
    batch_size: int = 32

    def __post_init__(self):
        packs = max(1, int(np.ceil(self.batch_size / self.spec.tb)))
        self.spec = self.spec.with_packs(packs)

    def _pack_window(self, rows: list[int]) -> tuple[PackedGraphBatch, int]:
        """Pack as many of ``rows`` as fit; returns (batch, n_consumed)."""
        n = len(rows)
        while True:
            # big graphs first (first-fit-decreasing); row_ids keep the
            # outputs row-addressable
            window = sorted(rows[:n],
                            key=lambda i: -self.dataset.graph(i).num_edges)
            graphs = [self.dataset.graph(i) for i in window]
            labels = [self.dataset.labels[i] for i in window]
            extra = ([self.dataset.extra_feats(i) for i in window]
                     if self.dataset.use_npz else None)
            try:
                return pack_graphs(graphs, labels, self.spec, extra,
                                   row_ids=window), n
            except ValueError:
                if n == 1:
                    raise
                n = max(1, int(n * 0.8))

    def __iter__(self) -> Iterator[PackedGraphBatch]:
        order = list(range(len(self.dataset)))
        pending: list[int] = []
        pos = 0
        while pos < len(order) or pending:
            take = self.batch_size - len(pending)
            rows = pending + order[pos:pos + take]
            pos += take
            batch, used = self._pack_window(rows)
            pending = rows[used:]
            yield batch
