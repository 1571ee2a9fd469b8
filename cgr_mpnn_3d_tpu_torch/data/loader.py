"""Host-side batch loader: shuffle -> featurize (cached) -> pack.

The counterpart of ``cgr_mpnn_3d_tpu/data/loader.py`` with the serial Python
packer: every batch has identical array shapes, a window of graphs that
overflows its packs shrinks and carries the remainder into the next batch,
and the shuffle order comes from ``seed + epoch`` -- so the windows are the
same as the JAX package's loader for the same dataset and seed.  A
background thread (:meth:`PackedLoader.prefetch`) overlaps packing with the
device's work.  The JAX loader's native packer, worker threads, reused
packs and window plan are not ported yet.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

from .batch import PackedGraphBatch, PackSpec, pack_graphs
from .dataset import ChemDataset

__all__ = ["PackedLoader", "background"]


@dataclass
class PackedLoader:
    """Iterates a :class:`ChemDataset` as fixed-shape :class:`PackedGraphBatch`es.

    ``batch_size`` is the target number of graphs per batch; ``spec.p`` is
    derived from it once (ceil(batch_size / tb)) so shapes stay static.
    """
    dataset: ChemDataset
    spec: PackSpec
    batch_size: int = 32
    shuffle: bool = False
    seed: int = 0
    drop_last: bool = False

    def __post_init__(self):
        packs = max(1, int(np.ceil(self.batch_size / self.spec.tb)))
        self.spec = self.spec.with_packs(packs)
        self._epoch = 0

    def __len__(self) -> int:
        return int(np.ceil(len(self.dataset) / self.batch_size))

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle order to a global epoch index so resumed runs
        replay the exact same data order."""
        self._epoch = epoch

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

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
        order = [int(i) for i in self._order()]
        pending: list[int] = []
        pos = 0
        while pos < len(order) or pending:
            take = self.batch_size - len(pending)
            rows = pending + order[pos:pos + take]
            pos += take
            if (self.drop_last and pos >= len(order)
                    and len(rows) < self.batch_size):
                return  # skip the final partial batch
            batch, used = self._pack_window(rows)
            pending = rows[used:]
            yield batch

    def prefetch(self, depth: int = 2) -> Iterator[PackedGraphBatch]:
        """The same batches, packed by a background thread ``depth``
        batches ahead of the consumer."""
        return background(self, depth)


def background(items: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``items`` on a background thread, at most ``depth`` items
    ahead of the consumer; an exception there is raised here."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _SENTINEL = object()
    err: list[BaseException] = []

    def worker():
        try:
            for b in items:
                q.put(b)
        except BaseException as e:  # surfaced to the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item
