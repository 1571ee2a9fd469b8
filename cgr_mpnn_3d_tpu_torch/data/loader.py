"""Host-side batch loader: shuffle -> featurize (cached) -> pack.

The counterpart of ``cgr_mpnn_3d_tpu/data/loader.py``: every batch has
identical array shapes, a window of graphs that overflows its packs shrinks
(n -> int(n*0.8)) and carries the remainder into the next batch, and the
shuffle order comes from ``seed + epoch`` -- so the windows are the JAX
package's for the same dataset and seed.

* **Packer.**  The native packer (``native/``) unless ``use_native=False``
  picks the Python twin (``data.batch``); both give the same batches bit
  for bit.  ``use_native=None`` means native, and a library that does not
  build raises (the JAX loader falls back to Python there).
* **Workers.**  ``workers`` is accepted for the JAX command line's
  ``--loader_workers`` and packs serially: the JAX loader's speculative
  thread pool gives the serial batches bit for bit, and on the measured
  workload it was slower than one thread (PERF.md section 6), while
  :meth:`PackedLoader.prefetch` already overlaps packing with the device.
* **Reused packs.**  ``reuse_packs`` packs the epoch once, from the epoch-0
  order (on the native path in one ``pack_epoch_native`` call), and later
  epochs emit the same batches in an order shuffled from ``seed + epoch``
  (:meth:`PackedLoader.batch_order`); :meth:`PackedLoader.cached_batches`
  hands the cache to the trainer's device-resident epoch.
* :meth:`PackedLoader.prefetch` packs on a background thread.

Windows are always sorted big graphs first (first-fit-decreasing); the JAX
loader's ``sort_within_batch`` has no other value in use.  Left out:
``round_packs_to``, which exists for the JAX loader's ``--pack_q``
sub-packs, which no Hopper kernel wants (ROADMAP.md section 3).

:meth:`PackedLoader.plan_windows` gives the windows of serial iteration
from the placement probe alone, so that the ranks of a multi-process run
agree on every window while each packs only its own (the trainer's
``_mh_stream``).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

from .batch import PackedGraphBatch, PackSpec, pack_graphs, place_graphs
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
    use_native: bool | None = None   # None = native (raises if it fails)
    # the JAX loader's packing threads; accepted, and packing is serial
    workers: int = 1
    # pack the epoch once and reuse its batches in later epochs, shuffling
    # batch order instead of graph order
    reuse_packs: bool = False

    def __post_init__(self):
        packs = max(1, int(np.ceil(self.batch_size / self.spec.tb)))
        self.spec = self.spec.with_packs(packs)
        self.use_native = self.use_native is None or bool(self.use_native)
        self._epoch = 0
        self._pack_cache: list[PackedGraphBatch] | None = None

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
        """Pack as many of ``rows`` as fit; returns (batch, n_consumed).

        Native path: the shrink loop probes with the placement-only
        ``place_graphs_native`` and packs once at the surviving n."""
        n = len(rows)
        while True:
            # big graphs first (first-fit-decreasing); row_ids keep the
            # outputs row-addressable
            window = sorted(rows[:n],
                            key=lambda i: -self.dataset.graph(i).num_edges)
            graphs = [self.dataset.graph(i) for i in window]
            if self.use_native:
                from .. import native
                if not native.place_graphs_native(graphs, self.spec):
                    if n == 1:
                        raise ValueError(native.last_error())
                    n = max(1, int(n * 0.8))
                    continue
                pack = native.pack_graphs_native
            else:
                pack = pack_graphs
            labels = [self.dataset.labels[i] for i in window]
            extra = ([self.dataset.extra_feats(i) for i in window]
                     if self.dataset.use_npz else None)
            try:
                return pack(graphs, labels, self.spec, extra,
                            row_ids=window), n
            except ValueError:
                if self.use_native or n == 1:
                    raise
                n = max(1, int(n * 0.8))

    def plan_windows(self, order) -> list[list[int]]:
        """The exact window and carry plan that serial iteration over
        ``order`` emits -- which rows land in which batch, the overflow
        shrink (n -> int(n*0.8)) and the carry of unconsumed rows included
        -- from the placement-only probe (``native.place_graphs_native``,
        or ``data.batch.place_graphs`` with ``use_native=False``): no
        packing and no output allocation (JAX ``loader.py:127-170``)."""
        if self.use_native:
            from .. import native
            probe = lambda gs: native.place_graphs_native(gs, self.spec)
        else:
            probe = lambda gs: place_graphs(gs, self.spec)
        plan: list[list[int]] = []
        pending: list[int] = []
        order = [int(i) for i in order]
        pos = 0
        while pos < len(order) or pending:
            take = self.batch_size - len(pending)
            rows = pending + order[pos:pos + take]
            pos += take
            if (self.drop_last and pos >= len(order)
                    and len(rows) < self.batch_size):
                break
            n = len(rows)
            while True:
                window = sorted(rows[:n],
                                key=lambda i: -self.dataset.graph(i).num_edges)
                if probe([self.dataset.graph(i) for i in window]):
                    break
                if n == 1:
                    # the error the real pack raises
                    self._pack_window(rows[:1])
                    raise RuntimeError("the placement probe refused a graph "
                                       "that the packer placed")
                n = max(1, int(n * 0.8))
            plan.append(rows[:n])
            pending = rows[n:]
        return plan

    def __iter__(self) -> Iterator[PackedGraphBatch]:
        if not self.reuse_packs:
            yield from self._iter_pack()
            return
        cache = self.cached_batches()
        for i in self.batch_order(self._epoch):
            yield cache[i]

    def cached_batches(self) -> list[PackedGraphBatch]:
        """The reused epoch's batches in cache order, packed on first use
        (``reuse_packs``): what a device-resident epoch stages."""
        if self._pack_cache is None:
            # the cache comes from the epoch-0 order, so a resumed run
            # rebuilds the same batches whatever epoch it resumes into
            saved = self._epoch
            self._epoch = 0
            try:
                self._pack_cache = self._build_cache()
            finally:
                self._epoch = saved
        return self._pack_cache

    def batch_order(self, epoch: int) -> np.ndarray:
        """The order of the cached batches in ``epoch``: shuffled from seed
        + epoch (identity without ``shuffle``)."""
        order = np.arange(len(self.cached_batches()))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    def _build_cache(self) -> list[PackedGraphBatch]:
        """Pack the whole epoch for reuse: on the native path one
        ``pack_epoch_native`` call, bit for bit the batches of per-window
        iteration."""
        if not self.use_native:
            return list(self._iter_pack())
        from .. import native
        order = self._order().tolist()
        return native.pack_epoch_native(
            [self.dataset.graph(i) for i in order],
            [self.dataset.labels[i] for i in order], self.spec,
            self.batch_size,
            extra_node_feats=([self.dataset.extra_feats(i) for i in order]
                              if self.dataset.use_npz else None),
            row_ids=order, sort_within=True,
            drop_last=self.drop_last)

    def _iter_pack(self) -> Iterator[PackedGraphBatch]:
        """Pack every window; an overflow carries its remainder into the
        next one."""
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
