"""Host-side loader for edge-partitioned training (CLI ``--ep N``).

The counterpart of ``cgr_mpnn_3d_tpu/parallel/ep_loader.py``'s
``EPPackLoader``, with the machinery of its ``_BaseEPLoader`` folded in
(the port has this one loader): each step batch is ``batch_size`` whole
graphs sharded over ``n_ep`` shards by :func:`~.ep_pack.pack_shard_edges`,
yielded as ``(spec, batch)`` with leaves ``[n_dp, n_ep, ...]`` (n_dp = 1
here).

* **Pinned shapes.**  The packer's padded sizes are pinned from a pre-scan
  of the first epoch's batches plus headroom; a later batch that overflows
  (:class:`~.edge_partition.EPOverflow` only, so real input errors surface
  at once) grows the pins monotonically from its own natural sizes and is
  packed again.  Each item carries the spec it was built under.
* **Fixed graph count.**  Short batches are padded with mask-0 dummy graphs
  (1 node, 0 edges).
* **Order.**  Shuffled from ``seed + epoch`` as the JAX loader does, so both
  see the same windows; :meth:`prefetch` packs on a background thread.
* **Reused packs.**  ``reuse_packs`` builds the epoch's items once from the
  epoch-0 order, again while the pins grow during a build (at most 4
  builds, so every item shares the final spec), and emits them in an order
  shuffled from ``seed + epoch``.
* **Workers.**  As in JAX, ``workers`` packs the ``n_dp`` windows of a
  group on a thread pool only when ``n_dp > 1``; at the port's one group it
  is accepted and changes nothing.

Not ported (ROADMAP.md): ``n_dp > 1`` (raises) and the flat v2
``EPLoader``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Sequence

import numpy as np

from ..chem.featurize import GraphArrays
from ..data.loader import background
from .edge_partition import EPOverflow, _r8
from .ep_pack import EPPackedBatch, EPPackSpec, pack_shard_edges

__all__ = ["EPPackLoader"]

_HEADROOM = 1.3


@dataclass
class EPPackLoader:
    """Yields ``(spec, batch)``: an :class:`~.ep_pack.EPPackedBatch` with
    leaves ``[1, n_ep, ...]`` and the pinned :class:`~.ep_pack.EPPackSpec`
    it was built under (the trainer keys its steps on it).  Without a
    ``spec`` the pins come from a pre-scan (see the module doc)."""
    dataset: object
    n_ep: int
    batch_size: int = 32          # graphs per step batch
    n_dp: int = 1
    shuffle: bool = True
    seed: int = 0
    prescan_batches: int = 8      # epoch-0 batches sampled to set pins
    reuse_packs: bool = False
    workers: int = 1
    te: int = 128
    tn: int = 72
    spec: EPPackSpec | None = field(default=None)

    def __post_init__(self):
        if self.n_dp != 1:
            raise NotImplementedError(
                "the port's EP loader runs one data-parallel group (n_dp=1); "
                "--dp and torch.distributed are queued in ROADMAP.md")
        if len(self.dataset) == 0:
            raise ValueError("empty dataset")
        self._epoch = 0
        self._cache: list | None = None
        self._dummy = self._make_dummy()
        if self.spec is None:
            for w in self._prescan_windows():
                self._learn(w)

    def __len__(self) -> int:
        return int(np.ceil(len(self.dataset) / self.batch_size))

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _make_dummy(self) -> tuple[GraphArrays, np.ndarray | None]:
        g0 = self.dataset.graph(0)
        fe = self.dataset.num_edge_features
        dummy = GraphArrays(
            node_feats=np.zeros((1, g0.node_feats.shape[1]), np.float32),
            edge_feats=np.zeros((0, fe), np.float32),
            senders=np.zeros(0, np.int32),
            receivers=np.zeros(0, np.int32),
            rev_edge_index=np.zeros(0, np.int32))
        extra = None
        if self.dataset.use_npz:
            extra = np.zeros(
                (1, np.asarray(self.dataset.extra_feats(0)).shape[1]),
                np.float32)
        return dummy, extra

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def _window(self, rows: Sequence[int]):
        """(graphs, labels, extra, n_real) for one batch, padded to
        batch_size with mask-0 dummies."""
        graphs = [self.dataset.graph(i) for i in rows]
        labels = [float(self.dataset.labels[i]) for i in rows]
        use_npz = self.dataset.use_npz
        extra = ([self.dataset.extra_feats(i) for i in rows]
                 if use_npz else None)
        n_real = len(rows)
        dummy, dummy_extra = self._dummy
        for _ in range(self.batch_size - n_real):
            graphs.append(dummy)
            labels.append(0.0)
            if use_npz:
                extra.append(dummy_extra)
        return graphs, labels, extra, n_real

    def _prescan_windows(self):
        order = self._order()
        bs = self.batch_size
        n = min(self.prescan_batches, int(np.ceil(len(order) / bs)))
        return [self._window(order[i * bs:(i + 1) * bs]) for i in range(n)]

    def __iter__(self):
        if not self.reuse_packs:
            yield from self._iter_build()
            return
        if self._cache is None:
            saved = self._epoch
            self._epoch = 0
            try:
                for _ in range(4):
                    before = self.spec
                    items = list(self._iter_build())
                    if self.spec == before:
                        break
                    # the pins grew during the build, so its items mix
                    # specs: build again at the (monotone) final pins
                else:
                    raise RuntimeError(
                        "EP pins failed to stabilize over 4 builds")
            finally:
                self._epoch = saved
            self._cache = items
        for i in self.batch_order(self._epoch):
            yield self._cache[i]

    def batch_order(self, epoch: int) -> np.ndarray:
        """The order of the cached items in ``epoch`` (``reuse_packs``):
        shuffled from seed + epoch (identity without ``shuffle``)."""
        order = np.arange(len(self._cache))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    def _iter_build(self):
        order = list(self._order())
        bs = self.batch_size
        windows = [self._window(order[i:i + bs])
                   for i in range(0, len(order), bs)]
        for w in windows:
            grows = 0
            while True:
                try:
                    b = self._shard_pinned(w)
                    break
                except EPOverflow:
                    grows += 1
                    if grows > 2:
                        raise
                    # grow the pins from THIS window's natural sizes, then
                    # pack it again at the new pinned shapes
                    self._learn(w)
            yield self.spec, _stack_group([b])

    def prefetch(self, depth: int = 2):
        """The same items, packed by a background thread ``depth`` items
        ahead of the consumer."""
        return background(self, depth)

    def _shard_pinned(self, window) -> EPPackedBatch:
        graphs, labels, extra, n_real = window
        b, _ = pack_shard_edges(graphs, labels, self.n_ep, te=self.te,
                                tn=self.tn, extra_node_feats=extra,
                                spec=self.spec)
        if n_real < self.batch_size:
            mask = b.graph_mask.copy()
            mask[:, n_real:] = 0.0
            b = b._replace(graph_mask=mask)
        return b

    def _learn(self, window) -> None:
        graphs, labels, extra, _ = window
        _, nat = pack_shard_edges(graphs, labels, self.n_ep, te=self.te,
                                  tn=self.tn, extra_node_feats=extra)
        gro = lambda v: _r8(int(np.ceil(v * _HEADROOM)))  # noqa: E731
        cur = self.spec
        if cur is None:
            self.spec = replace(
                nat, p=max(1, int(np.ceil(nat.p * _HEADROOM))),
                d=gro(nat.d), d2=gro(nat.d2), dr=gro(nat.dr),
                dn=gro(nat.dn), b=self.batch_size,
                caps=tuple(gro(c) if c else 0 for c in nat.caps),
                gp=gro(nat.gp), kg=gro(nat.kg))
        else:
            if nat.te > cur.te or nat.tn > cur.tn:
                # the natural build grew the tile (a giant fragment)
                cur = replace(cur, te=max(cur.te, nat.te),
                              tn=max(cur.tn, nat.tn))
            self.spec = replace(
                cur, p=max(cur.p, int(np.ceil(nat.p * _HEADROOM))),
                d=max(cur.d, gro(nat.d)), d2=max(cur.d2, gro(nat.d2)),
                dr=max(cur.dr, gro(nat.dr)), dn=max(cur.dn, gro(nat.dn)),
                b=max(cur.b, self.batch_size),
                caps=tuple(max(c, gro(n) if n else 0)
                           for c, n in zip(cur.caps, nat.caps)),
                gp=max(cur.gp, gro(nat.gp)), kg=max(cur.kg, gro(nat.kg)))
        self.te, self.tn = self.spec.te, self.spec.tn


def _stack_group(group: list) -> EPPackedBatch:
    cls = type(group[0])
    return cls(*[np.stack([getattr(b, f) for b in group], 0)
                 for f in cls._fields])
