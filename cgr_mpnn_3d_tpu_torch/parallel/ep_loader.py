"""Host-side loaders for edge-partitioned training (CLI ``--ep N``).

The counterpart of ``cgr_mpnn_3d_tpu/parallel/ep_loader.py``: each step
batch is ``batch_size`` whole graphs sharded over ``n_ep`` shards, and
``n_dp`` such batches (consecutive windows of the order) make one item,
stacked with leaves ``[n_dp, n_ep, ...]``; a short last group is padded
with an all-sentinel filler (mask 0: its loss and gradients are exactly 0).
Two loaders share the machinery of :class:`_BaseEPLoader`:

* :class:`EPPackLoader` -- the ``--ep`` path: the pack-local layout of
  :func:`~.ep_pack.pack_shard_edges`, each item yielded as ``(spec,
  batch)`` with the :class:`~.ep_pack.EPPackSpec` it was built under;
* :class:`EPLoader` -- the flat layout of
  :func:`~.edge_partition.shard_edges` (items are the stacked
  :class:`~.edge_partition.EdgeShardedBatch`), the independent layout the
  pack-local one is checked against.

* **Pinned shapes.**  The padded sizes are pinned from a pre-scan of the
  first epoch's batches plus headroom; a later batch that overflows
  (:class:`~.edge_partition.EPOverflow` only, so real input errors surface
  at once) grows the pins monotonically from its own natural sizes, and
  its whole group is sharded again at the new pins.
* **Fixed graph count.**  Short batches are padded with mask-0 dummy graphs
  (1 node, 0 edges).
* **Order.**  Shuffled from ``seed + epoch`` as the JAX loaders do, so both
  see the same windows; :meth:`prefetch` shards on a background thread.
* **Reused packs.**  ``reuse_packs`` builds the epoch's items once from the
  epoch-0 order, again while the pins grow during a build (at most 4
  builds, so every item shares the final pins), and emits them in an order
  shuffled from ``seed + epoch``.
* **Workers.**  JAX's ``workers`` shards the ``n_dp`` windows of a group on
  a thread pool, bit for bit the serial items; here it is accepted and the
  windows are sharded serially (ROADMAP.md section 1.3).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Sequence

import numpy as np

from ..chem.featurize import GraphArrays
from ..data.loader import background
from .edge_partition import EdgeShardedBatch, EPOverflow, _r8, shard_edges
from .ep_pack import (EPPackedBatch, EPPackSpec, empty_ep_pack_batch,
                      pack_shard_edges)

__all__ = ["EPLoader", "EPPackLoader", "empty_ep_batch_like",
           "natural_ep_pins"]

_HEADROOM = 1.3


def natural_ep_pins(b: EdgeShardedBatch) -> dict:
    """The padded sizes an :class:`EdgeShardedBatch` was built with."""
    nk = b.own_recv_inc.shape[1]
    nkh = b.node_x.shape[1]
    n_ep = b.node_x.shape[0]
    return {
        "nk": nk,
        "ek": b.src_idx.shape[1],
        "s_max": (nkh - nk) // n_ep,
        "d": b.part_inc.shape[2],
        "d_out": b.ext_out.shape[2],
        "d_recv": b.own_recv_inc.shape[2],
        "dn": b.graph_nodes.shape[2],
    }


def empty_ep_batch_like(b: EdgeShardedBatch) -> EdgeShardedBatch:
    """An all-sentinel batch of the same shapes: every gather hits the zero
    row and graph_mask is 0, so its loss and gradients are exactly 0 (the
    data-parallel filler of a short last group)."""
    NKH = b.node_x.shape[1]
    NK = b.own_recv_inc.shape[1]
    T = NKH - NK
    EK = b.src_idx.shape[1]
    B = b.labels.shape[1]
    return EdgeShardedBatch(
        node_x=np.zeros_like(b.node_x),
        edge_attr=np.zeros_like(b.edge_attr),
        src_idx=np.full_like(b.src_idx, NKH),
        rev=np.full_like(b.rev, EK),
        dst_part=np.full_like(b.dst_part, NKH),
        part_inc=np.full_like(b.part_inc, EK),
        ext_out=np.full_like(b.ext_out, EK),
        recv_idx=np.full_like(b.recv_idx, NK),
        own_recv_inc=np.full_like(b.own_recv_inc, T),
        graph_nodes=np.full_like(b.graph_nodes, NK),
        node_graph=np.full_like(b.node_graph, B),
        inv_deg_own=np.zeros_like(b.inv_deg_own),
        labels=np.zeros_like(b.labels),
        graph_mask=np.zeros_like(b.graph_mask))


@dataclass
class _BaseEPLoader:
    """The window, epoch, prescan, pin-growth and reuse machinery of both
    loaders (see the module doc).  A subclass gives ``_has_pins``,
    ``_pin_state``, ``_shard_pinned``, ``_learn`` (grow the pins from one
    window's natural sizes) and ``_filler``, and may wrap each item in
    ``_emit``."""
    dataset: object
    n_ep: int
    batch_size: int = 32          # graphs per data-parallel group's batch
    n_dp: int = 1
    shuffle: bool = True
    seed: int = 0
    prescan_batches: int = 8      # epoch-0 batches sampled to set pins
    reuse_packs: bool = False
    workers: int = 1

    def __post_init__(self):
        if len(self.dataset) == 0:
            raise ValueError("empty dataset")
        self._epoch = 0
        self._cache: list | None = None
        self._dummy = self._make_dummy()
        if not self._has_pins():
            for w in self._prescan_windows():
                self._learn(w)

    # -- the subclass's part -------------------------------------------------
    def _has_pins(self) -> bool:
        raise NotImplementedError

    def _pin_state(self):
        """A snapshot of the pins that compares equal while they hold."""
        raise NotImplementedError

    def _shard_pinned(self, window):
        raise NotImplementedError

    def _learn(self, window) -> None:
        raise NotImplementedError

    def _filler(self, like):
        raise NotImplementedError

    def _emit(self, stacked):
        return stacked

    # -- shared --------------------------------------------------------------
    def __len__(self) -> int:
        n_batches = int(np.ceil(len(self.dataset) / self.batch_size))
        return int(np.ceil(n_batches / self.n_dp))

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
                    before = self._pin_state()
                    items = list(self._iter_build())
                    if self._pin_state() == before:
                        break
                    # the pins grew during the build, so its items mix
                    # pins: build again at the (monotone) final pins
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
        for g0 in range(0, len(windows), self.n_dp):
            group_windows = windows[g0:g0 + self.n_dp]
            group, i, grows = [], 0, 0
            while i < len(group_windows):
                try:
                    group.append(self._shard_pinned(group_windows[i]))
                    i += 1
                except EPOverflow:
                    grows += 1
                    if grows > 2 * len(group_windows):
                        raise
                    # grow the pins from THIS window's natural sizes, then
                    # shard the whole group again at the new pins
                    self._learn(group_windows[i])
                    group, i = [], 0
            if len(group) < self.n_dp:
                group += [self._filler(group[0])] * (self.n_dp - len(group))
            yield self._emit(_stack_group(group))

    def prefetch(self, depth: int = 2):
        """The same items, sharded by a background thread ``depth`` items
        ahead of the consumer."""
        return background(self, depth)

    @staticmethod
    def _masked(b, n_real: int, batch_size: int):
        """``b`` with the dummy graphs past ``n_real`` masked out."""
        if n_real < batch_size:
            mask = b.graph_mask.copy()
            mask[:, n_real:] = 0.0
            b = b._replace(graph_mask=mask)
        return b


@dataclass
class EPLoader(_BaseEPLoader):
    """Yields stacked ``[n_dp, n_ep, ...]`` :class:`EdgeShardedBatch` items
    (the flat layout); ``pins`` are :func:`shard_edges`'s size arguments
    (:func:`natural_ep_pins`' keys), learned by the pre-scan when None."""
    pins: dict | None = field(default=None)

    def _has_pins(self) -> bool:
        return self.pins is not None

    def _pin_state(self):
        return None if self.pins is None else tuple(sorted(
            self.pins.items()))

    def _shard_pinned(self, window) -> EdgeShardedBatch:
        graphs, labels, extra, n_real = window
        b = shard_edges(graphs, labels, self.n_ep,
                        extra_node_feats=extra, **(self.pins or {}))
        return self._masked(b, n_real, self.batch_size)

    def _learn(self, window) -> None:
        graphs, labels, extra, _ = window
        nat = natural_ep_pins(shard_edges(graphs, labels, self.n_ep,
                                          extra_node_feats=extra))
        pins = dict(self.pins or {})
        for k, v in nat.items():
            pins[k] = max(_r8(int(np.ceil(v * _HEADROOM))), pins.get(k, 0))
        self.pins = pins

    def _filler(self, like: EdgeShardedBatch) -> EdgeShardedBatch:
        return empty_ep_batch_like(like)


@dataclass
class EPPackLoader(_BaseEPLoader):
    """Yields ``(spec, batch)``: an :class:`~.ep_pack.EPPackedBatch` with
    leaves ``[n_dp, n_ep, ...]`` and the pinned :class:`~.ep_pack.EPPackSpec`
    it was built under (the trainer keys its steps on it).  Without a
    ``spec`` the pins come from a pre-scan (see the module doc)."""
    te: int = 128
    tn: int = 72
    spec: EPPackSpec | None = field(default=None)

    def _has_pins(self) -> bool:
        return self.spec is not None

    def _pin_state(self):
        return self.spec

    def _filler(self, like: EPPackedBatch) -> EPPackedBatch:
        return empty_ep_pack_batch(self.spec, like.node_x.shape[2],
                                   like.edge_attr.shape[2])

    def _emit(self, stacked):
        return self.spec, stacked

    def _shard_pinned(self, window) -> EPPackedBatch:
        graphs, labels, extra, n_real = window
        b, _ = pack_shard_edges(graphs, labels, self.n_ep, te=self.te,
                                tn=self.tn, extra_node_feats=extra,
                                spec=self.spec)
        return self._masked(b, n_real, self.batch_size)

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


def _stack_group(group: list) -> EdgeShardedBatch | EPPackedBatch:
    cls = type(group[0])
    return cls(*[np.stack([getattr(b, f) for b in group], 0)
                 for f in cls._fields])
