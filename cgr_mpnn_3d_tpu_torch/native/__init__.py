"""ctypes binding of the native C++ featurizer and packer.

The port's own copy of ``featurizer.cpp`` (SMILES -> CGR graph arrays, with
the C ABI of the JAX package's ``native/``) and ``packer.cpp`` (the
block-dense packer over per-row tables, :class:`RowTables`: one window's
fit, one window, or a whole epoch, each in one call).  The library is
built with g++ at first use (or by :func:`build`) into
``build/libcgrfeat-<hash>.so`` beside the CUDA libraries; the hash covers
the two sources, the compiler and its flags, so an edited source rebuilds.
Several processes may build at once: each writes its own temporary file
and moves it into place.

There is no quiet fallback: a failed build or ``dlopen`` raises
:class:`NativeError` with the compiler's output, and the callers
(``data.ChemDataset``, ``data.PackedLoader``) take the pure-Python
``chem/`` featurizer and ``data.batch`` packer only when asked with
``use_native=False``.  The JAX package's ``available()`` probe is left
out: no path of the port chooses by it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..chem.featurize import GraphArrays

__all__ = ["featurize", "RowTables", "fit_window_native",
           "pack_window_native", "pack_epoch_native", "pack_graphs_native",
           "place_graphs_native", "last_error", "NativeError", "build",
           "SOURCES", "CXXFLAGS", "BUILD_DIR"]

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "build"
SOURCES = ("featurizer.cpp", "packer.cpp")
# the JAX package's Makefile flags
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]

_lock = threading.Lock()
_lib = None


class NativeError(RuntimeError):
    pass


def _cxx() -> list[str]:
    return shlex.split(os.environ.get("CXX") or "g++")


def _target(src_dir: Path, build_dir: Path) -> Path:
    h = hashlib.sha1()
    for name in SOURCES:
        h.update((src_dir / name).read_bytes())
    h.update(" ".join(_cxx() + CXXFLAGS).encode())
    return build_dir / f"libcgrfeat-{h.hexdigest()[:12]}.so"


def build(src_dir: str | Path | None = None,
          build_dir: str | Path | None = None) -> Path:
    """Compile ``featurizer.cpp`` and ``packer.cpp`` of ``src_dir`` (this
    directory) into ``build_dir`` (:data:`BUILD_DIR`) unless the library of
    these sources is there; returns its path.  A failed compile raises
    :class:`NativeError` with its output."""
    src_dir = Path(src_dir or _DIR)
    build_dir = Path(build_dir or BUILD_DIR)
    lib = _target(src_dir, build_dir)
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*_cxx(), *CXXFLAGS, "-o", str(tmp),
           *(str(src_dir / name) for name in SOURCES)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
    except OSError as e:
        raise NativeError(f"cannot run {cmd[0]!r}: {e}") from e
    if out.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise NativeError(
            f"building the native featurizer failed (exit "
            f"{out.returncode}): {' '.join(cmd)}\n{out.stdout}{out.stderr}")
    os.replace(tmp, lib)
    return lib


def _declare(lib) -> None:
    lib.cgr_graph_new.restype = ctypes.c_void_p
    lib.cgr_graph_new.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.cgr_last_error.restype = ctypes.c_char_p
    for f in ["cgr_graph_num_atoms", "cgr_graph_num_edges",
              "cgr_graph_atom_fdim", "cgr_graph_bond_fdim"]:
        getattr(lib, f).restype = ctypes.c_int
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.cgr_graph_copy.restype = None
    lib.cgr_graph_copy.argtypes = [ctypes.c_void_p] + \
        [np.ctypeslib.ndpointer(np.float32)] * 2 + \
        [np.ctypeslib.ndpointer(np.int32)] * 2
    lib.cgr_graph_free.argtypes = [ctypes.c_void_p]
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    spec = [ctypes.c_int32] * 6
    rows = [ctypes.POINTER(_Tables), i32, ctypes.c_int32]
    outs = [f32, f32, i32, i32, i32, i32, i32, i32, i32, i32, i32, f32, f32,
            i32]
    cnt = ctypes.POINTER(ctypes.c_int32)
    lib.cgr_fit_window.restype = ctypes.c_int
    lib.cgr_fit_window.argtypes = (
        spec + rows + [ctypes.c_int32] * 2 + [cnt, cnt])
    lib.cgr_pack_window.restype = ctypes.c_int
    lib.cgr_pack_window.argtypes = (
        spec + rows + [ctypes.c_int32] * 2 + outs + [cnt, cnt])
    lib.cgr_pack_epoch.restype = ctypes.c_int
    lib.cgr_pack_epoch.argtypes = (
        spec + rows + [ctypes.c_int32] * 3 + outs + [cnt, cnt])


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeError(
                    f"the native featurizer {path} failed to load: {e}") from e
            _declare(lib)
            _lib = lib
    return _lib


def featurize(smiles: str, mode: str = "rxn") -> GraphArrays:
    """Native equivalent of chem.RxnGraph / chem.MolGraph -> GraphArrays."""
    lib = _load()
    h = lib.cgr_graph_new(smiles.encode(), 1 if mode == "rxn" else 0)
    if not h:
        raise NativeError(lib.cgr_last_error().decode())
    try:
        n = lib.cgr_graph_num_atoms(h)
        e = lib.cgr_graph_num_edges(h)
        fa = lib.cgr_graph_atom_fdim(h)
        fb = lib.cgr_graph_bond_fdim(h)
        node_feats = np.empty((n, fa), np.float32)
        edge_feats = np.empty((e, fb), np.float32)
        senders = np.empty((e,), np.int32)
        receivers = np.empty((e,), np.int32)
        lib.cgr_graph_copy(h, node_feats, edge_feats, senders, receivers)
    finally:
        lib.cgr_graph_free(h)
    rev = (np.arange(e, dtype=np.int32) ^ 1) if e else np.zeros((0,), np.int32)
    return GraphArrays(node_feats, edge_feats, senders, receivers, rev)


def _empty_batch(spec, n_feat: int, e_feat: int, lead: tuple = ()):
    from ..data.batch import PackedGraphBatch
    ET, NT, BT = spec.total_edges, spec.total_nodes, spec.total_graphs
    return PackedGraphBatch(
        node_x=np.empty((*lead, NT, n_feat), np.float32),
        edge_attr=np.empty((*lead, ET, e_feat), np.float32),
        senders=np.empty((*lead, ET), np.int32),
        receivers=np.empty((*lead, ET), np.int32),
        rev=np.empty((*lead, ET), np.int32),
        edge_nbr=np.empty((*lead, ET, spec.d), np.int32),
        edge_nbr_rev=np.empty((*lead, ET, spec.d), np.int32),
        node_inc=np.empty((*lead, NT, spec.d), np.int32),
        node_out=np.empty((*lead, NT, spec.d), np.int32),
        graph_of_node=np.empty((*lead, NT), np.int32),
        graph_nodes=np.empty((*lead, BT, spec.dn), np.int32),
        labels=np.empty((*lead, BT), np.float32),
        graph_mask=np.empty((*lead, BT), np.float32),
        row_ids=np.empty((*lead, BT), np.int32),
    )


def _cast(b, spec):
    if np.dtype(spec.feat_dtype) == np.float32:
        return b
    return b._replace(node_x=b.node_x.astype(spec.feat_dtype),
                      edge_attr=b.edge_attr.astype(spec.feat_dtype))




class _Tables(ctypes.Structure):
    """``packer.cpp``'s ``CgrRowTables``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "node_counts", "edge_counts", "labels", "row_ids", "node_feats",
        "extra_feats", "edge_feats", "senders", "receivers")]
        + [(f, ctypes.c_int32) for f in (
            "n_rows", "base_dim", "extra_dim", "e_feat")])


class RowTables:
    """The native packer's inputs, one entry a row: ``node_counts`` and
    ``edge_counts`` (int32), ``labels`` (float32), ``row_ids`` (int32, the
    id a packed graph carries out; the row's index unless given) and the
    uint64 data pointers of each row's C-contiguous ``node_feats``,
    ``extra_feats`` (the descriptor block, if any), ``edge_feats``,
    ``senders`` and ``receivers``.

    Each array field of ``graphs`` is copied once into one flat array
    (cast to float32 or int32), which the object keeps alive, and the
    pointers are its base plus the rows' offsets: no loop over rows but
    the gathering of the arrays.  ``labels`` already float32 and
    contiguous is kept, not copied, so that an edit to a label shows."""

    def __init__(self, graphs, labels, extra_node_feats=None, row_ids=None):
        n = len(graphs)
        self.node_counts = np.fromiter((g.num_nodes for g in graphs),
                                       np.int32, n)
        self.edge_counts = np.fromiter((g.num_edges for g in graphs),
                                       np.int32, n)
        self.labels = np.ascontiguousarray(labels, np.float32)
        self.row_ids = (np.arange(n, dtype=np.int32) if row_ids is None
                        else np.ascontiguousarray(row_ids, np.int32))
        if len(self.labels) != n or len(self.row_ids) != n:
            raise ValueError(f"{n} graphs, {len(self.labels)} labels and "
                             f"{len(self.row_ids)} row ids")
        self._keep: list = []
        self.base_dim = graphs[0].node_feats.shape[1] if n else 0
        self.e_feat = graphs[0].edge_feats.shape[1] if n else 0
        nodes, edges = self.node_counts, self.edge_counts
        self.node_feats = self._flat([g.node_feats for g in graphs], nodes,
                                     np.float32, self.base_dim)
        self.edge_feats = self._flat([g.edge_feats for g in graphs], edges,
                                     np.float32, self.e_feat)
        self.senders = self._flat([g.senders for g in graphs], edges,
                                  np.int32)
        self.receivers = self._flat([g.receivers for g in graphs], edges,
                                    np.int32)
        if extra_node_feats is None:
            self.extra_dim = 0
            self.extra_feats = np.zeros(n, np.uint64)
        else:
            extra = list(extra_node_feats)
            if not np.array_equal(
                    np.fromiter((len(x) for x in extra), np.int32, n), nodes):
                raise ValueError("a descriptor block's rows differ from its "
                                 "graph's nodes")
            self.extra_dim = np.shape(extra[0])[1]
            self.extra_feats = self._flat(extra, nodes, np.float32,
                                          self.extra_dim)
        self.n_feat = self.base_dim + self.extra_dim
        ptr = lambda a: a.ctypes.data
        self._c = _Tables(
            ptr(self.node_counts), ptr(self.edge_counts), ptr(self.labels),
            ptr(self.row_ids), ptr(self.node_feats), ptr(self.extra_feats),
            ptr(self.edge_feats), ptr(self.senders), ptr(self.receivers),
            n, self.base_dim, self.extra_dim, self.e_feat)

    def _flat(self, arrays, counts, dtype, width: int | None = None):
        """The arrays (``counts`` rows each) in one flat array, which is
        kept; returns each array's pointer into it."""
        shape = (0,) if width is None else (0, width)
        flat = (np.concatenate(arrays, axis=0, dtype=dtype) if arrays
                else np.zeros(shape, dtype))
        self._keep.append(flat)
        offsets = (np.cumsum(counts) - counts).astype(np.uint64)
        return (np.uint64(flat.ctypes.data)
                + offsets * np.uint64(flat.itemsize * (width or 1)))


def _rows(rows) -> np.ndarray:
    return np.ascontiguousarray(rows, np.int32)


def fit_window_native(tables: RowTables, rows, spec, sort: bool = True,
                      shrink: bool = True) -> tuple[int, int]:
    """How many of the candidate ``rows`` one window takes: the in-window
    stable sort by descending edge count (``sort``), the placement probe,
    the shrink n -> max(1, int(n*0.8)) on a refusal (``shrink``).  Returns
    (that count, the placement attempts); a refused single row, or any
    refusal without ``shrink``, raises ValueError with the packer's
    message.  Nothing is written."""
    lib = _load()
    rows = _rows(rows)
    consumed, probes = ctypes.c_int32(0), ctypes.c_int32(0)
    rc = lib.cgr_fit_window(
        spec.p, spec.te, spec.tn, spec.tb, spec.d, spec.dn,
        ctypes.byref(tables._c), rows, len(rows), int(sort), int(shrink),
        ctypes.byref(consumed), ctypes.byref(probes))
    if rc != 0:
        raise ValueError(lib.cgr_last_error().decode())
    return consumed.value, probes.value


def pack_window_native(tables: RowTables, rows, spec, sort: bool = True,
                       shrink: bool = True):
    """One window in one call: the fit of :func:`fit_window_native`, then
    one pack of the surviving rows.  Returns (PackedGraphBatch, rows
    consumed, placement attempts); a refusal raises as there."""
    lib = _load()
    rows = _rows(rows)
    out = _empty_batch(spec, tables.n_feat, tables.e_feat)
    consumed, probes = ctypes.c_int32(0), ctypes.c_int32(0)
    rc = lib.cgr_pack_window(
        spec.p, spec.te, spec.tn, spec.tb, spec.d, spec.dn,
        ctypes.byref(tables._c), rows, len(rows), int(sort), int(shrink),
        *out, ctypes.byref(consumed), ctypes.byref(probes))
    if rc != 0:
        raise ValueError(lib.cgr_last_error().decode())
    return _cast(out, spec), consumed.value, probes.value


def pack_graphs_native(graphs, labels, spec, extra_node_feats=None,
                       row_ids=None):
    """Native equivalent of data.batch.pack_graphs: the graphs in the
    order given, the same placement, sentinels and outputs, bit for bit
    (tests/test_torch_native.py); a window that does not fit raises
    ValueError with the packer's message."""
    tables = RowTables(graphs, labels, extra_node_feats, row_ids)
    return pack_window_native(tables, np.arange(len(graphs)), spec,
                              sort=False, shrink=False)[0]


def place_graphs_native(graphs, spec) -> bool:
    """Placement-only feasibility probe for one window (no output
    allocation or writes): True iff ``pack_graphs_native(graphs, ...,
    spec)`` would succeed; :func:`last_error` says why not."""
    tables = RowTables(graphs, np.zeros(len(graphs), np.float32))
    try:
        fit_window_native(tables, np.arange(len(graphs)), spec, sort=False,
                          shrink=False)
    except ValueError:
        return False
    return True


def last_error() -> str:
    return _load().cgr_last_error().decode()


def pack_epoch_native(tables: RowTables, order, spec, batch_size,
                      drop_last=False):
    """Pack a whole epoch in one native call (the ``reuse_packs`` cache
    build): the rows of ``tables`` in the epoch ``order``; windowing, the
    fit of :func:`pack_window_native` and the carry of unconsumed rows
    are those of ``data.loader.PackedLoader``'s serial iteration, bit for
    bit.  The tables are the dataset's, built once (10-23 ms for a
    2,048-row library with descriptors on an H100 host's CPU), so the call
    itself is the packing.  Returns (the list of PackedGraphBatch, each a
    view into one stacked allocation; the placement attempts).  A window
    count above the estimate (``rc == -2``) doubles it and packs again."""
    from ..data.batch import PackedGraphBatch

    lib = _load()
    order = _rows(order)
    ET, NT = spec.total_edges, spec.total_nodes
    # window-count estimate: the graph-count bound and the edge and node
    # capacity bounds at 90% fill (too low costs a second pass)
    total_e = int(tables.edge_counts[order].sum())
    total_n = int(tables.node_counts[order].sum())
    W = max(int(np.ceil(len(order) / batch_size)),
            int(np.ceil(total_e / max(1, 0.9 * ET))),
            int(np.ceil(total_n / max(1, 0.9 * NT)))) + 4
    while True:
        out = _empty_batch(spec, tables.n_feat, tables.e_feat, (W,))
        n_windows, probes = ctypes.c_int32(0), ctypes.c_int32(0)
        rc = lib.cgr_pack_epoch(
            spec.p, spec.te, spec.tn, spec.tb, spec.d, spec.dn,
            ctypes.byref(tables._c), order, len(order), int(batch_size),
            int(bool(drop_last)), W, *out, ctypes.byref(n_windows),
            ctypes.byref(probes))
        if rc == -2:
            W *= 2
            continue
        if rc != 0:
            raise ValueError(lib.cgr_last_error().decode())
        break
    return ([_cast(PackedGraphBatch(*[f[w] for f in out]), spec)
             for w in range(n_windows.value)], probes.value)
