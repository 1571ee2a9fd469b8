"""ctypes binding of the native C++ featurizer and packer.

The port's own copy of ``featurizer.cpp`` (SMILES -> CGR graph arrays) and
``packer.cpp`` (the block-dense packer: one window, the placement probe and
a whole epoch in one call), with the C ABI of the JAX package's
``native/``.  The library is built with g++ at first use (or by
:func:`build`) into ``build/libcgrfeat-<hash>.so`` beside the CUDA
libraries; the hash covers the two sources, the compiler and its flags, so
an edited source rebuilds.  Several processes may build at once: each writes
its own temporary file and moves it into place.

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

__all__ = ["featurize", "pack_graphs_native",
           "pack_epoch_native", "place_graphs_native", "last_error",
           "NativeError", "build", "SOURCES", "CXXFLAGS", "BUILD_DIR"]

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
    lib.cgr_pack_graphs.restype = ctypes.c_int
    lib.cgr_pack_graphs.argtypes = (
        [ctypes.c_int32] * 6            # spec
        + [ctypes.c_int32, i32, i32]    # n_graphs, node/edge counts
        + [f32, ctypes.c_int32, f32, ctypes.c_int32]  # feats + dims
        + [i32, i32, f32, i32]          # senders, receivers, labels, rows
        + [f32, f32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
           f32, f32, i32])              # outputs
    lib.cgr_place_graphs.restype = ctypes.c_int
    lib.cgr_place_graphs.argtypes = (
        [ctypes.c_int32] * 6 + [ctypes.c_int32, i32, i32, i32])
    u64 = np.ctypeslib.ndpointer(np.uint64, flags="C")
    lib.cgr_pack_epoch.restype = ctypes.c_int
    lib.cgr_pack_epoch.argtypes = (
        [ctypes.c_int32] * 6            # spec
        + [ctypes.c_int32, i32, i32]    # n_rows, node/edge counts
        + [u64, ctypes.c_int32]         # node feat ptrs, base_dim
        + [u64, ctypes.c_int32]         # extra feat ptrs, extra_dim
        + [u64, ctypes.c_int32]         # edge feat ptrs, e_feat
        + [u64, u64, f32, i32]          # send/recv ptrs, labels, rows
        + [ctypes.c_int32] * 4          # bs, sort, drop_last, max_win
        + [f32, f32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
           f32, f32, i32]               # stacked outputs [W, ...]
        + [np.ctypeslib.ndpointer(np.int32)])  # n_windows_out


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


def pack_graphs_native(graphs, labels, spec, extra_node_feats=None,
                       row_ids=None):
    """Native equivalent of data.batch.pack_graphs: the same placement,
    sentinels and outputs, bit for bit (tests/test_torch_native.py); a
    window that does not fit raises ValueError with the packer's message."""
    lib = _load()
    n_graphs = len(graphs)
    n_feat = graphs[0].node_feats.shape[1]
    if extra_node_feats is not None:
        n_feat += extra_node_feats[0].shape[1]
    e_feat = graphs[0].edge_feats.shape[1]

    node_counts = np.asarray([g.num_nodes for g in graphs], np.int32)
    edge_counts = np.asarray([g.num_edges for g in graphs], np.int32)
    if extra_node_feats is None:
        node_feats = np.ascontiguousarray(
            np.concatenate([g.node_feats for g in graphs], axis=0))
    else:
        node_feats = np.ascontiguousarray(np.concatenate(
            [np.concatenate([g.node_feats,
                             np.asarray(x, np.float32)], axis=1)
             for g, x in zip(graphs, extra_node_feats)], axis=0))
    edge_feats = np.ascontiguousarray(
        np.concatenate([g.edge_feats for g in graphs], axis=0))
    senders = np.ascontiguousarray(
        np.concatenate([g.senders for g in graphs]))
    receivers = np.ascontiguousarray(
        np.concatenate([g.receivers for g in graphs]))
    labels_in = np.asarray(labels, np.float32)
    rows_in = (np.arange(n_graphs, dtype=np.int32) if row_ids is None
               else np.asarray(list(row_ids), np.int32))

    out = _empty_batch(spec, n_feat, e_feat)
    rc = lib.cgr_pack_graphs(
        spec.p, spec.te, spec.tn, spec.tb, spec.d, spec.dn,
        n_graphs, node_counts, edge_counts,
        node_feats, n_feat, edge_feats, e_feat,
        senders, receivers, labels_in, rows_in, *out)
    if rc != 0:
        raise ValueError(lib.cgr_last_error().decode())
    return _cast(out, spec)


def place_graphs_native(graphs, spec) -> bool:
    """Placement-only feasibility probe for one window (no output
    allocation or writes): True iff ``pack_graphs_native(graphs, ...,
    spec)`` would succeed; :func:`last_error` says why not."""
    lib = _load()
    node_counts = np.asarray([g.num_nodes for g in graphs], np.int32)
    edge_counts = np.asarray([g.num_edges for g in graphs], np.int32)
    recv = (np.ascontiguousarray(np.concatenate(
        [g.receivers for g in graphs])) if len(graphs) else
        np.zeros(0, np.int32))
    if recv.size == 0:
        recv = np.zeros(1, np.int32)  # valid pointer for the empty case
    rc = lib.cgr_place_graphs(
        spec.p, spec.te, spec.tn, spec.tb, spec.d, spec.dn,
        len(graphs), node_counts, edge_counts, recv)
    return rc == 0


def last_error() -> str:
    return _load().cgr_last_error().decode()


def _ptr_table(arrays, dtype, keep: list) -> np.ndarray:
    """uint64 table of each array's data pointer (C-contiguous, dtype
    coerced); appends every (possibly copied) array to ``keep``, which the
    caller must hold alive across the native call."""
    ptrs = np.empty(len(arrays), np.uint64)
    for i, a in enumerate(arrays):
        a = np.ascontiguousarray(a, dtype=dtype)
        keep.append(a)
        ptrs[i] = a.ctypes.data
    return ptrs


def pack_epoch_native(graphs, labels, spec, batch_size,
                      extra_node_feats=None, row_ids=None,
                      sort_within=True, drop_last=False):
    """Pack a whole epoch in one native call (the ``reuse_packs`` cache
    build).  ``graphs`` and ``labels`` arrive in epoch order; windowing,
    the in-window stable sort by descending edge count, the overflow
    shrink (n -> int(n*0.8)) and the carry of unconsumed rows are those of
    ``data.loader.PackedLoader``'s serial iteration, bit for bit.  The
    inputs cross as per-graph pointer tables (no epoch-sized
    concatenation).  Returns the list of PackedGraphBatch, each a view
    into one stacked allocation; a window count above the estimate
    (``rc == -2``) doubles it and packs again."""
    from ..data.batch import PackedGraphBatch

    lib = _load()
    n_rows = len(graphs)
    e_feat = graphs[0].edge_feats.shape[1]
    base_dim = graphs[0].node_feats.shape[1]
    keep: list = []   # pointer-table buffers, alive across the call
    nf_ptrs = _ptr_table([g.node_feats for g in graphs], np.float32, keep)
    ef_ptrs = _ptr_table([g.edge_feats for g in graphs], np.float32, keep)
    s_ptrs = _ptr_table([g.senders for g in graphs], np.int32, keep)
    r_ptrs = _ptr_table([g.receivers for g in graphs], np.int32, keep)
    if extra_node_feats is not None:
        extra_dim = np.asarray(extra_node_feats[0]).shape[1]
        x_ptrs = _ptr_table(list(extra_node_feats), np.float32, keep)
    else:
        extra_dim = 0
        x_ptrs = np.zeros(max(1, n_rows), np.uint64)
    n_feat = base_dim + extra_dim
    node_counts = np.asarray([g.num_nodes for g in graphs], np.int32)
    edge_counts = np.asarray([g.num_edges for g in graphs], np.int32)
    labels_in = np.asarray(labels, np.float32)
    rows_in = (np.arange(n_rows, dtype=np.int32) if row_ids is None
               else np.asarray(list(row_ids), np.int32))

    ET, NT = spec.total_edges, spec.total_nodes
    # window-count estimate: the graph-count bound and the edge and node
    # capacity bounds at 90% fill (too low costs a second pass)
    total_e = int(edge_counts.sum())
    total_n = int(node_counts.sum())
    W = max(int(np.ceil(n_rows / batch_size)),
            int(np.ceil(total_e / max(1, 0.9 * ET))),
            int(np.ceil(total_n / max(1, 0.9 * NT)))) + 4
    while True:
        out = _empty_batch(spec, n_feat, e_feat, (W,))
        n_windows = np.zeros(1, np.int32)
        rc = lib.cgr_pack_epoch(
            spec.p, spec.te, spec.tn, spec.tb, spec.d, spec.dn,
            n_rows, node_counts, edge_counts,
            nf_ptrs, base_dim, x_ptrs, extra_dim, ef_ptrs, e_feat,
            s_ptrs, r_ptrs, labels_in, rows_in,
            int(batch_size), int(bool(sort_within)), int(bool(drop_last)),
            W, *out, n_windows)
        if rc == -2:
            W *= 2
            continue
        if rc != 0:
            raise ValueError(lib.cgr_last_error().decode())
        break
    return [_cast(PackedGraphBatch(*[f[w] for f in out]), spec)
            for w in range(int(n_windows[0]))]
