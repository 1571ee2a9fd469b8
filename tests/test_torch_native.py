"""The port's native C++ featurizer and packer (``cgr_mpnn_3d_tpu_torch/
native/``) on the CPU:

* its featurizer equals the JAX package's native featurizer bit for bit
  and the port's Python ``RxnGraph`` / ``MolGraph`` at 1e-6 (the tolerance
  of tests/test_native.py), on that file's corpora and the 300-reaction
  corpus; its errors name the defect;
* ``pack_graphs_native`` and ``place_graphs_native`` equal the port's
  ``pack_graphs`` and ``place_graphs``; ``pack_epoch_native`` equals
  per-window iteration of the port's loader (native and Python) and the
  JAX package's ``PackedLoader(reuse_packs=True)`` cache, bit for bit,
  with and without descriptors, through overflow carry and ``drop_last``;
* the loader's native windows (one ``pack_window_native`` call a window
  over the dataset's row tables) equal the Python twin's and
  ``plan_windows``, refuse a lone graph with the packer's message, write
  every output byte (buffers pre-filled with garbage), call no
  ``ChemDataset.graph`` once the tables are built, and count their windows
  and placement attempts;
* the library builds under a hash of its sources (an edited source builds
  anew), and a compiler that fails raises: no path falls back to Python.
"""

import csv
import shutil
from pathlib import Path

import numpy as np
import pytest

import cgr_mpnn_3d_tpu.data as jdata
from cgr_mpnn_3d_tpu import native as jnative
from cgr_mpnn_3d_tpu_torch import native
from cgr_mpnn_3d_tpu_torch.chem import MolGraph, RxnGraph
from cgr_mpnn_3d_tpu_torch.chem.featurize import GraphArrays
from cgr_mpnn_3d_tpu_torch.data import (ChemDataset, PackedLoader, PackSpec,
                                        pack_graphs, place_graphs, plan_spec)
from cgr_mpnn_3d_tpu_torch.data.descriptors import synthetic_descriptors_npz

REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "examples" / "demo.csv"
CORPUS = REPO / "tests" / "corpus_reactions.csv"
FIELDS = ("node_feats", "edge_feats", "senders", "receivers",
          "rev_edge_index")

CORPUS_RXN = [line.split(",")[0] for line in
              DEMO.read_text().splitlines()[1:]] + [
    "CCO>>CC=O",
    "[N:1]([H:2])([H:3])[H:4]>>[N:1]([H:2])[H:3].[H:4]",
    "CC(=O)N>>CC(=O)N",
]
CORPUS_MOL = ["CCO", "c1ccccc1", "CC(=O)OC", "C1CC1CC", "[13CH4]",
              "c1cc[nH]c1", "ClCCBr", "C=CC=C", "[C-]#[O+]",
              "c1ccc(cc1)-c1ccccc1", "C%10CCCCC%10", "CC(=O)O.[Na+]"]


def _corpus_smiles():
    with open(CORPUS, newline="") as f:
        return [r[0] for r in list(csv.reader(f))[1:]]


def _corpus(mode):
    return CORPUS_RXN + _corpus_smiles() if mode == "rxn" else CORPUS_MOL


def _python(smi, mode):
    return (RxnGraph(smi) if mode == "rxn" else MolGraph(smi)).arrays


def _assert_batch_equal(a, b, what=""):
    assert a._fields == b._fields
    for f, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")


def _assert_lists_equal(a, b, what=""):
    assert len(a) == len(b), (what, len(a), len(b))
    for w, (x, y) in enumerate(zip(a, b)):
        _assert_batch_equal(x, y, f"{what} window {w}")


@pytest.mark.parametrize("mode", ["rxn", "mol"])
def test_featurize_equals_the_jax_native_featurizer(mode):
    for smi in _corpus(mode):
        a, b = native.featurize(smi, mode), jnative.featurize(smi, mode)
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, (smi, f)
            np.testing.assert_array_equal(x, y, err_msg=f"{smi} {f}")


@pytest.mark.parametrize("mode", ["rxn", "mol"])
def test_featurize_matches_the_python_twin(mode):
    for smi in _corpus(mode):
        a, b = native.featurize(smi, mode), _python(smi, mode)
        for f in ("senders", "receivers", "rev_edge_index"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{smi} {f}")
        for f in ("node_feats", "edge_feats"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{smi} {f}")


def test_errors_name_the_defect():
    with pytest.raises(native.NativeError, match="unclosed ring"):
        native.featurize("C1CC", "mol")
    with pytest.raises(native.NativeError):
        native.featurize("[Xx]", "mol")
    graphs = [native.featurize(CORPUS_RXN[0])]
    spec = plan_spec(graphs, te=4, tn=2, tb=1).with_packs(1)
    assert not native.place_graphs_native(graphs, spec)
    with pytest.raises(ValueError, match="exceeds pack tile"):
        native.pack_graphs_native(graphs, [0.0], spec)


@pytest.mark.parametrize("extra,rows", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_pack_and_place_equal_the_python_packer(extra, rows):
    graphs = [native.featurize(s) for s in CORPUS_RXN]
    labels = [0.5 * i - 1.0 for i in range(len(graphs))]
    rng = np.random.default_rng(0)
    xs = ([rng.random((g.num_nodes, 5)).astype(np.float32) for g in graphs]
          if extra else None)
    row_ids = list(rng.permutation(100)[:len(graphs)]) if rows else None
    spec = plan_spec(graphs, te=64, tn=32, tb=4)
    for p in range(1, 8):
        s = spec.with_packs(p)
        fits = place_graphs(graphs, s)
        assert native.place_graphs_native(graphs, s) == fits, p
        if fits:
            _assert_batch_equal(
                pack_graphs(graphs, labels, s, xs, row_ids=row_ids),
                native.pack_graphs_native(graphs, labels, s, xs,
                                          row_ids=row_ids), f"p={p}")
    assert fits, "no pack count placed every graph"


def _loaders(tmp_path, bs, te, tn, tb, npz=False, drop_last=False, seed=3):
    """(port native, port Python, JAX) loaders with reused packs over the
    demo set, shuffled from ``seed``."""
    kw = {}
    if npz:
        synthetic_descriptors_npz(str(DEMO), str(tmp_path / "d.npz"), 6)
        kw = dict(data_npz_path=str(tmp_path / "d.npz"))
    tn_ds = ChemDataset(str(DEMO), **kw)
    tp_ds = ChemDataset(str(DEMO), use_native=False, **kw)
    j_ds = jdata.ChemDataset(str(DEMO), **kw)
    spec = plan_spec([tn_ds.graph(i) for i in range(len(tn_ds))], te=te,
                     tn=tn, tb=tb)
    lkw = dict(batch_size=bs, shuffle=True, seed=seed, reuse_packs=True,
               drop_last=drop_last)
    return (PackedLoader(tn_ds, spec, **lkw),
            PackedLoader(tp_ds, spec, use_native=False, **lkw),
            jdata.PackedLoader(j_ds, jdata.PackSpec(**vars(spec)), **lkw))


@pytest.mark.parametrize("case", ["plain", "npz", "overflow_carry",
                                  "drop_last"])
def test_pack_epoch_equals_per_window_and_the_jax_cache(tmp_path, case):
    geom = {"plain": dict(bs=4, te=128, tn=64, tb=4),
            "npz": dict(bs=4, te=128, tn=64, tb=4, npz=True),
            # one pack of 64 edge slots for 8-graph windows: the shrink
            # and carry run on nearly every window
            "overflow_carry": dict(bs=8, te=64, tn=48, tb=8),
            "drop_last": dict(bs=3, te=128, tn=64, tb=3,
                              drop_last=True)}[case]
    ln, lp, lj = _loaders(tmp_path, **geom)
    next(iter(ln))                 # builds the cache in one native call
    next(iter(lj))
    assert ln._pack_cache is not None and lj._pack_cache is not None
    per_window = list(_loaders(tmp_path, **geom)[0]._iter_pack())
    python = list(lp._iter_pack())
    n = len(ln.dataset)
    if case == "overflow_carry":
        assert len(per_window) > -(-n // 8), "the spec did not overflow"
    if case == "drop_last":
        assert len(per_window) == n // 3
    _assert_lists_equal(ln._pack_cache, per_window, "per-window")
    _assert_lists_equal(ln._pack_cache, python, "python")
    _assert_lists_equal(ln._pack_cache, lj._pack_cache, "jax cache")


def test_pack_epoch_grows_its_window_estimate():
    """A window estimate that is too small (rc == -2) is doubled and the
    epoch packed again: every row lands in some window."""
    graphs = [native.featurize(s) for s in CORPUS_RXN] * 4
    labels = np.arange(len(graphs), dtype=np.float32)
    # two graphs a pack: the graph slots, which the estimate leaves out,
    # bound the windows
    spec = plan_spec(graphs, te=64, tn=48, tb=2).with_packs(1)
    tables = native.RowTables(graphs, labels)
    out, probes = native.pack_epoch_native(tables, np.arange(len(graphs)),
                                           spec, 8)
    assert probes >= len(out)
    rows = np.concatenate([b.row_ids[b.graph_mask > 0] for b in out])
    assert sorted(rows.tolist()) == list(range(len(graphs)))
    estimate = max(-(-len(graphs) // 8),
                   int(np.ceil(sum(g.num_edges for g in graphs)
                               / (0.9 * spec.total_edges))),
                   int(np.ceil(sum(g.num_nodes for g in graphs)
                               / (0.9 * spec.total_nodes)))) + 4
    assert len(out) > estimate


# -- the loader's one native call a window ---------------------------------

# loader geometry a case: batch size, tile and loader options
WINDOW_CASES = {
    "plain": dict(bs=4, te=128, tn=64, tb=4),
    "shuffled": dict(bs=4, te=128, tn=64, tb=4, shuffle=True),
    "npz": dict(bs=4, te=128, tn=64, tb=4, npz=True, shuffle=True),
    "drop_last": dict(bs=3, te=128, tn=64, tb=3, drop_last=True,
                      shuffle=True),
    # one pack of 64 edge slots for 8-graph windows: the first probe fails
    # and the shrink and carry run
    "overflow_carry": dict(bs=8, te=64, tn=48, tb=8, shuffle=True),
}


def _window_loaders(tmp_path, bs, te, tn, tb, npz=False, shuffle=False,
                    drop_last=False):
    """(native, Python) loaders without reused packs over the demo set."""
    kw = {}
    if npz:
        synthetic_descriptors_npz(str(DEMO), str(tmp_path / "d.npz"), 6)
        kw = dict(data_npz_path=str(tmp_path / "d.npz"))
    ds = ChemDataset(str(DEMO), **kw)
    spec = plan_spec([ds.graph(i) for i in range(len(ds))], te=te, tn=tn,
                     tb=tb)
    lkw = dict(batch_size=bs, shuffle=shuffle, seed=5, drop_last=drop_last)
    return (PackedLoader(ds, spec, **lkw),
            PackedLoader(ChemDataset(str(DEMO), use_native=False, **kw),
                         spec, use_native=False, **lkw))


def _probes(bs, n_rows, used):
    """The placement attempts of serial iteration whose windows took
    ``used`` rows each: one a window, and one more a shrink."""
    pending = pos = probes = 0
    for u in used:
        take = min(bs - pending, n_rows - pos)
        pos += take
        n = pending + take
        probes += 1
        while n != u:
            n = max(1, int(n * 0.8))
            probes += 1
        pending = pending + take - u
    return probes


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_loader_windows_equal_the_python_twin_and_the_plan(tmp_path, case):
    geom = WINDOW_CASES[case]
    ln, lp = _window_loaders(tmp_path, **geom)
    native_batches = list(ln)
    _assert_lists_equal(native_batches, list(lp), "python")
    n = len(ln.dataset)
    if case == "overflow_carry":
        assert len(native_batches) > -(-n // geom["bs"]), "no overflow"
    if case == "drop_last":
        assert len(native_batches) == n // geom["bs"]
    plan = ln.plan_windows(ln._order())
    assert plan == lp.plan_windows(lp._order())
    assert [sorted(b.row_ids[b.graph_mask > 0].tolist())
            for b in native_batches] == [sorted(w) for w in plan]


@pytest.mark.parametrize("limit,message", [
    (dict(te=19), "graph exceeds pack tile; increase te/tn"),
    (dict(dn=9), "graph has more nodes than dn"),
    (dict(d=2), "node in-degree exceeds ELL width d"),
])
def test_a_lone_refused_graph_raises_the_packers_message(limit, message):
    """Row 0 (10 nodes, 20 edges, in-degree 3) fits no pack: every window
    holding it shrinks to it alone, and that refusal raises."""
    ds = ChemDataset(str(DEMO))
    spec = PackSpec(**{**dict(te=128, tn=64, tb=4, d=8, dn=16), **limit})
    loader = PackedLoader(ds, spec, batch_size=4)
    for fn in (lambda: next(iter(loader)),
               lambda: loader.plan_windows(loader._order())):
        with pytest.raises(ValueError) as err:
            fn()
        assert str(err.value) == message
    python = PackedLoader(ChemDataset(str(DEMO), use_native=False), spec,
                          batch_size=4, use_native=False)
    with pytest.raises(ValueError):
        next(iter(python))


def _bond(rng, F=6, Fe=3):
    """A two-atom graph: two nodes, two directed edges."""
    return GraphArrays(rng.random((2, F)).astype(np.float32),
                       rng.random((2, Fe)).astype(np.float32),
                       np.array([0, 1], np.int32), np.array([1, 0], np.int32),
                       np.array([1, 0], np.int32))


@pytest.mark.parametrize("packs,what", [(2, "full"), (3, "empty")])
def test_every_output_byte_is_written(monkeypatch, packs, what):
    """Outputs pre-filled with a garbage pattern come out as the Python
    packer's batch: four bonds fill two packs of 4 edge, 4 node and 2
    graph slots to the last slot; a third pack stays empty.  Single
    windows and a whole epoch."""
    garbage = native._empty_batch

    def filled(*args, **kw):
        out = garbage(*args, **kw)
        for a in out:
            a.view(np.uint8).fill(0xA5)
        return out

    monkeypatch.setattr(native, "_empty_batch", filled)
    rng = np.random.default_rng(1)
    graphs = [_bond(rng) for _ in range(4)]
    labels = [1.5, -2.0, 0.25, 3.0]
    xs = [rng.random((2, 2)).astype(np.float32) for _ in graphs]
    spec = PackSpec(te=4, tn=4, tb=2, d=2, dn=3, p=packs)
    want = pack_graphs(graphs, labels, spec, xs, row_ids=[7, 3, 5, 1])
    got = native.pack_graphs_native(graphs, labels, spec, xs,
                                    row_ids=[7, 3, 5, 1])
    if what == "full":
        assert (got.graph_mask > 0).all() and (got.senders < 8).all()
    else:
        assert not (got.graph_mask[-2:] > 0).any()
    _assert_batch_equal(got, want, what)
    tables = native.RowTables(graphs, labels, xs)
    epoch, _ = native.pack_epoch_native(tables, np.arange(4), spec, 4)
    _assert_lists_equal(
        epoch, [pack_graphs(graphs, labels, spec, xs)], f"epoch {what}")


@pytest.mark.parametrize("case", ["npz", "overflow_carry"])
def test_a_native_pass_calls_no_graph_and_counts_its_windows(
        tmp_path, monkeypatch, case):
    from cgr_mpnn_3d_tpu_torch.utils import tracing
    geom = WINDOW_CASES[case]
    loader, _ = _window_loaders(tmp_path, **geom)
    loader.dataset.row_tables()
    calls = []
    graph = ChemDataset.graph
    monkeypatch.setattr(ChemDataset, "graph",
                        lambda self, i: calls.append(i) or graph(self, i))
    before = tracing.counters()
    batches = list(loader)
    after = tracing.counters()
    assert calls == []
    used = [int((b.graph_mask > 0).sum()) for b in batches]
    probes = _probes(geom["bs"], len(loader.dataset), used)
    if case == "overflow_carry":
        assert probes > len(batches)
    assert after["pack_windows"] - before["pack_windows"] == len(batches)
    assert after["pack_probes"] - before["pack_probes"] == probes
    loader.plan_windows(loader._order())
    again = tracing.counters()
    assert calls == []
    assert again["pack_windows"] == after["pack_windows"]
    assert again["pack_probes"] - after["pack_probes"] == probes


def test_an_edited_source_builds_under_a_new_hash(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES:
        shutil.copy(Path(native.__file__).parent / name, src / name)
    first = native.build(src, tmp_path / "build")
    assert first.exists() and first.parent == tmp_path / "build"
    assert native.build(src, tmp_path / "build") == first   # cached
    mtime = first.stat().st_mtime_ns
    with open(src / "packer.cpp", "a") as f:
        f.write("\n// an edit\n")
    second = native.build(src, tmp_path / "build")
    assert second != first and second.exists()
    assert first.stat().st_mtime_ns == mtime
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(native.NativeError, match="failed"):
        native.build(Path(native.__file__).parent, tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    ds = ChemDataset(str(DEMO))
    assert ds.use_native
    with pytest.raises(native.NativeError, match="failed"):
        ds.graph(0)
    py = ChemDataset(str(DEMO), use_native=False)
    spec = plan_spec([py.graph(i) for i in range(len(py))])
    with pytest.raises(native.NativeError, match="failed"):
        next(iter(PackedLoader(py, spec, batch_size=4)))
    assert len(list(PackedLoader(py, spec, batch_size=4,
                                 use_native=False))) == 3
