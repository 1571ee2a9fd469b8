"""The port's host pipeline gives exactly the JAX package's arrays:
featurization, pack planning, packing, the loader's window sequence, the
descriptor files, and the move to tensors."""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

import cgr_mpnn_3d_tpu.chem as jchem
import cgr_mpnn_3d_tpu.data as jdata
import cgr_mpnn_3d_tpu_torch.chem as tchem
import cgr_mpnn_3d_tpu_torch.data as tdata
from cgr_mpnn_3d_tpu.data.descriptors import (
    read_xyz as j_read_xyz, synthetic_descriptors_npz as j_synth_npz)
from cgr_mpnn_3d_tpu.data.synthetic import synthetic_graphs as j_synth
from cgr_mpnn_3d_tpu_torch.data.descriptors import (
    read_xyz as t_read_xyz, synthetic_descriptors_npz as t_synth_npz)
from cgr_mpnn_3d_tpu_torch.data.synthetic import synthetic_graphs as t_synth

REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "examples" / "demo.csv"
SMILES = ["CCO>>CC=O", "CC(=O)N>>CC(=O)N", "C=CC=C>>C=CC=C",
          "CCO>C>CCO", "O>C>CO", "N>C>CN", "CC>>CC",
          "[N:1]([H:2])([H:3])[H:4]>>[N:1]([H:2])[H:3].[H:4]"]


def _corpus(n):
    with open(REPO / "tests" / "corpus_reactions.csv", newline="") as f:
        rows = list(csv.reader(f))[1:]
    return [r[0] for r in rows[:n]]


def _assert_graph_equal(a, b):
    for f in ("node_feats", "edge_feats", "senders", "receivers",
              "rev_edge_index"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _assert_batch_equal(a, b):
    assert a._fields == b._fields
    for f, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("source", ["pallas_smiles", "corpus"])
def test_featurize_plan_pack_identical(source):
    smiles = SMILES if source == "pallas_smiles" else _corpus(60)
    labels = [float(i) for i in range(len(smiles))]
    gj = [jchem.RxnGraph(s).arrays for s in smiles]
    gt = [tchem.RxnGraph(s).arrays for s in smiles]
    for a, b in zip(gj, gt):
        _assert_graph_equal(a, b)
    for kw in (dict(), dict(te=64, tn=32, tb=8)):
        sj, st = jdata.plan_spec(gj, **kw), tdata.plan_spec(gt, **kw)
        assert (sj.te, sj.tn, sj.tb, sj.d, sj.dn, sj.p) == \
            (st.te, st.tn, st.tb, st.d, st.dn, st.p)
        pj = jdata.packs_needed(gj, sj)
        assert pj == tdata.packs_needed(gt, st)
        while not jdata.place_graphs(gj, sj.with_packs(pj)):
            assert not tdata.place_graphs(gt, st.with_packs(pj))
            pj += 1
        assert tdata.place_graphs(gt, st.with_packs(pj))
        _assert_batch_equal(
            jdata.pack_graphs(gj, labels, sj.with_packs(pj)),
            tdata.pack_graphs(gt, labels, st.with_packs(pj)))
        _assert_batch_equal(jdata.empty_batch(sj.with_packs(2), 78, 14),
                            tdata.empty_batch(st.with_packs(2), 78, 14))


def test_mol_graphs_identical():
    for s in ["CCO", "c1ccccc1O", "[NH4+]", "C#N", "OC(=O)C"]:
        _assert_graph_equal(jchem.MolGraph(s).arrays, tchem.MolGraph(s).arrays)


def test_synthetic_graphs_identical():
    gj = j_synth(20, np.random.default_rng(3), node_feat_dim=16)
    gt = t_synth(20, np.random.default_rng(3), node_feat_dim=16)
    for a, b in zip(gj, gt):
        _assert_graph_equal(a, b)


@pytest.mark.parametrize("batch_size", [7, 16, 64])
def test_loader_windows_identical(tmp_path, batch_size):
    """The same window/carry sequence as the JAX loader's Python path,
    including the overflow shrink (te=64 tiles force it)."""
    path = tmp_path / "rx.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["smiles", "ea"])
        for i, s in enumerate(_corpus(70)):
            w.writerow([s, float(i)])
    j_synth_npz(path, tmp_path / "rx.npz", 4)
    dj = jdata.ChemDataset(str(path), data_npz_path=str(tmp_path / "rx.npz"),
                           use_native=False)
    dt = tdata.ChemDataset(str(path), data_npz_path=str(tmp_path / "rx.npz"))
    assert dt.num_node_features == dj.num_node_features == 78 + 12
    spec = jdata.plan_spec([dj.graph(i) for i in range(len(dj))],
                           te=64, tn=32, tb=8)
    lj = jdata.PackedLoader(dj, spec, batch_size=batch_size, shuffle=False,
                            use_native=False)
    lt = tdata.PackedLoader(dt, spec, batch_size=batch_size)
    assert lj.spec == lt.spec
    bj, bt = list(lj), list(lt)
    assert len(bj) == len(bt) > len(dj) // batch_size
    for a, b in zip(bj, bt):
        _assert_batch_equal(a, b)


def test_descriptor_files_identical(tmp_path):
    j_synth_npz(DEMO, tmp_path / "j.npz", 8, seed=2)
    t_synth_npz(DEMO, tmp_path / "t.npz", 8, seed=2)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert a.files == b.files and len(a.files) == 10
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    xyz = REPO / "examples" / "demo.xyz"
    for (sa, pa), (sb, pb) in zip(j_read_xyz(xyz), t_read_xyz(xyz)):
        assert sa == sb
        np.testing.assert_array_equal(pa, pb)


def test_to_device_round_trip():
    graphs = [tchem.RxnGraph(s).arrays for s in SMILES]
    spec = tdata.plan_spec(graphs, te=64, tn=32, tb=8).with_packs(2)
    batch = tdata.pack_graphs(graphs, [1.0] * len(graphs), spec)
    tb = tdata.to_device(batch, "cpu")
    assert type(tb) is type(batch)
    for f, a, t in zip(batch._fields, batch, tb):
        assert isinstance(t, torch.Tensor), f
        assert t.dtype == torch.from_numpy(a).dtype, f
        np.testing.assert_array_equal(t.numpy(), a, err_msg=f)
    # the sentinel equals the row count
    assert int(tb.senders.max()) == spec.total_nodes
    assert int(tb.edge_nbr.max()) == spec.total_edges
    assert int(tb.graph_nodes.max()) == spec.total_nodes


# -- the loader's modes and the feature cache ---------------------------------

@pytest.fixture
def corpus_csv(tmp_path):
    path = tmp_path / "rx.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["smiles", "ea"])
        for i, s in enumerate(_corpus(40)):
            w.writerow([s, float(i)])
    return path


def _tight_spec(ds):
    # te=64 tiles make windows of 6 and more overflow and carry
    return tdata.plan_spec([ds.graph(i) for i in range(len(ds))], te=64,
                           tn=32, tb=4)


@pytest.mark.parametrize("use_native", [True, False])
def test_parallel_packing_yields_the_serial_batches(corpus_csv, use_native):
    """``workers`` packs serially in the port: its batches are those of one
    worker and of the JAX loader's thread pool, bit for bit."""
    ds = tdata.ChemDataset(str(corpus_csv), use_native=use_native)
    dj = jdata.ChemDataset(str(corpus_csv), use_native=use_native)
    spec = _tight_spec(ds)
    for shuffle in (False, True):
        kw = dict(batch_size=6, shuffle=shuffle, seed=3,
                  use_native=use_native)
        a = list(tdata.PackedLoader(ds, spec, **kw))
        b = list(tdata.PackedLoader(ds, spec, workers=3, **kw).prefetch())
        c = list(jdata.PackedLoader(dj, jdata.PackSpec(**vars(spec)),
                                    workers=3, **kw).prefetch())
        assert len(a) == len(b) == len(c) > len(ds) // 6
        for x, y, z in zip(a, b, c):
            _assert_batch_equal(x, y)
            _assert_batch_equal(x, z)


def test_reuse_packs_same_batches_in_shuffled_order(corpus_csv):
    """Epoch 2 on yields the cache's batch objects (composed from the
    epoch-0 order) in an order shuffled from seed + epoch; a loader that
    starts at a later epoch builds the same cache."""
    ds = tdata.ChemDataset(str(corpus_csv))
    spec = _tight_spec(ds)
    mk = lambda: tdata.PackedLoader(ds, spec, batch_size=6, shuffle=True,
                                    seed=5, reuse_packs=True)
    ld = mk()
    e0 = list(ld)
    ld.set_epoch(1)
    e1 = list(ld)
    assert {id(b) for b in e0} == {id(b) for b in e1} and len(e0) > 2
    key = lambda b: tuple(b.row_ids.tolist())  # noqa: E731
    orders = set()
    for ep in range(1, 5):
        ld.set_epoch(ep)
        orders.add(tuple(key(b) for b in ld))
    assert len(orders) > 1, "no epoch reordered the batches"
    straight = tdata.PackedLoader(ds, spec, batch_size=6, shuffle=True,
                                  seed=5)
    assert len(ld._pack_cache) == len(e0)
    for a, b in zip(ld._pack_cache, straight):
        _assert_batch_equal(a, b)
    late = mk()
    late.set_epoch(7)
    ld.set_epoch(7)
    for a, b in zip(ld, late):
        _assert_batch_equal(a, b)


@pytest.mark.parametrize("use_native,drop_last", [(True, False),
                                                  (False, False),
                                                  (True, True)])
def test_emitted_windows_equal_the_jax_plan(corpus_csv, use_native,
                                            drop_last):
    """The rows of every batch the port emits, overflow shrink and carry
    included, are those of the JAX loader's window plan."""
    ds = tdata.ChemDataset(str(corpus_csv), use_native=use_native)
    dj = jdata.ChemDataset(str(corpus_csv), use_native=use_native)
    spec = _tight_spec(ds)
    kw = dict(batch_size=7, shuffle=True, seed=2, drop_last=drop_last,
              use_native=use_native)
    lt = tdata.PackedLoader(ds, spec, **kw)
    lj = jdata.PackedLoader(dj, jdata.PackSpec(**vars(spec)), **kw)
    plan = lj.plan_windows(lt._order())
    emitted = [sorted(b.row_ids[b.graph_mask > 0].tolist()) for b in lt]
    assert [sorted(w) for w in plan] == emitted
    assert len(plan) > len(ds) // 7


def test_feature_cache_round_trips_and_crosses_packages(corpus_csv,
                                                         tmp_path):
    import os
    ds = tdata.ChemDataset(str(corpus_csv))
    ds.prefeaturize(cache=True)
    cache = Path(str(corpus_csv) + ".featcache.npz")
    assert cache.exists()
    back = tdata.ChemDataset(str(corpus_csv))
    assert back.load_feature_cache()
    for s in set(ds.smiles):
        _assert_graph_equal(back._cache[s], ds._cache[s])
    # the JAX package loads the port's cache, and the port the JAX one's
    dj = jdata.ChemDataset(str(corpus_csv), use_native=False)
    assert dj.load_feature_cache()
    for s in set(ds.smiles):
        _assert_graph_equal(dj._cache[s], ds._cache[s])
    other = tmp_path / "other.csv"
    other.write_text(corpus_csv.read_text())
    jw = jdata.ChemDataset(str(other), use_native=False)
    jw.prefeaturize(cache=True)
    pt = tdata.ChemDataset(str(other))
    assert pt.load_feature_cache()
    for s in set(pt.smiles):
        _assert_graph_equal(pt._cache[s], jw._cache[s])
    # stale: older than the CSV, or of another version
    t = cache.stat().st_mtime
    os.utime(corpus_csv, (t + 10, t + 10))
    assert not tdata.ChemDataset(str(corpus_csv)).load_feature_cache()
    os.utime(corpus_csv, (t - 10, t - 10))
    assert tdata.ChemDataset(str(corpus_csv)).load_feature_cache()
    stale = tdata.ChemDataset(str(corpus_csv))
    stale.FEAT_VERSION = tdata.ChemDataset.FEAT_VERSION + 1
    assert not stale.load_feature_cache()
    assert not tdata.ChemDataset(str(DEMO)).load_feature_cache()


def test_prefeaturize_on_workers_equals_serial(corpus_csv):
    serial = tdata.ChemDataset(str(corpus_csv))
    serial.prefeaturize()
    pooled = tdata.ChemDataset(str(corpus_csv))
    pooled.prefeaturize(num_workers=2)
    assert list(pooled._cache) == list(serial._cache)
    for s in serial._cache:
        _assert_graph_equal(pooled._cache[s], serial._cache[s])
    python = tdata.ChemDataset(str(corpus_csv), use_native=False)
    python.prefeaturize(num_workers=2)
    for s in serial._cache:
        _assert_graph_equal(python._cache[s], serial._cache[s])


def test_dataset_rows_equal_jax(tmp_path):
    bare = tmp_path / "bare.csv"
    bare.write_text("".join(DEMO.read_text().splitlines(True)[1:4]))
    j_synth_npz(DEMO, tmp_path / "d.npz", 4)
    for path, kw in ((bare, dict()),
                     (DEMO, dict(data_npz_path=str(tmp_path / "d.npz")))):
        dt = tdata.ChemDataset(str(path), **kw)
        dj = jdata.ChemDataset(str(path), **kw)
        assert dt.smiles == dj.smiles and len(dt) == len(dj) > 2
        np.testing.assert_array_equal(dt.labels, dj.labels)
        for i in (0, 1, -1):
            (gt, lt, xt), (gj, lj, xj) = dt[i], dj[i]
            _assert_graph_equal(gt, gj)
            assert lt == lj
            assert (xt is None) == (xj is None)
            if xt is not None:
                np.testing.assert_array_equal(xt, xj)
