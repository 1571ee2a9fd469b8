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
