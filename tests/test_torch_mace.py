"""MACE-MP-0 small in the port (``models/mace.py``, ``ops/mace.py``) on the
CPU at 16 channels (l <= 3, correlation 3, 2 interactions, r_max 6 Å) on
seeded weights:

* the port's plain path equals the benchmark's reference
  (``gpubench/reference/mace.py``) on demo.xyz's 57 real geometries, and
  dropping the order-3 term or the second interaction fails that
  comparison;
* the descriptors are unchanged under a rotation and a translation and
  follow a permutation of the atoms; an atom moved beyond the cutoff of
  all others leaves their first-layer descriptors unchanged;
* the real coupling tables are sympy's Clebsch-Gordan coefficients in the
  basis of the spherical harmonics (back in the complex basis, and the
  product of two harmonics couples to a third), and every order-3 path is
  a multiple of its multiset's polynomial;
* the edge list, the element tiles and a window's layout hold what the
  kernels read; the geometry path of ``predict`` equals ``predict`` on an
  npz of the reference's descriptors for the same rows, and the CLI takes
  it with ``--mace_model``;
* the benchmark's seeded geometries put as many pairs within 6 Å as
  demo.xyz's on demo.csv's 10 reactions (the first 30 of its 57 frames),
  none closer than 0.9 Å.
"""

from __future__ import annotations

import csv
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu_torch.chem.periodic import ATOMIC_NUMBERS
from cgr_mpnn_3d_tpu_torch.data.descriptors import atom_map_order, read_xyz
from cgr_mpnn_3d_tpu_torch.models import mace as M
from cgr_mpnn_3d_tpu_torch.ops import mace as ops
from gpubench.reference import mace as ref

ROOT = Path(__file__).resolve().parent.parent
DEMO_CSV = ROOT / "examples" / "demo.csv"
DEMO_XYZ = ROOT / "examples" / "demo.xyz"
C = 16
CFG = M.MACEConfig(num_channels=C)
REF_CFG = dict(channels=C, elements=89, bessel=8, radial_mlp=[64, 64, 64],
               interactions=2, correlation=3, r_max=6.0, polynomial_cutoff=5,
               avg_num_neighbors=CFG.avg_num_neighbors)
# float32 sums in other orders: the port and the reference agree to a few
# ulps of the largest descriptor (5e-7 measured); TF32 in the radial MLP
# alone reads 6e-4
TOL = 1e-5


def _gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def weights():
    return ref.make_weights(REF_CFG, 2026, "cpu")


@pytest.fixture(scope="module")
def demo():
    structs = [(np.asarray([ATOMIC_NUMBERS[s] - 1 for s in sym]), pos)
               for sym, pos in read_xyz(DEMO_XYZ)]
    pos = torch.tensor(np.concatenate([p for _, p in structs]),
                       dtype=torch.float32)
    z = torch.tensor(np.concatenate([z for z, _ in structs]),
                     dtype=torch.int32)
    ptr = torch.tensor(np.concatenate(
        [[0], np.cumsum([len(z) for z, _ in structs])]), dtype=torch.int32)
    return structs, pos, z, ptr


def _model(weights, cfg=CFG):
    m = M.MACE(cfg)
    m.load_state_dict(weights)
    return m.eval()


def _desc(m, pos, z, ptr):
    """``m``'s descriptors of the structures, with the tiles and the edge
    count that ``predict`` hands it."""
    n_edges = len(ops.edge_list(pos, ptr, m.cfg.r_max)[0])
    return m.descriptors(pos, z, ptr, ops.element_tiles(z.numpy()), n_edges)


def _ref(structs, weights):
    return torch.cat(ref.descriptors(structs, weights, REF_CFG, "cpu"))


def test_port_matches_reference_on_demo_geometries(weights, demo):
    structs, pos, z, ptr = demo
    assert len(structs) == 57
    got = _desc(_model(weights), pos, z, ptr)
    want = _ref(structs, weights)
    assert got.shape == (len(z), 2 * C)
    assert _gap(got, want) < TOL
    # both layers carry signal
    assert got[:, :C].abs().mean() > 0.1 and got[:, C:].abs().mean() > 0.1


@pytest.mark.parametrize("fault", ["order_3_dropped",
                                   "second_interaction_skipped"])
def test_dropped_term_fails_the_comparison(weights, demo, fault,
                                           monkeypatch):
    structs, pos, z, ptr = demo
    if fault == "order_3_dropped":
        w = dict(weights)
        for t in range(2):
            w[f"products.{t}.weights.2"] = torch.zeros_like(
                w[f"products.{t}.weights.2"])
        got = _desc(_model(w), pos, z, ptr)
    else:
        orig = ops.mace_interaction_ref
        calls = itertools.count()

        def first_only(*a):
            msg = orig(*a)
            return msg if next(calls) % 2 == 0 else msg * 0.0
        monkeypatch.setattr(ops, "mace_interaction_ref", first_only)
        got = _desc(_model(weights), pos, z, ptr)
    assert _gap(got, _ref(structs, weights)) > 100 * TOL


def _rotation(seed: int) -> torch.Tensor:
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    return torch.tensor(q * np.sign(np.linalg.det(q)), dtype=torch.float32)


@pytest.mark.parametrize("change", ["rotation_translation", "permutation"])
def test_descriptors_are_invariant_and_follow_the_atoms(weights, demo,
                                                        change):
    _, pos, z, ptr = demo
    m = _model(weights)
    base = _desc(m, pos, z, ptr)
    if change == "rotation_translation":
        moved = pos @ _rotation(7).T + torch.tensor([3.0, -1.5, 0.25])
        got = _desc(m, moved, z, ptr)
        assert _gap(got, base) < 1e-5
    else:
        perm = torch.cat([lo + torch.randperm(hi - lo,
                                              generator=torch.Generator()
                                              .manual_seed(int(lo)))
                          for lo, hi in zip(ptr[:-1].tolist(),
                                            ptr[1:].tolist())])
        got = _desc(m, pos[perm], z[perm], ptr)
        assert _gap(got, base[perm]) < 1e-5


def test_atom_beyond_the_cutoff_leaves_the_others_first_layer(weights,
                                                              demo):
    _, pos, z, ptr = demo
    pos, z = pos[:10].clone(), z[:10]
    ptr = torch.tensor([0, 10], dtype=torch.int32)
    m = _model(weights)
    base = _desc(m, pos, z, ptr)
    far = pos.clone()
    far[9] = pos[:9].mean(0) + torch.tensor([0.0, 0.0, 30.0])
    got = _desc(m, far, z, ptr)
    alone = _desc(m, pos[:9], z[:9], torch.tensor([0, 9], dtype=torch.int32))
    assert _gap(got[:9, :C], alone[:, :C]) < 1e-6
    # where it was, it did reach them
    assert _gap(base[:9, :C], alone[:, :C]) > 1e-3


TRIPLES = [(l1, l2, l3) for l1 in range(4) for l2 in range(4)
           for l3 in range(abs(l1 - l2), min(3, l1 + l2) + 1)
           if (l1 + l2 + l3) % 2 == 0]


@pytest.mark.parametrize("l1,l2,l3", TRIPLES)
def test_coupling_tables_are_sympys_clebsch_gordan(l1, l2, l3):
    from sympy.physics.wigner import clebsch_gordan
    real = M.real_cg(l1, l2, l3)
    q = [M._to_real(l) for l in (l1, l2, l3)]
    back = np.einsum("abc,ax,by,cz->xyz", real, q[0], q[1], q[2].conj())
    for m1, m2 in itertools.product(range(-l1, l1 + 1), range(-l2, l2 + 1)):
        for m3 in range(-l3, l3 + 1):
            want = (float(clebsch_gordan(l1, l2, l3, m1, m2, m3))
                    if m3 == m1 + m2 else 0.0)
            assert abs(back[m1 + l1, m2 + l2, m3 + l3] - want) < 1e-12
    # in the real basis, Y_l1 x Y_l2 couples to a multiple of Y_l3
    y = M.real_sh(torch.randn(64, 3, dtype=torch.float64)).numpy()
    sl = [slice(l * l, (l + 1) ** 2) for l in (l1, l2, l3)]
    lhs = np.einsum("abc,na,nb->nc", real, y[:, sl[0]], y[:, sl[1]])
    k = (lhs * y[:, sl[2]]).sum() / (y[:, sl[2]] ** 2).sum()
    assert np.abs(lhs - k * y[:, sl[2]]).max() < 1e-10
    assert abs(k) > 0.1


def test_order_3_paths_are_multiples_of_their_polynomials():
    basis = M.product_basis(3)
    u3 = M.u_tables(3)[2]
    assert u3.shape == (16, 16, 16, 23) and len(basis["ptr"]) == 14
    a = np.random.default_rng(3).standard_normal((32, 17))
    a[:, 16] = 1.0
    mono, coef, ptr = basis["mono"], basis["coef"], basis["ptr"]
    poly = np.stack([(coef[lo:hi] * a[:, mono[lo:hi, 0]]
                      * a[:, mono[lo:hi, 1]] * a[:, mono[lo:hi, 2]]).sum(1)
                     for lo, hi in zip(ptr[:-1], ptr[1:])], 1)
    dense = np.einsum("abck,na,nb,nc->nk", u3, a[:, :16], a[:, :16],
                      a[:, :16])
    for k, (q, s) in enumerate(basis["path_poly"][2]):
        assert np.allclose(dense[:, k], s * poly[:, q], atol=1e-10)


def test_edge_list_and_tiles_hold_what_the_kernels_read(demo):
    _, pos, z, ptr = demo
    recv, send = ops.edge_list(pos, ptr, 6.0)
    want = []
    for lo, hi in zip(ptr[:-1].tolist(), ptr[1:].tolist()):
        for i in range(lo, hi):
            for j in range(lo, hi):
                d = pos[i] - pos[j]
                if i != j and float((d * d).sum()) < 36.0:
                    want.append((i, j))
    assert list(zip(recv.tolist(), send.tolist())) == want
    tiles = ops.element_tiles(z.numpy())
    flat = tiles[tiles >= 0]
    assert sorted(flat.tolist()) == list(range(len(z)))
    for row in tiles:
        assert len(set(z[row[row >= 0].long()].tolist())) == 1


def _library(tmp_path, rows=None):
    with open(DEMO_CSV, newline="") as f:
        body = list(csv.reader(f))[1:]
    structs = read_xyz(DEMO_XYZ)
    rows = list(range(len(body))) if rows is None else rows
    path = tmp_path / "lib.csv"
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows([["smiles", "ea"]] + [body[r] for r in rows])
    lines = []
    for r in rows:
        for k in range(3):
            sym, pos = structs[3 * r + k]
            lines += [str(len(sym)), "x"] + [
                f"{s} {x!r} {y!r} {w!r}" for s, (x, y, w) in
                zip(sym, pos.tolist())]
    (tmp_path / "lib.xyz").write_text("\n".join(lines) + "\n")
    return path, tmp_path / "lib.xyz", [body[r][0] for r in rows], \
        [structs[3 * r + k] for r in rows for k in range(3)]


def test_window_layout_maps_each_node_to_its_xyz_atoms(tmp_path):
    from cgr_mpnn_3d_tpu_torch.data import GeometryDataset, PackedLoader
    from cgr_mpnn_3d_tpu_torch.data import plan_spec
    path, xyz, smiles, structs = _library(tmp_path, [3, 0, 7, 7, 9])
    ds = GeometryDataset(str(path), str(xyz))
    spec = plan_spec([ds.graph(i) for i in range(len(ds))])
    b = next(iter(PackedLoader(ds, spec, batch_size=5)))
    lay = ds.geometry.window(b.row_ids, b.graph_mask, b.graph_nodes,
                             b.node_x.shape[0], 6.0)
    A = len(lay.z)
    assert (lay.gather[b.graph_of_node >= len(b.graph_mask)] == A).all()
    for p, row in enumerate(lay.rows):
        g = int(np.nonzero(b.row_ids == row)[0][0]) if list(
            lay.rows).count(row) == 1 else None
        ridx = atom_map_order(smiles[row].split(">")[0])
        for k in range(3):
            lo, hi = lay.struct_ptr[3 * p + k], lay.struct_ptr[3 * p + k + 1]
            sym, pos = structs[3 * row + k]
            assert np.array_equal(lay.pos[lo:hi], pos.astype(np.float32))
            if g is not None:
                nodes = b.graph_nodes[g][:hi - lo]
                assert np.array_equal(lay.gather[nodes, k], lo + ridx)


def test_geometry_predict_equals_predict_on_the_references_npz(tmp_path,
                                                                weights):
    from cgr_mpnn_3d_tpu_torch.data import (ChemDataset, GeometryDataset,
                                            plan_spec)
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNN, CGRMPNNConfig
    from cgr_mpnn_3d_tpu_torch.train.evaluate import predict
    from cgr_mpnn_3d_tpu_torch.utils.tracing import counters
    path, xyz, smiles, structs = _library(tmp_path)
    z = [np.asarray([ATOMIC_NUMBERS[s] - 1 for s in sym])
         for sym, _ in structs]
    desc = ref.descriptors([(zz, pos) for zz, (_, pos) in zip(z, structs)],
                           weights, REF_CFG, "cpu")
    feats = [np.concatenate([desc[3 * i + k].numpy()[atom_map_order(
        smi.split(">")[0])] for k in range(3)], 1)
        for i, smi in enumerate(smiles)]
    np.savez(tmp_path / "lib.npz", *feats)
    torch.manual_seed(0)
    model = CGRMPNN(CGRMPNNConfig(num_node_features=78 + 6 * C,
                                  num_edge_features=14, depth=2,
                                  hidden_sizes=(32, 32),
                                  dropout_ps=(0.1, 0.1))).eval()
    geo = GeometryDataset(str(path), str(xyz))
    npz = ChemDataset(str(path), str(tmp_path / "lib.npz"))
    spec = plan_spec([geo.graph(i) for i in range(len(geo))])
    before = counters()
    got = predict(model, geo, spec, batch_size=8, device="cpu",
                  mace=_model(weights))
    after = counters()
    want = predict(model, npz, spec, batch_size=8, device="cpu")
    # every row's three structures ran once, with the edges of their tables
    assert after["mace_structures"] - before["mace_structures"] == len(structs)
    assert (after["mace_edges"] - before["mace_edges"]
            == geo.geometry.structure_edges(6.0).sum())
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_cli_predicts_from_coordinates_with_the_ports_mace(tmp_path,
                                                           weights):
    from cgr_mpnn_3d_tpu_torch.cli.predict import activation_energy_prediction
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig, init_params
    from cgr_mpnn_3d_tpu_torch.train import save_checkpoint
    path, xyz, _, _ = _library(tmp_path, [0, 1, 2, 3])
    M.save_mace(_model(weights), tmp_path / "mace.pt")
    assert torch.equal(M.load_mace(tmp_path / "mace.pt").embedding,
                       weights["embedding"])
    meta = {"name": "CGR-MPNN-3D", "model": {
        "num_node_features": 78 + 6 * C, "num_edge_features": 14,
        "depth": 2, "hidden_sizes": [32, 32], "dropout_ps": [0.0, 0.0],
        "activation": "ReLU", "aggr": "add", "pooling": "add",
        "use_learnable_skip": False}}
    cfg = CGRMPNNConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in meta["model"].items()})
    model = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    ckpt = save_checkpoint(tmp_path / "model.npz", model, meta)
    out = activation_energy_prediction(
        str(path), str(xyz), model_path=str(ckpt), device="cpu",
        mace_model=str(tmp_path / "mace.pt"))
    assert len(out) == 4 and all(np.isfinite(r["Activation Energy"])
                                 for r in out)
    assert not (tmp_path / "lib.npz").exists()


def test_seeded_geometries_match_demo_pair_share():
    from gpubench import geometry
    with open(DEMO_CSV, newline="") as f:
        smiles = [r[0] for r in list(csv.reader(f))[1:]]
    assert len(smiles) == 10

    def share(positions):
        near = pairs = 0
        low = np.inf
        for p in positions:
            d = np.linalg.norm(p[:, None] - p[None], axis=-1)
            iu = np.triu_indices(len(p), 1)
            near += int((d[iu] < 6.0).sum())
            pairs += len(iu[0])
            low = min(low, float(d[iu].min()))
        return near / pairs, low
    demo_share, _ = share([p for _, p in read_xyz(DEMO_XYZ)[:30]])
    geos = geometry.geometries(smiles, np.random.default_rng(2026))
    got, low = share([pos[k] for _, pos in geos for k in range(3)])
    assert abs(got - demo_share) <= 0.05
    assert low >= 0.9
    for smi, (zz, pos) in zip(smiles, geos):
        assert pos.shape == (3, len(zz), 3)
        assert len(zz) == len(atom_map_order(smi.split(">")[0]))
