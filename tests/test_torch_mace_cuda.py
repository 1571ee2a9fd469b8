"""The MACE kernels (``csrc/mace.cu``) on the card against their plain
versions, at the published width (128 channels): each layer's interaction
and product, the whole descriptors of the corpus's seeded geometries, a
one-atom structure and an atom beyond everyone's cutoff, the launch
counters; K3f at the geometry cell's width (F = 78 + 3 x 256 = 846)
against its CPU twin; and ``predict`` from geometries on the card against
the same on the CPU.  Needs a GPU and nvcc; skips elsewhere.  Run on a GPU
machine with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mace_cuda.py -q
"""

import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu_torch.models import mace as M
from cgr_mpnn_3d_tpu_torch.ops import mace as ops

pytestmark = pytest.mark.cuda

C = 128
REF_CFG = dict(channels=C, elements=89, bessel=8, radial_mlp=[64, 64, 64],
               interactions=2, correlation=3, r_max=6.0, polynomial_cutoff=5,
               avg_num_neighbors=M.MACEConfig().avg_num_neighbors)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(cuda):
    from gpubench.reference import mace as ref
    m = M.MACE(M.MACEConfig())
    m.load_state_dict(ref.make_weights(REF_CFG, 7, "cpu"))
    return m.eval()


@pytest.fixture(scope="module")
def structures(cuda):
    from gpubench import data, geometry
    smiles, _ = data.corpus()
    geos = geometry.geometries(smiles, np.random.default_rng(5))
    z = np.concatenate([np.tile(zz - 1, 3) for zz, _ in geos])
    pos = np.concatenate([p.reshape(-1, 3) for _, p in geos])
    sizes = np.repeat([len(zz) for zz, _ in geos], 3)
    # one lone atom, and one structure with an atom 40 Å from the rest
    z = np.concatenate([z, [5], [7, 0, 0, 5]])
    far = np.array([[0, 0, 0], [1.0, 0, 0], [0, 1.0, 0], [0, 0, 40.0]])
    pos = np.concatenate([pos, [[1.0, 2.0, 3.0]], far])
    sizes = np.concatenate([sizes, [1, 4]])
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    return (torch.tensor(pos, dtype=torch.float32),
            torch.tensor(z, dtype=torch.int32),
            torch.tensor(ptr, dtype=torch.int32))


def _desc(m, pos, z, ptr):
    """``m``'s descriptors with the tiles and edge count ``predict`` hands
    it (made from the CPU tensors)."""
    n_edges = len(ops.edge_list(pos.cpu(), ptr.cpu(), 6.0)[0])
    tiles = ops.element_tiles(z.cpu().numpy()).to(pos.device)
    return m.descriptors(pos, z, ptr, tiles, n_edges)


def _gap(a, b) -> float:
    return float((a.cpu() - b.cpu()).abs().max() / b.abs().max())


def test_descriptors_on_the_card_match_the_plain_path(cuda, model,
                                                      structures):
    pos, z, ptr = structures
    want = _desc(model, pos, z, ptr)
    gpu = model.to(cuda)
    n0, p0 = ops.interaction_launches, ops.product_launches
    got = _desc(gpu, pos.to(cuda), z.to(cuda), ptr.to(cuda))
    torch.cuda.synchronize()
    assert ops.interaction_launches - n0 == 2
    assert ops.product_launches - p0 == 2
    assert _gap(got, want) < 1e-5
    # the lone atom's messages are empty; the far atom's own too
    assert torch.isfinite(got).all()
    again = _desc(gpu, pos.to(cuda), z.to(cuda), ptr.to(cuda))
    assert torch.equal(got, again)
    model.to("cpu")


def test_each_layers_kernels_match_their_plain_versions(cuda, model,
                                                        structures):
    pos, z, ptr = structures
    prep_cpu = model.prepared()
    tiles = ops.element_tiles(z.numpy())
    gpu = model.to(cuda)
    prep = gpu.prepared()
    hup_c, hup_g = prep_cpu["hup0"][z.long()], prep["hup0"][z.long().to(cuda)]
    sc_c = sc_g = None
    out_c = torch.empty(len(z), 2 * C)
    out_g = torch.empty(len(z), 2 * C, device=cuda)
    for t in range(2):
        Lc, Lg = prep_cpu["layers"][t], prep["layers"][t]
        msg_c = ops.mace_interaction(pos, ptr, hup_c, Lc["radial"], 6.0, 5)
        msg_g = ops.mace_interaction(pos.to(cuda), ptr.to(cuda), hup_g,
                                     Lg["radial"], 6.0, 5)
        assert _gap(msg_g, msg_c) < 1e-5, t
        args = lambda p, L, msg, zz, tl, sc, out: (
            msg, zz, tl, L["m"], L["m_shared"], L["weff"], p["mono"],
            p["coef"], p["ptr"], L["wout"], sc, out, t * C, L["wup_next"],
            L["wskip_next"])
        hup_c, sc_c = ops.mace_product(*args(prep_cpu, Lc, msg_c, z, tiles,
                                             sc_c, out_c))
        hup_g, sc_g = ops.mace_product(*args(prep, Lg, msg_c.to(cuda),
                                             z.to(cuda), tiles.to(cuda),
                                             sc_g, out_g))
        assert _gap(out_g[:, t * C:(t + 1) * C], out_c[:, t * C:(t + 1) * C]
                    ) < 1e-5, t
        if t == 0:
            assert _gap(hup_g, hup_c) < 1e-5 and _gap(sc_g, sc_c) < 1e-5
    model.to("cpu")


def test_k3f_at_the_geometry_cells_width_matches_its_cpu_twin(cuda):
    from gpubench import data
    from gpubench.reference.model import Dims, make_weights
    from cgr_mpnn_3d_tpu_torch.data import (PackedLoader, ChemDataset,
                                            plan_spec, to_device)
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNN, CGRMPNNConfig, apply
    from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
    import tempfile
    from pathlib import Path
    smiles, labels = data.corpus()
    feats = data.descriptors(smiles, 256, 3, "k3f")
    with tempfile.TemporaryDirectory() as d:
        csv, npz = data.write_split(Path(d), "lib", smiles, labels, feats)
        ds = ChemDataset(str(csv), str(npz))
        ds.prefeaturize()
        spec = plan_spec([ds.graph(i) for i in range(len(ds))])
        model = CGRMPNN(CGRMPNNConfig(
            num_node_features=846, num_edge_features=14, depth=4,
            hidden_sizes=(400,) * 4, dropout_ps=(0.1,) * 4))
        model.load_state_dict(make_weights(Dims(846, 14, 400, 4), 3, "cpu"))
        model.eval()
        loader = PackedLoader(ds, spec, batch_size=1024)
        n0 = fm.launches
        for b in loader:
            with torch.no_grad():
                want = apply(model, to_device(b, "cpu"), loader.spec)
                got = apply(model.to(cuda), to_device(b, cuda), loader.spec)
            model.to("cpu")
            mask = torch.as_tensor(b.graph_mask > 0)
            assert _gap(got[mask.to(cuda)], want[mask]) < 1e-5
        assert fm.launches > n0


def test_predict_from_geometries_on_the_card_equals_the_cpu(cuda, model,
                                                            tmp_path):
    from gpubench import data, geometry
    from gpubench.reference.model import Dims, make_weights
    from cgr_mpnn_3d_tpu_torch.data import GeometryDataset, plan_spec
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNN, CGRMPNNConfig
    from cgr_mpnn_3d_tpu_torch.train.evaluate import predict
    smiles, labels = data.corpus()
    rows = data.draw_rows(200, 9, "library")
    s = [smiles[i] for i in rows]
    csv, _ = data.write_split(tmp_path, "lib", s, labels[rows], None)
    xyz = geometry.write_xyz(tmp_path / "lib.xyz", geometry.geometries(
        s, np.random.default_rng(9)))
    ds = GeometryDataset(str(csv), str(xyz))
    ds.prefeaturize()
    spec = plan_spec([ds.graph(i) for i in range(len(ds))])
    head = CGRMPNN(CGRMPNNConfig(num_node_features=846, num_edge_features=14,
                                 depth=4, hidden_sizes=(400,) * 4,
                                 dropout_ps=(0.1,) * 4))
    head.load_state_dict(make_weights(Dims(846, 14, 400, 4), 9, "cpu"))
    head.eval()
    want = predict(head, ds, spec, batch_size=64, device="cpu", mace=model)
    got = predict(head.to(cuda), ds, spec, batch_size=64, device=cuda,
                  mace=model.to(cuda))
    model.to("cpu")
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
