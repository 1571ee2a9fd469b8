"""The MACE descriptor pipeline of the port (``data/descriptors.py``,
``data/preprocess.py``, ``cli/predict.py --data_path_coordinates``) on the
CPU against the JAX package, with an injected descriptor backend (neither
``mace`` nor ``ase`` is installed here):

* ``atom_map_order`` equals JAX's on every reaction of the corpus and the
  demo set, and both raise on an unmapped SMILES;
* ``process_xyz_to_npz`` writes JAX's arrays, exactly, with a non-identity
  atom-map permutation; both raise the frame-count ValueError, and both
  default backends raise ImportError naming mace-torch before writing;
* ``write_xyz_frames``, ``process_log_to_xyz``, ``match_reaction`` and
  ``records_to_rows`` match JAX byte for byte and value for value;
* ``activation_energy_prediction`` from an xyz file, with the backend
  patched in both packages, serves JAX's predictions at rtol/atol 1e-4
  through one checkpoint in the JAX format.
"""

import csv
from pathlib import Path

import jax
import numpy as np
import pytest

import cgr_mpnn_3d_tpu.data.descriptors as jdesc
import cgr_mpnn_3d_tpu.data.preprocess as jpre
import cgr_mpnn_3d_tpu.models as jm
from cgr_mpnn_3d_tpu.cli.predict import \
    activation_energy_prediction as j_predict
from cgr_mpnn_3d_tpu.train import save_checkpoint as j_save
from cgr_mpnn_3d_tpu_torch.chem.mol import mol_from_smiles
from cgr_mpnn_3d_tpu_torch.cli.predict import \
    activation_energy_prediction as t_predict
from cgr_mpnn_3d_tpu_torch.data import descriptors as tdesc
from cgr_mpnn_3d_tpu_torch.data import preprocess as tpre

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "corpus_reactions.csv"
DEMO = REPO / "examples" / "demo.csv"


def _reactants(path: Path) -> list[str]:
    with open(path, newline="") as f:
        return [row[0].split(">")[0] for row in list(csv.reader(f))[1:]]


def fake_descriptors(symbols, positions):
    """A backend that depends on each row's position and element, 4 dims
    an atom: a reordering of the rows shows in the output."""
    z = np.asarray([len(s) + ord(s[0]) for s in symbols], np.float64)
    pos = np.asarray(positions, np.float64)
    return np.stack([pos.sum(1), pos[:, 0] * z, np.sin(pos[:, 1]), z], 1)


def mapped_frames(smiles_rows, seed: int):
    """Three frames a reaction (r / ts / p): the reactant's atoms in
    atom-map order, positions drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    frames = []
    for smi in smiles_rows:
        atoms = mol_from_smiles(smi.split(">")[0]).atoms
        syms = [a.symbol for a in sorted(atoms, key=lambda a: a.map_num)]
        for state in ("r", "ts", "p"):
            frames.append((syms, rng.standard_normal((len(syms), 3)),
                           f"state={state}"))
    return frames


@pytest.mark.parametrize("path", [CORPUS, DEMO], ids=["corpus", "demo"])
def test_atom_map_order_equals_jax(path):
    smiles = _reactants(path)
    assert len(smiles) >= 10
    perms = 0
    for smi in smiles:
        got, want = tdesc.atom_map_order(smi), jdesc.atom_map_order(smi)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        perms += not np.array_equal(got, np.arange(len(got)))
    assert perms > 0


def test_atom_map_order_raises_on_unmapped_smiles():
    for fn in (tdesc.atom_map_order, jdesc.atom_map_order):
        with pytest.raises(ValueError, match="atom-mapped"):
            fn("[N:1]([H:2])[H]")


def test_process_xyz_to_npz_equals_jax(tmp_path):
    """The JAX test's non-identity permutation case (graph atoms N, H, H
    with map numbers 2, 1, 3) and the demo set's ten reactions, through
    both packages with the same backend: the same arrays, exactly."""
    smis = ["[NH2:2].[H:1].[H:3]>>[NH2:2].[H:1].[H:3]",
            "[OH:1].[H:2]>>[OH:1].[H:2]"]
    with open(tmp_path / "r.csv", "w", newline="") as f:
        csv.writer(f).writerows([["smiles", "ea"]] + [[s, 1.0] for s in smis])
    rng = np.random.default_rng(0)
    frames = [(syms, rng.standard_normal((len(syms), 3)), "energy=-1.0")
              for syms in (["N", "H", "H"], ["O", "H"]) for _ in range(3)]
    tpre.write_xyz_frames(tmp_path / "r.xyz", frames)
    demo = [row[0] for row in list(csv.reader(open(DEMO)))[1:]]
    tpre.write_xyz_frames(tmp_path / "demo.xyz", mapped_frames(demo, 3))
    for name, csv_file in (("r", tmp_path / "r.csv"), ("demo", DEMO)):
        xyz = tmp_path / f"{name}.xyz"
        tdesc.process_xyz_to_npz(csv_file, xyz, tmp_path / f"{name}_t.npz",
                                 descriptor_fn=fake_descriptors)
        jdesc.process_xyz_to_npz(csv_file, xyz, tmp_path / f"{name}_j.npz",
                                 descriptor_fn=fake_descriptors)
        with np.load(tmp_path / f"{name}_t.npz") as t, \
                np.load(tmp_path / f"{name}_j.npz") as j:
            assert t.files == j.files
            for k in t.files:
                np.testing.assert_array_equal(t[k], j[k])
    with np.load(tmp_path / "r_t.npz") as z:
        a0 = z["arr_0"]
        assert a0.shape == (3, 12) and z["arr_1"].shape == (2, 12)
        # the reactant's rows in map order; the xyz holds 8 decimals
        np.testing.assert_allclose(
            a0[:, 0], [frames[0][1][i].sum() for i in (1, 0, 2)], atol=3e-8)


def test_process_xyz_to_npz_refusals(tmp_path):
    """A frame count that is not three a reaction raises ValueError in
    both; without an injected backend both raise ImportError naming
    mace-torch (the port's default device is cuda, JAX's cpu) and write
    no npz."""
    with open(tmp_path / "r.csv", "w", newline="") as f:
        csv.writer(f).writerows([["smiles", "ea"], ["[OH2:1]", 1.0]])
    tpre.write_xyz_frames(tmp_path / "r.xyz",
                          [(["O"], np.zeros((1, 3)), "")] * 2)
    for mod in (tdesc, jdesc):
        with pytest.raises(ValueError, match="expected 3"):
            mod.process_xyz_to_npz(tmp_path / "r.csv", tmp_path / "r.xyz",
                                   tmp_path / "x.npz",
                                   descriptor_fn=fake_descriptors)
        with pytest.raises(ImportError, match="mace-torch"):
            mod.process_xyz_to_npz(tmp_path / "r.csv", tmp_path / "r.xyz",
                                   tmp_path / "y.npz")
    assert not list(tmp_path.glob("*.npz"))


def test_preprocess_helpers_equal_jax(tmp_path, capsys):
    """write_xyz_frames byte for byte (and read back by both readers),
    process_log_to_xyz on a good and a truncated log, match_reaction and
    records_to_rows value for value."""
    frames = mapped_frames(["[CH3:1][OH:2]>>[CH2:1]=[O:2]"], 5)
    tpre.write_xyz_frames(tmp_path / "t.xyz", frames)
    jpre.write_xyz_frames(tmp_path / "j.xyz", frames)
    assert ((tmp_path / "t.xyz").read_bytes()
            == (tmp_path / "j.xyz").read_bytes())
    for (ts, tp), (js, jp) in zip(tdesc.read_xyz(tmp_path / "t.xyz"),
                                  jdesc.read_xyz(tmp_path / "t.xyz")):
        assert ts == js
        np.testing.assert_array_equal(tp, jp)

    log = ["Q-Chem log", " NAtoms, Ionic", " 3 0", "$molecule", "0 1",
           "O 0.0 0.0 0.1", "H 0.0 0.7 -0.5", "H 0.0 -0.7 -0.5", "$end"]
    (tmp_path / "a.log").write_text("\n".join(log) + "\n")
    (tmp_path / "b.log").write_text("\n".join(log[:6]) + "\n")
    for name in ("a", "b"):
        got = tpre.process_log_to_xyz(tmp_path / f"{name}.log",
                                      tmp_path / f"{name}_t.xyz")
        want = jpre.process_log_to_xyz(tmp_path / f"{name}.log",
                                       tmp_path / f"{name}_j.xyz")
        assert got == want == (name == "a")
        if got:
            assert ((tmp_path / "a_t.xyz").read_bytes()
                    == (tmp_path / "a_j.xyz").read_bytes())
    assert capsys.readouterr().out.count("truncated") == 2

    rng = np.random.default_rng(1)
    p_positions = [rng.standard_normal((3, 3)) for _ in range(5)]
    by_formula = {"811": [0, 2, 4], "61": [1, 3]}
    target = p_positions[2] + 1e-3
    assert (tpre.match_reaction("811", target, by_formula, p_positions)
            == jpre.match_reaction("811", target, by_formula, p_positions)
            == 2)
    for mod in (tpre, jpre):
        with pytest.raises(KeyError):
            mod.match_reaction("99", target, by_formula, p_positions)
    energy = "wB97x_6-31G(d).energy"
    records = [{state: {"atomic_numbers": [8, 1, 1],
                        "positions": p_positions[i] + k,
                        energy: -76.0 + 0.01 * k + 0.1 * i}
                for k, state in enumerate(("reactant", "transition_state",
                                           "product"))}
               for i in (0, 4)]
    smiles = {i: (f"r{i}", f"p{i}") for i in range(5)}
    got = tpre.records_to_rows(records, by_formula, p_positions, smiles)
    want = jpre.PreProcessTransition1x.records_to_rows(
        records, by_formula, p_positions, smiles)
    assert got[1] == want[1] and got[2] == want[2]
    for (ts, tp, tc), (js, jp, jc) in zip(got[0], want[0]):
        assert (ts, tc) == (js, jc)
        np.testing.assert_array_equal(tp, jp)


def test_predict_from_xyz_equals_jax(tmp_path, monkeypatch):
    """``activation_energy_prediction(input_coordinates=...)`` without a
    descriptor npz runs the descriptor step (backend patched in both
    packages, 4 dims a structure) and serves JAX's predictions through one
    JAX-format checkpoint, on the CPU; the npz it wrote beside the xyz
    serves the same predictions given as ``npz_path``."""
    for mod in (tdesc, jdesc):
        monkeypatch.setattr(mod, "_mace_descriptor_fn",
                            lambda model, device: fake_descriptors)
    demo = [row[0] for row in list(csv.reader(open(DEMO)))[1:]]
    meta = {"name": "CGR-MPNN-3D", "model": {
        "num_node_features": 78 + 12, "num_edge_features": 14, "depth": 2,
        "hidden_sizes": [16, 16], "dropout_ps": [0.0, 0.0],
        "activation": "ReLU", "aggr": "add", "pooling": "mean",
        "use_learnable_skip": False}}
    jcfg = jm.CGRMPNNConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in meta["model"].items()})
    params = jm.init_params(jax.random.PRNGKey(7), jcfg)
    ckpt = j_save(tmp_path / "CGR-MPNN-3D.npz", (params, {}, 0), meta)
    preds = {}
    for name, fn, kw in (("jax", j_predict, {}),
                         ("port", t_predict, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        (d / "demo.csv").write_text(DEMO.read_text())
        tpre.write_xyz_frames(d / "demo.xyz", mapped_frames(demo, 9))
        res = fn(str(d / "demo.csv"), str(d / "demo.xyz"),
                 str(d / "r.txt"), str(ckpt), **kw)
        assert (d / "demo.npz").exists()
        preds[name] = [r["Activation Energy"] for r in res]
    assert len(preds["port"]) == 10
    np.testing.assert_allclose(preds["port"], preds["jax"], rtol=1e-4,
                               atol=1e-4)
    d = tmp_path / "port"
    again = t_predict(str(d / "demo.csv"), model_path=str(ckpt),
                      npz_path=str(d / "demo.npz"), device="cpu")
    assert [r["Activation Energy"] for r in again] == preds["port"]
