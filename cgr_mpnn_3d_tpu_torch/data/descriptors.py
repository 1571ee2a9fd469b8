"""MACE descriptor files: the xyz reader, the xyz -> descriptor npz
pipeline and the synthetic stand-in.

The port's copy of ``cgr_mpnn_3d_tpu/data/descriptors.py``.  MACE is a
frozen external featurizer run on the host; :func:`process_xyz_to_npz`
iterates each reaction's [reactant, TS, product] xyz frames, computes
per-atom descriptors with a backend (``descriptor_fn``; by default the
pretrained MACE-MP model of the optional ``mace-torch`` package, which
raises ImportError naming it when absent -- nothing falls back to
synthetic descriptors), reorders the rows into SMILES atom-map order and
saves [r || ts || p] as ``arr_i`` per csv row.  Its ``device`` defaults to
``cuda``, as the port's entry points do (the JAX package's to ``cpu``).
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from ..chem.mol import mol_from_smiles
from .dataset import _is_float

__all__ = ["read_xyz", "atom_map_order", "process_xyz_to_npz",
           "synthetic_descriptors_npz"]


def read_xyz(path: str | Path) -> list[tuple[list[str], np.ndarray]]:
    """Parse a (multi-structure) xyz file -> [(symbols, positions[N,3])]."""
    structures = []
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        natoms = int(lines[i].split()[0])
        block = lines[i + 2: i + 2 + natoms]
        syms, pos = [], []
        for row in block:
            parts = row.split()
            syms.append(parts[0])
            pos.append([float(x) for x in parts[1:4]])
        structures.append((syms, np.asarray(pos, np.float64)))
        i += 2 + natoms
    return structures


def atom_map_order(reactant_smiles: str) -> np.ndarray:
    """Row-reorder indices: xyz rows are in atom-map order 1..N, graph rows
    in SMILES order, so ``ridx[i] = map_num(atom_i) - 1``."""
    mol = mol_from_smiles(reactant_smiles)
    ridx = np.asarray([a.map_num - 1 for a in mol.atoms], np.int64)
    if (ridx < 0).any():
        raise ValueError("reactant SMILES must be fully atom-mapped")
    return ridx


def _mace_descriptor_fn(model: str, device: str):
    """The default per-structure backend: the pretrained MACE-MP force
    field's descriptors (the optional ``mace-torch`` and ``ase``
    packages)."""
    try:
        from ase import Atoms
        from mace.calculators import mace_mp
    except ImportError as e:
        raise ImportError(
            "MACE descriptor extraction needs the optional 'mace-torch' "
            "package (run offline on a host with it installed, or pass a "
            "precomputed npz via --data_path_npz / "
            "synthetic_descriptors_npz for testing)") from e
    calc = mace_mp(model=model, device=device)

    def fn(symbols: list[str], positions: np.ndarray) -> np.ndarray:
        return np.asarray(calc.get_descriptors(
            Atoms(symbols=symbols, positions=positions)))
    return fn


def process_xyz_to_npz(csv_file: str | Path, xyz_file: str | Path,
                       npz_file: str | Path, model: str = "small",
                       device: str = "cuda", descriptor_fn=None) -> None:
    """Per-atom descriptors of each reaction's [reactant, TS, product] xyz
    triplet, reordered into SMILES atom-map order and concatenated
    [r || ts || p] along features, saved as ``arr_i`` per csv row.

    ``descriptor_fn(symbols, positions[N, 3]) -> [N, D]`` defaults to
    :func:`_mace_descriptor_fn` (``model``, ``device``); the backend is made
    before any file is read or written."""
    if descriptor_fn is None:
        descriptor_fn = _mace_descriptor_fn(model, device)
    descs = [np.asarray(descriptor_fn(syms, pos))
             for syms, pos in read_xyz(xyz_file)]
    with open(csv_file, newline="") as f:
        rows = _strip_header(list(csv.reader(f)))
    if len(descs) != 3 * len(rows):
        raise ValueError(
            f"{xyz_file} holds {len(descs)} structures but {csv_file} has "
            f"{len(rows)} reactions — expected 3 (r/ts/p) per reaction")
    features = []
    for i, row in enumerate(rows):
        ridx = atom_map_order(row[0].split(">")[0])
        features.append(np.concatenate(
            [descs[3 * i + k][ridx, :] for k in range(3)], axis=1))
    np.savez(str(npz_file), *features)


def synthetic_descriptors_npz(csv_file: str | Path, npz_file: str | Path,
                              dim_per_structure: int = 64,
                              seed: int = 0) -> None:
    """The MACE npz contract (``arr_i`` = [n_atoms, 3*dim] per csv row,
    [reactant || TS || product]) with deterministic pseudo-descriptors —
    the same arrays as the JAX package's function of the same name."""
    with open(csv_file, newline="") as f:
        rows = _strip_header(list(csv.reader(f)))
    rng = np.random.default_rng(seed)
    features = []
    for row in rows:
        rsmi = row[0].split(">")[0]
        n_atoms = mol_from_smiles(rsmi).num_atoms
        features.append(rng.standard_normal(
            (n_atoms, 3 * dim_per_structure)).astype(np.float32))
    np.savez(str(npz_file), *features)


def _strip_header(rows: list[list[str]]) -> list[list[str]]:
    """Drop a header row: keyed on the label column parsing as a float;
    single-column files fall back to a SMILES-shape heuristic."""
    if not rows:
        return rows
    first = rows[0]
    if len(first) > 1:
        return rows[1:] if not _is_float(first[1]) else rows
    return rows[1:] if not _looks_like_smiles(first[0]) else rows


def _looks_like_smiles(s: str) -> bool:
    return any(c in s for c in "[]>=#") or s.isalpha() and s[0].isupper()
