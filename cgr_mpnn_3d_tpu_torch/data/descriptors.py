"""MACE descriptor files: the xyz reader and the synthetic stand-in.

The port's copy of the host-side parts of ``cgr_mpnn_3d_tpu/data/
descriptors.py``.  The MACE call itself (``process_xyz_to_npz``) is not
ported yet: serving takes a precomputed descriptor ``.npz``.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from ..chem.mol import mol_from_smiles
from .dataset import _is_float

__all__ = ["read_xyz", "synthetic_descriptors_npz"]


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
