"""Reactant, TS and product geometries of corpus reactions, drawn from the
seed: the inputs of the geometry cells, where only demo.xyz's 57 real
Transition1x structures are in the repository.

Each reactant is embedded by a walk over its bonds (breadth first from the
first atom of each fragment in SMILES order): an atom goes at 1.09 Å from its
neighbour if either is a hydrogen, else 1.45 Å, in a random direction,
the most compact of a few draws that keep it at least 0.9 Å from every
placed atom (a molecule's atoms crowd as real ones do, so the share of
pairs within the 6 Å cutoff matches demo.xyz's).  A separate fragment
starts within 3 Å of a placed atom.  The TS and the product are the
reactant plus seeded Gaussian displacements, the atoms of any pair closer
than 0.9 Å drawing theirs again until none is.  Atoms are in ascending map
number (xyz row = map number - 1 where the maps run 1..n, as in
Transition1x's xyz files; 13 corpus reactions skip a number); elements as
atomic numbers.
"""

from __future__ import annotations

from collections import deque
from pathlib import Path

import numpy as np

from .reference.chem.mol import mol_from_smiles
from .reference.chem.periodic import ATOMIC_NUMBERS

__all__ = ["BOND_H", "BOND_HEAVY", "FLOOR", "FRAGMENT_REACH", "SIGMA",
           "reaction_geometry", "geometries", "write_xyz"]

BOND_H = 1.09
BOND_HEAVY = 1.45
FLOOR = 0.9
FRAGMENT_REACH = 3.0
# the TS's and the product's displacement from the reactant, Å a coordinate
SIGMA = (0.15, 0.3)
_DRAWS = 8


def _unit(rng, k: int) -> np.ndarray:
    v = rng.standard_normal((k, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _place(rng, placed: np.ndarray, anchor: np.ndarray, lo: float,
           hi: float) -> np.ndarray | None:
    """The most compact of ``_DRAWS`` points at lo..hi Å from ``anchor``
    that keep FLOOR from every placed point, or None."""
    d = lo + (hi - lo) * rng.random((_DRAWS, 1))
    cand = anchor + d * _unit(rng, _DRAWS)
    if len(placed):
        gap = np.linalg.norm(cand[:, None] - placed[None], axis=-1).min(1)
        cand = cand[gap >= FLOOR]
        if not len(cand):
            return None
        centre = placed.mean(0)
        return cand[np.argmin(np.linalg.norm(cand - centre, axis=1))]
    return cand[0]


def _embed(mol, rng) -> np.ndarray:
    n = mol.num_atoms
    nbrs = [[] for _ in range(n)]
    for b in mol.bonds:
        nbrs[b.a1].append(b.a2)
        nbrs[b.a2].append(b.a1)
    while True:
        pos = np.full((n, 3), np.nan)
        ok = True
        for root in range(n):
            if not np.isnan(pos[root, 0]):
                continue
            done = ~np.isnan(pos[:, 0])
            if done.any():
                anchor = pos[rng.choice(np.nonzero(done)[0])]
                p = _place(rng, pos[done], anchor, FLOOR, FRAGMENT_REACH)
                if p is None:
                    ok = False
                    break
                pos[root] = p
            else:
                pos[root] = 0.0
            queue = deque([root])
            while queue and ok:
                a = queue.popleft()
                for b in nbrs[a]:
                    if not np.isnan(pos[b, 0]):
                        continue
                    hyd = "H" in (mol.atoms[a].symbol, mol.atoms[b].symbol)
                    length = BOND_H if hyd else BOND_HEAVY
                    done = ~np.isnan(pos[:, 0])
                    p = _place(rng, pos[done], pos[a], length, length)
                    if p is None:
                        ok = False
                        break
                    pos[b] = p
                    queue.append(b)
            if not ok:
                break
        if ok:
            return pos


def _too_close(pos: np.ndarray) -> np.ndarray:
    """The atoms of every pair closer than FLOOR."""
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    return np.nonzero(((d + np.eye(len(pos)) * 1e9) < FLOOR).any(1))[0]


def reaction_geometry(smiles: str, rng) -> tuple[np.ndarray, np.ndarray]:
    """(atomic numbers [n], positions [3, n, 3] float64: reactant, TS,
    product) of a mapped reaction, atoms in atom-map order."""
    mol = mol_from_smiles(smiles.split(">")[0])
    maps = np.asarray([a.map_num for a in mol.atoms])
    if (maps <= 0).any() or len(set(maps.tolist())) != len(maps):
        raise ValueError(f"{smiles!r} is not fully mapped")
    xyz_row = np.argsort(np.argsort(maps, kind="stable"))
    r = np.empty((mol.num_atoms, 3))
    r[xyz_row] = _embed(mol, rng)
    z = np.empty(mol.num_atoms, np.int64)
    z[xyz_row] = [ATOMIC_NUMBERS[a.symbol.capitalize()] for a in mol.atoms]
    out = [r]
    for sigma in SIGMA:
        s = r + sigma * rng.standard_normal(r.shape)
        while len(bad := _too_close(s)):
            # the atoms of a pair too close draw their displacement again
            s[bad] = r[bad] + sigma * rng.standard_normal((len(bad), 3))
        out.append(s)
    return z, np.stack(out)


def geometries(smiles: list[str], rng) -> list:
    """Each row's (atomic numbers, [3, n, 3] positions), drawn in order."""
    return [reaction_geometry(s, rng) for s in smiles]


def write_xyz(path: Path, geos) -> Path:
    """The rows' structures as one xyz file, three frames a row, every
    coordinate in full precision (so both sides read the same floats)."""
    symbol = {v: k for k, v in ATOMIC_NUMBERS.items()}
    lines = []
    for z, pos in geos:
        for k in range(3):
            lines.append(str(len(z)))
            lines.append(f'Properties=species:S:1:pos:R:3 structure={k}')
            lines.extend(f"{symbol[int(a)]} {x!r} {y!r} {w!r}"
                         for a, (x, y, w) in zip(z, pos[k].tolist()))
    Path(path).write_text("\n".join(lines) + "\n")
    return Path(path)
