"""Reactions with their 3D geometries: the dataset whose MACE descriptors
are computed on the device inside ``predict``.

A :class:`GeometryDataset` is a :class:`ChemDataset` (the reaction csv,
its CGR graphs, no descriptor npz) plus each row's reactant, TS and
product structures from an xyz file (three frames a row, atoms in ascending
atom-map number: :func:`xyz_order`).
The structures are held in per-dataset tables (:class:`GeometryTables`),
built once: flat float32 positions and element indices, each row's
atom-map order, and each structure's count of atom pairs within the
cutoff.  :meth:`GeometryTables.window` lays out one packed window's
structures from them in a few array operations: their atoms end to end,
the structure offsets, the product kernel's element tiles, and for every
node slot of the packed batch the three atoms (reactant, TS, product)
whose descriptors its feature row takes, by :func:`xyz_order`.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..chem.mol import mol_from_smiles
from ..chem.periodic import ATOMIC_NUMBERS
from .dataset import ChemDataset
from .descriptors import read_xyz

__all__ = ["GeometryDataset", "GeometryTables", "WindowLayout", "xyz_order"]


def xyz_order(reactant_smiles: str) -> np.ndarray:
    """Graph node i is xyz atom ``ridx[i]``: the rank of its map number.
    Where the maps run 1..n this is ``data.descriptors.atom_map_order``
    (map number - 1); it also takes the corpus's reactions whose map
    numbers skip one."""
    maps = np.asarray([a.map_num for a in
                       mol_from_smiles(reactant_smiles).atoms])
    if (maps <= 0).any() or len(set(maps.tolist())) != len(maps):
        raise ValueError("reactant SMILES must be fully atom-mapped")
    return np.argsort(np.argsort(maps, kind="stable")).astype(np.int64)


@dataclass
class WindowLayout:
    """One packed window's structures: ``rows`` (the window's rows in slot
    order), their 3 structures each laid end to end (``pos`` [A, 3]
    float32, ``z`` [A] int32 element indices, ``struct_ptr`` [3B + 1]
    int32, ``tiles`` the product kernel's element tiles), ``gather``
    [NT, 3] int32 (the atom of each node slot in each structure; A for a
    padding slot) and the structures' edges within the cutoff."""
    rows: np.ndarray
    pos: np.ndarray
    z: np.ndarray
    struct_ptr: np.ndarray
    tiles: torch.Tensor
    gather: np.ndarray
    n_edges: int


class GeometryTables:
    """Every row's three structures, flat: ``n_atoms`` [R], positions
    [3 * sum(n), 3] float32 and element indices (atomic number - 1) [3 *
    sum(n)] int32 in (row, structure, xyz atom) order from ``first``
    [R], each row's atom-map order (graph node i is xyz atom
    ``ridx[i]``) from ``ridx_first`` [R]."""

    def __init__(self, structures, smiles: list[str]):
        R = len(smiles)
        if len(structures) != 3 * R:
            raise ValueError(f"{len(structures)} structures for {R} "
                             "reactions: expected 3 (reactant, TS, product) "
                             "a reaction")
        n = np.asarray([len(s[0]) for s in structures], np.int64)
        if not (n[0::3] == n[1::3]).all() or not (n[0::3] == n[2::3]).all():
            raise ValueError("a reaction's three structures differ in atoms")
        self.n_atoms = n[0::3]
        orders: dict = {}
        ridx = []
        for i, smi in enumerate(smiles):
            reactant = smi.split(">")[0]
            if reactant not in orders:
                orders[reactant] = xyz_order(reactant)
            if len(orders[reactant]) != self.n_atoms[i]:
                raise ValueError(f"row {i}: {len(orders[reactant])} mapped "
                                 f"atoms, {self.n_atoms[i]} in its xyz")
            ridx.append(orders[reactant])
        self.ridx = np.concatenate(ridx).astype(np.int32)
        self.ridx_first = np.cumsum(self.n_atoms) - self.n_atoms
        self.first = 3 * self.ridx_first
        self.pos = np.concatenate([np.asarray(s[1], np.float32)
                                   for s in structures]).reshape(-1, 3)
        self.z = np.asarray([ATOMIC_NUMBERS[sym] - 1 for s in structures
                             for sym in s[0]], np.int32)
        self._edges: dict = {}

    def structure_edges(self, r_max: float) -> np.ndarray:
        """[R, 3] int64: each structure's ordered pairs i != j with
        |pos_i - pos_j|^2 < r_max^2 in float32, as the kernel counts
        them."""
        if r_max not in self._edges:
            out = np.zeros(3 * len(self.n_atoms), np.int64)
            sizes = np.repeat(self.n_atoms, 3)
            starts = np.repeat(self.first, 3) + np.tile(
                np.arange(3), len(self.n_atoms)) * sizes
            lim = np.float32(r_max) * np.float32(r_max)
            for n in np.unique(sizes):
                sel = np.nonzero(sizes == n)[0]
                p = self.pos[starts[sel][:, None] + np.arange(n)]
                d = p[:, :, None, :] - p[:, None, :, :]
                d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
                    + d[..., 2] * d[..., 2]
                out[sel] = (d2 < lim).sum((1, 2)) - n
            self._edges[r_max] = out.reshape(-1, 3)
        return self._edges[r_max]

    def window(self, row_ids: np.ndarray, graph_mask: np.ndarray,
               graph_nodes: np.ndarray, n_slots: int,
               r_max: float) -> WindowLayout:
        """The layout of one packed batch (its ``row_ids``,
        ``graph_mask``, ``graph_nodes`` and node slot count)."""
        from ..ops.mace import element_tiles
        real = np.nonzero(graph_mask > 0)[0]
        rows = np.asarray(row_ids)[real].astype(np.int64)
        n = self.n_atoms[rows]
        sizes = np.repeat(n, 3)
        struct_ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
        A = int(struct_ptr[-1])
        s_first = (self.first[rows][:, None]
                   + np.arange(3)[None, :] * n[:, None]).ravel()
        src = (np.repeat(s_first - struct_ptr[:-1], sizes)
               + np.arange(A))
        gn = np.asarray(graph_nodes)[real]
        nodes = gn[np.arange(gn.shape[1])[None, :] < n[:, None]]
        p = np.repeat(np.arange(len(rows)), n)
        i = np.arange(len(p)) - np.repeat(np.cumsum(n) - n, n)
        atom = self.ridx[self.ridx_first[rows][p] + i]
        gather = np.full((n_slots, 3), A, np.int32)
        gather[nodes] = (struct_ptr[:-1].reshape(-1, 3)[p] + atom[:, None])
        z = self.z[src]
        return WindowLayout(
            rows, self.pos[src], z, struct_ptr, element_tiles(z), gather,
            int(self.structure_edges(r_max)[rows].sum()))


class GeometryDataset(ChemDataset):
    """A reaction csv (``ChemDataset``, without a descriptor npz) and the
    xyz of its rows' [reactant, TS, product] structures; ``geometry``
    holds them (:class:`GeometryTables`), parsed when the dataset is
    made."""

    def __init__(self, data_path: str, xyz_path: str | Path,
                 use_native: bool | None = None):
        super().__init__(data_path, None, use_native)
        self.geometry = GeometryTables(read_xyz(xyz_path), self.smiles)
