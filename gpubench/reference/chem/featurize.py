"""Atom/bond featurization and graph construction (host-side, pure numpy).

Feature contracts mirror the reference exactly:

* atom features, 39-dim (graph_features.py:4-35): symbol one-hot over
  [H,C,N,O,F,Si,P,S,Cl,Br,I]+unk (12) + total degree over [0..5]+unk (7) +
  formal charge over [-1,-2,1,2,0]+unk (6) + total num Hs over [0..4]+unk (6)
  + hybridization over [SP,SP2,SP3,SP3D,SP3D2]+unk (6) + aromatic (1) +
  0.01*mass (1).
* bond features, 7-dim (graph_features.py:38-63):
  [no-bond, single, double, triple, aromatic, conjugated, in-ring].
* molecule graphs (graph_features.py:121-151): upper-triangle bond scan, each
  bond emitted twice consecutively as (a1->a2),(a2->a1).
* CGR reaction graphs (graph_features.py:154-195): node feature =
  reac ++ (prod-reac) (78-dim), union edge set over reactant/product bonds,
  edge feature = reac ++ (prod-reac) (14-dim), atom alignment via atom-map
  numbers (graph_features.py:83-103).

Host-side deltas: everything is a numpy array (feeding padded device
batches), and the fragile consecutive-pair reverse-edge convention is
materialized as an explicit ``rev_edge_index`` permutation array (still
``e ^ 1`` by construction, but consumers never rely on that).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mol import (HYB_SP, HYB_SP2, HYB_SP3, HYB_SP3D, HYB_SP3D2, Molecule,
                  mol_from_smiles)

__all__ = [
    "ATOM_FDIM", "BOND_FDIM", "RXN_ATOM_FDIM", "RXN_BOND_FDIM",
    "onek_encoding_unk", "atom_features", "bond_features",
    "map_reac_to_prod", "MolGraph", "RxnGraph", "GraphArrays",
]

_ATOM_SYMBOLS = ["H", "C", "N", "O", "F", "Si", "P", "S", "Cl", "Br", "I"]
_DEGREES = [0, 1, 2, 3, 4, 5]
_CHARGES = [-1, -2, 1, 2, 0]
_NUM_HS = [0, 1, 2, 3, 4]
_HYBRIDIZATIONS = [HYB_SP, HYB_SP2, HYB_SP3, HYB_SP3D, HYB_SP3D2]

ATOM_FDIM = 12 + 7 + 6 + 6 + 6 + 1 + 1      # = 39
BOND_FDIM = 7
RXN_ATOM_FDIM = 2 * ATOM_FDIM               # = 78
RXN_BOND_FDIM = 2 * BOND_FDIM               # = 14


def onek_encoding_unk(value, choices: list) -> list:
    """One-hot with a trailing unknown slot (graph_features.py:66-80)."""
    encoding = [0] * (len(choices) + 1)
    index = choices.index(value) if value in choices else -1
    encoding[index] = 1
    return encoding


def atom_features(mol: Molecule, idx: int) -> list:
    """39-dim atom feature vector (graph_features.py:4-35)."""
    a = mol.atoms[idx]
    return (
        onek_encoding_unk(a.symbol, _ATOM_SYMBOLS)
        + onek_encoding_unk(a.total_degree, _DEGREES)
        + onek_encoding_unk(a.charge, _CHARGES)
        + onek_encoding_unk(a.num_hs, _NUM_HS)
        + onek_encoding_unk(a.hybridization, _HYBRIDIZATIONS)
        + [1 if a.aromatic else 0]
        + [a.mass * 0.01]
    )


def bond_features(bond) -> list:
    """7-dim bond feature vector; ``None`` encodes "no bond"
    (graph_features.py:38-63)."""
    if bond is None:
        return [1, 0, 0, 0, 0, 0, 0]
    return [
        0,
        1 if (not bond.aromatic and bond.order == 1) else 0,
        1 if (not bond.aromatic and bond.order == 2) else 0,
        1 if (not bond.aromatic and bond.order == 3) else 0,
        1 if bond.aromatic else 0,
        1 if bond.conjugated else 0,
        1 if bond.in_ring else 0,
    ]


def map_reac_to_prod(mol_reac: Molecule, mol_prod: Molecule) -> dict[int, int]:
    """Reactant atom index -> product atom index via atom-map numbers
    (graph_features.py:83-103)."""
    prod_map_to_id = {a.map_num: i for i, a in enumerate(mol_prod.atoms)}
    return {i: prod_map_to_id[a.map_num] for i, a in enumerate(mol_reac.atoms)}


@dataclass
class GraphArrays:
    """Dense host-side arrays for one (reaction) graph.

    ``edge_index`` rows are (src, dst) directed edges with forward/reverse
    pairs adjacent; ``rev_edge_index[e]`` is the opposite-direction edge of e.
    """
    node_feats: np.ndarray   # [N, F]  float32
    edge_feats: np.ndarray   # [E, Fe] float32
    senders: np.ndarray      # [E]     int32
    receivers: np.ndarray    # [E]     int32
    rev_edge_index: np.ndarray  # [E]  int32

    @property
    def num_nodes(self) -> int:
        return self.node_feats.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]


def _finalize(f_atoms, f_bonds, edge_index, atom_fdim, bond_fdim) -> GraphArrays:
    n = len(f_atoms)
    e = len(edge_index)
    node_feats = (np.asarray(f_atoms, dtype=np.float32)
                  if n else np.zeros((0, atom_fdim), np.float32))
    edge_feats = (np.asarray(f_bonds, dtype=np.float32)
                  if e else np.zeros((0, bond_fdim), np.float32))
    senders = np.asarray([s for s, _ in edge_index], dtype=np.int32)
    receivers = np.asarray([r for _, r in edge_index], dtype=np.int32)
    rev = np.arange(e, dtype=np.int32) ^ 1 if e else np.zeros((0,), np.int32)
    return GraphArrays(node_feats, edge_feats, senders, receivers, rev)


class MolGraph:
    """Single-molecule graph (graph_features.py:121-151 equivalent)."""

    def __init__(self, smiles: str):
        self.smiles = smiles
        mol = mol_from_smiles(smiles)
        f_atoms, f_bonds, edge_index = [], [], []
        n = mol.num_atoms
        for a1 in range(n):
            f_atoms.append(atom_features(mol, a1))
            for a2 in range(a1 + 1, n):
                bond = mol.bond_between(a1, a2)
                if bond is None:
                    continue
                fb = bond_features(bond)
                f_bonds.append(fb)
                f_bonds.append(fb)
                edge_index.extend([(a1, a2), (a2, a1)])
        self.f_atoms = f_atoms
        self.f_bonds = f_bonds
        self.edge_index = edge_index
        self.arrays = _finalize(f_atoms, f_bonds, edge_index,
                                ATOM_FDIM, BOND_FDIM)


class RxnGraph:
    """Condensed-graph-of-reaction (graph_features.py:154-195 equivalent).

    Node features: reac ++ (prod - reac); edges: union of reactant and product
    bonds; edge features: reac ++ (prod - reac); missing bonds on either side
    use the 'no bond' vector.
    """

    def __init__(self, smiles: str):
        self.smiles = smiles
        self.smiles_reac, _, self.smiles_prod = smiles.split(">")
        mol_reac = mol_from_smiles(self.smiles_reac)
        mol_prod = mol_from_smiles(self.smiles_prod)
        ri2pi = map_reac_to_prod(mol_reac, mol_prod)

        f_atoms, f_bonds, edge_index = [], [], []
        n = mol_reac.num_atoms
        for a1 in range(n):
            fr = atom_features(mol_reac, a1)
            fp = atom_features(mol_prod, ri2pi[a1])
            f_atoms.append(fr + [y - x for x, y in zip(fr, fp)])
            for a2 in range(a1 + 1, n):
                b_reac = mol_reac.bond_between(a1, a2)
                b_prod = mol_prod.bond_between(ri2pi[a1], ri2pi[a2])
                if b_reac is None and b_prod is None:
                    continue
                fbr = bond_features(b_reac)
                fbp = bond_features(b_prod)
                fb = fbr + [y - x for x, y in zip(fbr, fbp)]
                f_bonds.append(fb)
                f_bonds.append(fb)
                edge_index.extend([(a1, a2), (a2, a1)])
        self.f_atoms = f_atoms
        self.f_bonds = f_bonds
        self.edge_index = edge_index
        self.arrays = _finalize(f_atoms, f_bonds, edge_index,
                                RXN_ATOM_FDIM, RXN_BOND_FDIM)
