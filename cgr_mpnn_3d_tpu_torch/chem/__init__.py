"""Host-side chemistry: SMILES parsing, perception, featurization.

A copy of ``cgr_mpnn_3d_tpu/chem`` (pure Python and numpy): the port keeps
its own so that it imports nothing of the JAX package.  ``RxnGraph(s).arrays``
gives the same :class:`GraphArrays` as there (tests/test_torch_data.py).
"""

from .featurize import (ATOM_FDIM, BOND_FDIM, RXN_ATOM_FDIM, RXN_BOND_FDIM,
                        GraphArrays, MolGraph, RxnGraph, atom_features,
                        bond_features, map_reac_to_prod, onek_encoding_unk)
from .mol import Molecule, mol_from_smiles
from .smiles import SmilesError, parse_smiles

__all__ = [
    "ATOM_FDIM", "BOND_FDIM", "RXN_ATOM_FDIM", "RXN_BOND_FDIM",
    "GraphArrays", "MolGraph", "RxnGraph", "atom_features", "bond_features",
    "map_reac_to_prod", "onek_encoding_unk", "Molecule", "mol_from_smiles",
    "SmilesError", "parse_smiles",
]
