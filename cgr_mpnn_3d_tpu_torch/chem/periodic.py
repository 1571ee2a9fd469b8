"""Periodic-table data used by the featurizer.

The reference delegates element data to RDKit's C++ periodic table
(the original cgr_mpnn_3D/utils/graph_features.py:33 uses ``atom.GetMass()``).
RDKit is not a dependency of this framework, so we carry the small amount of
element data we need ourselves: standard atomic weights (IUPAC abridged),
valence-electron counts (for lone-pair / hybridization perception) and the
Daylight organic-subset default valences (for implicit-hydrogen computation).
"""

from __future__ import annotations

# Standard atomic weights, g/mol (IUPAC 2021 abridged values — these match what
# RDKit's GetMass() returns for non-isotopic atoms, e.g. C -> 12.011).
ATOMIC_WEIGHTS: dict[str, float] = {
    "H": 1.008, "He": 4.002602, "Li": 6.94, "Be": 9.0121831, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998403163, "Ne": 20.1797,
    "Na": 22.98976928, "Mg": 24.305, "Al": 26.9815385, "Si": 28.085,
    "P": 30.973761998, "S": 32.06, "Cl": 35.45, "Ar": 39.948, "K": 39.0983,
    "Ca": 40.078, "Sc": 44.955908, "Ti": 47.867, "V": 50.9415, "Cr": 51.9961,
    "Mn": 54.938044, "Fe": 55.845, "Co": 58.933194, "Ni": 58.6934,
    "Cu": 63.546, "Zn": 65.38, "Ga": 69.723, "Ge": 72.630, "As": 74.921595,
    "Se": 78.971, "Br": 79.904, "Kr": 83.798, "Rb": 85.4678, "Sr": 87.62,
    "Y": 88.90584, "Zr": 91.224, "Nb": 92.90637, "Mo": 95.95, "Tc": 98.0,
    "Ru": 101.07, "Rh": 102.90550, "Pd": 106.42, "Ag": 107.8682,
    "Cd": 112.414, "In": 114.818, "Sn": 118.710, "Sb": 121.760, "Te": 127.60,
    "I": 126.90447, "Xe": 131.293, "Cs": 132.90545196, "Ba": 137.327,
    "La": 138.90547, "Ce": 140.116, "Pr": 140.90766, "Nd": 144.242,
    "Sm": 150.36, "Eu": 151.964, "Gd": 157.25, "Tb": 158.92535,
    "Dy": 162.500, "Ho": 164.93033, "Er": 167.259, "Tm": 168.93422,
    "Yb": 173.045, "Lu": 174.9668, "Hf": 178.49, "Ta": 180.94788,
    "W": 183.84, "Re": 186.207, "Os": 190.23, "Ir": 192.217, "Pt": 195.084,
    "Au": 196.966569, "Hg": 200.592, "Tl": 204.38, "Pb": 207.2,
    "Bi": 208.98040, "Th": 232.0377, "U": 238.02891,
    "*": 0.0,  # wildcard atom
}

ATOMIC_NUMBERS: dict[str, int] = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22,
    "V": 23, "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29,
    "Zn": 30, "Ga": 31, "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Kr": 36,
    "Rb": 37, "Sr": 38, "Y": 39, "Zr": 40, "Nb": 41, "Mo": 42, "Tc": 43,
    "Ru": 44, "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50,
    "Sb": 51, "Te": 52, "I": 53, "Xe": 54, "Cs": 55, "Ba": 56, "La": 57,
    "W": 74, "Pt": 78, "Au": 79, "Hg": 80, "Tl": 81, "Pb": 82, "Bi": 83,
    "U": 92, "*": 0,
}

# Number of valence (outer-shell) electrons per element, used for lone-pair
# counting during hybridization / conjugation perception.
VALENCE_ELECTRONS: dict[str, int] = {
    "H": 1, "He": 2, "Li": 1, "Be": 2, "B": 3, "C": 4, "N": 5, "O": 6,
    "F": 7, "Ne": 8, "Na": 1, "Mg": 2, "Al": 3, "Si": 4, "P": 5, "S": 6,
    "Cl": 7, "Ar": 8, "K": 1, "Ca": 2, "Ga": 3, "Ge": 4, "As": 5, "Se": 6,
    "Br": 7, "Kr": 8, "In": 3, "Sn": 4, "Sb": 5, "Te": 6, "I": 7, "Xe": 8,
    "Tl": 3, "Pb": 4, "Bi": 5, "*": 0,
}

# Daylight organic-subset default valences: implicit hydrogens are added to
# organic-subset atoms (written without brackets) so that the atom's total
# bond order reaches the smallest listed valence >= its current bond order.
DEFAULT_VALENCES: dict[str, tuple[int, ...]] = {
    "B": (3,), "C": (4,), "N": (3, 5), "O": (2,), "P": (3, 5),
    "S": (2, 4, 6), "F": (1,), "Cl": (1,), "Br": (1,), "I": (1,),
}

# Elements that may appear without brackets in SMILES (organic subset).
ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I", "*"}
# Elements that may appear as lowercase (aromatic) symbols.
AROMATIC_OK = {"b", "c", "n", "o", "p", "s", "se", "as", "te"}


def atomic_weight(symbol: str, isotope: int = 0) -> float:
    """Average atomic weight, or the isotope's nominal mass when specified.

    RDKit returns the exact isotope mass for isotopically-labelled atoms; we
    use the integer mass number as a close approximation (documented
    deviation — Transition1x contains no isotope labels).
    """
    if isotope:
        return float(isotope)
    return ATOMIC_WEIGHTS.get(symbol, 0.0)


def valence_electrons(symbol: str) -> int:
    return VALENCE_ELECTRONS.get(symbol, 4)
