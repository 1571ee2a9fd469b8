"""A self-contained SMILES parser.

The reference uses RDKit (C++) for all SMILES handling
(the original cgr_mpnn_3D/utils/graph_features.py:106-118 ``make_mol`` with
``removeHs=False``). RDKit is not part of this framework's environment, so this
module implements the subset of SMILES needed for reaction datasets such as
Transition1x: bracket atoms with isotopes / charges / explicit H counts / atom
maps, the organic subset, aromatic (lowercase) atoms, ring-bond closures
(including %nn), branches, dots, and bond symbols (- = # $ : / \\).

Stereochemistry markers (@, @@, /, \\) are parsed and discarded: none of the
reference's atom/bond features depend on stereo
(graph_features.py:4-63).  Explicit hydrogen atoms written as graph atoms
(e.g. ``[H:8]``) are always retained, matching the reference's
``removeHs=False`` parsing.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from .periodic import ATOMIC_WEIGHTS, AROMATIC_OK

__all__ = ["RawAtom", "RawBond", "ParsedSmiles", "parse_smiles", "SmilesError"]


class SmilesError(ValueError):
    """Raised for malformed SMILES input."""


@dataclass
class RawAtom:
    symbol: str                 # canonical element symbol, e.g. "C", "Cl"
    aromatic: bool = False      # written lowercase
    charge: int = 0
    isotope: int = 0
    map_num: int = 0
    h_count: int | None = None  # None => organic subset (implicit H computed later)
    bracket: bool = False


@dataclass
class RawBond:
    a1: int
    a2: int
    # "single" | "double" | "triple" | "quadruple" | "aromatic" | "unspecified"
    symbol: str = "unspecified"


@dataclass
class ParsedSmiles:
    atoms: list[RawAtom] = field(default_factory=list)
    bonds: list[RawBond] = field(default_factory=list)


_BRACKET_RE = re.compile(
    r"""\[
        (?P<isotope>\d+)?
        (?P<symbol>[A-Z][a-z]?|[a-z]{1,2}|\*)
        (?P<chiral>@TH\d|@AL\d|@SP\d|@TB\d+|@OH\d+|@@|@)?
        (?P<hcount>H\d*)?
        (?P<charge>\+{1,3}|-{1,3}|\+\d+|-\d+)?
        (?::(?P<map>\d+))?
    \]""",
    re.VERBOSE,
)

_BOND_SYMBOLS = {
    "-": "single",
    "=": "double",
    "#": "triple",
    "$": "quadruple",
    ":": "aromatic",
    "/": "single",   # directional (stereo) bonds are plain single bonds here
    "\\": "single",
}

# Two-letter organic-subset symbols must be matched before one-letter ones.
_ORGANIC_TOKENS = ("Cl", "Br", "B", "C", "N", "O", "P", "S", "F", "I",
                   "b", "c", "n", "o", "p", "s", "*")


def _parse_bracket(body: str, pos: int) -> tuple[RawAtom, int]:
    m = _BRACKET_RE.match(body, pos)
    if m is None:
        raise SmilesError(f"malformed bracket atom at position {pos}: {body[pos:pos+12]!r}")
    sym = m.group("symbol")
    aromatic = sym[0].islower() and sym != "*"
    if aromatic:
        if sym not in AROMATIC_OK:
            raise SmilesError(f"element {sym!r} cannot be aromatic")
        sym = sym.capitalize()
    if sym != "*" and sym not in ATOMIC_WEIGHTS:
        raise SmilesError(f"unknown element symbol {sym!r}")
    hcount_tok = m.group("hcount")
    if hcount_tok is None:
        h_count = 0
    elif hcount_tok == "H":
        h_count = 1
    else:
        h_count = int(hcount_tok[1:])
    charge_tok = m.group("charge")
    if charge_tok is None:
        charge = 0
    elif charge_tok in ("+", "++", "+++", "-", "--", "---"):
        charge = charge_tok.count("+") - charge_tok.count("-")
    else:
        charge = int(charge_tok) if charge_tok[0] != "+" else int(charge_tok[1:])
    atom = RawAtom(
        symbol=sym,
        aromatic=aromatic,
        charge=charge,
        isotope=int(m.group("isotope") or 0),
        map_num=int(m.group("map") or 0),
        h_count=h_count,
        bracket=True,
    )
    return atom, m.end()


def parse_smiles(smiles: str) -> ParsedSmiles:
    """Parse one SMILES fragment string (no '>' reaction separators)."""
    out = ParsedSmiles()
    prev_atom: int | None = None
    pending_bond: str | None = None
    branch_stack: list[int | None] = []
    # ring-closure number -> (atom index, bond symbol or None)
    ring_open: dict[int, tuple[int, str | None]] = {}

    def add_atom(atom: RawAtom) -> None:
        nonlocal prev_atom, pending_bond
        idx = len(out.atoms)
        out.atoms.append(atom)
        if prev_atom is not None:
            out.bonds.append(RawBond(prev_atom, idx, pending_bond or "unspecified"))
        prev_atom = idx
        pending_bond = None

    def close_ring(num: int) -> None:
        nonlocal pending_bond
        if prev_atom is None:
            raise SmilesError(f"ring-closure digit {num} before any atom")
        if num in ring_open:
            open_atom, open_bond = ring_open.pop(num)
            if open_atom == prev_atom:
                raise SmilesError(f"ring bond {num} closes onto its own atom")
            sym = pending_bond or open_bond
            if pending_bond and open_bond and pending_bond != open_bond:
                raise SmilesError(f"conflicting bond symbols for ring closure {num}")
            out.bonds.append(RawBond(open_atom, prev_atom, sym or "unspecified"))
            pending_bond = None
        else:
            ring_open[num] = (prev_atom, pending_bond)
            pending_bond = None

    i, n = 0, len(smiles)
    while i < n:
        ch = smiles[i]
        if ch == "[":
            atom, i = _parse_bracket(smiles, i)
            add_atom(atom)
            continue
        if ch in _BOND_SYMBOLS:
            if pending_bond is not None:
                raise SmilesError(f"two bond symbols in a row at position {i}")
            pending_bond = _BOND_SYMBOLS[ch]
            i += 1
            continue
        if ch == "(":
            if prev_atom is None:
                raise SmilesError("branch opened before any atom")
            branch_stack.append(prev_atom)
            i += 1
            continue
        if ch == ")":
            if not branch_stack:
                raise SmilesError("unmatched ')'")
            prev_atom = branch_stack.pop()
            i += 1
            continue
        if ch == ".":
            prev_atom = None
            pending_bond = None
            i += 1
            continue
        if ch.isdigit():
            close_ring(int(ch))
            i += 1
            continue
        if ch == "%":
            m = re.match(r"%(\d\d)", smiles[i:])
            if not m:
                raise SmilesError(f"malformed %nn ring closure at position {i}")
            close_ring(int(m.group(1)))
            i += 3
            continue
        # organic-subset atom (two-letter symbols first)
        matched = False
        for tok in _ORGANIC_TOKENS:
            if smiles.startswith(tok, i):
                aromatic = tok[0].islower() and tok != "*"
                add_atom(RawAtom(symbol=tok.capitalize() if aromatic else tok,
                                 aromatic=aromatic))
                i += len(tok)
                matched = True
                break
        if matched:
            continue
        raise SmilesError(f"unexpected character {ch!r} at position {i} in {smiles!r}")

    if branch_stack:
        raise SmilesError("unclosed branch '('")
    if ring_open:
        raise SmilesError(f"unclosed ring bonds: {sorted(ring_open)}")
    if pending_bond is not None:
        raise SmilesError("dangling bond symbol at end of SMILES")
    return out
