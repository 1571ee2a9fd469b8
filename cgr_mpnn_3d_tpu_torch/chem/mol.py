"""Molecule model + chemical perception (rings, kekulization, valence,
hybridization, conjugation).

The reference obtains all of these properties from RDKit's C++ sanitizer
(the original cgr_mpnn_3D/utils/graph_features.py:15-62 reads
``GetTotalDegree``, ``GetFormalCharge``, ``GetTotalNumHs``,
``GetHybridization``, ``GetIsAromatic``, ``GetMass``, bond type /
``GetIsConjugated`` / ``IsInRing``).  This module re-derives the same
properties from first principles on the parsed graph:

* ring membership        — bridge detection (a bond is in a ring iff it is not
                           a cut edge); exact.
* kekulization           — backtracking perfect matching over aromatic systems
                           with standard contribution rules; used only to
                           obtain integer bond orders for valence counting.
* implicit hydrogens     — Daylight organic-subset default valences; bracket
                           atoms use their explicit H count (RDKit semantics:
                           bracket atoms get no implicit Hs).
* GetTotalNumHs parity   — implicit+bracket H count, NOT neighboring explicit
                           H atoms (RDKit default includeNeighbors=False), so
                           fully atom-mapped T1x SMILES give 0 for all atoms.
* GetTotalDegree parity  — graph degree (explicit neighbors, including H
                           atoms present in the graph) + the H count above.
* hybridization          — sigma orbitals + lone pairs, RDKit-style:
                           2->SP, 3->SP2, 4->SP3, 5->SP3D, 6->SP3D2; aromatic
                           SP3 results are demoted to SP2 (pyrrole N).
* conjugation            — documented approximation of RDKit's
                           ``setConjugation``: a multiple/aromatic bond and its
                           neighboring bond are conjugated when the shared atom
                           can carry a multiple bond and the far atom is a
                           pi-acceptor/donor candidate.

Exact bit-parity with every RDKit corner case is not a goal (nor testable in
this environment); the definitions above are self-consistent between training
and inference, which is what the model contract requires.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .periodic import (DEFAULT_VALENCES, atomic_weight, valence_electrons)
from .smiles import ParsedSmiles, RawAtom, RawBond, parse_smiles

__all__ = ["Molecule", "Atom", "Bond", "mol_from_smiles", "KekulizeError",
           "HYB_SP", "HYB_SP2", "HYB_SP3", "HYB_SP3D", "HYB_SP3D2", "HYB_OTHER"]

# Hybridization codes (only identity within this codebase matters; the
# featurizer maps them onto the reference's one-hot slots).
HYB_OTHER = 0   # S / unspecified -> falls into the "unknown" one-hot slot
HYB_SP = 2
HYB_SP2 = 3
HYB_SP3 = 4
HYB_SP3D = 5
HYB_SP3D2 = 6


class KekulizeError(ValueError):
    pass


@dataclass
class Atom:
    symbol: str
    aromatic: bool
    charge: int
    isotope: int
    map_num: int
    # perceived properties
    num_hs: int = 0            # GetTotalNumHs() equivalent (implicit + bracket H)
    degree: int = 0            # explicit graph degree
    total_degree: int = 0      # GetTotalDegree() equivalent
    in_ring: bool = False
    hybridization: int = HYB_OTHER
    lone_pairs: int = 0

    @property
    def mass(self) -> float:
        return atomic_weight(self.symbol, self.isotope)


@dataclass
class Bond:
    a1: int
    a2: int
    order: int                 # kekulized integer order (1/2/3/4)
    aromatic: bool
    in_ring: bool = False
    conjugated: bool = False

    def other(self, idx: int) -> int:
        return self.a2 if idx == self.a1 else self.a1


@dataclass
class Molecule:
    atoms: list[Atom] = field(default_factory=list)
    bonds: list[Bond] = field(default_factory=list)
    # adjacency: atom index -> list of bond indices
    adj: list[list[int]] = field(default_factory=list)

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    @property
    def num_bonds(self) -> int:
        return len(self.bonds)

    def bond_between(self, a1: int, a2: int) -> Bond | None:
        for bi in self.adj[a1]:
            b = self.bonds[bi]
            if b.other(a1) == a2:
                return b
        return None


# ---------------------------------------------------------------------------
# Perception passes
# ---------------------------------------------------------------------------

def _ring_bonds(n_atoms: int, bonds: list[RawBond],
                adj: list[list[int]]) -> list[bool]:
    """A bond is in a ring iff it is not a bridge (cut edge). Iterative DFS."""
    visited = [False] * n_atoms
    disc = [0] * n_atoms
    low = [0] * n_atoms
    is_bridge = [False] * len(bonds)
    timer = [1]

    for root in range(n_atoms):
        if visited[root]:
            continue
        # stack entries: (atom, parent_bond, iterator position)
        stack = [(root, -1, iter(adj[root]))]
        visited[root] = True
        disc[root] = low[root] = timer[0]
        timer[0] += 1
        while stack:
            u, pbond, it = stack[-1]
            advanced = False
            for bi in it:
                if bi == pbond:
                    continue
                b = bonds[bi]
                v = b.a2 if b.a1 == u else b.a1
                if not visited[v]:
                    visited[v] = True
                    disc[v] = low[v] = timer[0]
                    timer[0] += 1
                    stack.append((v, bi, iter(adj[v])))
                    advanced = True
                    break
                else:
                    low[u] = min(low[u], disc[v])
            if not advanced:
                stack.pop()
                if stack:
                    pu = stack[-1][0]
                    low[pu] = min(low[pu], low[u])
                    if low[u] > disc[pu]:
                        is_bridge[pbond] = True
    return [not br for br in is_bridge]


def _small_rings(n_atoms: int, bonds: list[RawBond], adj: list[list[int]],
                 in_ring: list[bool], max_size: int = 7) -> list[list[int]]:
    """Small rings as bond-index lists: for every ring bond, the shortest
    cycle through it (BFS on the graph minus that bond) — an SSSR-style
    approximation sufficient for chemistry-sized rings."""
    from collections import deque
    rings: list[list[int]] = []
    seen: set[frozenset[int]] = set()
    for bi, b in enumerate(bonds):
        if not in_ring[bi]:
            continue
        # BFS from a1 to a2 avoiding bond bi
        prev_bond = {b.a1: -1}
        dq = deque([b.a1])
        while dq and b.a2 not in prev_bond:
            u = dq.popleft()
            for bj in adj[u]:
                if bj == bi:
                    continue
                w = bonds[bj].a2 if bonds[bj].a1 == u else bonds[bj].a1
                if w not in prev_bond:
                    prev_bond[w] = bj
                    dq.append(w)
        if b.a2 not in prev_bond:
            continue
        path = [bi]
        cur = b.a2
        while cur != b.a1:
            bj = prev_bond[cur]
            path.append(bj)
            cur = bonds[bj].a1 + bonds[bj].a2 - cur
        if len(path) <= max_size:
            key = frozenset(path)
            if key not in seen:
                seen.add(key)
                rings.append(path)
    return rings


def _perceive_aromatic_rings(parsed: ParsedSmiles, adj: list[list[int]],
                             in_ring: list[bool],
                             orders: list[int]) -> set[int]:
    """Hueckel-style aromaticity perception for *kekulized* input (RDKit
    perceives aromaticity regardless of how the SMILES is written; lowercase
    input skips this).  Marks perceived atoms aromatic in-place and returns
    the perceived aromatic bond indices.

    Per-atom pi contributions: in-ring double bond -> 1; exocyclic double
    (quinone C=O) -> 0; lone-pair heteroatom (N/O/S pyrrole-type) -> 2;
    C+ -> 0; C- -> 2; sp3 carbon -> ring not aromatic.  A ring with 4k+2
    electrons becomes aromatic; already-aromatic atoms contribute 1, and
    rings are re-examined to a fixpoint (fused systems)."""
    bonds = parsed.bonds
    rings = _small_rings(len(parsed.atoms), bonds, adj, in_ring)
    if not rings:
        return set()

    has_ring_double = [False] * len(parsed.atoms)
    has_exo_double = [False] * len(parsed.atoms)
    for bi, b in enumerate(bonds):
        if orders[bi] >= 2:
            if in_ring[bi]:
                has_ring_double[b.a1] = has_ring_double[b.a2] = True
            else:
                has_exo_double[b.a1] = has_exo_double[b.a2] = True

    arom_bonds: set[int] = set()
    changed = True
    while changed:
        changed = False
        for ring in rings:
            if all(bi in arom_bonds for bi in ring):
                continue
            ring_atoms: list[int] = []
            for bi in ring:
                for a in (bonds[bi].a1, bonds[bi].a2):
                    if a not in ring_atoms:
                        ring_atoms.append(a)
            pi = 0
            ok = True
            for a in ring_atoms:
                atom = parsed.atoms[a]
                if atom.aromatic:
                    pi += 1
                elif has_ring_double[a]:
                    pi += 1
                elif has_exo_double[a]:
                    pi += 0
                elif atom.symbol == "C":
                    if atom.charge == 1:
                        pi += 0
                    elif atom.charge == -1:
                        pi += 2
                    else:
                        ok = False   # sp3 carbon breaks the ring
                        break
                elif atom.symbol in ("N", "O", "S", "P", "Se", "Te"):
                    pi += 2          # lone pair in the pi system
                else:
                    ok = False
                    break
            if ok and pi % 4 == 2:
                for a in ring_atoms:
                    parsed.atoms[a].aromatic = True
                for bi in ring:
                    if bi not in arom_bonds:
                        arom_bonds.add(bi)
                        changed = True
    return arom_bonds


def _needs_double(atom: RawAtom, conn: int, has_exo_multiple: bool) -> bool:
    """Does this aromatic atom need one double bond in the kekulized form?

    ``conn`` counts explicit neighbors + bracket/implicit hydrogens.
    """
    if has_exo_multiple:
        return False
    sym, chg = atom.symbol, atom.charge
    if sym == "C":
        return chg == 0
    if sym in ("N", "P", "As"):
        if chg == 1:
            return True
        if chg == -1:
            return False
        return conn == 2          # pyridine-type N; pyrrole-type has conn 3
    if sym in ("O", "S", "Se", "Te"):
        return chg == 1
    if sym == "B":
        return False
    return False


def _kekulize(parsed: ParsedSmiles, bond_aromatic: list[bool],
              adj: list[list[int]], est_conn: list[int],
              arom_flags: list[bool] | None = None) -> list[int]:
    """Assign integer orders to aromatic bonds via backtracking matching.

    Returns the per-bond integer order list (non-aromatic bonds keep their
    written order).  ``arom_flags`` restricts matching to the lowercase-
    written aromatic atoms (perceived-aromatic rings keep their written
    kekulized orders and must not be re-matched).
    """
    order_map = {"single": 1, "double": 2, "triple": 3, "quadruple": 4,
                 "aromatic": 1, "unspecified": 1}
    orders = [order_map[b.symbol] for b in parsed.bonds]

    if arom_flags is None:
        arom_flags = [a.aromatic for a in parsed.atoms]
    arom_atoms = [i for i, f in enumerate(arom_flags) if f]
    if not arom_atoms:
        return orders

    # does the atom carry a non-aromatic multiple bond (e.g. exocyclic C=O)?
    exo_multiple = [False] * len(parsed.atoms)
    for bi, b in enumerate(parsed.bonds):
        if not bond_aromatic[bi] and orders[bi] >= 2:
            exo_multiple[b.a1] = True
            exo_multiple[b.a2] = True

    needs = {}
    for i in arom_atoms:
        needs[i] = _needs_double(parsed.atoms[i], est_conn[i], exo_multiple[i])

    # aromatic adjacency restricted to atoms needing a double bond
    cand_bonds: dict[int, list[int]] = {i: [] for i in needs if needs[i]}
    for bi, b in enumerate(parsed.bonds):
        if bond_aromatic[bi] and needs.get(b.a1) and needs.get(b.a2):
            cand_bonds[b.a1].append(bi)
            cand_bonds[b.a2].append(bi)

    unmatched = sorted((i for i in cand_bonds), key=lambda i: len(cand_bonds[i]))
    matched: dict[int, int] = {}
    chosen: list[int] = []

    def backtrack(pos: int) -> bool:
        while pos < len(unmatched) and unmatched[pos] in matched:
            pos += 1
        if pos == len(unmatched):
            return True
        u = unmatched[pos]
        for bi in cand_bonds[u]:
            b = parsed.bonds[bi]
            v = b.a2 if b.a1 == u else b.a1
            if v in matched or u in matched:
                continue
            matched[u] = bi
            matched[v] = bi
            chosen.append(bi)
            if backtrack(pos + 1):
                return True
            chosen.pop()
            del matched[u]
            del matched[v]
        return False

    if not backtrack(0):
        bad = [i for i in cand_bonds if i not in matched]
        raise KekulizeError(
            f"cannot kekulize aromatic system; unmatched atoms {bad}")
    for bi in chosen:
        orders[bi] = 2
    return orders


def _implicit_hs(atom: RawAtom, bond_order_sum: int) -> int:
    if atom.bracket:
        return atom.h_count or 0
    defaults = DEFAULT_VALENCES.get(atom.symbol)
    if not defaults:
        return 0
    for v in defaults:
        if bond_order_sum <= v:
            return v - bond_order_sum
    return 0


def _hybridization(symbol: str, sigma: int, lone_pairs: int,
                   aromatic: bool) -> int:
    norbs = sigma + lone_pairs
    table = {2: HYB_SP, 3: HYB_SP2, 4: HYB_SP3, 5: HYB_SP3D, 6: HYB_SP3D2}
    res = table.get(norbs, HYB_OTHER)
    # RDKit demotes aromatic SP3 atoms (pyrrole-type N with a lone pair in
    # the pi system) to SP2.
    if aromatic and res == HYB_SP3:
        res = HYB_SP2
    return res


def _set_conjugation(mol: Molecule) -> None:
    """Approximation of RDKit MolOps::setConjugation (see module docstring)."""
    def pi_candidate(i: int) -> bool:
        a = mol.atoms[i]
        if a.aromatic:
            return True
        for bi in mol.adj[i]:
            if mol.bonds[bi].order >= 2:
                return True
        # lone-pair donors adjacent to a pi system
        return a.lone_pairs > 0 and a.symbol not in ("C", "H", "*")

    for bi, b in enumerate(mol.bonds):
        if b.aromatic:
            b.conjugated = True

    for i in range(mol.num_atoms):
        if not pi_candidate(i):
            continue
        multi = [bi for bi in mol.adj[i]
                 if mol.bonds[bi].order >= 2 or mol.bonds[bi].aromatic]
        if not multi:
            continue
        for b1 in multi:
            for b2 in mol.adj[i]:
                if b1 == b2:
                    continue
                j = mol.bonds[b2].other(i)
                if pi_candidate(j):
                    mol.bonds[b1].conjugated = True
                    mol.bonds[b2].conjugated = True


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def mol_from_smiles(smiles: str) -> Molecule:
    """Parse + perceive a molecule. Explicit hydrogens are always retained,
    matching the reference's ``Chem.MolFromSmiles(smi, removeHs=False)``
    (graph_features.py:116-118)."""
    parsed = parse_smiles(smiles)
    n = len(parsed.atoms)

    adj: list[list[int]] = [[] for _ in range(n)]
    for bi, b in enumerate(parsed.bonds):
        adj[b.a1].append(bi)
        adj[b.a2].append(bi)

    in_ring = _ring_bonds(n, parsed.bonds, adj)
    # lowercase-written aromatic flags (before perception mutates them)
    written_arom = [a.aromatic for a in parsed.atoms]

    # Bond aromaticity: written ':' bonds, or unspecified bonds between two
    # aromatic atoms *inside a ring* (biphenyl's linker bond stays single).
    bond_aromatic = []
    for bi, b in enumerate(parsed.bonds):
        if b.symbol == "aromatic":
            bond_aromatic.append(True)
        elif (b.symbol == "unspecified" and in_ring[bi]
              and parsed.atoms[b.a1].aromatic and parsed.atoms[b.a2].aromatic):
            bond_aromatic.append(True)
        else:
            bond_aromatic.append(False)

    # Estimated connectivity (neighbors + bracket H) used by kekulization
    # contribution rules.  For organic-subset aromatic atoms (c, n, o, s) the
    # implicit H count is not yet known; approximate with graph degree +
    # bracket hcount, plus 1 for bare aromatic 'c' with degree 2 (ring CH).
    est_conn = []
    for i, a in enumerate(parsed.atoms):
        conn = len(adj[i]) + (a.h_count or 0)
        if (not a.bracket and a.aromatic and a.symbol == "C"
                and len(adj[i]) == 2):
            conn += 1  # aromatic ring carbon with implicit H
        est_conn.append(conn)

    orders = _kekulize(parsed, bond_aromatic, adj, est_conn,
                       arom_flags=written_arom)

    # Aromaticity perception for kekulized input (RDKit perceives regardless
    # of how the ring was written); perceived rings keep their written
    # integer orders — only the aromatic flags change.
    perceived = _perceive_aromatic_rings(parsed, adj, in_ring, orders)
    if perceived:
        bond_aromatic = [ba or (bi in perceived)
                         for bi, ba in enumerate(bond_aromatic)]

    mol = Molecule()
    mol.adj = adj
    for bi, b in enumerate(parsed.bonds):
        mol.bonds.append(Bond(b.a1, b.a2, orders[bi], bond_aromatic[bi],
                              in_ring=in_ring[bi]))

    for i, ra in enumerate(parsed.atoms):
        bond_sum = sum(orders[bi] for bi in adj[i])
        num_hs = _implicit_hs(ra, bond_sum)
        degree = len(adj[i])
        total_valence = bond_sum + num_hs
        nouter = valence_electrons(ra.symbol)
        lone_pairs = max(0, (nouter - ra.charge - total_valence) // 2)
        sigma = degree + num_hs
        hyb = _hybridization(ra.symbol, sigma, lone_pairs, ra.aromatic)
        if ra.symbol in ("H", "*"):
            hyb = HYB_OTHER
        mol.atoms.append(Atom(
            symbol=ra.symbol,
            aromatic=ra.aromatic,
            charge=ra.charge,
            isotope=ra.isotope,
            map_num=ra.map_num,
            num_hs=num_hs,
            degree=degree,
            total_degree=degree + num_hs,
            in_ring=any(in_ring[bi] for bi in adj[i]),
            hybridization=hyb,
            lone_pairs=lone_pairs,
        ))

    _set_conjugation(mol)
    return mol
