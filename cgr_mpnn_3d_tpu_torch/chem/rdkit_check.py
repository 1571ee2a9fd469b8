"""RDKit differential check of the port's own featurizer.

The counterpart of ``cgr_mpnn_3d_tpu/chem/rdkit_check.py`` (a copy,
importing the port's ``chem.featurize``).  ``chem/`` re-implements the
perception rules that the original model takes from RDKit (degree, number
of hydrogens, hybridization, aromaticity, conjugation, rings).  Where RDKit
is importable, :func:`verify_corpus` derives every feature vector of the
vendored corpus (``tests/corpus_reactions.csv``) from RDKit and raises
:class:`FeaturizerDrift` on the first disagreement; ``cli/runbook.py`` runs
it before training, and skips it where RDKit is absent.

The RDKit backend below implements the featurization contract (the one-hot
lists and the CGR assembly shared with ``chem/featurize.py``) with every
perception rule delegated to RDKit, so a disagreement isolates a rule of
``chem/mol.py``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .featurize import (_ATOM_SYMBOLS, _CHARGES, _DEGREES, _NUM_HS,
                        RxnGraph, onek_encoding_unk)

__all__ = ["FeaturizerDrift", "rdkit_available", "verify_corpus",
           "rdkit_reaction_features"]

# reference hybridization one-hot order (graph_features.py:24-31), keyed by
# RDKit's HybridizationType name
_HYB_NAMES = ["SP", "SP2", "SP3", "SP3D", "SP3D2"]


class FeaturizerDrift(AssertionError):
    """The self-contained featurizer disagrees with RDKit on the corpus."""


def rdkit_available() -> bool:
    try:
        import rdkit  # noqa: F401
        return True
    except ImportError:
        return False


def _rd_atom_features(atom) -> list:
    """39-dim reference atom vector from a live RDKit atom
    (graph_features.py:15-34 contract)."""
    return (
        onek_encoding_unk(atom.GetSymbol(), _ATOM_SYMBOLS)
        + onek_encoding_unk(atom.GetTotalDegree(), _DEGREES)
        + onek_encoding_unk(atom.GetFormalCharge(), _CHARGES)
        + onek_encoding_unk(int(atom.GetTotalNumHs()), _NUM_HS)
        + onek_encoding_unk(atom.GetHybridization().name, _HYB_NAMES)
        + [1 if atom.GetIsAromatic() else 0]
        + [0.01 * atom.GetMass()]
    )


def _rd_bond_features(bond) -> list:
    """7-dim reference bond vector (graph_features.py:38-63 contract)."""
    if bond is None:
        return [1, 0, 0, 0, 0, 0, 0]
    from rdkit import Chem
    bt = bond.GetBondType()
    return [
        0,
        1 if bt == Chem.rdchem.BondType.SINGLE else 0,
        1 if bt == Chem.rdchem.BondType.DOUBLE else 0,
        1 if bt == Chem.rdchem.BondType.TRIPLE else 0,
        1 if bt == Chem.rdchem.BondType.AROMATIC else 0,
        1 if bond.GetIsConjugated() else 0,
        1 if bond.IsInRing() else 0,
    ]


def rdkit_reaction_features(smi: str):
    """CGR features for ``reac>agents>prod`` via RDKit perception.

    Returns (node_feats [N,78], edge_feats [E,14], senders, receivers) in
    the reference's deterministic order: reactant atom order, upper-triangle
    union-bond scan, directed pairs adjacent (graph_features.py:154-195).
    """
    from rdkit import Chem

    def make_mol(s):  # removeHs=False parse (graph_features.py:106-118)
        ps = Chem.SmilesParserParams()
        ps.removeHs = False
        mol = Chem.MolFromSmiles(s, ps)
        if mol is None:
            raise ValueError(f"RDKit could not parse {s!r}")
        return mol

    parts = smi.split(">")
    reac, prod = make_mol(parts[0]), make_mol(parts[-1])
    p_map = {a.GetAtomMapNum(): a.GetIdx() for a in prod.GetAtoms()}
    ri2pi = {a.GetIdx(): p_map[a.GetAtomMapNum()] for a in reac.GetAtoms()}

    n = reac.GetNumAtoms()
    f_r = [_rd_atom_features(reac.GetAtomWithIdx(i)) for i in range(n)]
    f_p = [_rd_atom_features(prod.GetAtomWithIdx(ri2pi[i])) for i in range(n)]
    node = np.asarray([fr + [b - a for a, b in zip(fr, fp)]
                       for fr, fp in zip(f_r, f_p)], np.float32)

    edge, send, recv = [], [], []
    for a1 in range(n):
        for a2 in range(a1 + 1, n):
            br = reac.GetBondBetweenAtoms(a1, a2)
            bp = prod.GetBondBetweenAtoms(ri2pi[a1], ri2pi[a2])
            if br is None and bp is None:
                continue
            fr, fp = _rd_bond_features(br), _rd_bond_features(bp)
            f = fr + [b - a for a, b in zip(fr, fp)]
            edge += [f, f]
            send += [a1, a2]
            recv += [a2, a1]
    return (node, np.asarray(edge, np.float32).reshape(len(send), 14),
            np.asarray(send, np.int32), np.asarray(recv, np.int32))


def verify_corpus(corpus_csv: str,
                  backend: Callable | None = None,
                  limit: int | None = None,
                  atol: float = 1e-4) -> dict:
    """Compare chem/ featurization against ``backend`` on every corpus line.

    ``backend`` defaults to :func:`rdkit_reaction_features` (requires
    RDKit).  Raises :class:`FeaturizerDrift` on the first disagreement with
    the offending SMILES and array named; returns a summary dict otherwise.
    One-hot drift shows up as a unit-sized difference, far above ``atol``
    (which only absorbs atomic-mass table rounding).
    """
    if backend is None:
        if not rdkit_available():
            raise ImportError(
                "RDKit is not importable: verify_corpus needs it (or a "
                "backend)")
        backend = rdkit_reaction_features

    with open(corpus_csv) as f:
        smis = [ln.split(",")[0] for ln in f.read().splitlines()[1:]
                if ln.strip()]
    if limit is not None:
        smis = smis[:limit]

    for smi in smis:
        ours = RxnGraph(smi).arrays
        node, edge, send, recv = backend(smi)

        def fail(what, a, b):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            if a.shape != b.shape:
                # a drifting edge union / atom count is the likeliest real
                # drift mode — report it as such, not as a broadcast error
                raise FeaturizerDrift(
                    f"featurizer drift vs backend on {smi!r}: {what} shapes "
                    f"disagree (ours {a.shape} vs backend {b.shape})")
            d = np.abs(a - b)
            raise FeaturizerDrift(
                f"featurizer drift vs backend on {smi!r}: {what} disagree "
                f"(max |delta| {d.max():.4g} at {np.unravel_index(d.argmax(), d.shape)})")

        if ours.node_feats.shape != node.shape or not np.allclose(
                ours.node_feats, node, atol=atol):
            fail("node features", ours.node_feats, node)
        if ours.edge_feats.shape != edge.shape or not np.allclose(
                ours.edge_feats, edge, atol=atol):
            fail("edge features", ours.edge_feats, edge)
        if not (np.array_equal(ours.senders, send)
                and np.array_equal(ours.receivers, recv)):
            raise FeaturizerDrift(
                f"featurizer drift vs backend on {smi!r}: edge topology "
                f"disagrees")
    return {"checked": len(smis), "mismatches": 0}
