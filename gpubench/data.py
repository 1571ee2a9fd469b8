"""The inputs of a run, made from ``--seed``: reactions drawn from the
corpus, synthetic MACE descriptors, and the split files the program reads.

The corpus is 300 atom-mapped Transition1x reactions with their activation
energies (kcal/mol), copied into ``gpubench/data``.  A split of n rows
holds the same reactions for every seed (the corpus repeated, then its
first n mod 300 rows once more), in an order shuffled from the seed: the
seed changes the order and not the sizes of the work.  Each row gets its
own descriptors, so no two rows are alike.  The descriptors follow the
MACE npz contract (``arr_i`` = [atoms, 3 * dim] per csv row, reactant ||
TS || product), drawn standard normal from the seed; the atoms are
counted from the bracketed atoms of the mapped reactant SMILES.  So a
CGR configuration's node features are the CGR's own plus three descriptor
sets (``check_cgr_config``).
"""

from __future__ import annotations

import csv
import re
from pathlib import Path

import numpy as np

__all__ = ["CORPUS", "corpus", "rng", "draw_rows", "atom_count",
           "descriptors", "write_split", "check_cgr_config"]

CORPUS = Path(__file__).resolve().parent / "data" / "corpus_reactions.csv"
_BRACKET = re.compile(r"\[[^\]]*\]")
_BARE_ATOM = re.compile(r"Cl|Br|[BCNOSPFIbcnosp]")


def corpus() -> tuple[list[str], np.ndarray]:
    """(reaction SMILES, activation energies) of the corpus."""
    with open(CORPUS, newline="") as f:
        rows = list(csv.reader(f))[1:]
    return ([r[0] for r in rows],
            np.asarray([float(r[1]) for r in rows], np.float32))


def rng(seed: int, stream: str) -> np.random.Generator:
    """The generator of one input stream of a run."""
    return np.random.default_rng([int(seed), sum(map(ord, stream))])


def draw_rows(n: int, seed: int, stream: str) -> np.ndarray:
    """``n`` corpus row indices: a fixed multiset in seeded order."""
    rows = np.arange(n) % len(corpus()[0])
    rng(seed, stream).shuffle(rows)
    return rows


def atom_count(smiles: str) -> int:
    """Atoms of the reactant side of a mapped reaction SMILES, every one
    of which is bracketed."""
    reactant = smiles.split(">")[0]
    if _BARE_ATOM.search(_BRACKET.sub("", reactant)):
        raise ValueError(f"unbracketed atom in {smiles!r}")
    return len(_BRACKET.findall(reactant))


def descriptors(smiles: list[str], dim: int, seed: int,
                stream: str) -> list[np.ndarray]:
    """Each row's [atoms, 3 * dim] descriptor block, drawn in one call."""
    counts = [atom_count(s) for s in smiles]
    flat = rng(seed, stream + ".desc").standard_normal(
        (sum(counts), 3 * dim), dtype=np.float32)
    return np.split(flat, np.cumsum(counts)[:-1])


def write_split(directory: Path, name: str, smiles: list[str],
                labels: np.ndarray, feats: list[np.ndarray] | None):
    """``<name>.csv`` (header, SMILES and label) and, with ``feats``,
    ``<name>.npz``, as the training and predicting entry points read them;
    returns (csv path, npz path or None)."""
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"{name}.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["smiles", "ea"])
        w.writerows(zip(smiles, (repr(float(v)) for v in labels)))
    if feats is None:
        return path, None
    npz = directory / f"{name}.npz"
    np.savez(npz, *feats)
    return path, npz


def check_cgr_config(cfg: dict, keys) -> None:
    """Raise ValueError unless ``cfg`` has each of ``keys`` and its node
    features are the CGR's plus three descriptor sets."""
    missing = sorted(set(keys) - set(cfg))
    if missing:
        raise ValueError(f"configuration {cfg.get('name')!r} lacks "
                         f"{missing}")
    want = cfg["cgr_node_features"] + 3 * cfg["descriptor_dim"]
    if cfg["node_features"] != want:
        raise ValueError(
            f"configuration {cfg.get('name')!r}: node_features "
            f"{cfg['node_features']} is not cgr_node_features + 3 * "
            f"descriptor_dim = {want}")
