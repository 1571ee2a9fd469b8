"""The offline helpers that write the xyz files of the descriptor step:
the port's copy of the host-side functions of
``cgr_mpnn_3d_tpu/data/preprocess.py``.

* :func:`process_log_to_xyz` turns a wb97xd3 Q-Chem ``.log`` into a minimal
  ``.xyz``;
* :func:`match_reaction` finds the wb97xd3 reaction of a Transition1x record
  (same reactant formula string, closest product geometry);
* :func:`write_xyz_frames` writes multi-frame xyz, which
  ``data.descriptors.read_xyz`` reads back;
* :func:`records_to_rows` turns Transition1x records into xyz frames,
  reaction SMILES and activation energies in kcal/mol.

``PreProcessTransition1x`` (the download, the unpacking and the split files)
stays out: this package downloads nothing (ROADMAP.md section 1.7).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

import numpy as np

from ..chem.periodic import ATOMIC_NUMBERS

__all__ = ["EV_TO_KCAL_PER_MOL", "process_log_to_xyz", "match_reaction",
           "write_xyz_frames", "records_to_rows"]

EV_TO_KCAL_PER_MOL = 23.06

_SYMBOL_OF = {z: sym for sym, z in ATOMIC_NUMBERS.items()}

# Transition1x record field names
_STATES = ("reactant", "transition_state", "product")
_ENERGY = "wB97x_6-31G(d).energy"


def process_log_to_xyz(log_file: str | Path, xyz_file: str | Path) -> bool:
    """Convert a wb97xd3 Q-Chem ``.log`` into a minimal ``.xyz``.

    The atom count is the first token on the line after a ``NAtoms``
    marker; the coordinates begin two lines below the ``$molecule`` marker
    (the charge/multiplicity line is skipped).  A corrupt or truncated log
    is reported and skipped (returns False), so a sweep over many folders
    keeps going."""
    src, dst = Path(log_file), Path(xyz_file)
    try:
        text = src.read_text().splitlines()
        count = coords_at = None
        for ln, line in enumerate(text):
            if count is None and "NAtoms" in line:
                count = int(text[ln + 1].split()[0])
            elif coords_at is None and "$molecule" in line:
                coords_at = ln + 2
            if count is not None and coords_at is not None:
                break
        if count is None or coords_at is None:
            raise ValueError("no NAtoms/$molecule markers")
        block = text[coords_at:coords_at + count]
        if len(block) < count:
            raise ValueError(f"coordinate block truncated "
                             f"({len(block)}/{count} rows)")
        dst.write_text("\n".join([str(count), ""] + block) + "\n")
        return True
    except Exception as exc:
        print(f"skipping {src}: unparsable Q-Chem log ({exc})")
        return False


def match_reaction(r_numbers: str, p_positions: np.ndarray,
                   candidates_by_formula: dict[str, list[int]],
                   product_positions: list[np.ndarray]) -> int:
    """Transition1x record -> wb97xd3 reaction index: the candidates share
    the reactant's concatenated atomic-number string, and the one with the
    closest product geometry (least Frobenius distance) wins."""
    candidates = candidates_by_formula.get(r_numbers, [])
    if not candidates:
        raise KeyError(f"no wb97xd3 candidate for formula string {r_numbers}")
    dists = [float(np.linalg.norm(p_positions - product_positions[i]))
             for i in candidates]
    return candidates[int(np.argmin(dists))]


def write_xyz_frames(path: str | Path,
                     frames: Iterable[tuple[list[str], np.ndarray, str]]
                     ) -> None:
    """Write multi-frame xyz: each frame is (symbols, positions[N, 3],
    comment)."""
    with open(path, "w") as f:
        for syms, pos, comment in frames:
            f.write(f"{len(syms)}\n{comment}\n")
            for s, (px, py, pz) in zip(syms, np.asarray(pos, np.float64)):
                f.write(f"{s} {px:.8f} {py:.8f} {pz:.8f}\n")


def _formula_string(numbers: Iterable[int]) -> str:
    return "".join(str(int(z)) for z in numbers)


def records_to_rows(records: Iterable[dict],
                    by_formula: dict[str, list[int]],
                    p_positions: list[np.ndarray],
                    smiles: dict[int, tuple[str, str]]):
    """For each Transition1x record: three xyz frames (r / ts / p, the
    energy in the comment), the matched reaction SMILES and the activation
    energy (E_TS - E_reactant) in kcal/mol."""
    frames, rxn_smiles, e_a = [], [], []
    for rec in records:
        for state in _STATES:
            mol = rec[state]
            syms = [_SYMBOL_OF[int(z)] for z in mol["atomic_numbers"]]
            frames.append((syms, np.asarray(mol["positions"]),
                           f"energy={float(mol[_ENERGY])!r}"))
        ea_ev = rec["transition_state"][_ENERGY] - rec["reactant"][_ENERGY]
        e_a.append(float(ea_ev) * EV_TO_KCAL_PER_MOL)
        idx = match_reaction(
            _formula_string(rec["reactant"]["atomic_numbers"]),
            np.asarray(rec["product"]["positions"]), by_formula, p_positions)
        rsmi, psmi = smiles[idx]
        rxn_smiles.append(f"{rsmi}>>{psmi}")
    return frames, rxn_smiles, e_a
