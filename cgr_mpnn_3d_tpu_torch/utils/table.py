"""Minimal ASCII table (the reference depends on prettytable,
activation_energy_predictor.py:4; we render the same box style ourselves)."""

from __future__ import annotations

__all__ = ["AsciiTable"]


class AsciiTable:
    def __init__(self, field_names: list[str]):
        self.field_names = list(field_names)
        self.rows: list[list[str]] = []

    def add_row(self, row) -> None:
        if len(row) != len(self.field_names):
            raise ValueError("row length mismatch")
        self.rows.append([str(c) for c in row])

    def __str__(self) -> str:
        widths = [len(h) for h in self.field_names]
        for row in self.rows:
            widths = [max(w, len(c)) for w, c in zip(widths, row)]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

        def fmt(cells):
            return "| " + " | ".join(c.center(w) for c, w in
                                     zip(cells, widths)) + " |"

        lines = [sep, fmt(self.field_names), sep]
        lines += [fmt(r) for r in self.rows]
        lines.append(sep)
        return "\n".join(lines)
