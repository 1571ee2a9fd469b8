"""The yardstick of the MACE kernels (``cost.py`` holds the head's): the
work of one window's MACE forward, kernel by kernel, summed over the
layers, and its least time on the card (``cost.bound``).

Counted over the real atoms and edges (ordered pairs within r_max) of the
window's structures: products count 2 operations a multiply-add; the
interaction's message R[l, c] h~_j[c] Y_lm, its sum into the receiver and
the symmetric contraction's monomials (3 multiplies and an add each, 94
of them) count their multiplies and adds; the spherical harmonics, the
Bessel functions and the neighbour search are not counted.  Every input
is read once and every output written once, each tensor at its element
size (float32, int32); weights that depend on the element count once for
each element the window holds.
"""

from __future__ import annotations

__all__ = ["MONOMIALS", "POLYNOMIALS", "mace_cost"]

# the symmetric contraction to 0e at correlation 3, l <= 3, as the
# product kernel evaluates it: 13 polynomials of 94 monomials
MONOMIALS = 94
POLYNOMIALS = 13
_TILE = 4


def mace_cost(m: dict, atoms: int, edges: int, structures: int,
              elements: int, tiles: int) -> dict:
    """{"interaction": (products, other operations, bytes), "product":
    (...)} of one window over every layer; ``m`` is the configuration's
    mace block, ``elements`` the distinct elements of the window, ``tiles``
    the product kernel's element tiles."""
    C, NB, RH = m["channels"], m["bessel"], m["radial_mlp"][0]
    T = m["interactions"]
    mlp = NB * RH + 2 * RH * RH + RH * 4 * C
    inter = [0.0, 0.0, 0.0]
    prod = [0.0, 0.0, 0.0]
    for t in range(T):
        nxt = t + 1 < T
        inter[0] += edges * 2 * mlp
        inter[1] += edges * (4 * C + 2 * 16 * C)
        inter[2] += 4 * (3 * atoms + structures + 1 + atoms * C + mlp
                         + atoms * 16 * C)
        prod[0] += atoms * (2 * 16 * C * C + 2 * POLYNOMIALS * C
                            + 2 * C * C + (4 * C * C if nxt else 0))
        prod[1] += atoms * (4 * MONOMIALS * C + (C if t else 0))
        maps = (elements if t == 0 else 1) * 4 * C * C
        prod[2] += 4 * (atoms * 16 * C + atoms + tiles * _TILE + maps
                        + elements * POLYNOMIALS * C + C * C
                        + (atoms * C if t else 0) + atoms * C
                        + ((C * C + elements * C * C + 2 * atoms * C)
                           if nxt else 0))
    return {"interaction": tuple(inter), "product": tuple(prod)}
