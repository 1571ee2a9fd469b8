"""MACE-MP-0 "small" descriptors in plain PyTorch: the reference that the
program's MACE kernels are compared with.

MACE (arXiv:2206.07697), MACE-MP-0 (arXiv:2401.00096), the ``small``
model of github.com/ACEsuit/mace: per structure, every ordered pair i != j
within r_max (no periodic images), r_ij = pos_i - pos_j;

  h0       = W_emb[z]
  layer t: h~ = h @ W_up;  R_ij = MLP(bessel(r_ij) * envelope(r_ij)) (SiLU,
           no biases);  m_i[lm, c] = sum_j R_ij[l, c] h~_j[c] Y_lm(r^_ij);
           A = (m @ W_lin[l]) / avg_num_neighbors;  t = 0: A = A @
           W_skip[z, l];  t > 0: sc = h @ W_skip[z];
           B[c] = sum_nu sum_k w_nu[z, k, c] (U^nu_k . A[c] x ... x A[c]);
           h = B @ W_out (+ sc)
  descriptors = [h1 || h2]

One structure at a time, as dense [n, n] arrays masked at the cutoff
(structures of one size stacked, which changes no sum), float32 with TF32
off; the coupling tensors U^nu are dense, one column a path in MACE's
order, from sympy's Clebsch-Gordan coefficients in the real basis of
:func:`sh`.  It shares no code with the program: the weights' names and
layout (:func:`make_weights`) and the conventions (the basis, the path
order, e3nn's constants folded into the weights) are the contract.
``tf32=True`` rounds the radial MLP's operands to TF32 (the control).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .model import round_tf32

__all__ = ["leaf_shapes", "make_weights", "sh", "coupling", "u_matrices",
           "descriptors"]

LMAX = 3


def leaf_shapes(cfg: dict) -> dict:
    """The MACE parameters by name, in the order they are drawn, with the
    fan-in and gain of each."""
    C, E, NB = cfg["channels"], cfg["elements"], cfg["bessel"]
    RH = cfg["radial_mlp"][0]
    out = {"embedding": ((E, C), 1, 1.0)}
    for t in range(cfg["interactions"]):
        p = f"interactions.{t}."
        out[p + "linear_up"] = ((C, C), C, 1.0)
        for k, (a, b) in enumerate([(NB, RH), (RH, RH), (RH, RH),
                                    (RH, 4 * C)]):
            out[p + f"radial.{k}"] = ((a, b), a, _GAIN_RADIAL[k])
        out[p + "linear"] = ((4, C, C), C, _GAIN_LINEAR)
        out[p + "skip_tp"] = (((E, 4, C, C) if t == 0 else (E, C, C)), C,
                              1.0)
    for t in range(cfg["interactions"]):
        for nu in range(1, cfg["correlation"] + 1):
            k = len(_paths(nu))
            out[f"products.{t}.weights.{nu - 1}"] = ((E, k, C), k, 1.0)
        out[f"products.{t}.linear"] = ((C, C), C, 1.0)
    return out


# gains over unit variance: the Bessel features are ~0.2 and SiLU halves
# small inputs, and the messages are divided by avg_num_neighbors, so with
# unit-variance maps the correlation orders 2 and 3 would sit under float32
# rounding; with these every stage is of order one on molecular geometries,
# as in a trained model
_GAIN_RADIAL = (5.0, 2.0, 2.0, 1.0)
_GAIN_LINEAR = 8.0


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Weights drawn on ``device`` from ``seed`` in one call, each uniform
    in +-gain * sqrt(3 / fan_in) (:func:`leaf_shapes`)."""
    shapes = leaf_shapes(cfg)
    sizes = [math.prod(s) for s, _, _ in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x3ACE)
    u = torch.rand(sum(sizes), generator=gen, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([g * math.sqrt(3.0 / f) for _, f, g in shapes.values()],
                     device=device), torch.tensor(sizes, device=device))
    flat = (2.0 * u - 1.0) * scale
    return {n: t.view(s) for (n, (s, _, _)), t in
            zip(shapes.items(), torch.split(flat, sizes))}


def sh(u: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics l <= 3 of unit vectors [..., 3], component
    normalised, e3nn's basis: the standard real Y_l,m (m = -l..l) of the
    axes (z, x, y) relabelled (X, Y, Z)."""
    x, y, z = u[..., 2], u[..., 0], u[..., 1]
    return torch.stack([
        torch.ones_like(x),
        math.sqrt(3) * y, math.sqrt(3) * z, math.sqrt(3) * x,
        math.sqrt(15) * x * y, math.sqrt(15) * y * z,
        math.sqrt(5) / 2 * (3 * z ** 2 - 1), math.sqrt(15) * x * z,
        math.sqrt(15) / 2 * (x ** 2 - y ** 2),
        math.sqrt(70) / 4 * y * (3 * x ** 2 - y ** 2),
        math.sqrt(105) * x * y * z,
        math.sqrt(42) / 4 * y * (5 * z ** 2 - 1),
        math.sqrt(7) / 2 * z * (5 * z ** 2 - 3),
        math.sqrt(42) / 4 * x * (5 * z ** 2 - 1),
        math.sqrt(105) / 2 * z * (x ** 2 - y ** 2),
        math.sqrt(70) / 4 * x * (x ** 2 - 3 * y ** 2)], dim=-1)


def _real_of_complex(l: int) -> np.ndarray:
    """Rows: the real harmonics of :func:`sh` as combinations of the
    complex Y_l^m (Condon-Shortley phase), columns m = -l..l."""
    q = np.zeros((2 * l + 1, 2 * l + 1), complex)
    for m in range(1, l + 1):
        q[l + m, l - m] = 1 / math.sqrt(2)
        q[l + m, l + m] = (-1) ** m / math.sqrt(2)
        q[l - m, l - m] = 1j / math.sqrt(2)
        q[l - m, l + m] = -1j * (-1) ** m / math.sqrt(2)
    q[l, l] = 1.0
    return q


@lru_cache(maxsize=None)
def coupling(l1: int, l2: int, l3: int) -> np.ndarray:
    """The real coupling tensor l1 x l2 -> l3 (l1 + l2 + l3 even)."""
    from sympy.physics.wigner import clebsch_gordan
    cg = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for i in range(2 * l1 + 1):
        for j in range(2 * l2 + 1):
            m3 = i - l1 + j - l2
            if -l3 <= m3 <= l3:
                cg[i, j, m3 + l3] = float(clebsch_gordan(
                    l1, l2, l3, i - l1, j - l2, m3))
    q1, q2, q3 = (_real_of_complex(l) for l in (l1, l2, l3))
    t = np.einsum("ijk,ai,bj,ck->abc", cg, q1.conj(), q2.conj(), q3)
    assert np.abs(t.imag).max() < 1e-12
    return t.real


def _paths(nu: int) -> list:
    ls = range(LMAX + 1)
    if nu == 1:
        return [(0,)]
    if nu == 2:
        return [(l, l) for l in ls]
    return sorted([(a, b, c) for a in ls for b in ls for c in ls
                   if abs(a - b) <= c <= a + b and (a + b + c) % 2 == 0],
                  key=lambda p: (p[2], p[0], p[1]))


@lru_cache(maxsize=None)
def u_matrices(correlation: int) -> tuple:
    """Dense U^1 [16, 1], U^2 [16, 16, 4], U^3 [16, 16, 16, 23]: path k
    couples its l's to a scalar through the intermediate l3."""
    out = []
    for nu in range(1, correlation + 1):
        ps = _paths(nu)
        u = np.zeros((16,) * nu + (len(ps),))
        for k, p in enumerate(ps):
            sl = [slice(l * l, (l + 1) ** 2) for l in p]
            if nu == 1:
                u[0, k] = 1.0
            elif nu == 2:
                u[sl[0], sl[1], k] = coupling(p[0], p[0], 0)[..., 0]
            else:
                u[sl[0], sl[1], sl[2], k] = np.einsum(
                    "abm,mc->abc", coupling(*p),
                    coupling(p[2], p[2], 0)[..., 0])
        out.append(u)
    return tuple(out)


def _mm(a, b, tf32: bool):
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def _per_element(x, z, w, idx_shape):
    """x[i] @ w[z_i] for every atom, one element at a time."""
    out = torch.empty(idx_shape, dtype=x.dtype, device=x.device)
    for e in torch.unique(z).tolist():
        sel = z == e
        out[sel] = x[sel] @ w[e]
    return out


def _group(pos, z, w, cfg, tf32: bool, atom_block: int) -> torch.Tensor:
    """Descriptors [B, n, T * C] of B structures of n atoms."""
    B, n, _ = pos.shape
    C, T = cfg["channels"], cfg["interactions"]
    rmax, p = cfg["r_max"], cfg["polynomial_cutoff"]
    vec = pos[:, :, None, :] - pos[:, None, :, :]
    d = torch.linalg.vector_norm(vec, dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    mask = (d < rmax) & ~eye
    d_safe = torch.where(eye, torch.ones_like(d), d)
    Y = sh(vec / d_safe[..., None]) * mask[..., None]
    k = torch.arange(1, cfg["bessel"] + 1, device=pos.device,
                     dtype=pos.dtype)
    x = d_safe / rmax
    env = (1 - (p + 1) * (p + 2) / 2 * x ** p + p * (p + 2) * x ** (p + 1)
           - p * (p + 1) / 2 * x ** (p + 2)) * mask
    rb = (math.sqrt(2 / rmax) * torch.sin(k * math.pi * x[..., None])
          / d_safe[..., None]) * env[..., None]
    l_of = torch.as_tensor([l for l in range(LMAX + 1)
                            for _ in range(2 * l + 1)], device=pos.device)
    zf = z.reshape(-1)
    h = w["embedding"][zf]
    sc = None
    us = [torch.as_tensor(u, dtype=pos.dtype, device=pos.device)
          for u in u_matrices(cfg["correlation"])]
    outs = []
    for t in range(T):
        pre = f"interactions.{t}."
        if t > 0:
            sc = _per_element(h, zf, w[pre + "skip_tp"], h.shape)
        hup = (h @ w[pre + "linear_up"]).view(B, n, C)
        r = rb
        for j in range(3):
            r = torch.nn.functional.silu(_mm(r, w[pre + f"radial.{j}"], tf32))
        R = _mm(r, w[pre + "radial.3"], tf32).view(B, n, n, 4, C)[..., l_of, :]
        m = torch.einsum("bijlc,bjc,bijl->bilc", R, hup, Y).reshape(-1, 16, C)
        a = torch.empty_like(m)
        for l in range(LMAX + 1):
            s = slice(l * l, (l + 1) ** 2)
            a[:, s] = m[:, s] @ w[pre + "linear"][l] / cfg["avg_num_neighbors"]
            if t == 0:
                a[:, s] = _per_element(a[:, s], zf,
                                       w[pre + "skip_tp"][:, l], a[:, s].shape)
        bsum = torch.empty(B * n, C, dtype=pos.dtype, device=pos.device)
        for lo in range(0, B * n, atom_block):
            ab = a[lo:lo + atom_block]
            zb = zf[lo:lo + atom_block]
            N = ab.shape[0]
            terms = 0
            for nu, u in enumerate(us, start=1):
                wz = w[f"products.{t}.weights.{nu - 1}"][zb]       # [N, K, C]
                if nu == 1:
                    phi = torch.einsum("ak,nac->nkc", u, ab)
                elif nu == 2:
                    phi = torch.einsum("abk,nac,nbc->nkc", u, ab, ab)
                else:
                    pair = (ab[:, :, None, :] * ab[:, None, :, :]).reshape(
                        N, 256, C)
                    g = (u.reshape(256, -1).T @ pair).view(N, 16, -1, C)
                    phi = torch.einsum("nckh,nch->nkh", g, ab)
                terms = terms + (wz * phi).sum(1)
            bsum[lo:lo + atom_block] = terms
        h = bsum @ w[f"products.{t}.linear"]
        if sc is not None:
            h = h + sc
        outs.append(h)
    return torch.cat(outs, -1).view(B, n, T * C)


def descriptors(structures, weights: dict, cfg: dict, device,
                tf32: bool = False, atom_block: int = 4096,
                pair_block: int = 2 ** 16) -> list:
    """[n, T * C] float32 descriptors of each structure (z [n] element
    indices = atomic number - 1, positions [n, 3] in Å), structures of one
    size computed together."""
    w = {k: v.detach().to(device=device, dtype=torch.float32)
         for k, v in weights.items()}
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        by_n: dict = {}
        for i, (z, pos) in enumerate(structures):
            by_n.setdefault(len(z), []).append(i)
        out = [None] * len(structures)
        with torch.no_grad():
            for n, every in by_n.items():
                step = max(1, pair_block // (n * n))
                for lo in range(0, len(every), step):
                    idx = every[lo:lo + step]
                    pos = torch.as_tensor(np.stack(
                        [np.asarray(structures[i][1], np.float32)
                         for i in idx]), device=device)
                    z = torch.as_tensor(np.stack(
                        [np.asarray(structures[i][0], np.int64)
                         for i in idx]), device=device)
                    d = _group(pos, z, w, cfg, tf32, atom_block)
                    for j, i in enumerate(idx):
                        out[i] = d[j]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    return out
