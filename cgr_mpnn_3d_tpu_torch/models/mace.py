"""MACE-MP-0 "small" as a descriptor model: per-atom invariant features of
3D structures, computed on the card by two hand-written kernels a layer.

The published small model (MACE, arXiv:2206.07697; MACE-MP-0,
arXiv:2401.00096; github.com/ACEsuit/mace, ``mace_mp(model="small")``):
128 scalar channels (hidden irreps 128x0e), 2 interactions, spherical
harmonics to l = 3, 8 Bessel functions under a polynomial envelope (p = 5)
into a [64, 64, 64] radial MLP, a per-element symmetric contraction of
correlation order 3, 89 elements, r_max 6 Å.  For one structure:

  edges      every ordered pair i != j with |r_ij| < r_max, r_ij =
             pos[receiver i] - pos[sender j] (no periodic images)
  h0_i     = W_emb[z_i]
  for t in interactions:
      h~    = h @ W_up
      R_ij  = MLP(bessel(r_ij) * envelope(r_ij))      8 -> 64 -> 64 -> 64 ->
                                                      4C, SiLU, no biases
      m_i   = sum_j R_ij[l, c] * h~_j[c] * Y_lm(r^_ij)
      A_i   = (m_i @ W_lin[l]) / avg_num_neighbors     one C x C map an l
      t = 0:  A_i = A_i @ W_skip[z_i, l]               (no residual)
      t > 0:  sc_i = h_i @ W_skip[z_i]                 (the residual)
      B_i   = sum_nu sum_k w_nu[z_i, k, c] * sum U^nu_k prod A_i[c, lm]
      h_i   = B_i @ W_out (+ sc_i)
  descriptor_i = [h1_i || h2_i]   (get_descriptors' invariants, all layers)

Weights are ``[fan_in, fan_out]`` with e3nn's normalisation constants (the
1/sqrt(fan_in) of its linear maps, the second-moment factor of its SiLU,
the path weights of its tensor products) folded in, so that the state
dict's tensors are used as they stand; a release file's tensors take those
factors on load (see the configuration's ``assumed``).

The couplings are built once on the host: Clebsch-Gordan coefficients
from ``sympy.physics.wigner`` turned into the real basis of
:func:`real_sh` (e3nn's: the standard real spherical harmonics at the
coordinates (z, x, y), "component" normalisation), the coupling tensors
``U^nu`` of every path as MACE enumerates them, and for the kernels the
same contraction reduced to one symmetric polynomial per multiset of l's
(:func:`product_basis`), the per-path weights folded onto it
(:meth:`MACE.prepared`).  Element index = atomic number - 1.

On CUDA tensors :meth:`MACE.descriptors` launches the interaction and
product kernels (``ops/mace.py``, ``csrc/mace.cu``); on CPU tensors it
takes their plain versions.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from functools import lru_cache
from itertools import permutations
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..utils.tracing import count_mace, span

__all__ = ["MACEConfig", "MACE", "real_sh", "real_cg", "u_tables",
           "product_basis", "L_OF_LM", "save_mace", "load_mace",
           "NUM_LM"]

LMAX = 3
NUM_LM = (LMAX + 1) ** 2
# the l of each of the 16 spherical-harmonic components
L_OF_LM = tuple(l for l in range(LMAX + 1) for _ in range(2 * l + 1))


@dataclass(frozen=True)
class MACEConfig:
    """The published small model's widths by default."""
    num_channels: int = 128
    num_interactions: int = 2
    max_ell: int = 3
    num_bessel: int = 8
    num_polynomial_cutoff: int = 5
    radial_mlp: tuple = (64, 64, 64)
    correlation: int = 3
    num_elements: int = 89
    r_max: float = 6.0
    avg_num_neighbors: float = 61.96

    def __post_init__(self):
        if self.max_ell != LMAX:
            raise ValueError(f"max_ell must be {LMAX}")
        if len(self.radial_mlp) != 3 or len(set(self.radial_mlp)) != 1:
            raise ValueError("the radial MLP has three hidden layers of one "
                             "width")
        if not 1 <= self.correlation <= 3:
            raise ValueError("correlation order 1 to 3")
        if self.num_interactions < 1:
            raise ValueError("at least one interaction")

    @property
    def descriptor_dim(self) -> int:
        """Features an atom: every interaction's channels."""
        return self.num_channels * self.num_interactions


# ----------------------------------------------------------------- couplings

def real_sh(vec: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 16]: real spherical harmonics of the direction of
    ``vec`` for l = 0..3, component normalisation (sum_m Y_lm^2 = 2l + 1),
    in e3nn's order: the standard real harmonics Y_l,-l..l at (z, x, y)."""
    r = vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    X, Y, Z = r[..., 2], r[..., 0], r[..., 1]
    s3, s5, s7 = math.sqrt(3.0), math.sqrt(5.0), math.sqrt(7.0)
    one = torch.ones_like(X)
    return torch.stack([
        one,
        s3 * Y, s3 * Z, s3 * X,
        s5 * s3 * X * Y, s5 * s3 * Y * Z, s5 * 0.5 * (3 * Z * Z - 1),
        s5 * s3 * X * Z, s5 * s3 * 0.5 * (X * X - Y * Y),
        math.sqrt(70.0) / 4 * Y * (3 * X * X - Y * Y),
        math.sqrt(105.0) * X * Y * Z,
        math.sqrt(42.0) / 4 * Y * (5 * Z * Z - 1),
        s7 / 2 * Z * (5 * Z * Z - 3),
        math.sqrt(42.0) / 4 * X * (5 * Z * Z - 1),
        math.sqrt(105.0) / 2 * Z * (X * X - Y * Y),
        math.sqrt(70.0) / 4 * X * (X * X - 3 * Y * Y)], dim=-1)


def _to_real(l: int) -> np.ndarray:
    """Q[a, m]: real harmonic a = sum_m Q[a, m] Y_l^m (complex, with the
    Condon-Shortley phase, as sympy's)."""
    q = np.zeros((2 * l + 1, 2 * l + 1), complex)
    s = 1 / math.sqrt(2)
    for m in range(-l, l + 1):
        if m > 0:
            q[m + l, -m + l], q[m + l, m + l] = s, (-1) ** m * s
        elif m == 0:
            q[l, l] = 1.0
        else:
            q[m + l, m + l], q[m + l, -m + l] = 1j * s, -1j * (-1) ** m * s
    return q


@lru_cache(maxsize=None)
def complex_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """sympy's <l1 m1 l2 m2 | l3 m3>, indexed [m1 + l1, m2 + l2, m3 + l3]."""
    from sympy.physics.wigner import clebsch_gordan
    c = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                c[m1 + l1, m2 + l2, m3 + l3] = float(
                    clebsch_gordan(l1, l2, l3, m1, m2, m3))
    return c


@lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """The coupling l1 x l2 -> l3 in the real basis of :func:`real_sh`:
    C[a, b, c] = sum Q3[c, m3] <l1 m1 l2 m2|l3 m3> conj(Q1[a, m1])
    conj(Q2[b, m2]), real where l1 + l2 + l3 is even (the only couplings
    the model takes: parity)."""
    if (l1 + l2 + l3) % 2:
        raise ValueError("odd l1 + l2 + l3 couples to a pseudo-scalar")
    c = np.einsum("zm,xym,ax,by->abz", _to_real(l3), complex_cg(l1, l2, l3),
                  _to_real(l1).conj(), _to_real(l2).conj())
    if np.abs(c.imag).max() > 1e-12:
        raise ArithmeticError(f"real coupling ({l1},{l2},{l3}) is complex")
    return np.ascontiguousarray(c.real)


def _block(l: int) -> slice:
    return slice(l * l, (l + 1) * (l + 1))


def paths(nu: int) -> list[tuple]:
    """The coupling paths of ``nu`` factors to one scalar, in the order of
    the weights' second axis: nu = 1 (0,); nu = 2 (l, l); nu = 3 every
    (l1, l2, l3) with l3 in |l1 - l2|..l1 + l2 and l1 + l2 + l3 even,
    sorted by the intermediate l (= l3), then l1, l2."""
    ls = range(LMAX + 1)
    if nu == 1:
        return [(0,)]
    if nu == 2:
        return [(l, l) for l in ls]
    return sorted(((a, b, c) for a in ls for b in ls for c in ls
                   if abs(a - b) <= c <= a + b and (a + b + c) % 2 == 0),
                  key=lambda p: (p[2], p[0], p[1]))


@lru_cache(maxsize=None)
def u_tables(correlation: int = 3) -> tuple:
    """U^nu for nu = 1..correlation, dense float64: [16, K1], [16, 16, K2],
    [16, 16, 16, K3], one column a path of :func:`paths`."""
    out = []
    for nu in range(1, correlation + 1):
        ps = paths(nu)
        u = np.zeros((NUM_LM,) * nu + (len(ps),))
        for k, p in enumerate(ps):
            if nu == 1:
                u[0, k] = 1.0
            elif nu == 2:
                l = p[0]
                u[_block(l), _block(l), k] = real_cg(l, l, 0)[:, :, 0]
            else:
                l1, l2, l3 = p
                u[_block(l1), _block(l2), _block(l3), k] = np.einsum(
                    "abm,mc->abc", real_cg(l1, l2, l3),
                    real_cg(l3, l3, 0)[:, :, 0])
        out.append(u)
    return tuple(out)


@lru_cache(maxsize=None)
def product_basis(correlation: int = 3) -> dict:
    """The symmetric contraction as the kernels compute it: a list of
    polynomials of A (one for nu = 1, one an l for nu = 2, one a multiset
    {l1, l2, l3} for nu = 3), each a sum of monomials coef * A[a] * A[b] *
    A[c] over sorted a <= b <= c (index 16 stands for 1), and for every
    path of every nu the polynomial q its contraction with A x ... x A
    equals times the scale s (only the symmetric part of U^nu meets the
    symmetric product of A's).  Returns {"mono": int [M, 3], "coef": [M],
    "ptr": [Q + 1], "path_poly": [[(q, s) a path] a nu]}."""
    mono, coef, ptr, path_poly = [], [], [0], []
    for nu, u in enumerate(u_tables(correlation), start=1):
        canon: dict = {}            # multiset -> (q, symmetric tensor)
        maps = []
        for k, p in enumerate(paths(nu)):
            t = u[..., k]
            sym = sum(np.transpose(t, perm) for perm in
                      permutations(range(nu))) / math.factorial(nu)
            key = tuple(sorted(p))
            if key not in canon and np.abs(sym).max() > 1e-12:
                canon[key] = (len(ptr) - 1, sym)
                for idx in zip(*np.nonzero(np.abs(sym) > 1e-12)):
                    if list(idx) != sorted(idx):
                        continue
                    n_perm = len(set(permutations(idx)))
                    mono.append(list(idx) + [NUM_LM] * (3 - nu))
                    coef.append(sym[idx] * n_perm)
                ptr.append(len(mono))
            if key not in canon:
                maps.append((-1, 0.0))
                continue
            q, ref = canon[key]
            s = float((sym * ref).sum() / (ref * ref).sum())
            if np.abs(sym - s * ref).max() > 1e-10:
                raise ArithmeticError(f"path {p} is not a multiple of its "
                                      "multiset's invariant")
            maps.append((q, s))
        path_poly.append(maps)
    return {"mono": np.asarray(mono, np.int64), "coef": np.asarray(coef),
            "ptr": np.asarray(ptr, np.int64), "path_poly": path_poly}


# --------------------------------------------------------------------- model

class _Interaction(nn.Module):
    def __init__(self, cfg: MACEConfig, first: bool):
        super().__init__()
        C, E, RH = cfg.num_channels, cfg.num_elements, cfg.radial_mlp[0]
        z = lambda *s: nn.Parameter(torch.zeros(*s))
        self.linear_up = z(C, C)
        self.radial = nn.ParameterList(
            [z(cfg.num_bessel, RH), z(RH, RH), z(RH, RH),
             z(RH, (LMAX + 1) * C)])
        self.linear = z(LMAX + 1, C, C)
        # t = 0: the message's element-dependent map a l; later: the
        # residual's element-dependent map of h
        self.skip_tp = z(E, LMAX + 1, C, C) if first else z(E, C, C)


class _Product(nn.Module):
    def __init__(self, cfg: MACEConfig):
        super().__init__()
        C, E = cfg.num_channels, cfg.num_elements
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.zeros(E, len(paths(nu)), C))
             for nu in range(1, cfg.correlation + 1)])
        self.linear = nn.Parameter(torch.zeros(C, C))


class MACE(nn.Module):
    """The descriptor part of a MACE model (no readouts): parameters by the
    state dict's names (``embedding``, ``interactions.<t>.linear_up``,
    ``.radial.<0..3>``, ``.linear``, ``.skip_tp``,
    ``products.<t>.weights.<nu - 1>``, ``products.<t>.linear``), zeros
    until a state dict is loaded."""

    def __init__(self, cfg: MACEConfig = MACEConfig()):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Parameter(
            torch.zeros(cfg.num_elements, cfg.num_channels))
        self.interactions = nn.ModuleList(
            [_Interaction(cfg, t == 0) for t in range(cfg.num_interactions)])
        self.products = nn.ModuleList(
            [_Product(cfg) for _ in range(cfg.num_interactions)])
        self._prep = None

    def load_state_dict(self, state, strict: bool = True, assign=False):
        self._prep = None
        return super().load_state_dict(state, strict, assign)

    def _apply(self, fn, *args, **kwargs):
        self._prep = None
        return super()._apply(fn, *args, **kwargs)

    @torch.no_grad()
    def prepared(self) -> dict:
        """The tensors the kernels read, made once per weights and device:
        layer 0's up-projected embedding; each layer's radial weights, its
        message maps over avg_num_neighbors (layer 0's folded with its
        element-dependent skip, [E, 4, C, C]; later [4, C, C]), the
        product's per-path weights folded onto :func:`product_basis`'s
        polynomials ([E, Q, C]) and its output map; the next layer's
        up-projection and residual map; the basis tables."""
        if self._prep is not None:
            return self._prep
        cfg = self.cfg
        dev = self.embedding.device
        f32 = lambda t: t.detach().to(torch.float32).contiguous()
        basis = product_basis(cfg.correlation)
        Q = len(basis["ptr"]) - 1
        layers = []
        for t, (it, pr) in enumerate(zip(self.interactions, self.products)):
            # folded in float64, so that no setting of TF32 reaches them
            lin = it.linear.double() / cfg.avg_num_neighbors
            if t == 0:
                m = torch.einsum("lcd,eldf->elcf", lin, it.skip_tp.double())
            else:
                m = lin
            weff = torch.zeros(cfg.num_elements, Q, cfg.num_channels,
                               device=dev, dtype=torch.float64)
            for w, maps in zip(pr.weights, basis["path_poly"]):
                for k, (q, s) in enumerate(maps):
                    if q >= 0:
                        weff[:, q] += s * w[:, k].double()
            nxt = (self.interactions[t + 1]
                   if t + 1 < cfg.num_interactions else None)
            layers.append({
                "radial": [f32(w) for w in it.radial], "m": f32(m),
                "m_shared": t > 0, "weff": f32(weff), "wout": f32(pr.linear),
                "wup_next": None if nxt is None else f32(nxt.linear_up),
                "wskip_next": None if nxt is None else f32(nxt.skip_tp)})
        mono = basis["mono"]
        self._prep = {
            "hup0": f32(self.embedding.double()
                        @ self.interactions[0].linear_up.double()),
            "layers": layers,
            "mono": torch.as_tensor(mono[:, 0] | mono[:, 1] << 8
                                    | mono[:, 2] << 16, dtype=torch.int32,
                                    device=dev),
            "coef": torch.as_tensor(basis["coef"], dtype=torch.float32,
                                    device=dev),
            "ptr": torch.as_tensor(basis["ptr"], dtype=torch.int32,
                                   device=dev)}
        return self._prep

    @torch.no_grad()
    def descriptors(self, pos: torch.Tensor, z: torch.Tensor,
                    struct_ptr: torch.Tensor, tiles: torch.Tensor,
                    n_edges: int) -> torch.Tensor:
        """[A, num_interactions * C] float32 descriptors of the structures
        laid end to end: ``pos`` [A, 3] float32 (Å), ``z`` [A] element
        indices, ``struct_ptr`` [S + 1] the first atom of each structure
        (int32), ``tiles`` [T, ops.mace.TILE] atoms of one element a row,
        -1 padding (:func:`ops.mace.element_tiles`; the card's product
        kernel reads them), ``n_edges`` the structures' ordered pairs
        within r_max.  Counts ``mace_structures``, ``mace_atoms`` and
        ``mace_edges``."""
        from ..ops import mace as ops
        cfg = self.cfg
        with span("mace.forward"):
            prep = self.prepared()
            A = pos.shape[0]
            hup = prep["hup0"][z.long()]
            out = torch.empty(A, cfg.descriptor_dim, device=pos.device)
            sc = None
            for t, lay in enumerate(prep["layers"]):
                msg = ops.mace_interaction(
                    pos, struct_ptr, hup, lay["radial"], cfg.r_max,
                    cfg.num_polynomial_cutoff)
                hup, sc = ops.mace_product(
                    msg, z, tiles, lay["m"], lay["m_shared"], lay["weff"],
                    prep["mono"], prep["coef"], prep["ptr"], lay["wout"], sc,
                    out, t * cfg.num_channels, lay["wup_next"],
                    lay["wskip_next"])
            count_mace(len(struct_ptr) - 1, A, n_edges)
        return out


def save_mace(model: MACE, path: str | Path) -> None:
    """The model's configuration and state dict in one ``torch.save``
    file: what ``--mace_model`` loads."""
    cfg = asdict(model.cfg)
    cfg["radial_mlp"] = list(cfg["radial_mlp"])
    torch.save({"config": cfg, "state_dict": {
        k: v.detach().cpu() for k, v in model.state_dict().items()}},
        str(path))


def load_mace(path: str | Path, device="cpu") -> MACE:
    """A :func:`save_mace` file as a model on ``device``."""
    blob = torch.load(str(path), map_location="cpu", weights_only=True)
    cfg = dict(blob["config"])
    cfg["radial_mlp"] = tuple(cfg["radial_mlp"])
    model = MACE(MACEConfig(**cfg))
    model.load_state_dict(blob["state_dict"])
    return model.to(device).eval()
