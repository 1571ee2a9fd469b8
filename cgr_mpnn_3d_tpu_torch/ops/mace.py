"""The MACE kernels a layer: their wrappers and plain PyTorch versions.

No TPU kernel of the JAX package computes MACE (its descriptors came from
the ``mace-torch`` package on the host), so these were written for the
card; ``models/mace.py`` gives the equations.

* :func:`mace_interaction` (``csrc/mace.cu::interaction_kernel``, one block
  a structure): the neighbour list within r_max, the spherical harmonics,
  the Bessel functions under the envelope, the radial MLP, the "uvu" tensor
  product with the senders' up-projected features and the sum over each
  receiver's edges, in one launch: msg [A, 16, C], the [edges, 4C] radial
  weights never written to memory.
* :func:`mace_product` (``product_kernel``, one block a tile of
  :data:`TILE` atoms of one element): the message maps a l (with layer 0's
  element-dependent skip folded in), the symmetric contraction to 0e as
  ``models.mace.product_basis``'s polynomials under the element's folded
  weights, the output map and the residual, the result written into its
  columns of the descriptor array, and for the next layer its
  up-projection and residual map.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
its plain version only for CPU tensors.  Launches count in
``interaction_launches`` and ``product_launches``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..utils.tracing import span
from ._launch import I32, PTR, check_cuda, library, ptr, raise_on, stream

__all__ = ["mace_interaction", "mace_product", "mace_interaction_ref",
           "mace_product_ref", "edge_list", "radial_basis", "element_tiles",
           "TILE", "interaction_launches", "product_launches"]

interaction_launches = 0
product_launches = 0

# atoms a product block: one element, so its weights load once for them
TILE = 4


def _l_of_lm(device):
    from ..models.mace import L_OF_LM
    return torch.as_tensor(L_OF_LM, device=device)


def element_tiles(z: np.ndarray, tile: int = TILE) -> torch.Tensor:
    """[T, tile] int32 host tensor: the atoms grouped by element, ``tile``
    a row in ascending order, -1 where an element's last row is short."""
    z = np.asarray(z, np.int64)
    order = np.argsort(z, kind="stable")
    zs = z[order]
    counts = np.bincount(zs) if len(zs) else np.zeros(0, np.int64)
    starts = np.cumsum(counts) - counts
    rows = -(-counts // tile)
    row0 = np.cumsum(rows) - rows
    rank = np.arange(len(zs)) - starts[zs]
    out = np.full((int(rows.sum()), tile), -1, np.int32)
    out[row0[zs] + rank // tile, rank % tile] = order
    return torch.from_numpy(out)


# ------------------------------------------------------------ plain versions

def edge_list(pos: torch.Tensor, struct_ptr: torch.Tensor, r_max: float):
    """(receivers, senders) int64 of every ordered pair i != j of one
    structure with |pos_i - pos_j|^2 < r_max^2, receiver-major, senders
    ascending: the kernel's order."""
    sp = struct_ptr.to(torch.int64)
    counts = sp[1:] - sp[:-1]
    A = pos.shape[0]
    sid = torch.repeat_interleave(torch.arange(len(counts),
                                                device=pos.device), counts)
    n_i = counts[sid]
    recv = torch.repeat_interleave(torch.arange(A, device=pos.device), n_i)
    first = torch.cumsum(n_i, 0) - n_i
    local = torch.arange(len(recv), device=pos.device) - first[recv]
    send = sp[:-1][sid[recv]] + local
    d = pos[recv] - pos[send]
    keep = (recv != send) & ((d * d).sum(-1) < r_max * r_max)
    return recv[keep], send[keep]


def radial_basis(r: torch.Tensor, n: int, r_max: float, p: int):
    """[E, n]: sqrt(2 / r_max) sin(k pi r / r_max) / r, k = 1..n, times the
    polynomial envelope of order ``p`` (0 from r_max on)."""
    k = torch.arange(1, n + 1, device=r.device, dtype=r.dtype)
    bessel = (math.sqrt(2.0 / r_max)
              * torch.sin(k * (math.pi / r_max) * r[:, None]) / r[:, None])
    x = r / r_max
    env = (1.0 - (p + 1) * (p + 2) / 2 * x ** p + p * (p + 2) * x ** (p + 1)
           - p * (p + 1) / 2 * x ** (p + 2))
    return bessel * torch.where(x < 1.0, env, 0.0)[:, None]


def mace_interaction_ref(pos, struct_ptr, hup, radial, r_max: float,
                         p: int):
    """Plain version of the interaction kernel: msg [A, 16, C]."""
    from ..models.mace import real_sh
    recv, send = edge_list(pos, struct_ptr, r_max)
    A, C = hup.shape
    vec = pos[recv] - pos[send]
    r = torch.linalg.vector_norm(vec, dim=-1)
    w1, w2, w3, w4 = radial
    h = radial_basis(r, w1.shape[0], r_max, p)
    for w in (w1, w2, w3):
        h = torch.nn.functional.silu(h @ w)
    R = (h @ w4).view(-1, 4, C)[:, _l_of_lm(pos.device), :]
    m = R * hup[send][:, None, :] * real_sh(vec)[:, :, None]
    msg = torch.zeros(A, 16, C, dtype=hup.dtype, device=hup.device)
    return msg.index_add_(0, recv, m)


def mace_product_ref(msg, z, m, m_shared: bool, weff, mono, coef, ptr_,
                     wout, sc, out, col: int, wup_next=None,
                     wskip_next=None):
    """Plain version of the product kernel; writes ``out[:, col:col + C]``
    and returns (the next layer's up-projected h, its residual) or
    (None, None)."""
    from ..models.mace import LMAX
    z = z.long()
    A, _, C = msg.shape
    a = torch.empty_like(msg)
    per = [None] if m_shared else torch.unique(z).tolist()
    for e in per:
        idx = slice(None) if e is None else (z == e).nonzero()[:, 0]
        me = m if e is None else m[e]
        for l in range(LMAX + 1):
            b = slice(l * l, (l + 1) ** 2)
            a[idx, b] = msg[idx, b] @ me[l]
    ext = torch.cat([a, torch.ones(A, 1, C, dtype=a.dtype,
                                   device=a.device)], 1)
    mono = mono.long()
    ia, ib, ic = mono & 255, (mono >> 8) & 255, (mono >> 16) & 255
    phi = torch.stack([
        (coef[lo:hi, None, None] * ext[:, ia[lo:hi]].transpose(0, 1)
         * ext[:, ib[lo:hi]].transpose(0, 1)
         * ext[:, ic[lo:hi]].transpose(0, 1)).sum(0)
        for lo, hi in zip(ptr_[:-1].tolist(), ptr_[1:].tolist())], 1)
    h = (phi * weff[z]).sum(1) @ wout
    if sc is not None:
        h = h + sc
    out[:, col:col + C] = h
    if wup_next is None:
        return None, None
    sc_next = torch.empty_like(h)
    for e in torch.unique(z).tolist():
        idx = (z == e).nonzero()[:, 0]
        sc_next[idx] = h[idx] @ wskip_next[e]
    return h @ wup_next, sc_next


# ------------------------------------------------------------------ kernels

_SIGNATURES = {"mace": {
    "cgr_mace_interaction": ([PTR] * 8 + [I32] * 4 + [ctypes.c_float, I32,
                                                     PTR], I32),
    "cgr_mace_product": ([PTR] * 15 + [I32] * 5 + [ctypes.c_longlong, PTR],
                         I32)}}


def _lib():
    return library("mace", _SIGNATURES["mace"])


def mace_interaction(pos, struct_ptr, hup, radial, r_max: float, p: int):
    """msg [A, 16, C]: the interaction kernel for CUDA tensors, its plain
    version for CPU ones."""
    global interaction_launches
    if pos.device.type != "cuda":
        return mace_interaction_ref(pos, struct_ptr, hup, radial, r_max, p)
    with span("ops.mace_interaction"):
        w1, w2, w3, w4 = radial
        A, C = hup.shape
        NB, RH = w1.shape
        args = dict(pos=pos, struct_ptr=struct_ptr, hup=hup, w1=w1, w2=w2,
                    w3=w3, w4=w4)
        check_cuda(args, pos.device, {"struct_ptr"})
        if (C % 32 or C > 256 or RH > 128 or NB > 16
                or tuple(w2.shape) != (RH, RH) or tuple(w3.shape) != (RH, RH)
                or tuple(w4.shape) != (RH, 4 * C)
                or tuple(pos.shape) != (A, 3)):
            shapes = [tuple(w.shape) for w in radial]
            raise ValueError(f"mace_interaction: C={C} (a multiple of 32 up "
                             f"to 256), radial {shapes} (NB <= 16, RH <= "
                             f"128), pos {tuple(pos.shape)}")
        msg = torch.zeros(A, 16, C, device=pos.device)
        S = struct_ptr.shape[0] - 1
        lib = _lib()
        if S > 0:
            err = lib.cgr_mace_interaction(
                ptr(pos), ptr(struct_ptr), ptr(hup), ptr(w1), ptr(w2),
                ptr(w3), ptr(w4), ptr(msg), S, C, NB, RH, float(r_max),
                int(p), stream(pos.device))
            raise_on(lib, err, "mace interaction")
            interaction_launches += 1
    return msg


def mace_product(msg, z, tiles, m, m_shared: bool, weff, mono, coef, ptr_,
                 wout, sc, out, col: int, wup_next=None, wskip_next=None):
    """The product kernel for CUDA tensors, its plain version for CPU ones:
    writes ``out[:, col:col + C]``, returns (next h~, next residual) or
    (None, None)."""
    global product_launches
    if msg.device.type != "cuda":
        return mace_product_ref(msg, z, m, m_shared, weff, mono, coef, ptr_,
                                wout, sc, out, col, wup_next, wskip_next)
    with span("ops.mace_product"):
        A, _, C = msg.shape
        dev = msg.device
        args = dict(msg=msg, z=z, tiles=tiles, m=m, weff=weff, mono=mono,
                    coef=coef, ptr=ptr_, wout=wout, out=out)
        for name, t in (("sc", sc), ("wup_next", wup_next),
                        ("wskip_next", wskip_next)):
            if t is not None:
                args[name] = t
        check_cuda(args, dev, {"z", "tiles", "mono", "ptr"})
        E, Q = weff.shape[0], weff.shape[1]
        if (tiles.dim() != 2 or tiles.shape[1] != TILE
                or tuple(m.shape[-3:]) != (4, C, C)
                or (not m_shared and m.shape[0] != E)
                or tuple(wout.shape) != (C, C) or out.shape[0] != A
                or col + C > out.shape[1]
                or (wup_next is None) != (wskip_next is None)):
            raise ValueError("mace_product: inconsistent shapes")
        nxt = wup_next is not None
        hup = torch.empty(A, C, device=dev) if nxt else None
        sc_next = torch.empty(A, C, device=dev) if nxt else None
        lib = _lib()
        T = tiles.shape[0]
        if T > 0:
            err = lib.cgr_mace_product(
                ptr(msg), ptr(z), ptr(tiles), ptr(m), ptr(weff), ptr(mono),
                ptr(coef), ptr(ptr_), ptr(wout), ptr(sc), ptr(out),
                ptr(wup_next), ptr(wskip_next), ptr(hup), ptr(sc_next), T, C,
                Q, int(out.stride(0)), col, 0 if m_shared else 4 * C * C,
                stream(dev))
            raise_on(lib, err, "mace product")
            product_launches += 1
    return hup, sc_next
