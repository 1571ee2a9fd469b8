"""The whole-model forward per pack: the CUDA kernel's wrapper and its plain
PyTorch version.

The counterpart of the forward of ``cgr_mpnn_3d_tpu/ops/pallas_model.py::
fused_model`` (``_fwd_call`` -> ``_replay_forward``).  Per pack it computes
edge_init, the L conv layers, the readout, pooling (add | mean) and the FFN
head, and returns ``preds [p*tb]`` in f32 (padded graph slots hold garbage:
mask them with ``graph_mask``).

Unlike the TPU kernel, which builds one-hot matrices from transposed index
rows, both versions here gather straight through the packer's ELL arrays.
An index outside the pack of the row that holds it -- the sentinel included
-- counts as absent, which is what a never-matching one-hot column does on
the TPU.  For mean, the scale is 1 over the number of entries that count,
and the ``rev`` term stays unscaled.

:func:`fused_model_forward` launches ``csrc/fused_model_fwd.cu`` for CUDA
tensors (or raises) and takes :func:`fused_model_forward_ref` only for CPU
tensors.  Eval mode only: the hash dropout arrives with the training
kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .kernel_math import KERNEL_ACTS, k_act, mean_colscale
from .segment import ext_zero_row

__all__ = ["fused_model_forward", "fused_model_forward_ref", "launches"]

# launches of the CUDA kernel by fused_model_forward (nothing else adds here)
launches = 0

_NAMES = ("x", "e", "senders", "edge_nbr", "rev", "node_inc", "graph_nodes",
          "wx", "we", "be", "wc", "bc", "skips", "ws", "wxn", "ben", "wffn",
          "bffn")
_INDEX_NAMES = {"senders", "edge_nbr", "rev", "node_inc", "graph_nodes"}


def _shapes(x, e, edge_nbr, graph_nodes, wc, p: int) -> dict:
    """Expected shape of every argument, from the batch and the weights."""
    if p < 1 or x.shape[0] % p or e.shape[0] % p or graph_nodes.shape[0] % p:
        raise ValueError(f"rows of x {tuple(x.shape)}, e {tuple(e.shape)} "
                         f"and graph_nodes {tuple(graph_nodes.shape)} must "
                         f"split into p={p} packs")
    NT, F = x.shape
    ET, Fe = e.shape
    BT, DN = graph_nodes.shape
    L, H = wc.shape[0], wc.shape[2]
    D = edge_nbr.shape[1]
    return dict(x=(NT, F), e=(ET, Fe), senders=(ET,), edge_nbr=(ET, D),
                rev=(ET,), node_inc=(NT, D), graph_nodes=(BT, DN),
                wx=(F, H), we=(Fe, H), be=(H,), wc=(L, H, H), bc=(L, H),
                skips=(L,), ws=(H, H), wxn=(F, H), ben=(H,), wffn=(H, 1),
                bffn=(1,))


def _check(args: dict, p: int, act: str, aggr: str, pooling: str,
           train: bool) -> None:
    if train:
        raise NotImplementedError(
            "fused_model_forward is eval only: the in-kernel hash dropout "
            "arrives with the training kernels")
    if act not in KERNEL_ACTS:
        raise ValueError(f"unsupported kernel activation {act!r}")
    for name, mode in (("aggr", aggr), ("pooling", pooling)):
        if mode not in ("add", "mean"):
            raise ValueError(f"unsupported {name} {mode!r}")
    want = _shapes(args["x"], args["e"], args["edge_nbr"],
                   args["graph_nodes"], args["wc"], p)
    for name in _NAMES:
        if tuple(args[name].shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(args[name].shape)}, "
                             f"expected {want[name]}")


def _in_pack(idx: torch.Tensor, p: int, n_src: int):
    """(ids, valid): ids outside the pack of their row become the sentinel
    ``n_src`` (the zero row of ``ext_zero_row``)."""
    rows = idx.shape[0]
    pack = torch.arange(rows, device=idx.device) // (rows // p)
    lo = pack * (n_src // p)
    if idx.dim() == 2:
        lo = lo[:, None]
    valid = (idx >= lo) & (idx < lo + n_src // p)
    return torch.where(valid, idx, n_src).long(), valid


def fused_model_forward_ref(x, e, senders, edge_nbr, rev, node_inc,
                            graph_nodes, wx, we, be, wc, bc, skips, ws, wxn,
                            ben, wffn, bffn, *, p: int, act: str = "relu",
                            aggr: str = "add", pooling: str = "add",
                            train: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device): preds [p*tb]."""
    args = dict(zip(_NAMES, (x, e, senders, edge_nbr, rev, node_inc,
                             graph_nodes, wx, we, be, wc, bc, skips, ws, wxn,
                             ben, wffn, bffn)))
    _check(args, p, act, aggr, pooling, train)
    ET, NT = e.shape[0], x.shape[0]

    def gather_sum(src, idx, mean):
        ids, valid = _in_pack(idx, p, src.shape[0])
        out = ext_zero_row(src)[ids].sum(dim=1)
        return out * mean_colscale(valid)[:, None] if mean else out

    s_ids, _ = _in_pack(senders, p, NT)
    h0 = k_act(act, ext_zero_row(x)[s_ids] @ wx + e @ we + be)
    rev_ids, _ = _in_pack(rev, p, ET)
    h = h0
    for l in range(wc.shape[0]):
        t = (gather_sum(h, edge_nbr, aggr == "mean")
             - ext_zero_row(h)[rev_ids])
        h = k_act(act, t @ wc[l] + bc[l] + skips[l] * h0)
    s = gather_sum(h, node_inc, aggr == "mean")
    hn = k_act(act, s @ ws + x @ wxn + ben)
    pooled = gather_sum(hn, graph_nodes, pooling == "mean")
    return (pooled @ wffn)[:, 0] + bffn


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused_model_fwd")
    if not getattr(lib, "_cgr_typed", False):
        lib.cgr_fused_model_fwd.argtypes = (
            [ctypes.c_void_p] * 25 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
        lib.cgr_fused_model_fwd.restype = ctypes.c_int
        lib.cgr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cgr_cuda_error_string.restype = ctypes.c_char_p
        lib._cgr_typed = True
    return lib


def fused_model_forward(x, e, senders, edge_nbr, rev, node_inc, graph_nodes,
                        wx, we, be, wc, bc, skips, ws, wxn, ben, wffn, bffn,
                        *, p: int, act: str = "relu", aggr: str = "add",
                        pooling: str = "add",
                        train: bool = False) -> torch.Tensor:
    """Whole-model forward -> preds [p*tb] f32.

    CUDA tensors launch ``csrc/fused_model_fwd.cu`` (one block per pack) or
    raise; CPU tensors take :func:`fused_model_forward_ref`.  Features and
    weights are float32, indices int32, all contiguous; ``wffn`` is [H, 1],
    ``skips`` [L], ``bffn`` [1].  No backward: call it without gradients."""
    global launches
    tensors = (x, e, senders, edge_nbr, rev, node_inc, graph_nodes, wx, we,
               be, wc, bc, skips, ws, wxn, ben, wffn, bffn)
    if x.device.type == "cpu":
        return fused_model_forward_ref(*tensors, p=p, act=act, aggr=aggr,
                                       pooling=pooling, train=train)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    args = dict(zip(_NAMES, tensors))
    _check(args, p, act, aggr, pooling, train)
    for name, tsr in args.items():
        want = torch.int32 if name in _INDEX_NAMES else torch.float32
        if tsr.device != x.device:
            raise ValueError(f"{name} is on {tsr.device}, x on {x.device}")
        if tsr.dtype != want:
            raise TypeError(f"{name} is {tsr.dtype}, the kernel takes {want}")
        if not tsr.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if torch.is_grad_enabled() and tsr.requires_grad:
            raise RuntimeError("the forward kernel has no backward yet: "
                               "call it under torch.no_grad()")

    NT, F = x.shape
    ET, Fe = e.shape
    BT, DN = graph_nodes.shape
    L, H = wc.shape[0], wc.shape[2]
    D = edge_nbr.shape[1]
    scratch = dict(h0=(ET, H), h=(ET, H), t=(ET, H), s=(NT, H), hn=(NT, H),
                   pooled=(BT, H))
    bufs = [torch.empty(shape, device=x.device, dtype=torch.float32)
            for shape in scratch.values()]
    out = torch.empty(BT, device=x.device, dtype=torch.float32)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cgr_fused_model_fwd(
            *(t.data_ptr() for t in tensors), *(b.data_ptr() for b in bufs),
            out.data_ptr(), p, ET // p, NT // p, BT // p, F, Fe, H, L, D, DN,
            KERNEL_ACTS.index(act), int(aggr == "mean"),
            int(pooling == "mean"), stream)
    launches += 1
    if err != 0:
        raise RuntimeError("fused_model_fwd launch failed: "
                           + lib.cgr_cuda_error_string(err).decode())
    return out
