"""The layered kernels' plain versions against the JAX package's kernels in
interpret mode on the CPU (f32 one-hot matrices, as tests/test_pallas.py and
tests/test_pallas_stack.py run them):

* ``onehot_spmm_ref`` against ``onehot_spmm_t`` (K7) for every (idx, sign)
  instance of the model; ``spmm``'s autograd equals the same gather over
  the transposed ELL array, which is what its backward kernel computes;
* ``gather_linear_forward_ref`` and its autograd against
  ``fused_gather_linear`` (K5) and ``jax.grad``, edge_init and readout, add
  and mean; the backward kernel's dxa (a gather of dpre·waᵀ through the
  transposed ELL, scaled by the forward row's 1/degree) emulated;
* ``conv_stack_forward_ref`` and its autograd against ``fused_conv_stack``
  (K4), in eval and train mode; the backward kernel's message adjoint
  (through edge_nbr_rev minus rev) emulated.

Inputs are made with numpy from a seed.  Tolerances: outputs rtol = atol =
1e-4; gradients max|delta| / max|JAX| <= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu.chem import RxnGraph
from cgr_mpnn_3d_tpu.data import pack_graphs, plan_spec
from cgr_mpnn_3d_tpu.ops.pallas_glin import (GatherLinearSpec,
                                             fused_gather_linear)
from cgr_mpnn_3d_tpu.ops.pallas_ops import build_idx_t, onehot_spmm_t
from cgr_mpnn_3d_tpu.ops.pallas_stack import ConvStackSpec, fused_conv_stack
from cgr_mpnn_3d_tpu_torch.data import to_device
from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
from cgr_mpnn_3d_tpu_torch.ops._launch import split_k
from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
from cgr_mpnn_3d_tpu_torch.ops.kernel_math import k_act, mean_colscale
from cgr_mpnn_3d_tpu_torch.ops.segment import in_pack, pack_gather_sum

SMILES = ["CCO>>CC=O", "CC(=O)N>>CC(=O)N", "C=CC=C>>C=CC=C",
          "CCO>C>CCO", "O>C>CO", "N>C>CN", "CC>>CC",
          "[N:1]([H:2])([H:3])[H:4]>>[N:1]([H:2])[H:3].[H:4]"]
LABELS = [float(i) for i in range(len(SMILES))]
H = 16
DEPTH = 3


@pytest.fixture(scope="module")
def packed():
    graphs = [RxnGraph(s).arrays for s in SMILES]
    spec = plan_spec(graphs, te=64, tn=32, tb=8).with_packs(2)
    batch = pack_graphs(graphs, LABELS, spec)
    return spec, batch, to_device(batch, "cpu")


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close_grads(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float32).reshape(tuple(g.shape))
        err = np.abs(g.detach().numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (name, err)


# -- K7 ---------------------------------------------------------------------

# (name, idx field or (field, column), sign field, source rows)
SPMM_CASES = [
    ("messages fwd", "edge_nbr", "rev", "edges"),
    ("messages bwd", "edge_nbr_rev", "rev", "edges"),
    ("incoming fwd", "node_inc", None, "edges"),
    ("incoming bwd", "receivers", None, "nodes"),
    ("gather fwd", "senders", None, "nodes"),
    ("gather bwd", "node_out", None, "edges"),
    ("pool fwd", "graph_nodes", None, "nodes"),
    ("pool bwd", "graph_of_node", None, "graphs"),
]


@pytest.mark.parametrize("name,idx_f,sign_f,src_rows", SPMM_CASES,
                         ids=[c[0] for c in SPMM_CASES])
def test_onehot_spmm_ref_matches_interpret_k7(packed, name, idx_f, sign_f,
                                              src_rows):
    spec, b, tb = packed
    rows = dict(edges=spec.total_edges, nodes=spec.total_nodes,
                graphs=spec.total_graphs)[src_rows]
    src = _rand(np.random.default_rng(0), rows, H)
    idx = np.asarray(getattr(b, idx_f))
    idx = idx[:, None] if idx.ndim == 1 else idx
    sign = None if sign_f is None else np.asarray(getattr(b, sign_f))
    idx_t = build_idx_t(jnp.asarray(idx),
                        None if sign is None else jnp.asarray(sign), spec.p)
    want = onehot_spmm_t(idx_t, jnp.asarray(src), spec.p, idx.shape[1],
                         sign is not None, mat_dtype=jnp.float32,
                         interpret=True)
    t_sign = None if sign is None else _t(sign)
    got = sp.onehot_spmm_ref(_t(src), _t(idx), t_sign, p=spec.p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    before = (sp.launches, sp.bwd_launches)
    assert torch.equal(sp.onehot_spmm(_t(src), _t(idx), t_sign, p=spec.p),
                       got)
    assert (sp.launches, sp.bwd_launches) == before


# (forward ELL, sign, backward ELL, source rows, mean): the backward kernel
# of each gather is the forward kernel over the backward ELL, each entry
# scaled by its forward row's 1/degree when the forward takes the mean
ADJOINTS = [("edge_nbr", "rev", "edge_nbr_rev", "edges", False),
            ("edge_nbr", "rev", "edge_nbr_rev", "edges", True),
            ("node_inc", None, "receivers", "edges", True),
            ("senders", None, "node_out", "nodes", False),
            ("graph_nodes", None, "graph_of_node", "nodes", False)]


@pytest.mark.parametrize("fwd,sign_f,bwd,src_rows,mean", ADJOINTS)
def test_backward_gather_is_the_adjoint(packed, fwd, sign_f, bwd, src_rows,
                                        mean):
    spec, b, tb = packed
    rows = spec.total_edges if src_rows == "edges" else spec.total_nodes
    rng = np.random.default_rng(1)
    src = _t(_rand(rng, rows, H)).requires_grad_()

    def ell(f):
        idx = getattr(tb, f)
        return idx[:, None] if idx.dim() == 1 else idx

    idx, idx_bwd = ell(fwd), ell(bwd)
    sign = None if sign_f is None else getattr(tb, sign_f)
    out = pack_gather_sum(src, idx, spec.p, mean)
    if sign is not None:
        out = out - sp.onehot_spmm_ref(src, sign[:, None], p=spec.p)
    cot = _t(_rand(rng, *out.shape))
    (want,) = torch.autograd.grad((out * cot).sum(), src)
    scale = (mean_colscale(in_pack(idx, spec.p, rows)[1])[:, None] if mean
             else 1.0)
    got = sp.onehot_spmm_ref(cot * scale, idx_bwd, p=spec.p)
    if sign is not None:            # the rev term stays unscaled
        got = got - sp.onehot_spmm_ref(cot, sign[:, None], p=spec.p)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if not mean:
        # spmm's autograd on the CPU is the same transposed gather
        (auto,) = torch.autograd.grad(
            (sp.spmm(src, idx, idx_bwd, sign, sign, p=spec.p) * cot).sum(),
            src)
        torch.testing.assert_close(auto, want, rtol=1e-5, atol=1e-5)


# -- K5 ---------------------------------------------------------------------

GLIN_CASES = [("edge_init", "relu", False), ("edge_init", "silu", False),
              ("readout", "relu", False), ("readout", "gelu", True)]


def _glin_inputs(spec, b, tb, stage, seed):
    rng = np.random.default_rng(seed)
    ET, NT = spec.total_edges, spec.total_nodes
    F, Fe = 78, 14
    if stage == "edge_init":
        xa, xb = _rand(rng, NT, F), _rand(rng, ET, Fe)
        idx, adj = np.asarray(b.senders)[:, None], tb.node_out
    else:
        xa, xb = _rand(rng, ET, H), _rand(rng, NT, F)
        idx, adj = np.asarray(b.node_inc), tb.receivers[:, None]
    wa = _rand(rng, xa.shape[1], H, scale=0.2)
    wb = _rand(rng, xb.shape[1], H, scale=0.2)
    bias = _rand(rng, H, scale=0.1)
    cot = _rand(rng, xb.shape[0], H)
    return xa, xb, idx, adj, wa, wb, bias, cot


@pytest.mark.parametrize("stage,act,mean", GLIN_CASES)
def test_gather_linear_ref_matches_interpret_k5(packed, stage, act, mean):
    spec, b, tb = packed
    xa, xb, idx, adj, wa, wb, bias, cot = _glin_inputs(spec, b, tb, stage, 2)
    gspec = GatherLinearSpec(p=spec.p, d_nbr=idx.shape[1],
                             mat_dtype=jnp.float32, out_dtype=jnp.float32,
                             interpret=True, act=act,
                             aggr="mean" if mean else "add")
    idx_t = build_idx_t(jnp.asarray(idx), None, spec.p)
    want = fused_gather_linear(gspec, xa, xb, idx_t, wa, wb, bias)
    g_j = jax.grad(lambda *a: jnp.sum(fused_gather_linear(
        gspec, a[0], a[1], idx_t, *a[2:]) * cot), argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(wa), jnp.asarray(wb),
        jnp.asarray(bias))
    kw = dict(p=spec.p, act=act, mean=mean)
    args = [_t(xa), _t(xb), _t(idx)]
    ws = [_t(wa), _t(wb), _t(bias)]
    out = gl.gather_linear_forward_ref(*args, *ws, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    grads = gl.gather_linear_backward_ref(*args, adj, *ws, out, _t(cot), **kw)
    _close_grads(grads, g_j, ["dxa", "dxb", "dwa", "dwb", "db"])
    # the wrappers take the plain versions for CPU tensors
    assert torch.equal(gl.gather_linear_forward(*args, *ws, **kw), out)
    assert all(torch.equal(x, y) for x, y in zip(gl.gather_linear_backward(
        *args, adj, *ws, out, _t(cot), **kw), grads))
    # the backward kernel's dxa: dt = dpre·waᵀ gathered through adj, each
    # entry scaled by its forward row's scale
    pre = pack_gather_sum(args[0], args[2], spec.p, mean) @ ws[0] \
        + args[1] @ ws[1] + ws[2]
    with torch.enable_grad():
        pre_v = pre.clone().requires_grad_()
        (dpre,) = torch.autograd.grad(k_act(act, pre_v), pre_v, _t(cot))
    rs = (mean_colscale(in_pack(args[2], spec.p, xa.shape[0])[1])[:, None]
          if mean else 1.0)
    dxa = sp.onehot_spmm_ref((dpre @ ws[0].T) * rs, adj, p=spec.p)
    _close_grads([dxa], [g_j[0]], ["dxa via adj"])


# -- K4 ---------------------------------------------------------------------

STACK_CASES = [("relu", False, False), ("gelu", True, False),
               ("relu", False, True), ("silu", True, True)]


@pytest.mark.parametrize("act,mean,train", STACK_CASES)
def test_conv_stack_ref_matches_interpret_k4(packed, act, mean, train):
    spec, b, tb = packed
    rng = np.random.default_rng(3)
    ET = spec.total_edges
    h0 = _rand(rng, ET, H)
    w = _rand(rng, DEPTH, H, H, scale=0.2)
    bias = _rand(rng, DEPTH, H, scale=0.1)
    skips = np.asarray([1.0, 0.5, -0.7], np.float32)
    cot = _rand(rng, ET, H)
    seeds = [11, 22, 33]
    drops = (0.3, 0.0, 0.5) if train else (0.0,) * DEPTH
    sspec = ConvStackSpec(p=spec.p, d_nbr=b.edge_nbr.shape[1], depth=DEPTH,
                          dropout_ps=drops, train=train, learnable_skip=True,
                          mat_dtype=jnp.float32, out_dtype=jnp.float32,
                          interpret=True, act=act,
                          aggr="mean" if mean else "add")
    idx_t = build_idx_t(jnp.asarray(b.edge_nbr), jnp.asarray(b.rev), spec.p)
    j_seeds = jnp.asarray(seeds, jnp.int32)
    want = fused_conv_stack(sspec, jnp.asarray(h0), idx_t, jnp.asarray(w),
                            jnp.asarray(bias), jnp.asarray(skips),
                            j_seeds)
    g_j = jax.grad(lambda *a: jnp.sum(fused_conv_stack(
        sspec, a[0], idx_t, a[1], a[2], a[3], j_seeds) * cot),
        argnums=(0, 1, 2, 3))(jnp.asarray(h0), jnp.asarray(w),
                              jnp.asarray(bias), jnp.asarray(skips))
    kw = dict(p=spec.p, act=act, mean=mean, train=train,
              seeds=seeds if train else None,
              dropout_ps=drops if train else ())
    ins = [_t(h0), tb.edge_nbr, tb.rev]
    ws = [_t(w), _t(bias), _t(skips)]
    out = cs.conv_stack_forward_ref(*ins, *ws, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    grads = cs.conv_stack_backward_ref(*ins, tb.edge_nbr_rev, *ws, _t(cot),
                                       **kw)
    _close_grads(grads, g_j, ["dh0", "dw", "db", "dskips"])
    assert torch.equal(cs.conv_stack_forward(*ins, *ws, **kw), out)


def test_checks_and_counters(packed):
    spec, b, tb = packed
    h0 = torch.zeros(spec.total_edges, H)
    w, bias, skips = torch.zeros(DEPTH, H, H), torch.zeros(DEPTH, H), \
        torch.ones(DEPTH)
    with pytest.raises(ValueError, match="one seed and one drop rate"):
        cs.conv_stack_forward(h0, tb.edge_nbr, tb.rev, w, bias, skips,
                              p=spec.p, train=True)
    with pytest.raises(ValueError, match="skips has shape"):
        cs.conv_stack_forward(h0, tb.edge_nbr, tb.rev, w, bias, skips[:2],
                              p=spec.p)
    with pytest.raises(ValueError, match="split into p=3 packs"):
        sp.onehot_spmm(h0, tb.edge_nbr, p=3)
    with pytest.raises(ValueError, match="unsupported kernel activation"):
        gl.gather_linear_forward(torch.zeros(spec.total_nodes, 4), h0,
                                 tb.senders[:, None], torch.zeros(4, H),
                                 torch.zeros(H, H), torch.zeros(H), p=spec.p,
                                 act="tanh")
    with pytest.raises(ValueError, match="idx has shape"):
        gl.gather_linear_forward(torch.zeros(spec.total_nodes, 4), h0,
                                 tb.senders, torch.zeros(4, H),
                                 torch.zeros(H, H), torch.zeros(H), p=spec.p)
    assert split_k(1) == 1 and split_k(1024) == 4 and split_k(111616) == 64
