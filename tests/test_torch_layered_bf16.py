"""bf16 compute of the port's layered, capture and XLA paths on the CPU,
against the JAX package at bf16 (its Pallas kernels in interpret mode, as
tests/test_pallas*.py run them):

* the plain versions of K7 (``onehot_spmm_ref``, with and without the sign
  row, src f32 or bf16), K5 (``gather_linear_forward_ref``: edge_init with
  bf16 output, readout with f32 output, add and mean), K4
  (``conv_stack_forward_ref``, eval and train-mode dropout) and K6
  (``fused_conv_layer_ref``: train-mode dropout, mean, Hin != H) at
  ``mat_dtype="bfloat16"`` against ``spmm_t``, ``fused_gather_linear``,
  ``fused_conv_stack`` and ``fused_conv_layer`` at bf16: outputs, output
  dtypes (bf16 exactly where JAX's are) and the gradients of ``jax.vjp``
  under one cotangent, as one vector;
* layered ``apply`` and capture ``apply`` (every ``acts`` entry) at bf16 and
  their autograd parameter gradients against JAX ``apply(...,
  use_pallas=True, pallas_interpret=True, compute_dtype=bf16)`` in
  tests/test_torch_bf16.py's three cases, with learnable skips and
  train-mode dropout 0.1 under the same seeds;
* the XLA path (no ``spec``) at bf16 against JAX's XLA path at bf16, and
  against the f32 oracle at tests/test_bf16.py's bound (rel-L2 < 1e-2, and
  not equal to f32);
* each wrapper refuses a dtype its mat_dtype (and K5's out_dtype) does not
  take.

Inputs are made with numpy from seeds; weights by ``jax.random``, copied
into the port.  Tolerance (the rule of tests/test_torch_bf16.py): the
rel-L2 distance of the port's bf16 result to JAX's bf16 result is at most a
quarter of JAX's own bf16-vs-f32 distance on the same inputs and at most
5e-3 -- both round at the same places, only the order of f32 sums differs,
which can flip a rounding -- and the port's bf16 result differs from its
f32 one.  Shapes: the kernels at tests/test_torch_layered_kernels.py's
(H = 16, depth 3, te = 64, p = 2), the model paths at
tests/test_torch_bf16.py's corpus batch (16 reactions, p = 4, hidden 32).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgr_mpnn_3d_tpu.models as jm
from cgr_mpnn_3d_tpu.chem import RxnGraph
from cgr_mpnn_3d_tpu.data import pack_graphs, plan_spec
from cgr_mpnn_3d_tpu.models.cgr_mpnn import kernel_seeds as j_kernel_seeds
from cgr_mpnn_3d_tpu.ops.dispatch import SpmmMeta, spmm_t
from cgr_mpnn_3d_tpu.ops.pallas_fused import FusedConvSpec, fused_conv_layer
from cgr_mpnn_3d_tpu.ops.pallas_glin import (GatherLinearSpec,
                                             fused_gather_linear)
from cgr_mpnn_3d_tpu.ops.pallas_ops import build_idx_t
from cgr_mpnn_3d_tpu.ops.pallas_stack import ConvStackSpec, fused_conv_stack
from cgr_mpnn_3d_tpu_torch.data import to_device
from cgr_mpnn_3d_tpu_torch.models import (CGRMPNN, CGRMPNNConfig, apply,
                                          params_from_jax)
from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp

REPO = Path(__file__).resolve().parent.parent
CASES = [("ReLU", "add", "add"), ("SiLU", "mean", "mean"),
         ("GELU", "mean", "add")]          # tests/test_torch_bf16.py's
SKIPS = (0.8, -0.3, 1.2)
DROP = 0.1
SMILES = ["CCO>>CC=O", "CC(=O)N>>CC(=O)N", "C=CC=C>>C=CC=C",
          "CCO>C>CCO", "O>C>CO", "N>C>CN", "CC>>CC",
          "[N:1]([H:2])([H:3])[H:4]>>[N:1]([H:2])[H:3].[H:4]"]
H = 16
DEPTH = 3
BF16, F32 = "bfloat16", "float32"


@pytest.fixture(scope="module")
def corpus():
    rows = (REPO / "tests" / "corpus_reactions.csv"
            ).read_text().splitlines()[1:]
    return [RxnGraph(r.split(",")[0]).arrays for r in rows if r.strip()][:16]


@pytest.fixture(scope="module")
def packed(corpus):
    """tests/test_torch_bf16.py's batch: 16 corpus reactions in 4 packs."""
    spec = plan_spec(corpus, te=128, tn=64, tb=8).with_packs(4)
    batch = pack_graphs(corpus, [float(i % 7 - 3) for i in range(16)], spec)
    return spec, batch, to_device(batch, "cpu")


@pytest.fixture(scope="module")
def small():
    graphs = [RxnGraph(s).arrays for s in SMILES]
    spec = plan_spec(graphs, te=64, tn=32, tb=8).with_packs(2)
    batch = pack_graphs(graphs, [float(i) for i in range(len(SMILES))], spec)
    return spec, batch, to_device(batch, "cpu")


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(t) -> np.ndarray:
    """A torch or JAX array as float64 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(ts) -> np.ndarray:
    return np.concatenate([_np(t).ravel() for t in ts])


def _held(port16, port32, jax16, jax32, what):
    """The rule of the module docstring."""
    own = _rel_l2(_flat(jax16), _flat(jax32))
    err = _rel_l2(_flat(port16), _flat(jax16))
    assert err <= min(0.25 * own, 5e-3), (what, err, own)
    assert _rel_l2(_flat(port16), _flat(port32)) > 0.0, what


def _jax_dt(md):
    return jnp.bfloat16 if md == BF16 else jnp.float32


def _torch_dt(md):
    return torch.bfloat16 if md == BF16 else torch.float32


def _port_vjp(fn, ins, cot):
    """(output, gradients of every input) of ``fn`` under the cotangent
    ``cot``, given in the output's type."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in ins]
        y = fn(*ins)
        grads = torch.autograd.grad(y, ins, cot.to(y.dtype))
    return y.detach(), grads


def _jax_vjp(fn, ins, cot):
    y, pull = jax.vjp(fn, *ins)
    return y, pull(jnp.asarray(cot).astype(y.dtype))


# -- K7 ---------------------------------------------------------------------

# (idx field, sign field, backward ELL field, source rows, src type)
SPMM_CASES = [("edge_nbr", "rev", "edge_nbr_rev", "edges", F32),
              ("graph_nodes", None, "graph_of_node", "nodes", F32),
              ("senders", None, "node_out", "nodes", BF16)]


@pytest.mark.parametrize("idx_f,sign_f,bwd_f,src_rows,src_dt", SPMM_CASES,
                         ids=["messages", "pool", "x_senders_bf16"])
def test_plain_k7_bf16_matches_interpret_k7(small, idx_f, sign_f, bwd_f,
                                            src_rows, src_dt):
    spec, b, tb = small
    rows = spec.total_edges if src_rows == "edges" else spec.total_nodes
    rng = np.random.default_rng(0)
    src = _rand(rng, rows, H)
    if src_dt == BF16:      # x is bf16 before the gather: round it first
        src = np.asarray(jnp.asarray(src, jnp.bfloat16), np.float32)
    idx = np.asarray(getattr(b, idx_f))
    idx = idx[:, None] if idx.ndim == 1 else idx
    bwd = np.asarray(getattr(b, bwd_f))
    bwd = bwd[:, None] if bwd.ndim == 1 else bwd
    sign = None if sign_f is None else np.asarray(getattr(b, sign_f))
    j_sign = None if sign is None else jnp.asarray(sign)
    idx_t = build_idx_t(jnp.asarray(idx), j_sign, spec.p)
    bwd_t = build_idx_t(jnp.asarray(bwd), j_sign, spec.p)
    cot = _rand(rng, idx.shape[0], H)
    t_sign = None if sign is None else torch.from_numpy(sign)
    got, want = {}, {}
    for md in (BF16, F32):
        meta_f = SpmmMeta(idx.shape[1], sign is not None, _jax_dt(md),
                          jnp.float32, True)
        meta_b = SpmmMeta(bwd.shape[1], sign is not None, _jax_dt(md),
                          jnp.float32, True)
        dt = _jax_dt(src_dt) if md == BF16 else jnp.float32
        want[md] = _jax_vjp(lambda s: spmm_t(spec.p, meta_f, meta_b, s, idx_t,
                                             bwd_t),
                            [jnp.asarray(src).astype(dt)], cot)
        got[md] = _port_vjp(
            lambda s: sp.spmm(s, torch.from_numpy(idx),
                              torch.from_numpy(bwd), t_sign, t_sign,
                              p=spec.p, mat_dtype=md),
            [torch.from_numpy(src).to(_torch_dt(src_dt) if md == BF16
                                      else torch.float32)],
            torch.from_numpy(cot))
    (y16, g16), (y32, g32) = got[BF16], got[F32]
    assert y16.dtype == torch.float32 and g16[0].dtype == _torch_dt(src_dt)
    if src_dt == F32:
        _held([y16], [y32], [want[BF16][0]], [want[F32][0]], "K7 out")
    else:           # a bf16 source is exact in both: only the sums differ
        np.testing.assert_allclose(_np(y16), _np(want[BF16][0]), rtol=1e-6,
                                   atol=1e-6)
    _held(g16, g32, want[BF16][1], want[F32][1], "K7 d_src")


# -- K5 ---------------------------------------------------------------------

# (stage, act, mean, out_dtype)
GLIN_CASES = [("edge_init", "relu", False, BF16),
              ("readout", "relu", False, F32),
              ("readout", "gelu", True, F32)]


@pytest.mark.parametrize("stage,act,mean,out_dtype", GLIN_CASES)
def test_plain_k5_bf16_matches_interpret_k5(small, stage, act, mean,
                                            out_dtype):
    spec, b, tb = small
    rng = np.random.default_rng(2)
    ET, NT, F, Fe = spec.total_edges, spec.total_nodes, 78, 14
    if stage == "edge_init":
        xa, xb = _rand(rng, NT, F), _rand(rng, ET, Fe)
        idx = np.asarray(b.senders)[:, None]
    else:
        xa, xb = _rand(rng, ET, H), _rand(rng, NT, F)
        idx = np.asarray(b.node_inc)
    ws = [_rand(rng, xa.shape[1], H, scale=0.2),
          _rand(rng, xb.shape[1], H, scale=0.2), _rand(rng, H, scale=0.1)]
    cot = _rand(rng, xb.shape[0], H)
    adj = tb.node_out if stage == "edge_init" else tb.receivers[:, None]
    idx_t = build_idx_t(jnp.asarray(idx), None, spec.p)
    got, want = {}, {}
    for md in (BF16, F32):
        od = out_dtype if md == BF16 else F32
        gspec = GatherLinearSpec(p=spec.p, d_nbr=idx.shape[1],
                                 mat_dtype=_jax_dt(md),
                                 out_dtype=_jax_dt(od), interpret=True,
                                 act=act, aggr="mean" if mean else "add")
        want[md] = _jax_vjp(
            lambda a, bb, *w: fused_gather_linear(gspec, a, bb, idx_t, *w),
            [jnp.asarray(xa).astype(_jax_dt(md)),
             jnp.asarray(xb).astype(_jax_dt(md))]
            + [jnp.asarray(w) for w in ws], cot)
        kw = dict(p=spec.p, act=act, mean=mean, mat_dtype=md, out_dtype=od)
        got[md] = _port_vjp(
            lambda a, bb, *w: gl.gather_linear(a, bb, torch.from_numpy(idx),
                                               adj, *w, **kw),
            [torch.from_numpy(xa).to(_torch_dt(md)),
             torch.from_numpy(xb).to(_torch_dt(md))]
            + [torch.from_numpy(w) for w in ws], torch.from_numpy(cot))
    (y16, g16), (y32, g32) = got[BF16], got[F32]
    assert y16.dtype == _torch_dt(out_dtype)
    assert [g.dtype for g in g16] == [torch.bfloat16] * 2 + [torch.float32] * 3
    _held([y16], [y32], [want[BF16][0]], [want[F32][0]], "K5 out")
    _held(g16, g32, want[BF16][1], want[F32][1], "K5 grads")
    # the wrappers take the plain versions for CPU tensors, and count nothing
    before = (gl.bf16_launches, gl.bf16_bwd_launches)
    ins = [torch.from_numpy(xa).bfloat16(), torch.from_numpy(xb).bfloat16(),
           torch.from_numpy(idx)]
    tw = [torch.from_numpy(w) for w in ws]
    kw16 = dict(p=spec.p, act=act, mean=mean, mat_dtype=BF16,
                out_dtype=out_dtype)
    assert torch.equal(gl.gather_linear_forward(*ins, *tw, **kw16), y16)
    back = gl.gather_linear_backward(*ins[:3], adj, *tw, y16,
                                     torch.from_numpy(cot).to(y16.dtype),
                                     **kw16)
    assert all(torch.equal(x, y) for x, y in zip(back, g16))
    assert (gl.bf16_launches, gl.bf16_bwd_launches) == before


# -- K4 ---------------------------------------------------------------------

@pytest.mark.parametrize("act,mean,train", [("relu", False, False),
                                            ("silu", True, True)])
def test_plain_k4_bf16_matches_interpret_k4(small, act, mean, train):
    spec, b, tb = small
    rng = np.random.default_rng(3)
    h0 = _rand(rng, spec.total_edges, H)
    ws = [_rand(rng, DEPTH, H, H, scale=0.2), _rand(rng, DEPTH, H, scale=0.1),
          np.asarray([1.0, 0.5, -0.7], np.float32)]
    cot = _rand(rng, spec.total_edges, H)
    seeds = [11, 22, 33]
    drops = (0.3, 0.0, 0.5) if train else (0.0,) * DEPTH
    idx_t = build_idx_t(jnp.asarray(b.edge_nbr), jnp.asarray(b.rev), spec.p)
    got, want = {}, {}
    for md in (BF16, F32):
        sspec = ConvStackSpec(p=spec.p, d_nbr=b.edge_nbr.shape[1],
                              depth=DEPTH, dropout_ps=drops, train=train,
                              learnable_skip=True, mat_dtype=_jax_dt(md),
                              out_dtype=_jax_dt(md), interpret=True, act=act,
                              aggr="mean" if mean else "add")
        want[md] = _jax_vjp(
            lambda h, w, bb, sk: fused_conv_stack(
                sspec, h, idx_t, w, bb, sk, jnp.asarray(seeds, jnp.int32)),
            [jnp.asarray(h0).astype(_jax_dt(md))]
            + [jnp.asarray(w) for w in ws], cot)
        kw = dict(p=spec.p, act=act, mean=mean, train=train,
                  seeds=seeds if train else None,
                  dropout_ps=drops if train else (), mat_dtype=md)
        got[md] = _port_vjp(
            lambda h, *w: cs.conv_stack(h, tb.edge_nbr, tb.rev,
                                        tb.edge_nbr_rev, *w, **kw),
            [torch.from_numpy(h0).to(_torch_dt(md))]
            + [torch.from_numpy(w) for w in ws], torch.from_numpy(cot))
    (y16, g16), (y32, g32) = got[BF16], got[F32]
    assert y16.dtype == g16[0].dtype == torch.bfloat16
    assert want[BF16][0].dtype == want[BF16][1][0].dtype == jnp.bfloat16
    _held([y16], [y32], [want[BF16][0]], [want[F32][0]], "K4 out")
    _held(g16, g32, want[BF16][1], want[F32][1], "K4 grads")


# -- K6 ---------------------------------------------------------------------

# (act, mean, skip, dropout rate, Hin)
CONV_CASES = [("relu", False, 1.0, 0.3, H), ("gelu", True, 0.8, 0.0, H),
              ("relu", False, 1.0, 0.0, 24)]


@pytest.mark.parametrize("act,mean,skip,drop,hin", CONV_CASES,
                         ids=["relu-train", "gelu-mean-skip", "hin24"])
def test_plain_k6_bf16_matches_interpret_k6(small, act, mean, skip, drop,
                                            hin):
    spec, b, tb = small
    rng = np.random.default_rng(4)
    ET = spec.total_edges
    h, h0 = _rand(rng, ET, hin), _rand(rng, ET, H)
    ws = [_rand(rng, hin, H, scale=0.2), _rand(rng, H, scale=0.1),
          np.asarray(skip, np.float32)]
    cot = _rand(rng, ET, H)
    train, seed = drop > 0, 11
    idx_t = build_idx_t(jnp.asarray(b.edge_nbr), jnp.asarray(b.rev), spec.p)
    got, want = {}, {}
    for md in (BF16, F32):
        fspec = FusedConvSpec(p=spec.p, d_nbr=b.edge_nbr.shape[1],
                              dropout_p=drop, train=train,
                              learnable_skip=True, mat_dtype=_jax_dt(md),
                              out_dtype=_jax_dt(md), interpret=True, act=act,
                              aggr="mean" if mean else "add")
        want[md] = _jax_vjp(
            lambda hh, hh0, *w: fused_conv_layer(
                fspec, hh, hh0, idx_t, *w, jnp.asarray(seed, jnp.int32)),
            [jnp.asarray(v).astype(_jax_dt(md)) for v in (h, h0)]
            + [jnp.asarray(w) for w in ws], cot)
        kw = dict(p=spec.p, act=act, mean=mean, train=train,
                  seed=seed if train else None, dropout_p=drop, mat_dtype=md)
        got[md] = _port_vjp(
            lambda hh, hh0, *w: fc.fused_conv_layer(
                hh, hh0, tb.edge_nbr, tb.rev, tb.edge_nbr_rev, *w, **kw),
            [torch.from_numpy(v).to(_torch_dt(md)) for v in (h, h0)]
            + [torch.from_numpy(w) for w in ws], torch.from_numpy(cot))
    (y16, g16), (y32, g32) = got[BF16], got[F32]
    assert y16.dtype == torch.bfloat16
    assert [g.dtype for g in g16] == [torch.bfloat16] * 2 + [torch.float32] * 3
    _held([y16], [y32], [want[BF16][0]], [want[F32][0]], "K6 out")
    _held(g16, g32, want[BF16][1], want[F32][1], "K6 grads")


# -- the model paths ----------------------------------------------------------

def _model_kw(b, act, aggr, pooling):
    F, Fe = b.node_x.shape[1], b.edge_attr.shape[1]
    return dict(num_node_features=F, num_edge_features=Fe, depth=3,
                hidden_sizes=(32,) * 3, dropout_ps=(DROP,) * 3,
                activation=act, aggr=aggr, pooling=pooling,
                use_learnable_skip=True)


def _jax_run(params, b, spec, kw, md, capture, rng):
    """JAX apply at ``md`` through its Pallas kernels in interpret mode:
    (predictions, acts or {}, parameter gradients of the masked SSE)."""
    cfg = jm.CGRMPNNConfig(**kw, compute_dtype=_jax_dt(md), use_pallas=True,
                           pallas_interpret=True, fuse_whole_model=False)
    y, m = jnp.asarray(b.labels), jnp.asarray(b.graph_mask)

    def loss(p):
        out = jm.apply(p, b, cfg, spec, train=True, rng=rng, capture=capture)
        pred, acts = out if capture else (out, {})
        return jnp.sum(m * (pred - y) ** 2), (pred, acts)

    (_, (pred, acts)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return pred, acts, params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              grads))


def _port_run(model, tb, spec, seeds, capture):
    pred = apply(model, tb, spec, train=True, seeds=seeds, capture=capture)
    pred, acts = pred if capture else (pred, {})
    model.zero_grad()
    ((pred - tb.labels) ** 2 * tb.graph_mask).sum().backward()
    return pred.detach(), acts, {n: q.grad.clone() for n, q in
                                 model.named_parameters()}


@pytest.mark.parametrize("capture", [False, True], ids=["layered", "capture"])
@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_layered_and_capture_apply_bf16_match_jax(packed, case, capture):
    spec, b, tb = packed
    kw = _model_kw(b, *case)
    params = jm.init_params(jax.random.PRNGKey(CASES.index(case)),
                            jm.CGRMPNNConfig(**kw))
    params["skip_weights"] = [jnp.asarray(v) for v in SKIPS]
    rng = jax.random.PRNGKey(7)
    seeds = np.asarray(j_kernel_seeds(jm.CGRMPNNConfig(**kw), rng)).tolist()
    mask = b.graph_mask > 0
    port, jaxr = {}, {}
    for md in (BF16, F32):
        jaxr[md] = _jax_run(params, b, spec, kw, md, capture, rng)
        model = CGRMPNN(CGRMPNNConfig(**kw, compute_dtype=md,
                                      fuse_whole_model=False))
        model.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
        port[md] = _port_run(model, tb, spec, seeds, capture)
    names = sorted(port[BF16][2])
    (p16, a16, g16), (p32, a32, g32) = port[BF16], port[F32]
    (j16, ja16, jg16), (j32, ja32, jg32) = jaxr[BF16], jaxr[F32]
    _held([p16[mask]], [p32[mask]], [np.asarray(j16)[mask]],
          [np.asarray(j32)[mask]], "preds")
    _held([g16[n] for n in names], [g32[n] for n in names],
          [jg16[n] for n in names], [jg32[n] for n in names], "grads")
    assert set(a16) == set(ja16)
    for k in ja16:
        assert (a16[k].dtype == torch.bfloat16) == (ja16[k].dtype
                                                    == jnp.bfloat16), k
        _held([a16[k]], [a32[k]], [ja16[k]], [ja32[k]], k)


def test_capture_acts_bf16_dtypes_and_launches(packed):
    """Capture at bf16 on CPU tensors: h0 f32, the conv layers' outputs
    bf16 (JAX's h0c and fused_conv_layer's out_dtype), s, h_node and pooled
    f32; no kernel is counted."""
    spec, b, tb = packed
    model = CGRMPNN(CGRMPNNConfig(**_model_kw(b, *CASES[0]),
                                  compute_dtype=BF16),
                    torch.Generator().manual_seed(0))
    counts = [(m.bf16_launches, m.bf16_bwd_launches) for m in (sp, fc)]
    with torch.no_grad():
        _, acts = apply(model, tb, spec, capture=True)
    assert {k: v.dtype for k, v in acts.items()} == dict(
        h0=torch.float32, h_0=torch.bfloat16, h_1=torch.bfloat16,
        h_2=torch.bfloat16, s=torch.float32, h_node=torch.float32,
        pooled=torch.float32)
    assert [(m.bf16_launches, m.bf16_bwd_launches) for m in (sp, fc)] == counts


def _oracle(corpus, n, seed=1):
    """(JAX params, port bf16 model, JAX f32 config, spec, JAX batch, port
    batch) of tests/test_bf16.py's setup: depth 2, hidden 32, no dropout."""
    gs = corpus[:n]
    spec = plan_spec(gs, te=128, tn=64, tb=8).with_packs(4)
    b = pack_graphs(gs, [0.0] * n, spec)
    kw = dict(num_node_features=gs[0].node_feats.shape[1],
              num_edge_features=gs[0].edge_feats.shape[1], depth=2,
              hidden_sizes=(32, 32), dropout_ps=(0.0, 0.0))
    params = jm.init_params(jax.random.PRNGKey(seed), jm.CGRMPNNConfig(**kw))
    model = CGRMPNN(CGRMPNNConfig(**kw, compute_dtype=BF16))
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, model, jm.CGRMPNNConfig(**kw), spec, b, to_device(b, "cpu")


@pytest.mark.parametrize("aggr,pooling", [("add", "add"), ("mean", "mean")])
def test_xla_path_bf16_matches_jax_and_f32_oracle(corpus, aggr, pooling):
    params, model, jcfg, spec, b, tb = _oracle(corpus, 16)
    jcfg = dataclasses.replace(jcfg, aggr=aggr, pooling=pooling)
    model.cfg = dataclasses.replace(model.cfg, aggr=aggr, pooling=pooling)
    mask = b.graph_mask > 0
    j32 = np.asarray(jm.apply(params, b, jcfg))[mask]
    j16 = np.asarray(jm.apply(params, b, dataclasses.replace(
        jcfg, compute_dtype=jnp.bfloat16)), np.float32)[mask]
    with torch.no_grad():
        p16 = apply(model, tb).numpy()[mask]
        model.cfg = dataclasses.replace(model.cfg, compute_dtype=F32)
        p32 = apply(model, tb).numpy()[mask]
    _held([p16], [p32], [j16], [j32], "XLA preds")
    err = _rel_l2(p16, j32)
    assert 0.0 < err < 1e-2, err


def test_xla_path_bf16_grads_match_jax(corpus):
    """The XLA path's parameter gradients at bf16: JAX's ``astype`` rounds
    the cotangent of every rounded operand, and so does autograd through
    ``round_bf16``."""
    params, model, jcfg, spec, b, tb = _oracle(corpus, 16, seed=2)
    m = jnp.asarray(b.graph_mask)

    def jax_grads(cfg):
        g = jax.grad(lambda p: jnp.sum(m * (jm.apply(p, b, cfg) - 1.0) ** 2))(
            params)
        return params_from_jax(jax.tree_util.tree_map(np.asarray, g))

    def port_grads(md):
        model.cfg = dataclasses.replace(model.cfg, compute_dtype=md)
        model.zero_grad()
        ((apply(model, tb) - 1.0) ** 2 * tb.graph_mask).sum().backward()
        return {n: q.grad.clone() for n, q in model.named_parameters()}

    jg16 = jax_grads(dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16))
    jg32 = jax_grads(jcfg)
    g16, g32 = port_grads(BF16), port_grads(F32)
    names = sorted(g16)
    _held([g16[n] for n in names], [g32[n] for n in names],
          [jg16[n] for n in names], [jg32[n] for n in names], "XLA grads")


def test_wrappers_refuse_the_other_dtype(small):
    """Each wrapper takes the dtypes of its mat_dtype (and K5's out_dtype)
    only, on any device: bf16 states at bf16, f32 at f32."""
    spec, b, tb = small
    ET, NT = spec.total_edges, spec.total_nodes
    h32 = torch.zeros(ET, H)
    h16 = h32.bfloat16()
    ws = (torch.zeros(DEPTH, H, H), torch.zeros(DEPTH, H), torch.ones(DEPTH))
    msg = (tb.edge_nbr, tb.rev)
    with pytest.raises(TypeError, match="h0 is torch.bfloat16"):
        cs.conv_stack_forward(h16, *msg, *ws, p=spec.p)
    with pytest.raises(TypeError, match="h0 is torch.float32"):
        cs.conv_stack_forward(h32, *msg, *ws, p=spec.p, mat_dtype=BF16)
    w1 = (torch.zeros(H, H), torch.zeros(H), torch.tensor(1.0))
    with pytest.raises(TypeError, match="h is torch.float32"):
        fc.fused_conv_forward(h32, h16, *msg, *w1, p=spec.p, mat_dtype=BF16)
    gw = (torch.zeros(4, H), torch.zeros(H, H), torch.zeros(H))
    with pytest.raises(TypeError, match="xa is torch.float32"):
        gl.gather_linear_forward(torch.zeros(NT, 4), h16, tb.senders[:, None],
                                 *gw, p=spec.p, mat_dtype=BF16)
    with pytest.raises(ValueError, match="unsupported out_dtype"):
        gl.gather_linear_forward(torch.zeros(NT, 4), h32, tb.senders[:, None],
                                 *gw, p=spec.p, out_dtype=BF16)
    with pytest.raises(TypeError, match="src is torch.bfloat16"):
        sp.onehot_spmm(h16, tb.edge_nbr, p=spec.p)
    with pytest.raises(ValueError, match="unsupported mat_dtype"):
        sp.onehot_spmm(h32, tb.edge_nbr, p=spec.p, mat_dtype="float16")
    # at bf16 K7 takes an f32 or a bf16 source, and writes f32
    for src in (h32, h16):
        assert sp.onehot_spmm(src, tb.edge_nbr, p=spec.p,
                              mat_dtype=BF16).dtype == torch.float32
