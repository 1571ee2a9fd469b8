"""Capture mode of the port on the CPU, where each kernel takes its plain
version, against the JAX package in interpret mode (f32 one-hot matrices,
as tests/test_pallas_fused.py runs them):

* ``fused_conv_layer_ref`` and its autograd against ``fused_conv_layer``
  (K6) and ``jax.grad`` for all five cotangents (dh, dh0, dw, db, dskip);
  the backward kernel's dh (dpre·wᵀ gathered through edge_nbr_rev, scaled
  by the forward row's 1/degree, minus the rev row) emulated;
* ``apply(capture=True)`` with the batch's spec (K7 gathers, K6 per layer)
  against JAX ``apply(..., capture=True)`` with ``use_pallas=True,
  pallas_interpret=True``: every activation, the predictions and the
  parameter gradients; and against the port's layered path in train mode;
* ``act_chain_ref`` (P1) against chains of the JAX kernels' ``k_act`` /
  ``k_dact``;
* ``cli/bench_ops.py`` and ``tools/gelu_roofline.py`` run with ``--cpu``.

Inputs are made with numpy from a seed.  Tolerances: outputs rtol = atol =
1e-4; gradients max|delta| / max|JAX| <= 1e-4; capture against the layered
path 1e-6 relative (the two compute the same function in another order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgr_mpnn_3d_tpu.models as jm
from cgr_mpnn_3d_tpu.chem import RxnGraph
from cgr_mpnn_3d_tpu.data import pack_graphs, plan_spec
from cgr_mpnn_3d_tpu.models.cgr_mpnn import kernel_seeds as j_kernel_seeds
from cgr_mpnn_3d_tpu.ops.pallas_fused import FusedConvSpec
from cgr_mpnn_3d_tpu.ops.pallas_fused import fused_conv_layer as j_conv
from cgr_mpnn_3d_tpu.ops.pallas_fused import k_act as j_act
from cgr_mpnn_3d_tpu.ops.pallas_fused import k_dact as j_dact
from cgr_mpnn_3d_tpu.ops.pallas_ops import build_idx_t
from cgr_mpnn_3d_tpu_torch.data import to_device
from cgr_mpnn_3d_tpu_torch.models import (CGRMPNN, CGRMPNNConfig, apply,
                                          params_from_jax)
from cgr_mpnn_3d_tpu_torch.ops import act_chain as ac
from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
from cgr_mpnn_3d_tpu_torch.ops.kernel_math import (hash_dropout_keep_full,
                                                   k_act, mean_colscale)
from cgr_mpnn_3d_tpu_torch.ops.segment import in_pack, pack_gather_sum

SMILES = ["CCO>>CC=O", "CC(=O)N>>CC(=O)N", "C=CC=C>>C=CC=C",
          "CCO>C>CCO", "O>C>CO", "N>C>CN", "CC>>CC",
          "[N:1]([H:2])([H:3])[H:4]>>[N:1]([H:2])[H:3].[H:4]"]
LABELS = [float(i) for i in range(len(SMILES))]
H = 16
SKIPS = (0.8, -0.3, 1.2)


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


# -- K6 ---------------------------------------------------------------------

# (act, mean, skip, dropout rate, Hin)
CONV_CASES = [("relu", False, 1.0, 0.0, H), ("relu", False, 1.0, 0.3, H),
              ("silu", True, 1.0, 0.0, H), ("gelu", True, 0.8, 0.0, H),
              ("relu", False, 1.0, 0.0, 24)]


@pytest.mark.parametrize("act,mean,skip,drop,hin", CONV_CASES,
                         ids=["relu-add-eval", "relu-add-train",
                              "silu-mean", "gelu-mean-skip", "hin24"])
def test_fused_conv_ref_matches_interpret_k6(packed, act, mean, skip, drop,
                                             hin):
    spec, b, tb = packed
    rng = np.random.default_rng(4)
    ET = spec.total_edges
    h, h0 = _rand(rng, ET, hin), _rand(rng, ET, H)
    w = _rand(rng, hin, H, scale=0.2)
    bias = _rand(rng, H, scale=0.1)
    cot = _rand(rng, ET, H)
    train, seed = drop > 0, 11
    fspec = FusedConvSpec(p=spec.p, d_nbr=b.edge_nbr.shape[1],
                          dropout_p=drop, train=train, learnable_skip=True,
                          mat_dtype=jnp.float32, out_dtype=jnp.float32,
                          interpret=True, act=act,
                          aggr="mean" if mean else "add")
    idx_t = build_idx_t(jnp.asarray(b.edge_nbr), jnp.asarray(b.rev), spec.p)
    j_seed = jnp.asarray(seed, jnp.int32)
    args_j = [jnp.asarray(v) for v in (h, h0, w, bias)] + [
        jnp.asarray(skip, jnp.float32)]
    want = j_conv(fspec, args_j[0], args_j[1], idx_t, *args_j[2:], j_seed)
    g_j = jax.grad(lambda *a: jnp.sum(j_conv(
        fspec, a[0], a[1], idx_t, *a[2:], j_seed) * cot),
        argnums=(0, 1, 2, 3, 4))(*args_j)

    kw = dict(p=spec.p, act=act, mean=mean, train=train,
              seed=seed if train else None, dropout_p=drop)
    ins = [_t(h), _t(h0), tb.edge_nbr, tb.rev]
    ws = [_t(w), _t(bias), torch.tensor(skip)]
    out = fc.fused_conv_layer_ref(*ins, *ws, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    grads = fc.fused_conv_backward_ref(*ins, tb.edge_nbr_rev, *ws, out,
                                       _t(cot), **kw)
    _close_grads(grads, g_j, ["dh", "dh0", "dw", "db", "dskip"])
    # the wrappers take the plain versions for CPU tensors, and count nothing
    before = (fc.launches, fc.bwd_launches)
    assert torch.equal(fc.fused_conv_forward(*ins, *ws, **kw), out)
    part = fc.fused_conv_backward(*ins, tb.edge_nbr_rev, *ws, out, _t(cot),
                                  **kw, needs=(True, False, True, False,
                                               False))
    assert part[1] is None and torch.equal(part[2], grads[2])
    assert (fc.launches, fc.bwd_launches) == before
    # the backward kernel's dh: dt = dpre·wᵀ gathered through edge_nbr_rev,
    # each entry scaled by its forward row's 1/degree, minus the rev row
    th, tw = _t(h), _t(w)
    t = pack_gather_sum(th, tb.edge_nbr, spec.p, mean) \
        - sp.onehot_spmm_ref(th, tb.rev[:, None], p=spec.p)
    with torch.enable_grad():
        pre = (t @ tw + _t(bias) + skip * _t(h0)).requires_grad_()
        y = k_act(act, pre)
        if train:
            keep = hash_dropout_keep_full(ET, H, spec.te, seed, drop)
            y = torch.where(keep, y / (1.0 - drop), 0.0)
        (dpre,) = torch.autograd.grad(y, pre, _t(cot))
    dt = dpre @ tw.T
    rs = (mean_colscale(in_pack(tb.edge_nbr, spec.p, ET)[1])[:, None]
          if mean else 1.0)
    dh = sp.onehot_spmm_ref(dt * rs, tb.edge_nbr_rev, p=spec.p) \
        - sp.onehot_spmm_ref(dt, tb.rev[:, None], p=spec.p)
    _close_grads([dh], [g_j[0]], ["dh via edge_nbr_rev"])


# -- capture ----------------------------------------------------------------

def _cfg_kw(act, aggr, pooling, learnable, drops):
    return dict(num_node_features=78, num_edge_features=14, depth=3,
                hidden_sizes=(H,) * 3, dropout_ps=drops, activation=act,
                aggr=aggr, pooling=pooling, use_learnable_skip=learnable)


def _counts():
    return [(m.launches, m.bwd_launches) for m in (fc, sp)]


CAPTURE_CASES = [("ReLU", "add", "add", False, (0.0,) * 3, False),
                 ("GELU", "mean", "mean", True, (0.0,) * 3, False),
                 ("ReLU", "add", "add", False, (0.3, 0.0, 0.5), True)]


@pytest.mark.parametrize("act,aggr,pooling,learnable,drops,train",
                         CAPTURE_CASES, ids=["relu-eval", "gelu-mean-skip",
                                             "relu-train"])
def test_capture_apply_and_grads_match_jax(packed, act, aggr, pooling,
                                           learnable, drops, train):
    spec, b, tb = packed
    kw = _cfg_kw(act, aggr, pooling, learnable, drops)
    params = jm.init_params(jax.random.PRNGKey(0), jm.CGRMPNNConfig(**kw))
    if learnable:
        params["skip_weights"] = [jnp.asarray(v) for v in SKIPS]
    cfg_j = jm.CGRMPNNConfig(**kw, use_pallas=True, pallas_interpret=True)
    rng = jax.random.PRNGKey(7) if train else None
    y, m = jnp.asarray(b.labels), jnp.asarray(b.graph_mask)

    def loss(p):
        pred, acts = jm.apply(p, b, cfg_j, spec, train=train, rng=rng,
                              capture=True)
        return jnp.sum(m * (pred - y) ** 2), (pred, acts)

    (_, (want, acts_j)), g_j = jax.value_and_grad(loss, has_aux=True)(params)

    model = CGRMPNN(CGRMPNNConfig(**kw))
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    seeds = (np.asarray(j_kernel_seeds(cfg_j, rng)).tolist() if train
             else None)
    before = _counts()
    pred, acts = apply(model, tb, spec, train=train, seeds=seeds,
                       capture=True)
    ((pred - tb.labels) ** 2 * tb.graph_mask).sum().backward()
    assert _counts() == before            # the CPU launches no kernel
    assert set(acts) == set(acts_j)
    for k, v in acts_j.items():
        np.testing.assert_allclose(acts[k].detach().numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    mask = b.graph_mask > 0
    np.testing.assert_allclose(pred.detach().numpy()[mask],
                               np.asarray(want)[mask], rtol=1e-4, atol=1e-4)
    want_g = params_from_jax(jax.tree_util.tree_map(np.asarray, g_j))
    names, params_t = zip(*model.named_parameters())
    _close_grads([q.grad for q in params_t], [want_g[n] for n in names],
                 names)


@pytest.mark.parametrize("act,aggr,pooling", [("ReLU", "add", "add"),
                                              ("GELU", "mean", "mean")])
def test_capture_equals_layered_in_train_mode(packed, act, aggr, pooling):
    """Under the same seeds the capture path (K7 gathers, K6 per layer) and
    the layered path (K5, K4, K5, K7) compute the same predictions and
    gradients, up to the order of their sums."""
    spec, b, tb = packed
    kw = _cfg_kw(act, aggr, pooling, True, (0.3, 0.0, 0.5))
    out = {}
    for capture in (True, False):
        model = CGRMPNN(CGRMPNNConfig(**kw, fuse_whole_model=False),
                        torch.Generator().manual_seed(5))
        with torch.no_grad():
            for w, v in zip(model.skip_weights, SKIPS):
                w.fill_(v)
        pred = apply(model, tb, spec, train=True, seeds=[3, 4, 5],
                     capture=capture)
        pred = pred[0] if capture else pred
        ((pred - tb.labels) ** 2 * tb.graph_mask).sum().backward()
        out[capture] = (pred.detach(), {n: q.grad for n, q in
                                        model.named_parameters()})
    mask = tb.graph_mask > 0

    def rel(a, b_):
        return float((a - b_).abs().max()) / max(float(b_.abs().max()), 1e-30)

    assert rel(out[True][0][mask], out[False][0][mask]) <= 1e-6
    for name, g in out[False][1].items():
        assert rel(out[True][1][name], g) <= 1e-6, name


# -- P1 ---------------------------------------------------------------------

J_CHAIN = {
    "relu": lambda y: j_act("relu", y),
    "silu": lambda y: j_act("silu", y),
    "gelu": lambda y: j_act("gelu", y),
    "gelu_bwd": lambda y: j_dact("gelu", y),
    "gelu_bwd_from_out": lambda y: (
        jnp.where(jnp.abs(y) > 1e-6, j_act("gelu", y) / y, 0.5)
        + y * 0.3989422804014327 * jnp.exp(-y * y * 0.5)),
}


@pytest.mark.parametrize("fn", ac.FNS)
def test_act_chain_ref_matches_jax_chain(fn):
    x = _rand(np.random.default_rng(5), 64, 48, scale=3.0)
    before = ac.launches
    for k in (1, 4):
        want = jnp.asarray(x)
        for _ in range(k):
            want = J_CHAIN[fn](want * 0.5) - 0.1
        got = ac.act_chain_ref(_t(x), fn, k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"{fn} k={k}")
        assert torch.equal(ac.act_chain(_t(x), fn, k), got)
    assert ac.launches == before


# -- the measuring entry points ---------------------------------------------

def test_bench_ops_runs_on_the_cpu(capsys):
    from cgr_mpnn_3d_tpu_torch.cli import bench_ops
    res = bench_ops.main(["--cpu", "--graphs", "20", "--hidden", "16"])
    lines = capsys.readouterr().out.splitlines()
    names = ["dense_matmul[ET,H]x[H,H]", "xla_gather_messages",
             "pallas_onehot_messages", "fused_conv_fwd", "fused_conv_fwd+bwd",
             "model_fwd", "model_fwd+bwd", "optimizer_update"]
    assert list(res) == names
    assert [ln.split()[0] for ln in lines] == names
    assert all(np.isfinite(t) and t > 0 for t, _ in res.values())


def test_gelu_roofline_runs_on_the_cpu(capsys):
    from cgr_mpnn_3d_tpu_torch.data import PackSpec
    from cgr_mpnn_3d_tpu_torch.tools import gelu_roofline
    argv = ["--cpu", "--n", "64", "--h", "8", "--apps", "2", "--repeats", "1"]
    alone = gelu_roofline.main(argv)
    assert alone["act_elems_per_step"] is None
    assert alone["pred_gelu_step_ms"] is None
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14, depth=4,
                        hidden_sizes=(400,) * 4)
    out = gelu_roofline.main(argv, step=(PackSpec(te=256, tn=128, p=436),
                                         cfg))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert set(line["per_app_ms"]) == set(ac.FNS)
    # 436 packs: (depth + 1) edge states of te rows and one node state of tn
    # rows per pack, 400 wide, forward and backward
    assert line["act_elems_per_step"] == 2 * 436 * (5 * 256 + 128) * 400
    assert np.isfinite(line["pred_gelu_step_ms"])
