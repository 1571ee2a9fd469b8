"""The port's model and ops against the JAX package on the CPU.

* the plain gather ops and the kernel helpers against their JAX
  counterparts;
* ``apply(capture=True)`` per layer against JAX ``apply`` (XLA path) and
  against every case of tests/goldens/reference_gnn.npz;
* ``fused_model_forward_ref`` (the CUDA kernel's plain version) against the
  JAX whole-model kernel K3f run in interpret mode;
* init bounds, checkpoint leaf order, the kernel wrapper's checks.

Tolerances are the JAX package's own: rtol/atol 1e-4 (f32).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgr_mpnn_3d_tpu.models as jm
import cgr_mpnn_3d_tpu.ops.segment as jseg
from cgr_mpnn_3d_tpu.chem import RxnGraph
from cgr_mpnn_3d_tpu.data import pack_graphs, plan_spec
from cgr_mpnn_3d_tpu.ops.pallas_fused import k_act as j_k_act
from cgr_mpnn_3d_tpu.ops.pallas_fused import mean_colscale as j_colscale
from cgr_mpnn_3d_tpu_torch.data import to_device
from cgr_mpnn_3d_tpu_torch.models import (CGRMPNN, CGRMPNNConfig, apply,
                                          init_params, jax_leaf_names,
                                          kernel_inputs, params_from_jax)
from cgr_mpnn_3d_tpu_torch.ops import kernel_math, segment
from cgr_mpnn_3d_tpu_torch.ops.fused_model import (fused_model_forward,
                                                   fused_model_forward_ref)

from test_reference_goldens import GOLDENS, TOL, _pack, _rebuild

SMILES = ["CCO>>CC=O", "CC(=O)N>>CC(=O)N", "C=CC=C>>C=CC=C",
          "CCO>C>CCO", "O>C>CO", "N>C>CN", "CC>>CC",
          "[N:1]([H:2])([H:3])[H:4]>>[N:1]([H:2])[H:3].[H:4]"]
LABELS = [float(i) for i in range(len(SMILES))]
KACT = {"ReLU": "relu", "SiLU": "silu", "GELU": "gelu"}


@pytest.fixture(scope="module")
def packed():
    graphs = [RxnGraph(s).arrays for s in SMILES]
    spec = plan_spec(graphs, te=64, tn=32, tb=8).with_packs(2)
    batch = pack_graphs(graphs, LABELS, spec)
    return spec, batch, to_device(batch, "cpu")


def _kw(depth=3, act="ReLU", aggr="add", pooling="add", learnable=False):
    return dict(num_node_features=78, num_edge_features=14, depth=depth,
                hidden_sizes=(16,) * depth, dropout_ps=(0.0,) * depth,
                activation=act, aggr=aggr, pooling=pooling,
                use_learnable_skip=learnable)


def _models(seed, skips=None, **kw):
    """(JAX params, port model with the same weights)."""
    params = jm.init_params(jax.random.PRNGKey(seed), jm.CGRMPNNConfig(**kw))
    if skips is not None:
        params["skip_weights"] = [jnp.asarray(v) for v in skips]
    model = CGRMPNN(CGRMPNNConfig(**kw))
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, model


def _close(a, b, msg="", **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               **(tol or TOL), err_msg=msg)


# -- ops --------------------------------------------------------------------

@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_segment_ops_match_jax(packed, aggr):
    _, b, tb = packed
    rng = np.random.default_rng(0)
    h = rng.standard_normal((b.senders.shape[0], 5)).astype(np.float32)
    hn = rng.standard_normal((b.node_x.shape[0], 5)).astype(np.float32)
    norm = (rng.uniform(0.2, 1.0, b.senders.shape[0]).astype(np.float32)
            if aggr == "mean" else np.ones(b.senders.shape[0], np.float32))
    th, thn = torch.from_numpy(h), torch.from_numpy(hn)
    _close(segment.gather_nodes(torch.from_numpy(b.node_x), tb.senders),
           jseg.gather_nodes(b.node_x, b.senders, b.node_out))
    _close(segment.dmpnn_messages(th, tb.edge_nbr, tb.rev,
                                  torch.from_numpy(norm)),
           jseg.dmpnn_messages(h, b.edge_nbr, b.rev, b.edge_nbr_rev, norm))
    _close(segment.node_incoming_sum(th, tb.node_inc),
           jseg.node_incoming_sum(h, b.node_inc, b.receivers))
    _close(segment.graph_pool_sum(thn, tb.graph_nodes),
           jseg.graph_pool_sum(hn, b.graph_nodes, b.graph_of_node))


@pytest.mark.parametrize("name", ["relu", "silu", "gelu"])
def test_k_act_matches_jax(name):
    x = np.linspace(-12.0, 12.0, 4001, dtype=np.float32)
    # erf vs the JAX kernel's Abramowitz-Stegun erf: within f32 epsilon
    _close(kernel_math.k_act(name, torch.from_numpy(x)),
           j_k_act(name, jnp.asarray(x)), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        kernel_math.k_act("tanh", torch.from_numpy(x))


def test_mean_colscale_matches_jax():
    rng = np.random.default_rng(1)
    valid = rng.random((40, 6)) < 0.4
    onehot_cols = valid.T.astype(np.float32)        # [D, R]: colsum = degree
    want = np.asarray(j_colscale(jnp.asarray(onehot_cols), jnp.float32))
    got = kernel_math.mean_colscale(torch.from_numpy(valid))
    _close(onehot_cols * got.numpy()[None, :], want)


# -- model ------------------------------------------------------------------

CASES = [("ReLU", "add", "add", None), ("SiLU", "add", "add", None),
         ("GELU", "add", "add", None), ("ReLU", "mean", "add", None),
         ("SiLU", "mean", "mean", None), ("ReLU", "add", "mean", None),
         ("GELU", "mean", "mean", (0.8, -0.3, 1.2)),
         ("ReLU", "add", "add", (1.0, 0.4, -0.6))]


@pytest.mark.parametrize("act,aggr,pooling,skips", CASES)
def test_apply_capture_matches_jax_per_layer(packed, act, aggr, pooling,
                                             skips):
    _, b, tb = packed
    kw = _kw(act=act, aggr=aggr, pooling=pooling,
             learnable=skips is not None)
    params, model = _models(3, skips, **kw)
    out_j, acts_j = jm.apply(params, b, jm.CGRMPNNConfig(**kw), capture=True)
    with torch.no_grad():
        out_t, acts_t = apply(model, tb, capture=True)
        out_plain = apply(model, tb)
    assert set(acts_t) == set(acts_j)
    for k in acts_j:
        _close(acts_t[k], acts_j[k], k)
    mask = b.graph_mask > 0
    _close(out_t.numpy()[mask], np.asarray(out_j)[mask], "preds")
    _close(out_plain, out_t, "capture=False")


@pytest.mark.skipif(not GOLDENS.exists(), reason="goldens not vendored")
@pytest.mark.parametrize("case", [
    "synth_defaults_relu", "synth_flagship_d4", "synth_gelu_skip",
    "synth_silu_mean", "synth_relu_meanpool", "demo_flagship",
    "demo_defaults", "demo_3d_skip"])
def test_per_layer_matches_reference_goldens(case):
    """The loop of tests/test_reference_goldens.py through the port."""
    with np.load(GOLDENS, allow_pickle=True) as z:
        params, graphs, jcfg, gold = _rebuild(z, case)
    batch, E, N, B = _pack(graphs)
    cfg = CGRMPNNConfig(
        num_node_features=jcfg.num_node_features,
        num_edge_features=jcfg.num_edge_features, depth=jcfg.depth,
        hidden_sizes=jcfg.hidden_sizes, dropout_ps=jcfg.dropout_ps,
        activation=jcfg.activation, aggr=jcfg.aggr, pooling=jcfg.pooling,
        use_learnable_skip=jcfg.use_learnable_skip)
    model = CGRMPNN(cfg)
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        out, acts = apply(model, to_device(batch, "cpu"), capture=True)
    _close(acts["h0"][:E], gold["h0"], f"{case}: h0")
    for l in range(cfg.depth):
        _close(acts[f"h_{l}"][:E], gold[f"h_{l}"], f"{case}: h_{l}")
    _close(acts["s"][:N], gold["s"], f"{case}: s")
    _close(acts["h_node"][:N], gold["h_node"], f"{case}: h_node")
    _close(acts["pooled"][:B], gold["pooled"], f"{case}: pooled")
    _close(out[:B], gold["preds"], f"{case}: preds")


@pytest.mark.parametrize("q,act,aggr,pooling,skips", [
    (1, "ReLU", "add", "add", None), (2, "ReLU", "add", "add", None),
    (1, "SiLU", "add", "add", None), (1, "GELU", "add", "add", None),
    (1, "ReLU", "mean", "add", None), (2, "SiLU", "mean", "add", None),
    (1, "ReLU", "add", "mean", None), (2, "ReLU", "mean", "mean", None),
    (1, "GELU", "mean", "mean", (0.8, -0.3, 1.2))])
def test_kernel_plain_version_matches_interpret_k3f(packed, q, act, aggr,
                                                    pooling, skips):
    """fused_model_forward_ref against the JAX whole-model kernel (K3f)
    in interpret mode; masked slots only."""
    spec, b, tb = packed
    kw = _kw(act=act, aggr=aggr, pooling=pooling,
             learnable=skips is not None)
    params, model = _models(0, skips, **kw)
    cfg_m = jm.CGRMPNNConfig(**kw, use_pallas=True, pallas_interpret=True,
                             pallas_sub_packs=q)
    want = np.asarray(jm.apply(params, b, cfg_m, spec))
    with torch.no_grad():
        args = kernel_inputs(model, tb)
        kkw = dict(p=spec.p, act=KACT[act], aggr=aggr, pooling=pooling)
        got = fused_model_forward_ref(*args, **kkw)
        # on CPU tensors the wrapper is the plain version
        _close(fused_model_forward(*args, **kkw), got, "wrapper")
    mask = b.graph_mask > 0
    _close(got.numpy()[mask], want[mask])


def test_kernel_plain_version_skips_out_of_pack_indices(packed):
    """An index into another pack counts as absent (a never-matching
    one-hot column on the TPU): moving a real edge's neighbour id into
    the other pack changes its messages exactly as dropping it does."""
    spec, b, tb = packed
    params, model = _models(0, **_kw())
    te = spec.te
    e = int(np.nonzero((b.edge_nbr[:te] < te).sum(1) >= 2)[0][0])
    moved, dropped = b.edge_nbr.copy(), b.edge_nbr.copy()
    moved[e, 0] = b.edge_nbr[e, 0] + te          # a row of pack 1
    dropped[e, 0] = b.edge_nbr.shape[0]          # the sentinel
    kkw = dict(p=spec.p, act="relu", aggr="mean", pooling="add")
    with torch.no_grad():
        outs = []
        for nbr in (moved, dropped):
            args = list(kernel_inputs(model, tb))
            args[3] = torch.from_numpy(nbr)
            outs.append(fused_model_forward_ref(*args, **kkw))
    _close(outs[0], outs[1], rtol=0, atol=0)


def test_kernel_wrapper_checks(packed):
    spec, b, tb = packed
    _, model = _models(0, **_kw())
    args = kernel_inputs(model, tb)
    kkw = dict(p=spec.p, act="relu", aggr="add", pooling="add")
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="eval only"):
            fused_model_forward(*args, **kkw, train=True)
        with pytest.raises(ValueError, match="activation"):
            fused_model_forward(*args, **{**kkw, "act": "tanh"})
        with pytest.raises(ValueError, match="split into p=3"):
            fused_model_forward(*args, **{**kkw, "p": 3})
        bad = list(args)
        bad[7] = bad[7][:-1]                      # wx one row short
        with pytest.raises(ValueError, match="wx has shape"):
            fused_model_forward(*bad, **kkw)


def test_init_bounds_and_generator():
    cfg = CGRMPNNConfig(**_kw(learnable=True))
    a = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    c = init_params(cfg, torch.Generator().manual_seed(8), "cpu")
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        if name.startswith("skip_weights"):
            assert float(pa) == 1.0
            continue
        assert not torch.equal(pa, pc), name
        fan_in = {"edge_init": 78 + 14, "edge_to_node": 78 + 16}.get(
            name.split(".")[0], 16)
        assert float(pa.abs().max()) <= 1.0 / np.sqrt(fan_in)
    assert a.edge_init.w.shape == (92, 16) and a.ffn.w.shape == (16, 1)


def test_leaf_order_matches_jax_pytree():
    """jax_leaf_names is the JAX pytree's flatten order, so checkpoint
    leaves line up one to one."""
    kw = _kw(learnable=True)
    params = jm.init_params(jax.random.PRNGKey(0), jm.CGRMPNNConfig(**kw))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    model = CGRMPNN(CGRMPNNConfig(**kw))
    model.load_state_dict(params_from_jax(params))
    state = model.state_dict()
    names = jax_leaf_names(model.cfg)
    assert len(names) == len(flat) == len(state)
    for name, (path, leaf) in zip(names, flat):
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(leaf),
                                      err_msg=f"{name} vs "
                                              f"{jax.tree_util.keystr(path)}")
