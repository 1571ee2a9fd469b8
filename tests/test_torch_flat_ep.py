"""The flat edge-partition layout of the port
(``cgr_mpnn_3d_tpu_torch/parallel/edge_partition.py``, ``ep_loader.EPLoader``,
``ops/segment.py::flat_op``) against the JAX package's on the CPU:

* ``shard_edges`` equal to JAX's, every field ``array_equal``, at n_ep 2,
  4 and 8 (pinned sizes, descriptor columns, the 480-atom chain over 8
  shards); ``EPOverflow`` on each pin and the odd-edge ``ValueError``; the
  vectorised speed at ~100k edges;
* the lockstep flat forward against JAX's ``ep_forward`` under
  ``shard_map`` (jitted), add and mean aggregation, at rtol/atol 1e-4, and
  the SSE and gradients against ``jax.value_and_grad`` of the same sharded
  SSE at 1e-5 relative; bf16 against JAX's bf16 flat forward; mean pooling
  and shard-count invariance against the port's single-device model;
* the train step over [n_dp][n_ep] against JAX's ``make_ep_train_step``;
  the all-sentinel filler; hash dropout; the op and backward counts that
  make the planned K7 launches;
* ``EPLoader`` items bit for bit with JAX's on the demo set (n_dp 2, n_ep
  2, shuffled and reused) and its pin growth; ``EPPackLoader`` on the
  shared base;
* two gloo ranks, one flat shard a rank: SSE bit for bit and gradients
  within 1e-5 of the lockstep run.

The file is also the ranks' program: ``python tests/test_torch_flat_ep.py
'<json>'`` runs one rank (:func:`_child`), which imports nothing of JAX.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu_torch.data.synthetic import chain_graph, synthetic_graphs
from cgr_mpnn_3d_tpu_torch.models import CGRMPNN, CGRMPNNConfig
from cgr_mpnn_3d_tpu_torch.ops import segment
from cgr_mpnn_3d_tpu_torch.parallel import edge_partition as tflat
from cgr_mpnn_3d_tpu_torch.parallel import ep_pack as tep
from cgr_mpnn_3d_tpu_torch.parallel.ep_loader import (EPLoader,
                                                      empty_ep_batch_like,
                                                      natural_ep_pins)

REPO = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve()
NF, FE = 20, 14
DEPTH, HIDDEN = 2, 16
TOL = dict(rtol=1e-4, atol=1e-4)
CHILD_TIMEOUT = 180


def _wired(seed=11, big=120):
    rng = np.random.default_rng(seed)
    graphs = [chain_graph(big, rng, NF), chain_graph(33, rng, NF)] + \
        synthetic_graphs(6, rng, node_feat_dim=NF)
    return graphs, [0.7 * i - 2.0 for i in range(len(graphs))]


def _wide(seed=13, n=64, pairs=96):
    """A random graph of ``n`` nodes and ``pairs`` random edge pairs (wide
    boundaries under any node split) and six small graphs."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, pairs)
    v = (u + rng.integers(1, n, pairs)) % n
    send = np.stack([u, v], 1).reshape(-1).astype(np.int32)
    recv = np.stack([v, u], 1).reshape(-1).astype(np.int32)
    g = type(chain_graph(2, rng, NF))(
        rng.normal(size=(n, NF)).astype(np.float32),
        rng.normal(size=(2 * pairs, FE)).astype(np.float32), send, recv,
        np.arange(2 * pairs, dtype=np.int32) ^ 1)
    graphs = [g] + synthetic_graphs(6, rng, node_feat_dim=NF)
    return graphs, [0.5 * i - 1.0 for i in range(len(graphs))]


def _small(seed=3):
    rng = np.random.default_rng(seed)
    graphs = synthetic_graphs(12, rng, node_feat_dim=NF)
    return graphs, [0.3 * i for i in range(len(graphs))]


def _chain480():
    """tests/test_parallel.py's giant graph: 480 atoms, degree at most 3."""
    rng = np.random.default_rng(0)
    g = synthetic_graphs(1, rng, node_feat_dim=NF, min_atoms=480,
                         max_atoms=480, max_degree=3)[0]
    return [g], [1.0]


def _case(case):
    return {"wired": _wired, "wide": _wide, "small": _small,
            "chain480": _chain480}[case]()


def _jax():
    """The JAX modules the references need (imported here, not at module
    level: the file is also the ranks' program)."""
    import types

    import jax
    import jax.numpy as jnp

    from cgr_mpnn_3d_tpu.models import CGRMPNNConfig as JConfig
    from cgr_mpnn_3d_tpu.models import init_params
    from cgr_mpnn_3d_tpu.parallel import P, make_mesh
    from cgr_mpnn_3d_tpu.parallel import edge_partition as jflat
    from cgr_mpnn_3d_tpu.parallel import ep_loader as jloader
    return types.SimpleNamespace(jax=jax, jnp=jnp, JConfig=JConfig,
                                 init_params=init_params, P=P,
                                 make_mesh=make_mesh, flat=jflat,
                                 loader=jloader)


def _assert_same(bj, bt):
    assert type(bt)._fields == type(bj)._fields
    for f in type(bt)._fields:
        a, b = getattr(bt, f), getattr(bj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("case,n_ep,pinned,extra", [
    ("small", 2, False, False), ("small", 4, True, True),
    ("wired", 2, False, True), ("wired", 4, True, False),
    ("wide", 8, False, False), ("chain480", 8, False, False),
    ("chain480", 4, True, False)])
def test_shard_edges_equals_jax(case, n_ep, pinned, extra):
    j = _jax()
    graphs, labels = _case(case)
    kw = {}
    if extra:
        rng = np.random.default_rng(7)
        kw["extra_node_feats"] = [rng.normal(size=(g.num_nodes, 3)).astype(
            np.float32) for g in graphs]
    bt = tflat.shard_edges(graphs, labels, n_ep, **kw)
    bj = j.flat.shard_edges(graphs, labels, n_ep, **kw)
    _assert_same(bj, bt)
    if case == "chain480":
        # each shard holds a share of the edges and of the nodes
        g = graphs[0]
        assert bt.edge_attr.shape[1] < g.num_edges // (n_ep // 2 + 1)
    if pinned:
        pins = {k: v + 8 for k, v in natural_ep_pins(bt).items()}
        _assert_same(j.flat.shard_edges(graphs, labels, n_ep, **pins, **kw),
                     tflat.shard_edges(graphs, labels, n_ep, **pins, **kw))


@pytest.mark.parametrize("pin", ["nk", "ek", "s_max", "d", "d_out",
                                 "d_recv", "dn"])
def test_shard_edges_overflow_is_typed(pin):
    """Every pin below the batch's natural size raises EPOverflow (the
    loaders' only growth signal), as JAX's does."""
    j = _jax()
    graphs, labels = _wide()
    small = {pin: 1}
    with pytest.raises(tflat.EPOverflow):
        tflat.shard_edges(graphs, labels, 8, **small)
    with pytest.raises(j.flat.EPOverflow):
        j.flat.shard_edges(graphs, labels, 8, **small)


def test_shard_edges_refuses_odd_edge_counts():
    graphs, labels = _small()
    g = graphs[0]
    odd = type(g)(g.node_feats, g.edge_feats[:-1], g.senders[:-1],
                  g.receivers[:-1], g.rev_edge_index[:-1])
    with pytest.raises(ValueError, match="even") as e:
        tflat.shard_edges([odd] + graphs[1:], labels, 2)
    assert not isinstance(e.value, tflat.EPOverflow)


def test_shard_edges_vectorized_speed():
    """~100k directed edges shard in well under a second (best of 3), as
    JAX's tests/test_parallel.py holds its copy."""
    rng = np.random.default_rng(0)
    graphs = synthetic_graphs(2500, rng)
    E = sum(g.num_edges for g in graphs)
    assert E > 90_000
    dt = float("inf")
    for _ in range(3):
        t0 = time.time()
        b = tflat.shard_edges(graphs, [0.0] * len(graphs), n_ep=8)
        dt = min(dt, time.time() - t0)
    NKH = b.node_x.shape[1]
    assert sum(int((b.src_idx[k] < NKH).sum()) for k in range(8)) == E
    assert dt < 1.0, f"shard_edges took {dt:.2f}s at {E} edges"


# ---------------------------------------------------------------------------
# the flat forward and step against JAX's ep_forward
# ---------------------------------------------------------------------------

def _cfgs(aggr="add", pooling="add", skip=False, act="ReLU",
          dtype="float32"):
    j = _jax()
    jcfg = j.JConfig(num_node_features=NF, num_edge_features=FE, depth=DEPTH,
                     hidden_sizes=(HIDDEN,) * DEPTH,
                     dropout_ps=(0.0,) * DEPTH, activation=act, aggr=aggr,
                     pooling=pooling, use_learnable_skip=skip,
                     compute_dtype=getattr(j.jnp, dtype))
    tcfg = CGRMPNNConfig(num_node_features=NF, num_edge_features=FE,
                         depth=DEPTH, hidden_sizes=(HIDDEN,) * DEPTH,
                         dropout_ps=(0.0,) * DEPTH, activation=act,
                         aggr=aggr, pooling=pooling, use_learnable_skip=skip,
                         fuse_whole_model=False, compute_dtype=dtype)
    return jcfg, tcfg


def _params(jcfg, seed=2):
    j = _jax()
    params = j.init_params(j.jax.random.PRNGKey(seed), jcfg)
    if jcfg.use_learnable_skip:
        params["skip_weights"] = [j.jnp.asarray(0.6 + 0.3 * l, j.jnp.float32)
                                  for l in range(jcfg.depth)]
    return params


def _jax_flat(b, params, jcfg, n_ep):
    """(sse, preds, grads) of JAX's ep_forward under shard_map, jitted, and
    jax.value_and_grad of the sharded SSE."""
    from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import params_from_jax
    j = _jax()
    mesh = j.make_mesh(n_dp=1, n_ep=n_ep, devices=j.jax.devices()[:n_ep])
    pspec = j.jax.tree_util.tree_map(lambda _: j.P("ep"),
                                     j.flat.EdgeShardedBatch(*[0] * 14))

    def loss(params, bb):
        def f(p, bl):
            local = j.jax.tree_util.tree_map(lambda v: v[0], bl)
            sse, preds = j.flat.ep_forward(p, local, jcfg, axis="ep")
            return j.jax.lax.psum(sse / n_ep, "ep"), preds

        return j.jax.shard_map(f, mesh=mesh, in_specs=(j.P(), pspec),
                               out_specs=(j.P(), j.P()),
                               check_vma=False)(params, bb)

    bj = j.flat.EdgeShardedBatch(*b)
    (sse, preds), grads = j.jax.jit(j.jax.value_and_grad(
        loss, has_aux=True))(params, bj)
    return float(sse), np.asarray(preds), params_from_jax(grads)


def _port_flat(b, model, seeds=None):
    model.zero_grad(set_to_none=True)
    shards = tflat.flat_shards(b, "cpu")
    sse, preds = tflat.ep_forward(model, shards, train=seeds is not None,
                                  seeds=seeds)
    sse.backward()
    grads = {k: v.grad.clone() for k, v in model.named_parameters()}
    return float(sse.detach()), preds.detach().numpy(), grads


def _rel(got: dict, want: dict) -> float:
    """max |got - want| over every gradient leaf, over the largest |want|
    of them all."""
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    return max(float(np.abs(np.asarray(got[k], np.float64)
                            - np.asarray(want[k], np.float64)).max())
               for k in want) / top


@pytest.mark.parametrize("case,n_ep,aggr,skip,act", [
    ("wired", 2, "add", False, "ReLU"), ("wired", 4, "mean", True, "SiLU"),
    ("wide", 4, "add", True, "GELU"), ("wide", 8, "mean", False, "ReLU"),
    ("small", 2, "mean", True, "ReLU")])
def test_flat_forward_and_grads_match_jax(case, n_ep, aggr, skip, act):
    from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import params_from_jax
    graphs, labels = _case(case)
    jcfg, tcfg = _cfgs(aggr, "add", skip, act)
    params = _params(jcfg)
    b = tflat.shard_edges(graphs, labels, n_ep)
    sse_j, preds_j, grads_j = _jax_flat(b, params, jcfg, n_ep)
    model = CGRMPNN(tcfg)
    model.load_state_dict(params_from_jax(params))
    sse_t, preds_t, grads_t = _port_flat(b, model)
    np.testing.assert_allclose(preds_t, preds_j, **TOL)
    np.testing.assert_allclose(sse_t, sse_j, rtol=1e-5)
    assert _rel(grads_t, grads_j) < 1e-5


def test_flat_bf16_matches_jax():
    """At bf16 the linears' operands are rounded and every gather and sum
    stays f32, as JAX's flat ``_linear``: the port equals JAX's bf16 run
    far inside the f32-oracle bounds."""
    from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import params_from_jax
    graphs, labels = _wired()
    jcfg, tcfg = _cfgs("mean", "add", True, dtype="bfloat16")
    params = _params(jcfg)
    b = tflat.shard_edges(graphs, labels, 4)
    sse_j, preds_j, grads_j = _jax_flat(b, params, jcfg, 4)
    model = CGRMPNN(tcfg)
    model.load_state_dict(params_from_jax(params))
    sse_t, preds_t, grads_t = _port_flat(b, model)
    np.testing.assert_allclose(preds_t, preds_j, rtol=1e-3, atol=1e-3)
    assert _rel(grads_t, grads_j) < 1e-3
    # and the f32 run differs: the rounding is really there
    model32 = CGRMPNN(dataclasses.replace(tcfg, compute_dtype="float32"))
    model32.load_state_dict(model.state_dict())
    _, preds32, _ = _port_flat(b, model32)
    assert np.abs(preds32 - preds_t).max() > 1e-5


def _single_device(graphs, labels, model):
    """The port's single-device model (plain gather ops) -> (sse, preds)."""
    from cgr_mpnn_3d_tpu_torch.data import pack_graphs, packs_needed, \
        plan_spec
    from cgr_mpnn_3d_tpu_torch.models import apply
    spec = plan_spec(graphs, te=1024, tn=512, tb=len(graphs))
    spec = spec.with_packs(packs_needed(graphs, spec, fill_target=0.6) + 2)
    b = pack_graphs(graphs, labels, spec)
    preds = apply(model, type(b)(*(torch.as_tensor(a) for a in b)))
    mask = b.graph_mask.astype(bool)
    out = np.empty(len(graphs), np.float32)
    out[b.row_ids[mask]] = preds.detach().numpy()[mask]
    return float(((out - np.asarray(labels)) ** 2).sum()), out


@pytest.mark.parametrize("aggr,pooling", [("add", "add"), ("mean", "mean"),
                                          ("add", "mean")])
def test_shard_count_invariance_and_single_device(aggr, pooling):
    """n_ep = 1, 2, 4, 8 give the single-device model's predictions and
    loss (mean pooling included, which JAX's flat forward lacks)."""
    graphs, labels = _wired()
    _, tcfg = _cfgs(aggr, pooling, skip=True)
    model = CGRMPNN(tcfg, torch.Generator().manual_seed(4))
    sse1, preds1 = _single_device(graphs, labels, model)
    for n_ep in (1, 2, 4, 8):
        b = tflat.shard_edges(graphs, labels, n_ep)
        sse, preds, _ = _port_flat(b, model)
        np.testing.assert_allclose(preds, preds1, **TOL)
        np.testing.assert_allclose(sse, sse1, **TOL)


def test_train_step_matches_jax_make_ep_train_step():
    """make_ep_train_step over [n_dp 2][n_ep 2]: its SSE equals JAX's
    make_ep_train_step's on the same stacked batch, and its gradients the
    sum over the groups of jax.value_and_grad of each group's sharded SSE.
    JAX's step (SGD at lr 1, so its update is its gradient) applies n_ep
    times that gradient: each shard's psum transposes to a psum of the
    cotangents, and the gradients are summed over 'ep' again (Adam, the
    trainer's optimizer, does not see a constant factor)."""
    import optax

    from cgr_mpnn_3d_tpu.train.trainer import TrainState
    from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import params_from_jax
    j = _jax()
    graphs, labels = _wired()
    half = len(graphs) // 2
    jcfg, tcfg = _cfgs("mean", "add", True)
    params = _params(jcfg)
    parts = [(graphs[:half], labels[:half]), (graphs[half:], labels[half:])]
    nat = [natural_ep_pins(tflat.shard_edges(g, lab, 2)) for g, lab in parts]
    pins = {k: max(n[k] for n in nat) for k in nat[0]}
    batches = [tflat.shard_edges(g, lab, 2, **pins) for g, lab in parts]
    stacked = type(batches[0])(*(np.stack(f) for f in zip(*batches)))
    mesh = j.make_mesh(n_dp=2, n_ep=2, devices=j.jax.devices()[:4])
    opt = optax.sgd(1.0)
    step = j.flat.make_ep_train_step(opt, jcfg, mesh)
    state = TrainState(params, opt.init(params), j.jnp.zeros((), j.jnp.int32),
                       j.jax.random.PRNGKey(1))
    new, loss = step(state, j.flat.EdgeShardedBatch(*stacked))
    update = {k: (v.numpy() - params_from_jax(new.params)[k].numpy()) / 2
              for k, v in params_from_jax(params).items()}
    per_group = [_jax_flat(b, params, jcfg, 2) for b in batches]
    want = {k: sum(g[2][k].numpy() for g in per_group) for k in update}
    model = CGRMPNN(tcfg)
    model.load_state_dict(params_from_jax(params))
    groups = [tflat.flat_shards(b, "cpu") for b in batches]
    sse = tflat.make_ep_train_step(model)(groups)
    np.testing.assert_allclose(float(sse), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(sse), sum(g[0] for g in per_group),
                               rtol=1e-5)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert _rel(got, want) < 1e-5
    assert _rel(update, want) < 1e-5
    # the eval step: the summed SSE and both groups' predictions
    sse_e, preds = tflat.make_ep_eval_step(model)(groups)
    np.testing.assert_allclose(float(sse_e), float(sse), rtol=1e-6)
    assert preds.shape == (2 * half,)


def test_filler_is_exact_zero_and_dropout_is_seeded():
    graphs, labels = _wired()
    b = tflat.shard_edges(graphs, labels, 2)
    _, cfg = _cfgs("mean", "mean", skip=True)
    model = CGRMPNN(dataclasses.replace(cfg, dropout_ps=(0.2,) * DEPTH),
                    torch.Generator().manual_seed(1))
    sse, _, grads = _port_flat(empty_ep_batch_like(b), model)
    assert sse == 0.0
    assert all(float(g.abs().max()) == 0.0 for g in grads.values())
    seeds = torch.tensor([[7, 11], [5, 3]], dtype=torch.int32)
    a = _port_flat(b, model, seeds)
    again = _port_flat(b, model, seeds)
    other = _port_flat(b, model, seeds + 1)
    plain = _port_flat(b, model)
    assert a[0] == again[0] and np.array_equal(a[1], again[1])
    assert a[0] != other[0] and a[0] != plain[0]


def test_flat_ops_make_the_planned_launches(monkeypatch):
    """Every gather and partial sum of the flat forward goes through
    ``segment.flat_op`` with prepared int32 ELL arrays: 5·depth + 4 ops a
    shard and forward, 5·depth + 3 of them on a source that takes a
    gradient (K7 backward launches on the card), as ``flat_launches``
    plans."""
    calls = []
    real = segment.flat_op

    def counting(op, src, idx, idx_bwd):
        assert idx.dtype == idx_bwd.dtype == torch.int32
        assert idx.dim() == idx_bwd.dim() == 2 and idx.is_contiguous()
        assert idx_bwd.shape[0] == src.shape[0]
        calls.append((op, src.requires_grad))
        return real(op, src, idx, idx_bwd)

    monkeypatch.setattr(tflat, "flat_op", counting)
    graphs, labels = _wired()
    b = tflat.shard_edges(graphs, labels, 2)
    _, cfg = _cfgs()
    model = CGRMPNN(cfg, torch.Generator().manual_seed(1))
    _port_flat(b, model)
    assert len(calls) == 2 * tflat.flat_launches(DEPTH, False)
    assert 2 * tflat.flat_launches(DEPTH, True) == len(calls) + sum(
        g for _, g in calls)
    assert {op for op, _ in calls} == set(segment.FLAT_OPS)


def test_flat_op_has_no_other_route():
    src = torch.randn(5, 3)
    idx = segment.flat_ell(torch.tensor([0, 4, 5, 2]))
    out = segment.flat_op("t", src, idx, segment.flat_ell(torch.zeros(5)))
    np.testing.assert_array_equal(out[2].numpy(), np.zeros(3))
    np.testing.assert_array_equal(out[1].numpy(), src[4].numpy())
    with pytest.raises(ValueError, match="unsupported device"):
        segment.flat_op("t", src.to("meta"), idx, idx)


def test_all_to_all_is_its_own_adjoint():
    bufs = [torch.randn(3, 2, 4, dtype=torch.float64, requires_grad=True)
            for _ in range(3)]
    out = tep.all_to_all(bufs)
    for k in range(3):
        for jj in range(3):
            assert torch.equal(out[k][jj], bufs[jj][k])
    gs = [torch.randn(3, 2, 4, dtype=torch.float64) for _ in range(3)]
    torch.autograd.backward(out, gs)
    back = tep.all_to_all(gs)
    for b, g in zip(bufs, back):
        assert torch.equal(b.grad, g)


# ---------------------------------------------------------------------------
# EPLoader
# ---------------------------------------------------------------------------

class _FakeDataset:
    """A ChemDataset stand-in: small graphs, then one giant chain."""

    def __init__(self, seed=11):
        rng = np.random.default_rng(seed)
        self.graphs = synthetic_graphs(15, rng, node_feat_dim=NF) + \
            [chain_graph(200, rng, NF)]
        self.labels = np.arange(len(self.graphs), dtype=np.float32)
        self.use_npz = False
        self.num_edge_features = FE
        self.num_node_features = NF

    def __len__(self):
        return len(self.graphs)

    def graph(self, i):
        return self.graphs[i]


@pytest.fixture(scope="module")
def demo_ds():
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset
    return ChemDataset(str(REPO / "examples" / "demo.csv"))


def test_ep_loader_equals_jax_on_the_demo_set(demo_ds):
    """Items bit for bit with the JAX EPLoader's (n_dp 2, n_ep 2): shuffled
    over two epochs, and reused (the cache in JAX's shuffled order)."""
    j = _jax()
    from cgr_mpnn_3d_tpu.data import ChemDataset as JDataset
    jds = JDataset(str(REPO / "examples" / "demo.csv"))
    for reuse in (False, True):
        kw = dict(n_ep=2, batch_size=3, n_dp=2, shuffle=True, seed=5,
                  prescan_batches=2, reuse_packs=reuse)
        lt = EPLoader(demo_ds, **kw)
        lj = j.loader.EPLoader(jds, **kw)
        assert lt.pins == lj.pins
        for epoch in (0, 1):
            lt.set_epoch(epoch)
            lj.set_epoch(epoch)
            got, want = list(lt.prefetch()), list(lj)
            assert len(got) == len(want) == len(lt)
            for bt, bj in zip(got, want):
                assert bt.node_x.shape[:2] == (2, 2)
                _assert_same(bj, bt)


def test_ep_loader_grows_pins_as_jax_does():
    """A mid-epoch overflow (the giant chain) grows the pins and shards the
    group again; every item equals the JAX loader's, at one group and at
    three (the last group's missing batches the all-sentinel filler)."""
    j = _jax()
    for n_dp in (1, 3):
        kw = dict(n_ep=4, batch_size=4, n_dp=n_dp, shuffle=False, seed=3,
                  prescan_batches=1)
        lt = EPLoader(_FakeDataset(), **kw)
        first = dict(lt.pins)
        got = list(lt)
        lj = j.loader.EPLoader(_FakeDataset(), **kw)
        want = list(lj)
        assert lt.pins == lj.pins and lt.pins["nk"] > first["nk"]
        assert len(got) == len(want) == -(-4 // n_dp)
        for bt, bj in zip(got, want):
            _assert_same(bj, bt)
        if n_dp == 3:
            assert got[-1].graph_mask[1:].sum() == 0
    # pins pinned from the start: no prescan, no growth needed
    pinned = EPLoader(_FakeDataset(), n_ep=4, batch_size=4, shuffle=False,
                      pins=dict(lt.pins))
    assert pinned.pins == lt.pins
    for a, c in zip(pinned, EPLoader(_FakeDataset(), n_ep=4, batch_size=4,
                                     shuffle=False, pins=dict(lt.pins))):
        _assert_same(a, c)


def test_ep_loader_item_through_the_flat_step():
    """An EPLoader item [n_dp, n_ep, ...] through make_ep_train_step: the
    summed SSE is the single-device model's on the same graphs."""
    ds = _FakeDataset()
    loader = EPLoader(ds, n_ep=2, batch_size=8, n_dp=2, shuffle=False,
                      prescan_batches=2)
    item = next(iter(loader))
    _, cfg = _cfgs("add", "add", skip=False)
    model = CGRMPNN(cfg, torch.Generator().manual_seed(3))
    groups = [tflat.flat_shards(type(item)(*(a[g] for a in item)), "cpu")
              for g in range(2)]
    sse = tflat.make_ep_train_step(model)(groups)
    want, _ = _single_device(ds.graphs, list(ds.labels), model)
    np.testing.assert_allclose(float(sse), want, rtol=1e-4)


# ---------------------------------------------------------------------------
# two gloo ranks, one flat shard a rank
# ---------------------------------------------------------------------------

def _rank_model(job) -> CGRMPNN:
    cfg = CGRMPNNConfig(num_node_features=NF, num_edge_features=FE,
                        depth=DEPTH, hidden_sizes=(HIDDEN,) * DEPTH,
                        dropout_ps=(0.1,) * DEPTH, aggr=job["aggr"],
                        pooling=job["pooling"], use_learnable_skip=True,
                        fuse_whole_model=False)
    return CGRMPNN(cfg, torch.Generator().manual_seed(5))


_SEEDS = [[[7, 11], [5, 3]]]


def _child(job: dict) -> None:
    """One rank: joins the gloo group, takes its shard of the wired batch
    and runs the flat train step (dropout on) with ``comm``; writes its SSE
    and gradients."""
    from cgr_mpnn_3d_tpu_torch.parallel import multihost
    multihost.initialize(job["init"], 2, job["rank"], timeout_s=60)
    lay = multihost.layout(1, 2)
    comm = multihost.ep_comm(lay)
    graphs, labels = _wired()
    b = tflat.shard_edges(graphs, labels, 2)
    shard = tflat.flat_shards(b, "cpu")[comm.shard]
    model = _rank_model(job)
    seeds = torch.tensor(_SEEDS, dtype=torch.int32)[:, comm.shard:
                                                    comm.shard + 1]
    sse = tflat.make_ep_train_step(model, comm)([[shard]], seeds)
    np.savez(job["out"], sse=float(sse), **{
        k: p.grad.numpy() for k, p in model.named_parameters()})


@pytest.mark.parametrize("aggr,pooling", [("add", "mean"), ("mean", "add")])
def test_two_ranks_equal_lockstep(tmp_path, aggr, pooling):
    procs, outs = [], []
    for r in range(2):
        out = tmp_path / f"rank{r}.npz"
        job = dict(init=f"file://{tmp_path / 'rdv'}", rank=r, out=str(out),
                   aggr=aggr, pooling=pooling)
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE), json.dumps(job)], cwd=str(REPO),
            env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    model = _rank_model(dict(aggr=aggr, pooling=pooling))
    graphs, labels = _wired()
    b = tflat.shard_edges(graphs, labels, 2)
    sse = tflat.make_ep_train_step(model)(
        [tflat.flat_shards(b, "cpu")], torch.tensor(_SEEDS, dtype=torch.int32))
    for p in procs:
        log, _ = p.communicate(timeout=CHILD_TIMEOUT)
        assert p.returncode == 0, log
    ranks = [np.load(o) for o in outs]
    # rank 0 holds the group's SSE, rank 1 adds zero: the lockstep bits
    assert ranks[0]["sse"] == ranks[1]["sse"] == float(sse)
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        for r in ranks:
            assert np.abs(r[name] - g).max() <= 1e-5 * np.abs(g).max(), name


if __name__ == "__main__":
    _child(json.loads(sys.argv[1]))
