"""Edge partitioning in the port (``cgr_mpnn_3d_tpu_torch/parallel/``)
against the JAX package's ``parallel/ep_pack.py`` on the CPU:

* the packer's output equals JAX's field for field (and its ELL arrays are
  JAX's transposed tables untransposed), EPOverflow and pin growth in the
  loader, whose items equal the JAX loader's;
* the EP forward and gradients, every shard in one process through the
  kernels' plain versions, against JAX's ``ep_pack_forward`` under
  ``shard_map`` on the conftest's CPU devices with the Pallas kernels in
  interpret mode, for n_ep in {1, 2, 4}, add and mean, wired and zero-cut,
  learnable skip (rtol/atol 1e-4);
* shard-count invariance and the single-device model's loss; the zero-cut
  one-kernel step against the autograd step; JAX weights carried in by
  ``params_from_jax``; the training CLI with ``--ep`` (also at bf16, with
  ``--ep_overlap``, with ``--ep_rdma`` and with ``--reuse_packs
  --device_epoch``) and its refusal of ``--dp``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu.data.synthetic import synthetic_graphs
from cgr_mpnn_3d_tpu.models import CGRMPNNConfig as JConfig
from cgr_mpnn_3d_tpu.models import init_params as jinit
from cgr_mpnn_3d_tpu.models.cgr_mpnn import apply as japply
from cgr_mpnn_3d_tpu.parallel import EPPackLoader as JLoader
from cgr_mpnn_3d_tpu.parallel import P, make_mesh
from cgr_mpnn_3d_tpu.parallel import ep_pack as jep
from cgr_mpnn_3d_tpu_torch.data import pack_graphs, packs_needed, plan_spec
from cgr_mpnn_3d_tpu_torch.data.synthetic import chain_graph
from cgr_mpnn_3d_tpu_torch.models import CGRMPNN, CGRMPNNConfig, apply
from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import params_from_jax
from cgr_mpnn_3d_tpu_torch.parallel import EPOverflow, EPPackLoader
from cgr_mpnn_3d_tpu_torch.parallel import ep_pack as tep

NF, FE = 20, 14
TOL = dict(rtol=1e-4, atol=1e-4)
SHARED = [f for f in tep.EPPackedBatch._fields if f in jep.EPPackedBatch._fields]


def _zero_cut(seed=3):
    rng = np.random.default_rng(seed)
    graphs = synthetic_graphs(24, rng, node_feat_dim=NF)
    return graphs, [0.3 * i for i in range(len(graphs))]


def _wired(seed=11, big=200):
    rng = np.random.default_rng(seed)
    graphs = [chain_graph(big, rng, NF), chain_graph(33, rng, NF)] + \
        synthetic_graphs(6, rng, node_feat_dim=NF)
    return graphs, [0.7 * i - 2.0 for i in range(len(graphs))]


def _wide(seed=13, n=64, pairs=96):
    """A random graph of ``n`` nodes and ``pairs`` random edge pairs (cut
    wide by any node split: many halo slots and wire rows) and six small
    graphs."""
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


def _case(case):
    return {"zero_cut": _zero_cut, "wired": _wired, "wide": _wide}[case]()


def _untranspose(t, p):
    """JAX's transposed table [p*Dp, R] back to the ELL array [p*R, Dp]."""
    d_pad = t.shape[0] // p
    return t.reshape(p, d_pad, -1).transpose(0, 2, 1).reshape(-1, d_pad)


def _assert_same_pack(bj, sj, bt, st):
    assert vars(sj) == vars(st)
    for f in SHARED:
        np.testing.assert_array_equal(getattr(bt, f), getattr(bj, f),
                                      err_msg=f)
    PE, PN = st.pe, st.pn
    for k in range(st.n_ep):
        # pool_ell is pool_t untransposed (its sentinel columns cut off)
        np.testing.assert_array_equal(
            _untranspose(bj.pool_t[k], st.p)[:, :st.dn], bt.pool_ell[k])
        # edge_nbr + rev are the message index rows of JAX's _msg_index_t
        local = jax.tree_util.tree_map(lambda v: jnp.asarray(v[k]), bj)
        _, msg_t = jep._msg_index_t(local, sj)
        msg = np.asarray(_untranspose(np.asarray(msg_t), st.p))
        valid = lambda a: np.where(a < PE, a, PE)  # noqa: E731
        np.testing.assert_array_equal(valid(msg[:, :st.d]),
                                      bt.edge_nbr[k][:, :st.d])
        np.testing.assert_array_equal(valid(msg[:, st.d]), bt.rev[k])
        # edge_nbr_rev is the exact transpose of edge_nbr
        fwd = {(e, int(c)) for e in range(PE) for c in bt.edge_nbr[k][e]
               if c < PE}
        bwd = {(int(e), c) for c in range(PE) for e in bt.edge_nbr_rev[k][c]
               if e < PE}
        assert fwd == bwd


@pytest.mark.parametrize("case,n_ep", [("zero_cut", 1), ("zero_cut", 2),
                                       ("zero_cut", 4), ("wired", 2),
                                       ("wired", 4), ("giant", 4),
                                       ("wide", 4)])
def test_packer_equals_jax(case, n_ep):
    if case == "giant":
        rng = np.random.default_rng(5)
        graphs = [chain_graph(480, rng, NF)] + synthetic_graphs(
            6, rng, node_feat_dim=NF)
        labels = [0.5 * i for i in range(len(graphs))]
    else:
        graphs, labels = _case(case)
    bj, sj = jep.pack_shard_edges(graphs, labels, n_ep, te=64, tn=32)
    bt, st = tep.pack_shard_edges(graphs, labels, n_ep, te=64, tn=32)
    assert any(st.caps) == (case != "zero_cut")
    _assert_same_pack(bj, sj, bt, st)
    # pinned at the natural spec: the same batch again
    bj2, _ = jep.pack_shard_edges(graphs, labels, n_ep, spec=sj)
    bt2, _ = tep.pack_shard_edges(graphs, labels, n_ep,
                                  spec=tep.EPPackSpec(**vars(sj)))
    _assert_same_pack(bj2, sj, bt2, st)
    assert tep.wire_bytes_per_layer(st, 32) == jep.wire_bytes_per_layer(
        sj, 32)


def test_overflow_is_typed_and_growable():
    graphs, labels = _zero_cut(9)
    _, nat = tep.pack_shard_edges(graphs[:12], labels[:12], 2, te=64, tn=32)
    tight = dataclasses.replace(nat, p=max(1, nat.p - 1))
    with pytest.raises(EPOverflow):
        tep.pack_shard_edges(graphs[:12], labels[:12], 2, spec=tight)
    bad = type(graphs[0])(np.zeros((2, NF), np.float32),
                          np.zeros((1, FE), np.float32),
                          np.array([0], np.int32), np.array([1], np.int32),
                          np.array([0], np.int32))
    with pytest.raises(ValueError) as ei:
        tep.pack_shard_edges([bad], [0.0], 2)
    assert not isinstance(ei.value, EPOverflow)
    empty = tep.empty_ep_pack_batch(nat, NF, FE)
    want = jep.empty_ep_pack_batch(jep.EPPackSpec(**vars(nat)), NF, FE)
    for f in SHARED:
        np.testing.assert_array_equal(getattr(empty, f), getattr(want, f))


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


def test_loader_matches_jax_and_grows_pins():
    """Mid-epoch overflow grows the spec (and packs the whole group again);
    every item carries the spec it was built under and equals the JAX
    loader's, shuffled or not, at one data-parallel group and at three (2
    items: the last group's two missing batches are the all-sentinel
    filler)."""
    for n_dp in (1, 3):
        for shuffle in (False, True):
            kw = dict(n_ep=4, batch_size=4, n_dp=n_dp, shuffle=shuffle,
                      seed=3, prescan_batches=1, te=64, tn=32)
            loader = EPPackLoader(_FakeDataset(), **kw)
            got = list(loader.prefetch())
            want = list(JLoader(_FakeDataset(), **kw))
            assert len(got) == len(want) == len(loader) == -(-4 // n_dp)
            for (st, bt), (sj, bj) in zip(got, want):
                assert vars(st) == vars(sj)
                assert bt.node_x.shape[:2] == (n_dp, 4)
                for f in SHARED:
                    np.testing.assert_array_equal(getattr(bt, f),
                                                  getattr(bj, f), err_msg=f)
            if not shuffle:
                assert got[-1][0].te > 64 and got[0][0].te == 64
            if n_dp == 3:
                assert got[-1][1].graph_mask[1:].sum() == 0
    # workers is accepted and packs serially: the items of one and of
    # several groups are the serial ones
    for n_dp in (1, 2):
        kw = dict(n_ep=4, batch_size=4, n_dp=n_dp, shuffle=True, seed=3,
                  prescan_batches=1, te=64, tn=32)
        for (sa, ba), (sb, bb) in zip(EPPackLoader(_FakeDataset(), **kw),
                                      EPPackLoader(_FakeDataset(), workers=2,
                                                   **kw).prefetch()):
            assert sa == sb
            for f in SHARED:
                np.testing.assert_array_equal(getattr(ba, f), getattr(bb, f))


def test_loader_reuse_packs_equals_the_jax_cache():
    """reuse_packs: the cache is built from the epoch-0 order, again
    while the pins grow (the giant chain grows them), so every item shares
    the final spec; it equals the JAX loader's cache item for item, and
    each epoch emits it in the JAX loader's shuffled order; a loader that
    starts at a later epoch builds the same items."""
    kw = dict(n_ep=4, batch_size=4, n_dp=1, shuffle=True, seed=9,
              prescan_batches=1, te=64, tn=32, reuse_packs=True)
    lt, lj = EPPackLoader(_FakeDataset(), **kw), JLoader(_FakeDataset(), **kw)
    for epoch in (0, 3):
        lt.set_epoch(epoch)
        lj.set_epoch(epoch)
        got, want = list(lt), list(lj)
        assert len(got) == len(want) == 4
        assert len({id(s) for s, _ in got}) == 1 and got[0][0].te > 64
        for (st, bt), (sj, bj) in zip(got, want):
            assert vars(st) == vars(sj)
            for f in SHARED:
                np.testing.assert_array_equal(getattr(bt, f),
                                              getattr(bj, f), err_msg=f)
    late = EPPackLoader(_FakeDataset(), **kw)
    late.set_epoch(3)
    for (sa, ba), (sb, bb) in zip(lt, late.prefetch()):
        assert sa == sb
        for f in SHARED:
            np.testing.assert_array_equal(getattr(ba, f), getattr(bb, f))


def _cfgs(aggr="add", pooling="add", skip=False, act="ReLU", depth=3):
    jcfg = JConfig(num_node_features=NF, num_edge_features=FE, depth=depth,
                   hidden_sizes=(32,) * depth, dropout_ps=(0.0,) * depth,
                   activation=act, aggr=aggr, pooling=pooling,
                   use_learnable_skip=skip, compute_dtype=jnp.float32,
                   use_pallas=True, pallas_interpret=True)
    tcfg = CGRMPNNConfig(num_node_features=NF, num_edge_features=FE,
                         depth=depth, hidden_sizes=(32,) * depth,
                         dropout_ps=(0.0,) * depth, activation=act,
                         aggr=aggr, pooling=pooling, use_learnable_skip=skip,
                         fuse_whole_model=False)
    return jcfg, tcfg


def _params(jcfg, seed=2):
    params = jinit(jax.random.PRNGKey(seed), jcfg)
    if jcfg.use_learnable_skip:
        params["skip_weights"] = [jnp.asarray(0.6 + 0.3 * l, jnp.float32)
                                  for l in range(jcfg.depth)]
    return params


def _jax_ep(graphs, labels, params, jcfg, n_ep):
    """(sse, preds, grads) of JAX's ep_pack_forward under shard_map."""
    b, espec = jep.pack_shard_edges(graphs, labels, n_ep, te=64, tn=32)
    mesh = make_mesh(n_dp=1, n_ep=n_ep, devices=jax.devices()[:n_ep])
    pspec = jax.tree_util.tree_map(lambda _: P("ep"), b)

    def loss(params, bb):
        def f(p, bl):
            local = jax.tree_util.tree_map(lambda v: v[0], bl)
            sse, preds = jep.ep_pack_forward(p, local, jcfg, espec,
                                             axis="ep")
            return jax.lax.psum(sse / n_ep, "ep"), preds

        return jax.shard_map(f, mesh=mesh, in_specs=(P(), pspec),
                             out_specs=(P(), P()), check_vma=False)(params,
                                                                    bb)

    (sse, preds), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, b)
    return float(sse), np.asarray(preds), params_from_jax(grads)


def _port_ep(graphs, labels, model, n_ep):
    b, spec = tep.pack_shard_edges(graphs, labels, n_ep, te=64, tn=32)
    model.zero_grad(set_to_none=True)
    sse, preds = tep.ep_pack_forward(model, tep.ep_shards(b, "cpu"), spec)
    sse.backward()
    grads = {k: v.grad.clone() for k, v in model.named_parameters()}
    return float(sse.detach()), preds.detach().numpy(), grads, spec


@pytest.mark.parametrize("case,n_ep,aggr,pooling,skip", [
    ("zero_cut", 1, "add", "add", False),
    ("zero_cut", 2, "mean", "mean", True),
    ("wired", 2, "add", "mean", False),
    ("wired", 4, "add", "add", True),
    ("wired", 4, "mean", "add", False),
    ("wired", 4, "mean", "mean", True),
    ("wide", 4, "add", "add", True),
    ("wide", 4, "mean", "mean", False)])
def test_ep_forward_and_grads_match_jax(case, n_ep, aggr, pooling, skip):
    graphs, labels = _case(case)
    jcfg, tcfg = _cfgs(aggr, pooling, skip)
    params = _params(jcfg)
    sse_j, preds_j, grads_j = _jax_ep(graphs, labels, params, jcfg, n_ep)
    model = CGRMPNN(tcfg)
    model.load_state_dict(params_from_jax(params))
    sse_t, preds_t, grads_t, spec = _port_ep(graphs, labels, model, n_ep)
    assert any(spec.caps) == (case != "zero_cut")
    np.testing.assert_allclose(preds_t, preds_j, **TOL)
    np.testing.assert_allclose(sse_t, sse_j, **TOL)
    for name, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), grads_j[name].numpy(),
                                   err_msg=name, **TOL)


def _single_device(graphs, labels, model):
    """The port's single-device model (plain gather ops) -> (sse, preds)."""
    spec = plan_spec(graphs, te=1024, tn=512, tb=len(graphs))
    spec = spec.with_packs(packs_needed(graphs, spec, fill_target=0.6) + 2)
    b = pack_graphs(graphs, labels, spec)
    preds = apply(model, type(b)(*(torch.as_tensor(a) for a in b)))
    mask = b.graph_mask.astype(bool)
    out = np.empty(len(graphs), np.float32)
    out[b.row_ids[mask]] = preds.detach().numpy()[mask]
    return float(((out - np.asarray(labels)) ** 2).sum()), out


@pytest.mark.parametrize("aggr,pooling", [("add", "add"), ("mean", "mean")])
def test_shard_count_invariance_and_single_device(aggr, pooling):
    """n_ep = 1, 2, 4 give the single-device model's predictions and loss
    (a 200-atom chain cut at 2 and 4 shards)."""
    graphs, labels = _wired()
    _, tcfg = _cfgs(aggr, pooling, skip=True)
    model = CGRMPNN(tcfg, torch.Generator().manual_seed(4))
    sse1, preds1 = _single_device(graphs, labels, model)
    for n_ep in (1, 2, 4):
        sse, preds, _, _ = _port_ep(graphs, labels, model, n_ep)
        np.testing.assert_allclose(preds[:len(graphs)], preds1, **TOL)
        np.testing.assert_allclose(sse, sse1, **TOL)


@pytest.mark.parametrize("aggr,pooling,drop", [("add", "add", 0.0),
                                               ("mean", "mean", 0.0),
                                               ("add", "mean", 0.2)])
def test_one_kernel_step_equals_autograd_step(aggr, pooling, drop):
    """On a zero-cut spec the whole-model configuration's step (one K2 per
    shard: partial SSEs and gradients summed over the shards) equals the
    autograd step through K5, K4 and K11, dropout seeds included."""
    graphs, labels = _zero_cut()
    b, spec = tep.pack_shard_edges(graphs, labels, 2, te=64, tn=32)
    assert tep.supports_ep_fused_train(CGRMPNNConfig(NF, FE), spec)
    shards = tep.ep_shards(b, "cpu")
    seeds = torch.tensor([[7, 11, 2**31 - 2], [5, 3, 9]], dtype=torch.int32)
    _, cfg = _cfgs(aggr, pooling, skip=True)
    cfg = dataclasses.replace(cfg, dropout_ps=(drop,) * 3)
    whole = CGRMPNN(dataclasses.replace(cfg, fuse_whole_model=True),
                    torch.Generator().manual_seed(6))
    layered = CGRMPNN(cfg)
    layered.load_state_dict(whole.state_dict())
    results = []
    for model in (whole, layered):
        step = tep.make_ep_pack_train_step(model, spec)
        sse = step([shards], seeds[None] if drop else None)
        results.append((float(sse), [p.grad for p in model.parameters()]))
    np.testing.assert_allclose(results[0][0], results[1][0], **TOL)
    for a, c in zip(results[0][1], results[1][1]):
        np.testing.assert_allclose(a.numpy(), c.numpy(), **TOL)


def test_params_from_jax_carry_into_ep():
    """JAX weights loaded through params_from_jax give the JAX single-device
    model's predictions (XLA path) through the port's wired EP path."""
    graphs, labels = _wired()
    jcfg, tcfg = _cfgs("mean", "add", skip=True)
    params = _params(jcfg, seed=8)
    jx = dataclasses.replace(jcfg, use_pallas=False, pallas_interpret=False)
    from cgr_mpnn_3d_tpu.data import pack_graphs as jpack
    from cgr_mpnn_3d_tpu.data import plan_spec as jplan
    from cgr_mpnn_3d_tpu.data.batch import packs_needed as jneeded
    spec1 = jplan(graphs, te=1024, tn=512, tb=len(graphs))
    spec1 = spec1.with_packs(jneeded(graphs, spec1, fill_target=0.6) + 2)
    b1 = jpack(graphs, labels, spec1)
    pj = np.asarray(japply(params, b1, jx, spec1))
    mask = b1.graph_mask.astype(bool)
    want = np.empty(len(graphs), np.float32)
    want[b1.row_ids[mask]] = pj[mask]
    model = CGRMPNN(tcfg)
    model.load_state_dict(params_from_jax(params))
    _, preds, _, spec = _port_ep(graphs, labels, model, 4)
    assert any(spec.caps)
    np.testing.assert_allclose(preds[:len(graphs)], want, **TOL)


def test_empty_filler_is_exact_zero():
    graphs, labels = _zero_cut()
    _, spec = tep.pack_shard_edges(graphs, labels, 2, te=64, tn=32)
    spec = dataclasses.replace(spec, caps=(8,))      # a wired spec
    filler = tep.empty_ep_pack_batch(spec, NF, FE)
    _, cfg = _cfgs("mean", "mean", skip=True)
    model = CGRMPNN(cfg, torch.Generator().manual_seed(1))
    sse, _ = tep.ep_pack_forward(model, tep.ep_shards(filler, "cpu"), spec)
    sse.backward()
    assert float(sse.detach()) == 0.0
    assert all(float(p.grad.abs().max()) == 0.0 for p in model.parameters())


def _data(tmp_path):
    from cgr_mpnn_3d_tpu_torch.data.descriptors import \
        synthetic_descriptors_npz
    demo = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "demo.csv")
    d = tmp_path / "datasets"
    d.mkdir()
    for s in ("train", "val", "test"):
        (d / f"{s}.csv").write_text(open(demo).read())
        synthetic_descriptors_npz(str(d / f"{s}.csv"), str(d / f"{s}.npz"),
                                  8)
    return d


def test_train_cli_with_ep_and_its_refusals(tmp_path, monkeypatch):
    """cli.train --ep 2 trains on the CPU (zero cut: the one-kernel step's
    plain version, validation through K5/K4/K11's), also with
    --compute_dtype bfloat16, --ep_overlap, --ep_rdma, --reuse_packs
    with --loader_workers 2, --reuse_packs --device_epoch and --dp 2; a
    multi-process launch with one EP shard a rank and --ep_rdma, whose hop
    exchange across ranks is not ported, raises before any data is
    read."""
    from cgr_mpnn_3d_tpu_torch.cli.train import main
    monkeypatch.chdir(tmp_path)
    data = _data(tmp_path)
    base = ["--name", "CGR-MPNN-3D", "-d", "2", "--hidden_sizes", "16",
            "--dropout_ps", "0.1", "-bs", "8", "--val_frequency", "1",
            "--data_path", str(data), "--save_path", str(tmp_path / "saved"),
            "--device", "cpu", "--skip_test", "--ep", "2"]
    res = main(base + ["-ne", "2"])
    assert res["steps"] > 0 and len(res["val_losses"]) == 2
    assert np.isfinite(res["train_losses"]).all()
    for flags in (["--compute_dtype", "bfloat16"], ["--ep_overlap"],
                  ["--ep_rdma"], ["--reuse_packs", "--loader_workers", "2"],
                  ["--reuse_packs", "--device_epoch"], ["--dp", "2"]):
        res = main(base + ["-ne", "2"] + flags)
        assert res["steps"] > 0 and len(res["val_losses"]) == 2
        assert np.isfinite(res["train_losses"]).all()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(base + ["-ne", "1", "--data_path", "missing", "--ep_rdma"])
