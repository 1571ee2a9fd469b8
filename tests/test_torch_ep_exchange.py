"""The hop exchange (K12, ``--ep_rdma``) and the overlap path
(``--ep_overlap``) of the port's edge partitioning on the CPU, against the
JAX package:

* the port's exchange with ``ep_rdma_exchange`` (its plain version,
  ``_ring_move``, on the CPU) against JAX's ``ring_exchange_rdma`` (the
  Pallas kernel in interpret mode) and ``_ring_exchange`` (the ppermute
  ring) under ``shard_map`` for the caps of tests/test_rdma_exchange.py, in
  both directions, bit for bit; its backward is the inverse exchange; the
  EP forward and gradients are the same with and without it; the
  cross-rank K12's buffer check, its backward's need of a plan made by a
  forward, and no active hop;
* the port's overlap path against JAX's (``ep_overlap=True`` with the
  Pallas kernels in interpret mode) on tests/test_ep_pack.py's wired case
  (a 160-atom chain and 12 graphs over 4 shards), eval and train mode with
  dropout, predictions, SSE and gradients at 1e-4; overlap with wired mean
  warns once and equals the non-overlap path.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu.data.synthetic import synthetic_graphs
from cgr_mpnn_3d_tpu.models import CGRMPNNConfig as JConfig
from cgr_mpnn_3d_tpu.models import init_params as jinit
from cgr_mpnn_3d_tpu.parallel import P, make_mesh
from cgr_mpnn_3d_tpu.parallel import ep_pack as jep
from cgr_mpnn_3d_tpu.parallel.rdma_exchange import ring_exchange_rdma as jrdma
from cgr_mpnn_3d_tpu_torch.data.synthetic import chain_graph
from cgr_mpnn_3d_tpu_torch.models import CGRMPNN, CGRMPNNConfig
from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import params_from_jax
from cgr_mpnn_3d_tpu_torch.parallel import ep_pack as tep
from cgr_mpnn_3d_tpu_torch.parallel import rdma_exchange as trx

from test_torch_ep_bf16 import _jax_seeds
from test_torch_ep_pack import _wired

NF, FE, H, DEPTH = 20, 14, 16, 3
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_exchange(bufs, caps, n_ep, n_dp, fn):
    """``fn(local buffer)`` under shard_map on an (n_dp, n_ep) mesh of the
    conftest's CPU devices -> the stacked [n_dp*n_ep, TW, H] result."""
    mesh = make_mesh(n_dp=n_dp, n_ep=n_ep,
                     devices=jax.devices()[:n_dp * n_ep])
    sm = jax.jit(jax.shard_map(lambda b: fn(b[0])[None], mesh=mesh,
                               in_specs=(P(("dp", "ep")),),
                               out_specs=P(("dp", "ep")), check_vma=False))
    return np.asarray(sm(bufs))


@pytest.mark.parametrize("caps", [(8, 0, 16), (8,), (0, 8, 0, 0, 0, 0, 8)])
def test_exchange_matches_jax_bit_for_bit(caps):
    """Both directions of the port's exchange equal JAX's Pallas exchange
    and its ppermute ring, on every dp row of the mesh."""
    n_ep = len(caps) + 1
    n_dp = 8 // n_ep
    tw = sum(caps)
    bufs = np.random.default_rng(0).normal(
        size=(n_dp * n_ep, tw, 24)).astype(np.float32)
    for inverse in (False, True):
        want = _jax_exchange(bufs, caps, n_ep, n_dp, lambda b: jrdma(
            b, caps, "ep", inverse=inverse, interpret=True))
        ring = _jax_exchange(bufs, caps, n_ep, n_dp, lambda b: jep.
                             _ring_exchange(b, caps, "ep", inverse=inverse))
        np.testing.assert_array_equal(want, ring)
        for d in range(n_dp):
            rows = slice(d * n_ep, (d + 1) * n_ep)
            got = trx.ring_exchange_rdma(
                [torch.from_numpy(b) for b in bufs[rows]], caps, inverse)
            np.testing.assert_array_equal(np.stack([g.numpy() for g in got]),
                                          want[rows])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exchange_backward_is_the_inverse_exchange(dtype):
    """The gradient of the exchange is the inverse exchange of the
    cotangents; no active hop gives the buffers back as they are."""
    caps = (8, 0, 16)
    gen = torch.Generator().manual_seed(3)
    bufs = [torch.randn((24, 12), generator=gen).to(dtype).requires_grad_()
            for _ in range(4)]
    cots = [torch.randn((24, 12), generator=gen).to(dtype) for _ in range(4)]
    outs = trx.ring_exchange_rdma(bufs, caps)
    grads = torch.autograd.grad(outs, bufs, cots)
    want = trx.ring_exchange_rdma(cots, caps, inverse=True)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    assert all(torch.equal(a, b) for a, b in zip(
        trx.ring_exchange_rdma(outs, caps, inverse=True), bufs))
    flat = [torch.zeros(0, 12) for _ in range(3)]
    assert trx.ring_exchange_rdma(flat, (0, 0))[1] is flat[1]
    with pytest.raises(ValueError, match="buffers for"):
        trx._launch(bufs[:3], caps, False)


def _bufs(n=4, tw=24, H=12, **kw):
    gen = torch.Generator().manual_seed(n)
    return [torch.randn((tw, H), generator=gen, **kw) for _ in range(n)]


def _transposed(b):
    return b.t().contiguous().t()


@pytest.mark.parametrize("case,error,match", [
    ("count", ValueError, "3 buffers for 3 hops"),
    ("shards", ValueError, "at most 32 shards"),
    ("shape first", ValueError, "buffer 0 has shape"),
    ("shape", ValueError, "buffer 2 has shape"),
    ("rank", ValueError, "buffer 1 has shape"),
    ("dtype first", TypeError, "buffer 0 is torch.float16"),
    ("dtype", TypeError, "buffer 3 is torch.bfloat16"),
    ("device", ValueError, "buffer 1 is on meta, not cpu"),
    ("contiguous", ValueError, "buffer 2 is not contiguous")])
def test_exchange_check_raises_what_it_raised(case, error, match):
    """K12's single-pass check: a buffer that differs from the first in
    shape, dtype, device or layout, a wrong count and more than 32 shards
    raise what the per-buffer check raised; good buffers pass."""
    caps, bufs = (8, 0, 16), _bufs()
    trx._check(bufs, caps)
    trx._check([b.bfloat16() for b in bufs], caps)
    if case == "count":
        bufs = bufs[:3]
    elif case == "shards":
        caps, bufs = (8,) * 32, _bufs(33, tw=256)
    elif case == "shape first":
        bufs[0] = bufs[0][:20]
    elif case == "shape":
        bufs[2] = torch.zeros(24, 13)
    elif case == "rank":
        bufs[1] = bufs[1].reshape(24, 3, 4)
    elif case == "dtype first":
        bufs = [b.half() for b in bufs]
    elif case == "dtype":
        bufs[3] = bufs[3].bfloat16()
    elif case == "device":
        bufs[1] = torch.empty(24, 12, device="meta")
    else:
        bufs[2] = _transposed(bufs[2])
    with pytest.raises(error, match=match):
        trx._check(bufs, caps)
    if case in ("count", "shards"):
        with pytest.raises(error, match=match):
            trx._launch(bufs, caps, False)


@pytest.mark.parametrize("case,error,match", [
    ("rows", ValueError, r"shape \(20, 12\); the exchange takes \[TW=24"),
    ("rank", ValueError, r"shape \(24, 3, 4\)"),
    ("dtype", TypeError, "float16; the kernel takes float32 or bfloat16"),
    ("contiguous", ValueError, "not contiguous")])
def test_rank_exchange_check_raises(case, error, match):
    """The cross-rank K12's check of this rank's buffer: [TW, H], f32 or
    bf16, contiguous; good buffers pass."""
    caps, buf = (8, 0, 16), _bufs(1)[0]
    trx._check_rank(buf, caps)
    trx._check_rank(buf.bfloat16(), caps)
    bad = {"rows": buf[:20], "rank": buf.reshape(24, 3, 4),
           "dtype": buf.half(), "contiguous": _transposed(buf)}[case]
    with pytest.raises(error, match=match):
        trx._check_rank(bad, caps)


def test_rank_exchange_needs_a_forward_plan_and_passes_no_hop():
    """A backward exchange finds the plan its forward made, or raises
    before any launch; no active hop gives the buffer back as it is;
    without an exchange on the card there is no error to raise."""
    from cgr_mpnn_3d_tpu_torch.parallel.multihost import EPComm
    comm = EPComm(ranks=(0, 1), shard=0, group=None)
    with pytest.raises(RuntimeError, match="made by a forward exchange"):
        trx._rank_plan((8,), 1600, comm, torch.device("cuda", 0), False)
    buf = _bufs(1, tw=0)[0]
    assert trx.rank_exchange_rdma(buf, [0], False, comm) is buf
    trx.check_errors()
    trx.close()


@pytest.mark.parametrize("caps", [(8,), (8, 0, 0), (0, 8, 0, 0, 0, 0, 8),
                                  (24, 8, 16), (0, 0), ()])
def test_exchange_plan_cache_matches_active_hops(caps):
    """The cached active hops and hop table of a spec are what
    _active_hops gives, offsets and lengths in bytes of the row; the same
    spec gives the same plan object, and caps as a list or tuple alike."""
    assert list(trx._active(caps)) == trx._active_hops(caps)
    assert trx._active(caps) is trx._active(tuple(caps))
    assert trx.ring_exchange_rdma(_bufs(len(caps) + 1, tw=sum(caps)),
                                  list(caps)) is not None
    if not trx._active(caps):
        return
    plan = trx._plan(caps, 48)
    assert plan is trx._plan(caps, 48) and plan.tw == sum(caps)
    t = plan.keep
    assert (t.n, t.n_active, t.stride) == (len(caps) + 1,
                                          len(trx._active(caps)),
                                          sum(caps) * 48)
    assert [(t.hop[i], t.off[i] // 48, t.len[i] // 48)
            for i in range(t.n_active)] == trx._active_hops(caps)


def _port_model(seed=4, drop=0.2, **kw):
    cfg = CGRMPNNConfig(num_node_features=NF, num_edge_features=FE,
                        depth=DEPTH, hidden_sizes=(H,) * DEPTH,
                        dropout_ps=(drop,) * DEPTH, use_learnable_skip=True,
                        fuse_whole_model=False, **kw)
    return CGRMPNN(cfg, torch.Generator().manual_seed(seed))


def _loss_and_grads(model, shards, spec, seeds):
    model.zero_grad(set_to_none=True)
    sse, preds = tep.ep_pack_forward(model, shards, spec,
                                     train=seeds is not None, seeds=seeds)
    sse.backward()
    return sse.detach(), preds.detach(), [p.grad for p in
                                          model.parameters()]


@pytest.mark.parametrize("aggr,n_ep", [("add", 4), ("mean", 2)])
def test_ep_forward_same_with_and_without_rdma(aggr, n_ep):
    """ep_rdma_exchange moves the same rows: loss, predictions and
    gradients equal bit for bit, in train mode, at f32 and bf16."""
    graphs, labels = _wired()
    b, spec = tep.pack_shard_edges(graphs, labels, n_ep, te=64, tn=32)
    shards = tep.ep_shards(b, "cpu")
    seeds = torch.randint(0, 2**31 - 1, (n_ep, DEPTH), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(2))
    for md in ("float32", "bfloat16"):
        res = [_loss_and_grads(_port_model(aggr=aggr, compute_dtype=md,
                                           ep_rdma_exchange=r), shards, spec,
                               seeds) for r in (False, True)]
        (s0, p0, g0), (s1, p1, g1) = res
        assert torch.equal(s0, s1) and torch.equal(p0, p1)
        assert all(torch.equal(x, y) for x, y in zip(g0, g1))


# -- --ep_overlap ------------------------------------------------------------

def _overlap_case():
    """tests/test_ep_pack.py's wired case: a 160-atom chain and 12 small
    graphs over 4 shards (non-zero caps)."""
    rng = np.random.default_rng(11)
    graphs = [chain_graph(160, rng, NF)] + list(
        synthetic_graphs(12, rng, node_feat_dim=NF))
    labels = [1.0] + [0.2 * i for i in range(12)]
    return graphs, labels


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_overlap_matches_jax_overlap(dropout):
    """The port's overlap path (K6 linear per layer, the compact correction
    through the gather tables) against JAX's overlap path: SSE, predictions and
    every gradient at 1e-4, train mode under JAX's dropout seeds."""
    n_ep = 4
    graphs, labels = _overlap_case()
    jcfg = JConfig(num_node_features=NF, num_edge_features=FE, depth=DEPTH,
                   hidden_sizes=(H,) * DEPTH, dropout_ps=(dropout,) * DEPTH,
                   use_learnable_skip=True, compute_dtype=jnp.float32,
                   use_pallas=True, pallas_interpret=True, ep_overlap=True)
    params = jinit(jax.random.PRNGKey(5), jcfg)
    params["skip_weights"] = [jnp.asarray(0.6 + 0.3 * l, jnp.float32)
                              for l in range(DEPTH)]
    bj, espec = jep.pack_shard_edges(graphs, labels, n_ep, te=64, tn=32)
    bt, spec = tep.pack_shard_edges(graphs, labels, n_ep, te=64, tn=32)
    assert any(spec.caps)
    key = jax.random.PRNGKey(0)
    mesh = make_mesh(n_dp=1, n_ep=n_ep, devices=jax.devices()[:n_ep])
    pspec = jax.tree_util.tree_map(lambda _: P("ep"), bj)

    def loss(p, bb):
        def f(q, bl):
            local = jax.tree_util.tree_map(lambda v: v[0], bl)
            sse, preds = jep.ep_pack_forward(q, local, jcfg, espec,
                                             axis="ep", train=True, rng=key)
            return jax.lax.psum(sse / n_ep, "ep"), preds
        return jax.shard_map(f, mesh=mesh, in_specs=(P(), pspec),
                             out_specs=(P(), P()), check_vma=False)(p, bb)

    (sse, preds), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, bj)
    model = _port_model(drop=dropout, ep_overlap=True)
    model.load_state_dict(params_from_jax(params))
    t_sse, t_preds, _ = _loss_and_grads(
        model, tep.ep_shards(bt, "cpu"), spec,
        torch.from_numpy(_jax_seeds(key, n_ep)))
    np.testing.assert_allclose(t_preds.numpy(), np.asarray(preds), **TOL)
    np.testing.assert_allclose(float(t_sse), float(sse), **TOL)
    want = params_from_jax(grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def test_overlap_matches_non_overlap_and_wired_mean_warns_once():
    """Overlap equals the K8 path at 1e-4 (eval predictions and train-mode
    gradients); with wired mean it warns once and runs the K9 path, bit
    for bit."""
    graphs, labels = _overlap_case()
    b, spec = tep.pack_shard_edges(graphs, labels, 4, te=64, tn=32)
    shards = tep.ep_shards(b, "cpu")
    seeds = torch.randint(0, 2**31 - 1, (4, DEPTH), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(6))
    base, ov = _port_model(), _port_model(ep_overlap=True)
    with torch.no_grad():
        _, p0 = tep.ep_pack_forward(base, shards, spec)
        _, p1 = tep.ep_pack_forward(ov, shards, spec)
    np.testing.assert_allclose(p1.numpy(), p0.numpy(), **TOL)
    (s0, _, g0), (s1, _, g1) = (_loss_and_grads(m, shards, spec, seeds)
                                for m in (base, ov))
    np.testing.assert_allclose(float(s1), float(s0), **TOL)
    for x, y in zip(g1, g0):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)
    tep._overlap_wired_mean_warned = False
    mean, mean_ov = _port_model(aggr="mean"), _port_model(aggr="mean",
                                                          ep_overlap=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r_ov = [_loss_and_grads(mean_ov, shards, spec, seeds)
                for _ in range(2)]
    assert sum("--ep_overlap" in str(w.message) for w in caught) == 1
    r0 = _loss_and_grads(mean, shards, spec, seeds)
    assert torch.equal(r_ov[0][0], r0[0])
    assert all(torch.equal(x, y) for x, y in zip(r_ov[0][2], r0[2]))
