"""The plain versions of the port's edge-partitioned kernels against the JAX
package's Pallas kernels in interpret mode, forward and every gradient, on
the same seeded numpy inputs of a wired EP shard (rtol/atol 1e-4):

* K8 / K9  ``ops.fused_conv.fused_conv_layer_r_ref`` against
  ``pallas_fused.fused_conv_layer_r`` / ``fused_conv_layer_rm``;
* K10      ``ops.gather_linear.gather_linear_r_forward_ref`` against
  ``pallas_glin.fused_gather_linear_r``;
* K11      ``ops.gather_linear.gather_linear_pool_forward_ref`` against
  ``pallas_glin.fused_gather_linear_pool``.

The JAX kernels take the transposed index tables of the JAX packer; the
port's take the ELL arrays of its own packer, built from the same graphs.
The hash dropout is the same bit for bit, so K8 is also held in train mode.
Their bf16 instantiations are held in tests/test_torch_ep_bf16.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu.data.synthetic import synthetic_graphs
from cgr_mpnn_3d_tpu.ops.pallas_fused import (FusedConvSpec,
                                              fused_conv_layer_r,
                                              fused_conv_layer_rm)
from cgr_mpnn_3d_tpu.ops.pallas_glin import (GatherLinearSpec,
                                             fused_gather_linear_pool,
                                             fused_gather_linear_r)
from cgr_mpnn_3d_tpu.parallel import ep_pack as jep
from cgr_mpnn_3d_tpu_torch.data.synthetic import chain_graph
from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
from cgr_mpnn_3d_tpu_torch.parallel import ep_pack as tep

NF, FE, H = 20, 14, 32
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def shard():
    """The most-wired shard of a 4-shard batch (chains of 80 and 33 atoms
    cut across the shards) from both packers, and a seeded rng."""
    rng = np.random.default_rng(11)
    graphs = [chain_graph(80, rng, NF), chain_graph(33, rng, NF)] + \
        synthetic_graphs(6, rng, node_feat_dim=NF)
    labels = [0.7 * i - 2.0 for i in range(len(graphs))]
    bj, sj = jep.pack_shard_edges(graphs, labels, 4, te=64, tn=32)
    bt, st = tep.pack_shard_edges(graphs, labels, 4, te=64, tn=32)
    assert vars(sj) == vars(st) and any(st.caps)
    k = int(np.argmax(bt.halo_mask.sum(axis=1)))
    local_j = jax.tree_util.tree_map(lambda v: jnp.asarray(v[k]), bj)
    local_t = tep.EPPackedBatch(*(torch.as_tensor(a[k]) for a in bt))
    return st, local_j, local_t, np.random.default_rng(5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _torch(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("act,mean,global_mean,drop", [
    ("relu", False, False, 0.0), ("gelu", False, False, 0.25),
    ("silu", True, False, 0.0), ("relu", False, True, 0.0),
    ("gelu", False, True, 0.25)])
def test_conv_r_plain_matches_jax(shard, act, mean, global_mean, drop):
    """K8 (K9 with the global 1/in-degree scale; K8 with the local mean)
    forward and the cotangents of h, r, h0, w, b and skip."""
    spec, bj, bt, rng = shard
    PE, PN = spec.pe, spec.pn
    h, r, h0 = _rand(rng, PE, H), _rand(rng, PN, H), _rand(rng, PE, H)
    w, b = _rand(rng, H, H, scale=0.2), _rand(rng, H, scale=0.1)
    skip, g = np.float32(0.7), _rand(rng, PE, H)
    seed = 2**31 - 5
    fspec = FusedConvSpec(p=spec.p, d_nbr=spec.d, tn=spec.tn,
                          learnable_skip=True, mat_dtype=jnp.float32,
                          out_dtype=jnp.float32, interpret=True, act=act,
                          aggr="mean" if mean or global_mean else "add",
                          mean_global=global_mean, dropout_p=drop,
                          train=drop > 0)
    _, msg_t = jep._msg_index_t(bj, spec)
    inv_ext = np.concatenate([np.asarray(bj.inv_deg), [0.0]]).astype(
        np.float32)
    scale = inv_ext[np.minimum(np.asarray(bj.senders), PN)]

    def jfn(h, r, h0, w, b, skip):
        seed_a = jnp.asarray(seed, jnp.int32)
        if global_mean:
            return fused_conv_layer_rm(fspec, h, r, h0, msg_t, bj.send_t,
                                       jnp.asarray(scale).reshape(spec.p,
                                                                  spec.te),
                                       w, b, skip, seed_a)
        return fused_conv_layer_r(fspec, h, r, h0, msg_t, bj.send_t, w, b,
                                  skip, seed_a)

    want, vjp = jax.vjp(jfn, h, r, h0, w, b, jnp.asarray(skip))
    want_grads = vjp(jnp.asarray(g))
    ins = _torch(h, r, h0, w, b, skip)
    got = fc.fused_conv_layer_r_ref(
        ins[0], ins[1], ins[2], bt.edge_nbr, bt.rev, bt.senders, *ins[3:],
        p=spec.p, tn=spec.tn,
        scale=torch.from_numpy(scale) if global_mean else None, act=act,
        mean=mean, train=drop > 0, seed=seed if drop else None,
        dropout_p=drop)
    _close(got.detach(), want)
    grads = torch.autograd.grad(got, ins, torch.from_numpy(g))
    for name, gt, gj in zip(("h", "r", "h0", "w", "b", "skip"), grads,
                            want_grads):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj).reshape(
            gt.shape), err_msg=name, **TOL)
    # the backward wrapper on the CPU is the same autograd
    bwd = fc.fused_conv_r_backward(
        *(t.detach() for t in ins[:3]), bt.edge_nbr, bt.rev, bt.senders,
        bt.edge_nbr_rev, bt.node_out, *(t.detach() for t in ins[3:]),
        got.detach(), torch.from_numpy(g), p=spec.p, tn=spec.tn,
        scale=torch.from_numpy(scale) if global_mean else None, act=act,
        mean=mean, train=drop > 0, seed=seed if drop else None,
        dropout_p=drop)
    for a, c in zip(bwd, grads):
        assert torch.equal(a, c)


@pytest.mark.parametrize("act,mean,pool", [
    ("relu", False, True), ("gelu", True, True), ("silu", False, False),
    ("relu", True, False)])
def test_gather_linear_r_plain_matches_jax(shard, act, mean, pool):
    """K11 (K10 with the pool off) forward, pool and the cotangents of xa,
    xr, xb, wa, wb and b."""
    spec, bj, bt, rng = shard
    PE, PN = spec.pe, spec.pn
    xa, xr, xb = _rand(rng, PE, H), _rand(rng, PN, H), _rand(rng, PN, NF)
    wa, wb = _rand(rng, H, H, scale=0.2), _rand(rng, NF, H, scale=0.2)
    b, g = _rand(rng, H, scale=0.1), _rand(rng, PN, H)
    gpool = _rand(rng, spec.p * spec.gp, H)
    gspec = GatherLinearSpec(p=spec.p, d_nbr=spec.d, mat_dtype=jnp.float32,
                             out_dtype=jnp.float32, interpret=True,
                             gp=spec.gp if pool else 0, act=act,
                             aggr="mean" if mean else "add")
    ng = jnp.full((spec.p, 8, spec.tn), spec.p * spec.gp, jnp.int32)
    ng = ng.at[:, 0, :].set(bj.node_group.reshape(spec.p, spec.tn))
    ng = ng.reshape(spec.p * 8, spec.tn)

    def jfn(xa, xr, xb, wa, wb, b):
        if pool:
            return fused_gather_linear_pool(gspec, xa, xr, xb, bj.inc_t, ng,
                                            wa, wb, b)
        return fused_gather_linear_r(gspec, xa, xr, xb, bj.inc_t, wa, wb, b)

    want, vjp = jax.vjp(jfn, xa, xr, xb, wa, wb, b)
    want_grads = vjp((jnp.asarray(g), jnp.asarray(gpool)) if pool
                     else jnp.asarray(g))
    ins = _torch(xa, xr, xb, wa, wb, b)
    kw = dict(p=spec.p, act=act, mean=mean)
    if pool:
        got = gl.gather_linear_pool_forward_ref(
            ins[0], ins[1], ins[2], bt.node_inc, bt.node_group, bt.pool_ell,
            *ins[3:], **kw)
        _close(got[0].detach(), want[0])
        _close(got[1].detach(), want[1])
        cot = (torch.from_numpy(g), torch.from_numpy(gpool))
    else:
        got = gl.gather_linear_r_forward_ref(ins[0], ins[1], ins[2],
                                             bt.node_inc, *ins[3:], **kw)
        _close(got.detach(), want)
        cot = torch.from_numpy(g)
    grads = torch.autograd.grad(got, ins, cot)
    for name, gt, gj in zip(("xa", "xr", "xb", "wa", "wb", "b"), grads,
                            want_grads):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), err_msg=name,
                                   **TOL)


@pytest.fixture(scope="module")
def long_shard():
    """The most-wired shard of a 2-shard batch whose 200-atom chain makes
    a group of 100 pool entries (four chunks of K11's split pool), from
    both packers, and a seeded rng."""
    rng = np.random.default_rng(12)
    graphs = [chain_graph(200, rng, NF)] + synthetic_graphs(
        6, rng, node_feat_dim=NF)
    labels = [0.3 * i for i in range(len(graphs))]
    bj, sj = jep.pack_shard_edges(graphs, labels, 2, te=64, tn=32)
    bt, st = tep.pack_shard_edges(graphs, labels, 2, te=64, tn=32)
    assert vars(sj) == vars(st) and any(st.caps)
    k = int(np.argmax(bt.halo_mask.sum(axis=1)))
    local_j = jax.tree_util.tree_map(lambda v: jnp.asarray(v[k]), bj)
    local_t = tep.EPPackedBatch(*(torch.as_tensor(a[k]) for a in bt))
    return st, local_j, local_t, np.random.default_rng(6)


@pytest.mark.parametrize("act,mean", [("relu", False), ("gelu", True)])
def test_gather_linear_pool_plain_matches_jax_on_a_long_group(long_shard,
                                                              act, mean):
    """K11's forward (readout and group pool) on a shard whose chain group
    spans several chunks of the card's split pool, padded with sentinels:
    the plain version, which the card holds the kernel to, against JAX's
    Pallas K11 in interpret mode."""
    spec, bj, bt, rng = long_shard
    DN = bt.pool_ell.shape[1]
    real = (bt.pool_ell < spec.pn).sum(dim=1)
    assert gl.pool_chunks(DN) > 2 and int(real.max()) > 2 * gl.POOL_CHUNK
    assert int(real.min()) < DN
    PE, PN = spec.pe, spec.pn
    xa, xr, xb = _rand(rng, PE, H), _rand(rng, PN, H), _rand(rng, PN, NF)
    wa, wb = _rand(rng, H, H, scale=0.2), _rand(rng, NF, H, scale=0.2)
    b = _rand(rng, H, scale=0.1)
    gspec = GatherLinearSpec(p=spec.p, d_nbr=spec.d, mat_dtype=jnp.float32,
                             out_dtype=jnp.float32, interpret=True,
                             gp=spec.gp, act=act,
                             aggr="mean" if mean else "add")
    ng = jnp.full((spec.p, 8, spec.tn), spec.p * spec.gp, jnp.int32)
    ng = ng.at[:, 0, :].set(bj.node_group.reshape(spec.p, spec.tn))
    ng = ng.reshape(spec.p * 8, spec.tn)
    want = jax.jit(lambda *a: fused_gather_linear_pool(gspec, *a))(
        xa, xr, xb, bj.inc_t, ng, wa, wb, b)
    got = gl.gather_linear_pool_forward(
        *(torch.from_numpy(a) for a in (xa, xr, xb)), bt.node_inc,
        bt.node_group, bt.pool_ell, *(torch.from_numpy(a) for a in (wa, wb,
                                                                   b)),
        p=spec.p, act=act, mean=mean)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("DN,chunks", [(1, 1), (31, 1), (32, 1), (33, 2),
                                       (100, 4), (4800, 150)])
def test_pool_chunks_match_the_kernel(DN, chunks):
    """The chunks of K11's split pool depend on DN alone, and the wrapper's
    chunk width is the kernel's kPoolChunk (which refuses another count)."""
    import re
    from cgr_mpnn_3d_tpu_torch.ops import _build
    src = (_build.CSRC / "gather_linear.cu").read_text()
    width = int(re.search(r"constexpr int kPoolChunk = (\d+);", src).group(1))
    assert gl.POOL_CHUNK == width
    assert gl.pool_chunks(DN) == chunks == max(1, -(-DN // width))


def test_wrappers_refuse_bf16_and_bad_shapes(shard):
    """K8-K11 take the dtypes of their mat_dtype only (bf16 states at
    bf16, never f16; r and xr f32 at both), and check their shapes."""
    spec, _, bt, rng = shard
    PE, PN = spec.pe, spec.pn
    h = torch.from_numpy(_rand(rng, PE, H))
    r = torch.from_numpy(_rand(rng, PN, H))
    w, b = torch.zeros(H, H), torch.zeros(H)
    one = torch.tensor(1.0)
    with pytest.raises(TypeError, match="mat_dtype=float32"):
        fc.fused_conv_r_forward(h.bfloat16(), r, h, bt.edge_nbr, bt.rev,
                                bt.senders, w, b, one, p=spec.p, tn=spec.tn)
    for hh, rr, name in ((h.half(), r, "h"), (h.bfloat16(), r.bfloat16(),
                                               "r")):
        with pytest.raises(TypeError, match=f"^{name} is"):
            fc.fused_conv_r_forward(hh, rr, h.bfloat16(), bt.edge_nbr,
                                    bt.rev, bt.senders, w, b, one, p=spec.p,
                                    tn=spec.tn, mat_dtype="bfloat16")
    with pytest.raises(ValueError, match="r has shape"):
        fc.fused_conv_r_forward(h, r[:-1], h, bt.edge_nbr, bt.rev,
                                bt.senders, w, b, one, p=spec.p, tn=spec.tn)
    with pytest.raises(ValueError, match="replaces the local mean"):
        fc.fused_conv_r_forward(h, r, h, bt.edge_nbr, bt.rev, bt.senders, w,
                                b, one, p=spec.p, tn=spec.tn, mean=True,
                                scale=torch.ones(PE))
    with pytest.raises(ValueError, match="unsupported kernel activation"):
        fc.fused_conv_r_forward(h, r, h, bt.edge_nbr, bt.rev, bt.senders, w,
                                b, one, p=spec.p, tn=spec.tn, act="linear")
    x = torch.zeros(PN, NF)
    with pytest.raises(TypeError, match="xr is torch.bfloat16"):
        gl.gather_linear_r_forward(h, r.bfloat16(), x, bt.node_inc, w,
                                   torch.zeros(NF, H), b, p=spec.p)
    with pytest.raises(TypeError, match="xr is torch.bfloat16"):
        gl.gather_linear_r_forward(h.bfloat16(), r.bfloat16(), x.bfloat16(),
                                   bt.node_inc, w, torch.zeros(NF, H), b,
                                   p=spec.p, mat_dtype="bfloat16")
    with pytest.raises(TypeError, match="xa is torch.float16"):
        gl.gather_linear_r_forward(h.half(), r, x.bfloat16(), bt.node_inc, w,
                                   torch.zeros(NF, H), b, p=spec.p,
                                   mat_dtype="bfloat16")
    with pytest.raises(ValueError, match="xr has shape"):
        gl.gather_linear_pool_forward(h, r[:-1], x, bt.node_inc,
                                      bt.node_group, bt.pool_ell, w,
                                      torch.zeros(NF, H), b, p=spec.p)
