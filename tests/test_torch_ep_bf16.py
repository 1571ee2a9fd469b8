"""Edge partitioning at bf16 in the port, against the JAX package at bf16
(its Pallas kernels in interpret mode) on the CPU:

* the plain versions of K8 / K9 (``fused_conv_layer_r_ref``), K10
  (``gather_linear_r_forward_ref``) and K11
  (``gather_linear_pool_forward_ref``) at ``mat_dtype="bfloat16"`` against
  ``fused_conv_layer_r`` / ``fused_conv_layer_rm``, ``fused_gather_linear_r``
  and ``fused_gather_linear_pool`` at bf16 on a wired shard: outputs, output
  dtypes and the gradients of ``jax.vjp`` under one cotangent;
* K6's linear activation (``fused_conv_layer_ref(act="linear")``, f32
  output as the overlap path takes it) at f32 (1e-4) and at bf16;
* the port's ``ep_pack_forward`` and its gradients at bf16 against JAX's
  ``ep_pack_forward(use_pallas=True, pallas_interpret=True,
  compute_dtype=bf16)`` under ``shard_map`` on the wired and zero-cut
  batches of tests/test_torch_ep_pack.py, train-mode dropout 0.1 under the
  seeds JAX draws.

Tolerance (tests/test_torch_layered_bf16.py's rule): the port's bf16 result
is at most a quarter of JAX's own bf16-vs-f32 distance and at most 5e-3
(rel-L2) from JAX's bf16 result, and differs from the port's f32 result.
Shapes: te 64, tn 32, H 16, depth 3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu.data.synthetic import synthetic_graphs
from cgr_mpnn_3d_tpu.models import CGRMPNNConfig as JConfig
from cgr_mpnn_3d_tpu.models import init_params as jinit
from cgr_mpnn_3d_tpu.ops.pallas_fused import (FusedConvSpec, fused_conv_layer,
                                              fused_conv_layer_r,
                                              fused_conv_layer_rm)
from cgr_mpnn_3d_tpu.ops.pallas_glin import (GatherLinearSpec,
                                             fused_gather_linear_pool,
                                             fused_gather_linear_r)
from cgr_mpnn_3d_tpu.parallel import P, make_mesh
from cgr_mpnn_3d_tpu.parallel import ep_pack as jep
from cgr_mpnn_3d_tpu_torch.data.synthetic import chain_graph
from cgr_mpnn_3d_tpu_torch.models import CGRMPNN, CGRMPNNConfig
from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import params_from_jax
from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
from cgr_mpnn_3d_tpu_torch.parallel import ep_pack as tep

from test_torch_ep_pack import _wired, _zero_cut

NF, FE, H, DEPTH = 20, 14, 16, 3
BF16, F32 = "bfloat16", "float32"
DT = {BF16: (jnp.bfloat16, torch.bfloat16), F32: (jnp.float32, torch.float32)}


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


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(ts) -> np.ndarray:
    return np.concatenate([_np(t).ravel() for t in ts])


def _held(port16, port32, jax16, jax32, what):
    own = _rel_l2(_flat(jax16), _flat(jax32))
    err = _rel_l2(_flat(port16), _flat(jax16))
    assert err <= min(0.25 * own, 5e-3), (what, err, own)
    assert _rel_l2(_flat(port16), _flat(port32)) > 0.0, what


def _both(jfn, pfn, ins, cast, cot):
    """{md: ((JAX out, JAX grads), (port out, port grads))}: the inputs
    whose ``cast`` flag is set take the run's type, the others stay f32;
    one cotangent, given in each output's type."""
    res = {}
    for md in (BF16, F32):
        jd, td = DT[md]
        j_ins = [jnp.asarray(a).astype(jd) if c else jnp.asarray(a)
                 for a, c in zip(ins, cast)]
        y, pull = jax.vjp(lambda *a: jfn(md, *a), *j_ins)
        ys = y if isinstance(y, tuple) else (y,)
        j_cot = tuple(jnp.asarray(c).astype(v.dtype) for c, v in zip(cot, ys))
        jg = pull(j_cot if isinstance(y, tuple) else j_cot[0])
        t_ins = [torch.tensor(a).to(td if c else torch.float32)
                 .requires_grad_() for a, c in zip(ins, cast)]
        out = pfn(md, *t_ins)
        outs = out if isinstance(out, tuple) else (out,)
        tg = torch.autograd.grad(outs, t_ins, [torch.from_numpy(c).to(o.dtype)
                                               for c, o in zip(cot, outs)])
        res[md] = ((ys, jg), (outs, tg))
    return res


def _check(res, what):
    (j_out, j_g), (t_out, t_g) = res[BF16]
    assert [o.dtype for o in t_out] == [
        torch.bfloat16 if o.dtype == jnp.bfloat16 else torch.float32
        for o in j_out], what
    assert [g.dtype for g in t_g] == [
        torch.bfloat16 if g.dtype == jnp.bfloat16 else torch.float32
        for g in j_g], what
    (j_out32, j_g32), (t_out32, t_g32) = res[F32]
    _held(t_out, t_out32, j_out, j_out32, what + " out")
    _held(t_g, t_g32, j_g, j_g32, what + " grads")


@pytest.mark.parametrize("act,mean,global_mean,drop", [
    ("relu", False, False, 0.0), ("gelu", False, True, 0.25),
    ("silu", True, False, 0.0)])
def test_conv_r_bf16_plain_matches_jax(shard, act, mean, global_mean, drop):
    """K8 (K9 with the global 1/in-degree scale; K8 with the local mean)
    at bf16: out and dh, dh0 bf16, dr f32, as JAX's."""
    spec, bj, bt, rng = shard
    PE, PN = spec.pe, spec.pn
    ins = [_rand(rng, PE, H), _rand(rng, PN, H), _rand(rng, PE, H),
           _rand(rng, H, H, scale=0.3), _rand(rng, H, scale=0.1),
           np.float32(0.7)]
    cot = [_rand(rng, PE, H)]
    seed = 2**31 - 5
    _, msg_t = jep._msg_index_t(bj, spec)
    inv_ext = np.concatenate([np.asarray(bj.inv_deg), [0.0]]).astype(
        np.float32)
    scale = inv_ext[np.minimum(np.asarray(bj.senders), PN)]

    def jfn(md, h, r, h0, w, b, skip):
        jd = DT[md][0]
        fspec = FusedConvSpec(p=spec.p, d_nbr=spec.d, tn=spec.tn,
                              learnable_skip=True, mat_dtype=jd,
                              out_dtype=jd, interpret=True, act=act,
                              aggr="mean" if mean or global_mean else "add",
                              mean_global=global_mean, dropout_p=drop,
                              train=drop > 0)
        s = jnp.asarray(seed, jnp.int32)
        if global_mean:
            return fused_conv_layer_rm(fspec, h, r, h0, msg_t, bj.send_t,
                                       jnp.asarray(scale).reshape(spec.p,
                                                                  spec.te),
                                       w, b, skip, s)
        return fused_conv_layer_r(fspec, h, r, h0, msg_t, bj.send_t, w, b,
                                  skip, s)

    def pfn(md, h, r, h0, w, b, skip):
        return fc.fused_conv_layer_r_ref(
            h, r, h0, bt.edge_nbr, bt.rev, bt.senders, w, b, skip, p=spec.p,
            tn=spec.tn, scale=torch.from_numpy(scale) if global_mean else None,
            act=act, mean=mean, train=drop > 0, seed=seed if drop else None,
            dropout_p=drop, mat_dtype=md)

    _check(_both(jfn, pfn, ins, [1, 0, 1, 0, 0, 0], cot), "K8/K9")


@pytest.mark.parametrize("act,mean,pool", [("relu", False, True),
                                           ("gelu", True, True),
                                           ("silu", False, False)])
def test_gather_linear_r_bf16_plain_matches_jax(shard, act, mean, pool):
    """K11 (K10 with the pool off) at bf16: the output and the pool f32,
    dxa and dxb bf16, dxr f32, as JAX's."""
    spec, bj, bt, rng = shard
    PE, PN = spec.pe, spec.pn
    ins = [_rand(rng, PE, H), _rand(rng, PN, H), _rand(rng, PN, NF),
           _rand(rng, H, H, scale=0.3), _rand(rng, NF, H, scale=0.3),
           _rand(rng, H, scale=0.1)]
    cot = [_rand(rng, PN, H)] + ([_rand(rng, spec.p * spec.gp, H)]
                                 if pool else [])
    ng = jnp.full((spec.p, 8, spec.tn), spec.p * spec.gp, jnp.int32)
    ng = ng.at[:, 0, :].set(bj.node_group.reshape(spec.p, spec.tn))
    ng = ng.reshape(spec.p * 8, spec.tn)

    def jfn(md, xa, xr, xb, wa, wb, b):
        gspec = GatherLinearSpec(p=spec.p, d_nbr=spec.d,
                                 mat_dtype=DT[md][0], out_dtype=jnp.float32,
                                 interpret=True, gp=spec.gp if pool else 0,
                                 act=act, aggr="mean" if mean else "add")
        if pool:
            return fused_gather_linear_pool(gspec, xa, xr, xb, bj.inc_t, ng,
                                            wa, wb, b)
        return fused_gather_linear_r(gspec, xa, xr, xb, bj.inc_t, wa, wb, b)

    def pfn(md, xa, xr, xb, wa, wb, b):
        kw = dict(p=spec.p, act=act, mean=mean, mat_dtype=md)
        if pool:
            return gl.gather_linear_pool_forward_ref(
                xa, xr, xb, bt.node_inc, bt.node_group, bt.pool_ell, wa, wb,
                b, **kw)
        return gl.gather_linear_r_forward_ref(xa, xr, xb, bt.node_inc, wa, wb,
                                              b, **kw)

    _check(_both(jfn, pfn, ins, [1, 0, 1, 0, 0, 0], cot), "K10/K11")


@pytest.mark.parametrize("drop", [0.0, 0.25])
def test_conv_linear_plain_matches_jax(shard, drop):
    """K6 with act="linear" and an f32 output, at f32 within 1e-4 and at
    bf16 by the rule, against JAX's kernel A of the overlap path."""
    spec, bj, bt, rng = shard
    PE = spec.pe
    ins = [_rand(rng, PE, H), _rand(rng, PE, H), _rand(rng, H, H, scale=0.3),
           _rand(rng, H, scale=0.1), np.float32(0.6)]
    cot = [_rand(rng, PE, H)]
    _, msg_t = jep._msg_index_t(bj, spec)
    seed = 12345

    def jfn(md, h, h0, w, b, skip):
        fspec = FusedConvSpec(p=spec.p, d_nbr=spec.d, learnable_skip=True,
                              mat_dtype=DT[md][0], out_dtype=jnp.float32,
                              interpret=True, act="linear", dropout_p=drop,
                              train=drop > 0)
        return fused_conv_layer(fspec, h, h0, msg_t, w, b, skip,
                                jnp.asarray(seed, jnp.int32))

    def pfn(md, h, h0, w, b, skip):
        return fc.fused_conv_layer_ref(
            h, h0, bt.edge_nbr, bt.rev, w, b, skip, p=spec.p, act="linear",
            train=drop > 0, seed=seed if drop else None, dropout_p=drop,
            mat_dtype=md, out_dtype="float32")

    res = _both(jfn, pfn, ins, [1, 1, 0, 0, 0], cot)
    (j_out, j_g), (t_out, t_g) = res[F32]
    for a, b_ in zip([*t_out, *t_g], [*j_out, *j_g]):
        np.testing.assert_allclose(_np(a), _np(b_).reshape(a.shape),
                                   rtol=1e-4, atol=1e-4)
    _check(res, "K6 linear")


# -- the EP forward at bf16 --------------------------------------------------

def _jax_seeds(rng_key, n_ep: int) -> np.ndarray:
    """The int32 dropout seed per shard and layer that JAX's
    ``ep_pack_forward`` draws from ``rng_key`` (fold_in the shard, split
    per layer, randint)."""
    out = np.empty((n_ep, DEPTH), np.int32)
    for k in range(n_ep):
        keys = jax.random.split(jax.random.fold_in(rng_key, k), DEPTH)
        for l in range(DEPTH):
            out[k, l] = int(jax.random.randint(keys[l], (), 0, 2**31 - 1,
                                               dtype=jnp.int32))
    return out


@pytest.mark.parametrize("case,n_ep,aggr,pooling", [
    ("wired", 4, "mean", "mean"), ("wired", 2, "add", "add"),
    ("zero_cut", 2, "add", "mean")])
def test_ep_forward_bf16_matches_jax(case, n_ep, aggr, pooling):
    """The SSE, predictions and every parameter gradient of the bf16 EP
    forward in train mode (dropout 0.1) against JAX's at bf16, by the
    rule, with the f32 runs of both as the yardstick."""
    graphs, labels = {"wired": _wired, "zero_cut": _zero_cut}[case]()
    jcfg = JConfig(num_node_features=NF, num_edge_features=FE, depth=DEPTH,
                   hidden_sizes=(H,) * DEPTH, dropout_ps=(0.1,) * DEPTH,
                   aggr=aggr, pooling=pooling, use_learnable_skip=True,
                   compute_dtype=jnp.float32, use_pallas=True,
                   pallas_interpret=True)
    params = jinit(jax.random.PRNGKey(2), jcfg)
    params["skip_weights"] = [jnp.asarray(0.6 + 0.3 * l, jnp.float32)
                              for l in range(DEPTH)]
    bj, espec = jep.pack_shard_edges(graphs, labels, n_ep, te=64, tn=32)
    bt, spec = tep.pack_shard_edges(graphs, labels, n_ep, te=64, tn=32)
    assert any(spec.caps) == (case == "wired")
    key = jax.random.PRNGKey(7)
    seeds = torch.from_numpy(_jax_seeds(key, n_ep))
    mesh = make_mesh(n_dp=1, n_ep=n_ep, devices=jax.devices()[:n_ep])
    pspec = jax.tree_util.tree_map(lambda _: P("ep"), bj)
    shards = tep.ep_shards(bt, "cpu")
    got, want = {}, {}
    for md in (BF16, F32):
        cfg = dataclasses.replace(jcfg, compute_dtype=DT[md][0])

        def loss(p, bb, cfg=cfg):
            def f(q, bl):
                local = jax.tree_util.tree_map(lambda v: v[0], bl)
                sse, preds = jep.ep_pack_forward(q, local, cfg, espec,
                                                 axis="ep", train=True,
                                                 rng=key)
                return jax.lax.psum(sse / n_ep, "ep"), preds
            return jax.shard_map(f, mesh=mesh, in_specs=(P(), pspec),
                                 out_specs=(P(), P()), check_vma=False)(p, bb)

        (sse, preds), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params, bj)
        jg = params_from_jax(grads)
        model = CGRMPNN(CGRMPNNConfig(
            num_node_features=NF, num_edge_features=FE, depth=DEPTH,
            hidden_sizes=(H,) * DEPTH, dropout_ps=(0.1,) * DEPTH, aggr=aggr,
            pooling=pooling, use_learnable_skip=True, fuse_whole_model=False,
            compute_dtype=md))
        model.load_state_dict(params_from_jax(params))
        t_sse, t_preds = tep.ep_pack_forward(model, shards, spec, train=True,
                                             seeds=seeds)
        t_sse.backward()
        names = sorted(jg)
        want[md] = ([np.asarray(sse)], [np.asarray(preds)],
                    [jg[n] for n in names])
        got[md] = ([t_sse.detach()], [t_preds.detach()],
                   [dict(model.named_parameters())[n].grad for n in names])
    for i, what in enumerate(("sse", "preds", "grads")):
        _held(got[BF16][i], got[F32][i], want[BF16][i], want[F32][i], what)
