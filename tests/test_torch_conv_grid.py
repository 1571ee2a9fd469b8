"""The conv layer of K6, K8/K9 and K4 (``csrc/conv_grid.cuh``) on the CPU:

* the plain versions of K8, K9 and K6 with act="linear" against the JAX
  package's Pallas kernels in interpret mode (jitted), forward and every
  gradient, on the layout of the wired training runs: a 480-atom chain and
  7 synthetic graphs cut across 2 shards at the trainer's te 128 / tn 72
  (tiles grown to te 480, tn 248), at a small width (rtol/atol 1e-4);
* the wrappers' mirrors of the conv grid's shape rules (tile rows, blocks
  per SM, the forward's scratch) against the constants and rules of the
  CUDA source.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu.data.synthetic import synthetic_graphs
from cgr_mpnn_3d_tpu.ops.pallas_fused import (FusedConvSpec, fused_conv_layer,
                                              fused_conv_layer_r,
                                              fused_conv_layer_rm)
from cgr_mpnn_3d_tpu.parallel import ep_pack as jep
from cgr_mpnn_3d_tpu_torch.data.synthetic import chain_graph
from cgr_mpnn_3d_tpu_torch.ops import _build
from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
from cgr_mpnn_3d_tpu_torch.parallel import ep_pack as tep

NF, H = 20, 24
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def wired():
    """The most-wired shard of the wired training runs' layout (a 480-atom
    chain and 7 graphs, n_ep 2, te 128 / tn 72) from both packers."""
    rng = np.random.default_rng(3)
    graphs = synthetic_graphs(7, rng, node_feat_dim=NF) + [
        chain_graph(480, rng, NF)]
    labels = [0.5 * i - 1.0 for i in range(len(graphs))]
    bj, sj = jep.pack_shard_edges(graphs, labels, 2, te=128, tn=72)
    bt, st = tep.pack_shard_edges(graphs, labels, 2, te=128, tn=72)
    assert vars(sj) == vars(st) and any(st.caps)
    assert st.te == 480, vars(st)   # the chain's fragment set the tile
    k = int(np.argmax(bt.halo_mask.sum(axis=1)))
    local_j = jax.tree_util.tree_map(lambda v: jnp.asarray(v[k]), bj)
    local_t = tep.EPPackedBatch(*(torch.as_tensor(a[k]) for a in bt))
    return st, local_j, local_t, np.random.default_rng(7)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32).reshape(
                                   np.shape(got)), err_msg=name, **TOL)


@pytest.mark.parametrize("kernel,act,drop", [
    ("K8", "relu", 0.1), ("K8 mean", "gelu", 0.0), ("K9", "relu", 0.1),
    ("K9", "silu", 0.0)])
def test_conv_r_plain_matches_jax_on_the_wired_runs_layout(wired, kernel,
                                                           act, drop):
    """K8 (with the local mean: "K8 mean") and K9 (the global 1/in-degree
    scale): the forward and the cotangents of h, r, h0, w, b and skip."""
    spec, bj, bt, rng = wired
    PE, PN = spec.pe, spec.pn
    global_mean, mean = kernel == "K9", kernel == "K8 mean"
    ins = [_rand(rng, PE, H), _rand(rng, PN, H), _rand(rng, PE, H),
           _rand(rng, H, H, scale=0.3), _rand(rng, H, scale=0.1),
           np.float32(0.8)]
    g = _rand(rng, PE, H)
    seed = 987654
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

    @jax.jit
    def jfn(h, r, h0, w, b, skip):
        seed_a = jnp.asarray(seed, jnp.int32)
        if global_mean:
            return fused_conv_layer_rm(fspec, h, r, h0, msg_t, bj.send_t,
                                       jnp.asarray(scale).reshape(spec.p,
                                                                  spec.te),
                                       w, b, skip, seed_a)
        return fused_conv_layer_r(fspec, h, r, h0, msg_t, bj.send_t, w, b,
                                  skip, seed_a)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in ins))
    want_grads = vjp(jnp.asarray(g))
    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    got = fc.fused_conv_layer_r_ref(
        tins[0], tins[1], tins[2], bt.edge_nbr, bt.rev, bt.senders,
        *tins[3:], p=spec.p, tn=spec.tn,
        scale=torch.from_numpy(scale) if global_mean else None, act=act,
        mean=mean, train=drop > 0, seed=seed if drop else None,
        dropout_p=drop)
    _close(got.detach(), want, "out")
    grads = torch.autograd.grad(got, tins, torch.from_numpy(g))
    for name, gt, gj in zip(("h", "r", "h0", "w", "b", "skip"), grads,
                            want_grads):
        _close(gt, gj, name)


@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_conv_linear_plain_matches_jax_on_the_wired_runs_layout(wired, drop):
    """K6 with act="linear" and an f32 output (the overlap path's wired
    layers): the forward and the cotangents of h, h0, w, b and skip."""
    spec, bj, bt, rng = wired
    PE = spec.pe
    ins = [_rand(rng, PE, H), _rand(rng, PE, H), _rand(rng, H, H, scale=0.3),
           _rand(rng, H, scale=0.1), np.float32(0.6)]
    g = _rand(rng, PE, H)
    seed = 4242
    fspec = FusedConvSpec(p=spec.p, d_nbr=spec.d, learnable_skip=True,
                          mat_dtype=jnp.float32, out_dtype=jnp.float32,
                          interpret=True, act="linear", dropout_p=drop,
                          train=drop > 0)
    _, msg_t = jep._msg_index_t(bj, spec)

    @jax.jit
    def jfn(h, h0, w, b, skip):
        return fused_conv_layer(fspec, h, h0, msg_t, w, b, skip,
                                jnp.asarray(seed, jnp.int32))

    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in ins))
    want_grads = vjp(jnp.asarray(g))
    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    got = fc.fused_conv_layer_ref(
        tins[0], tins[1], bt.edge_nbr, bt.rev, *tins[2:], p=spec.p,
        act="linear", train=drop > 0, seed=seed if drop else None,
        dropout_p=drop, out_dtype="float32")
    _close(got.detach(), want, "out")
    grads = torch.autograd.grad(got, tins, torch.from_numpy(g))
    for name, gt, gj in zip(("h", "h0", "w", "b", "skip"), grads,
                            want_grads):
        _close(gt, gj, name)


def _source() -> str:
    return (_build.CSRC / "conv_grid.cuh").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _source())
               .group(1))


def test_conv_grid_constants_match_the_kernel():
    """The wrappers' CONV_ALIGN, CONV_STAGES and CONV_SMEM are the CUDA
    source's kConvAlign, kConvStages and kConvStages · 2 · kConvHalf, and
    the source's rules are the ones the mirrors follow."""
    assert fc.CONV_ALIGN == _const("kConvAlign")
    assert fc.CONV_STAGES == _const("kConvStages")
    assert fc.CONV_SMEM == _const("kConvStages") * 2 * _const("kConvHalf")
    src = _source()
    assert re.search(r"\(\(rows \+ 63\) / 64\) \* \(\(N \+ BN - 1\) / BN\) "
                     r"< sms \? 32 : 64;", src)
    assert re.search(r"\(\(rows \+ bm - 1\) / bm\) \* \(\(N \+ BN - 1\) / "
                     r"BN\) <= sms \? 1 : 2;", src)
    assert ("(rows * Hin + kConvAlign - 1) / kConvAlign * kConvAlign;"
            in src)


# (rows, N, SMs) -> (tile rows, blocks per SM): the main paths' shapes at
# full width (the wired runs' shard, p = 4, 436 packs) and edges of the rule
@pytest.mark.parametrize("rows,N,sms,bm,per_sm", [
    (960, 400, 132, 32, 2), (1024, 400, 132, 32, 2),
    (111616, 400, 132, 64, 2), (256, 400, 132, 32, 1),
    (1216, 400, 132, 64, 2), (1152, 400, 132, 32, 2),
    (128, 40, 132, 32, 1), (64, 64, 1, 64, 1)])
def test_conv_grid_rule(rows, N, sms, bm, per_sm):
    """Tile rows 32 while the 64-row tiles do not fill the SMs, else 64;
    one block an SM while the tiles fit the SMs, else two."""
    assert fc.conv_bm(rows, N, sms) == bm
    assert fc.conv_blocks_per_sm(rows, N, bm, sms) == per_sm


@pytest.mark.parametrize("rows,Hin,H", [(960, 400, 400), (1000, 24, 40),
                                        (7, 3, 5)])
def test_fwd_scratch_holds_t_and_the_bf16_weights(rows, Hin, H):
    """The forward's scratch: t alone at f32; at bf16 t, then W from the
    next multiple of kConvAlign elements (16-byte aligned for cp.async)."""
    assert fc.fwd_scratch_elems(rows, Hin, H, "float32") == rows * Hin
    n = fc.fwd_scratch_elems(rows, Hin, H, "bfloat16")
    w_at = n - Hin * H
    assert w_at >= rows * Hin and w_at % fc.CONV_ALIGN == 0
    assert w_at - rows * Hin < fc.CONV_ALIGN and (w_at * 2) % 16 == 0
