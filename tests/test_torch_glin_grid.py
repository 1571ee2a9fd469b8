"""The gather-linear K5 and the EP readout K10/K11 (``csrc/gather_linear.cu``
on ``csrc/conv_grid.cuh``'s tile) on the CPU:

* K5's plain version against the JAX package's ``fused_gather_linear`` in
  interpret mode (jitted), forward and every gradient, as edge_init and as
  the readout (add and mean) on the layered step's layout: 40 corpus
  reactions packed at te 256 / tn 128 into p = 4 packs, at a small width
  (rtol/atol 1e-4);
* K11's plain version against ``fused_gather_linear_pool`` on the layout
  of ``--ep 2`` validation: 64 corpus reactions cut across 2 shards at te
  128 / tn 72 and pinned to 8 packs, 24 groups a pack and a pool ELL 40
  wide (two chunks of the card's split pool), forward, pool and every
  gradient;
* the wrapper's mirrors of the grid's rules (tile rows, blocks per SM, the
  padded t1 stride, the scratch layout) against the CUDA source.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import re
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu.ops.pallas_glin import (GatherLinearSpec,
                                             fused_gather_linear,
                                             fused_gather_linear_pool)
from cgr_mpnn_3d_tpu.ops.pallas_ops import build_idx_t
from cgr_mpnn_3d_tpu.parallel import ep_pack as jep
from cgr_mpnn_3d_tpu_torch.chem import RxnGraph
from cgr_mpnn_3d_tpu_torch.data import pack_graphs, plan_spec, to_device
from cgr_mpnn_3d_tpu_torch.ops import _build
from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
from cgr_mpnn_3d_tpu_torch.parallel import ep_pack as tep

REPO = Path(__file__).resolve().parent.parent
H, FE = 24, 14
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def corpus():
    rows = (REPO / "tests" / "corpus_reactions.csv"
            ).read_text().splitlines()[1:]
    return [RxnGraph(r.split(",")[0]).arrays for r in rows if r.strip()]


@pytest.fixture(scope="module")
def layered(corpus):
    """40 corpus reactions at the layered step's te 256 / tn 128, p = 4."""
    graphs = corpus[:40]
    spec = plan_spec(graphs, te=256, tn=128, tb=16).with_packs(4)
    batch = pack_graphs(graphs, [0.1 * i for i in range(40)], spec)
    return spec, batch, to_device(batch, "cpu")


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32).reshape(
                                   np.shape(got)), err_msg=name, **TOL)


@pytest.mark.parametrize("stage,act,mean", [
    ("edge_init", "relu", False), ("edge_init", "silu", False),
    ("readout", "relu", False), ("readout", "relu", True),
    ("readout", "gelu", True), ("readout", "silu", False)])
def test_k5_plain_matches_jax_on_the_layered_step_layout(layered, stage, act,
                                                         mean):
    """K5: the output and the cotangents of xa, xb, wa, wb and b."""
    spec, b, tb = layered
    rng = np.random.default_rng(17)
    ET, NT = b.edge_nbr.shape[0], b.node_x.shape[0]
    F = b.node_x.shape[1]
    if stage == "edge_init":
        xa, xb, idx = _rand(rng, NT, F), _rand(rng, ET, FE), \
            np.asarray(b.senders)[:, None]
        adj = tb.node_out
    else:
        xa, xb, idx = _rand(rng, ET, H), _rand(rng, NT, F), \
            np.asarray(b.node_inc)
        adj = tb.receivers[:, None]
    ins = [xa, xb, _rand(rng, xa.shape[1], H, scale=0.2),
           _rand(rng, xb.shape[1], H, scale=0.2), _rand(rng, H, scale=0.1)]
    g = _rand(rng, xb.shape[0], H)
    gspec = GatherLinearSpec(p=spec.p, d_nbr=idx.shape[1],
                             mat_dtype=jnp.float32, out_dtype=jnp.float32,
                             interpret=True, act=act,
                             aggr="mean" if mean else "add")
    idx_t = build_idx_t(jnp.asarray(idx), None, spec.p)

    @jax.jit
    def jfn(xa, xb, wa, wb, bias, g):
        out, vjp = jax.vjp(lambda *a: fused_gather_linear(
            gspec, a[0], a[1], idx_t, *a[2:]), xa, xb, wa, wb, bias)
        return out, vjp(g)

    want, want_grads = jfn(*ins, g)
    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    kw = dict(p=spec.p, act=act, mean=mean)
    got = gl.gather_linear(tins[0], tins[1], torch.from_numpy(idx), adj,
                           *tins[2:], **kw)
    _close(got.detach(), want, "out")
    grads = torch.autograd.grad(got, tins, torch.from_numpy(g))
    for name, gt, gj in zip(("xa", "xb", "wa", "wb", "b"), grads,
                            want_grads):
        _close(gt, gj, name)
    # the backward wrapper on CPU tensors: its plain version, held the same
    back = gl.gather_linear_backward(*(torch.from_numpy(a) for a in ins[:2]),
                                     torch.from_numpy(idx), adj,
                                     *(torch.from_numpy(a) for a in ins[2:]),
                                     got.detach(), torch.from_numpy(g), **kw)
    for name, gb, gj in zip(("xa", "xb", "wa", "wb", "b"), back, want_grads):
        _close(gb, gj, "backward wrapper " + name)


@pytest.fixture(scope="module")
def validation(corpus):
    """The most wired shard (all zero cut) of 64 corpus reactions at n_ep
    2, te 128 / tn 72, pinned to --ep 2 validation's 8 packs, 24 groups a
    pack and pool ELL width 40, from both packers."""
    graphs = corpus[:64]
    labels = [0.1 * i for i in range(64)]
    _, nat = tep.pack_shard_edges(graphs, labels, 2, te=128, tn=72)
    pinned = replace(nat, p=8, dn=40, gp=24)
    bt, st = tep.pack_shard_edges(graphs, labels, 2, te=128, tn=72,
                                  spec=pinned)
    bj, sj = jep.pack_shard_edges(graphs, labels, 2, te=128, tn=72,
                                  spec=pinned)
    assert vars(sj) == vars(st)
    k = int(np.argmax(bt.halo_mask.sum(axis=1)))
    local_j = jax.tree_util.tree_map(lambda v: jnp.asarray(v[k]), bj)
    local_t = tep.EPPackedBatch(*(torch.as_tensor(a[k]) for a in bt))
    return st, local_j, local_t


@pytest.mark.parametrize("act,mean", [("relu", False), ("gelu", True)])
def test_k11_plain_matches_jax_on_the_ep_validation_layout(validation, act,
                                                           mean):
    """K11: the readout, its group pool (two chunks a group on the card)
    and the cotangents of xa, xr, xb, wa, wb and b from both
    cotangents."""
    spec, bj, bt = validation
    assert tuple(bt.pool_ell.shape) == (192, 40)
    assert gl.pool_chunks(bt.pool_ell.shape[1]) == 2
    rng = np.random.default_rng(23)
    PE, PN, F = spec.pe, spec.pn, bt.node_x.shape[1]
    ins = [_rand(rng, PE, H), _rand(rng, PN, H), _rand(rng, PN, F),
           _rand(rng, H, H, scale=0.2), _rand(rng, F, H, scale=0.2),
           _rand(rng, H, scale=0.1)]
    g, gpool = _rand(rng, PN, H), _rand(rng, spec.p * spec.gp, H)
    gspec = GatherLinearSpec(p=spec.p, d_nbr=spec.d, mat_dtype=jnp.float32,
                             out_dtype=jnp.float32, interpret=True,
                             gp=spec.gp, act=act,
                             aggr="mean" if mean else "add")
    ng = jnp.full((spec.p, 8, spec.tn), spec.p * spec.gp, jnp.int32)
    ng = ng.at[:, 0, :].set(bj.node_group.reshape(spec.p, spec.tn))
    ng = ng.reshape(spec.p * 8, spec.tn)

    @jax.jit
    def jfn(xa, xr, xb, wa, wb, bias, g, gpool):
        out, vjp = jax.vjp(lambda *a: fused_gather_linear_pool(
            gspec, a[0], a[1], a[2], bj.inc_t, ng, *a[3:]),
            xa, xr, xb, wa, wb, bias)
        return out, vjp((g, gpool))

    (want, want_pool), want_grads = jfn(*ins, g, gpool)
    tins = [torch.tensor(a, requires_grad=True) for a in ins]
    out, pool = gl.gather_linear_pool(
        tins[0], tins[1], tins[2], bt.node_inc, bt.dst[:, None],
        bt.node_group, bt.pool_ell, *tins[3:], p=spec.p, act=act, mean=mean)
    _close(out.detach(), want, "out")
    _close(pool.detach(), want_pool, "pool")
    grads = torch.autograd.grad((out, pool), tins,
                                (torch.from_numpy(g), torch.from_numpy(gpool)))
    for name, gt, gj in zip(("xa", "xr", "xb", "wa", "wb", "b"), grads,
                            want_grads):
        _close(gt, gj, name)


# -- the wrapper's mirrors of the grid's rules ------------------------------

def _source(name: str = "gather_linear.cu") -> str:
    return (_build.CSRC / name).read_text()


def test_glin_grid_constants_match_the_kernel():
    """GLIN_PAD and POOL_CHUNK are the source's kGlinPad and kPoolChunk;
    the padded stride, the xb copy rule, the scratch's buffers and their
    256-byte carving are the ones the mirrors follow; the grid takes
    conv_grid.cuh's tile rule over the widest product."""
    src = _source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert gl.GLIN_PAD == const("kGlinPad")
    assert gl.POOL_CHUNK == const("kPoolChunk")
    assert "return (n + kGlinPad - 1) / kGlinPad * kGlinPad;" in src
    assert "return padded(FB) != FB;" in src
    carve = re.search(r"used \+= \(static_cast<size_t>\(n\) \* sizeof\(T\) "
                      r"\+ (\d+)\) / (\d+) \* (\d+);",
                      _source("layered_common.cuh"))
    assert int(carve.group(1)) + 1 == int(carve.group(2)) == \
        int(carve.group(3)) == gl._CARVE
    for take in ("t1 = c.take<E>(rows * padded(d.FA));",
                 "xbp = c.take<E>(rows * padded(d.FB));",
                 "wa16 = c.take<E>(static_cast<long long>(d.FA) * d.H);",
                 "wb16 = c.take<E>(static_cast<long long>(d.FB) * d.H);",
                 "part = c.take<float>(pool_items * d.H);",
                 "used = c.take<int>(pool_items);",
                 "dt = c.take<DT>(rows * d.FA);",
                 "dpre = c.take<float>(rows * d.H);",
                 "rscale = c.take<float>(rows);",
                 "dpre16 = c.take<E>(rows * d.H);",
                 "wpart = c.take<float>(static_cast<long long>(S) * (d.FA + "
                 "d.FB + 1) * d.H);"):
        assert take in src, take
    assert len(re.findall(r"c\.take<", src)) == 11
    assert "if (!backward) return d.H;" in src
    assert "launch_conv(fwd_fn<kBf16, O>(32), fwd_fn<kBf16, O>(64)" in src


# (rows, FA, FB, H, backward, SMs) -> (tile rows, blocks per SM): the main
# paths' shapes at full width (K5 edge_init and readout at p = 4 and 436
# packs, K11 at --ep 2 validation and in the wired runs) and edges
@pytest.mark.parametrize("rows,FA,FB,H,backward,bm,per_sm", [
    (1024, 270, 14, 400, False, 32, 2), (512, 400, 270, 400, False, 32, 1),
    (111616, 270, 14, 400, True, 64, 2), (55808, 400, 270, 400, False, 64, 2),
    (576, 400, 270, 400, True, 32, 1), (744, 400, 270, 400, False, 32, 2),
    (64, 20, 14, 24, True, 32, 1), (256, 600, 14, 400, True, 32, 1)])
def test_glin_grid_rule(rows, FA, FB, H, backward, bm, per_sm):
    """The tile rows and blocks per SM of a launch: conv_grid.cuh's rule
    over the widest product (forward H, backward the widest of FA, FB and
    H) on 132 SMs."""
    got = gl.glin_tiles(rows, FA, FB, H, backward, 132)
    assert got == (bm, per_sm)
    N = max(FA, FB, H) if backward else H
    assert got == (fc.conv_bm(rows, N, 132),
                   fc.conv_blocks_per_sm(rows, N, bm, 132))


@pytest.mark.parametrize("FA,stride", [(270, 272), (400, 400), (14, 16),
                                       (78, 80), (1, 8), (8, 8)])
def test_padded_stride_is_whole_chunks(FA, stride):
    """t1's row stride: the width rounded up to GLIN_PAD elements, so that
    every row starts on a 16-byte boundary at f32 and at bf16."""
    assert gl.padded(FA) == stride
    assert (stride * 4) % 16 == 0 and (stride * 2) % 16 == 0
    assert gl.xb_copied(FA) == (stride != FA)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("mat_dtype", ["float32", "bfloat16"])
def test_scratch_bytes_hold_every_buffer(backward, mat_dtype):
    """The mirror's bytes at K5 edge_init's p = 4 shape: each buffer at its
    element size rounded up to 256 bytes, t1 at its padded stride; the
    backward's split-K partials of dWa, dWb and db; K11's forward adds the
    pool's partials only with more than one chunk."""
    p, R, FA, FB, H, S = 4, 256, 270, 14, 400, 4
    e = 2 if mat_dtype == "bfloat16" else 4

    def r(n):
        return -(-n // 256) * 256
    want = r(p * R * 272 * e) + r(p * R * 16 * e)
    if e == 2:
        want += r(FA * H * 2) + r(FB * H * 2)
    if backward:
        want += (r(p * R * FA * 4) + r(p * R * H * 4) + r(p * R * 4)
                 + (r(p * R * H * 2) if e == 2 else 0)
                 + r(S * (FA + FB + 1) * H * 4))
    assert gl.scratch_bytes(backward, p, R, FA, FB, H, mat_dtype, S) == want
    if not backward:
        one = gl.scratch_bytes(False, 8, 72, 400, 270, 400, mat_dtype, GP=24,
                               chunks=1)
        two = gl.scratch_bytes(False, 8, 72, 400, 270, 400, mat_dtype, GP=24,
                               chunks=2)
        assert two - one == r(8 * 24 * 2 * H * 4) + r(8 * 24 * 2 * 4)


def test_glin_ties_tool_on_the_plain_version(capsys):
    """tools/glin_ties.py on CPU tensors, where the wrapper is the plain
    version run a second time (the CPU's products may round otherwise from
    call to call, so a tie may flip): the readings of the float64 rule,
    which the plain version passes against itself."""
    from cgr_mpnn_3d_tpu_torch.tools import glin_ties
    out = glin_ties.main(["--graphs", "6", "--seeds", "2", "--device",
                          "cpu"])
    assert [(r["seed"], r["stage"]) for r in out] == [
        (0, "edge_init"), (0, "readout"), (1, "edge_init"), (1, "readout")]
    for r in out:
        assert 0 <= r["flips"] <= r["n"] // 10000 and r["rel"] < 5e-2
        assert r["l1_plain"] < 1e-5
        assert r["l1_kernel"] <= max(3 * r["l1_plain"], 1e-4)
    assert "glin_ties K5 readout" in capsys.readouterr().out
