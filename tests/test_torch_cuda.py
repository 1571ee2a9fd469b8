"""The CUDA kernels on the card against their plain versions (needs a GPU
and nvcc; skips elsewhere): the whole-model forward (eval and train mode),
the training step and the VJP; the layered kernels (ELL gather-sum,
gather-linear, conv stack, forward and backward, backward reruns bit for
bit) and the layered configuration against the whole-model one; the
per-layer conv kernel (forward and backward, Hin != H included, backward
reruns bit for bit), capture mode on the card against the CPU and the
layered path, and the activation-chain probe's kernel; the bf16
instantiation of the whole-model kernels against their bf16 plain versions
(reruns bit for bit, the bf16 launch counters, a bf16 model on the card
against the CPU), no CUDA tensor reaching a plain version, the matmul
probe's kernel (P2), ``predict`` over natively featurized graphs
against the Python twin's, and the trainer's device-resident modes (seeds
on the card give host seeds' bits; a staged epoch equals the host loop
with no synchronizing call in its steps).  Run on a GPU machine with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX, which a GPU machine for
the port need not have.)
"""

import dataclasses
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu_torch.chem import RxnGraph
from cgr_mpnn_3d_tpu_torch.data import (pack_graphs, packs_needed,
                                        place_graphs, plan_spec, to_device)
from cgr_mpnn_3d_tpu_torch.data.synthetic import synthetic_graphs
from cgr_mpnn_3d_tpu_torch.models import (ACTIVATIONS, CGRMPNNConfig,
                                          adjoint_inputs, apply,
                                          fused_train_value_and_grad,
                                          init_params, kernel_inputs)
from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(n, seed, F, device, te=256, tn=128, tb=16):
    graphs = synthetic_graphs(n, np.random.default_rng(seed),
                              node_feat_dim=F)
    spec = plan_spec(graphs, te=te, tn=tn, tb=tb)
    p = packs_needed(graphs, spec)
    while not place_graphs(graphs, spec.with_packs(p)):
        p += 1
    spec = spec.with_packs(p)
    return spec, to_device(pack_graphs(graphs, [0.0] * n, spec), device)


@pytest.mark.parametrize("act,aggr,pooling", list(itertools.product(
    ["ReLU", "SiLU", "GELU"], ["add", "mean"], ["add", "mean"])))
def test_kernel_matches_plain_version(cuda, act, aggr, pooling):
    spec, batch = _batch(120, 0, 78, cuda)
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                        depth=3, hidden_sizes=(40,) * 3,
                        dropout_ps=(0.0,) * 3, activation=act, aggr=aggr,
                        pooling=pooling, use_learnable_skip=True)
    model = init_params(cfg, torch.Generator().manual_seed(1), cuda)
    with torch.no_grad():
        for w, v in zip(model.skip_weights, (0.8, -0.3, 1.2)):
            w.fill_(v)
        args = kernel_inputs(model, batch)
        kw = dict(p=spec.p, act=ACTIVATIONS[act], aggr=aggr,
                  pooling=pooling)
        before = fm.launches
        got = fm.fused_model_forward(*args, **kw)
        assert fm.launches == before + 1
        want = fm.fused_model_forward_ref(*args, **kw)
        torch.cuda.synchronize()
    mask = batch.graph_mask > 0
    torch.testing.assert_close(got[mask], want[mask], rtol=1e-4, atol=1e-5)


def test_apply_on_card_matches_cpu(cuda):
    graphs = [RxnGraph(s).arrays for s in
              ["CCO>>CC=O", "CC(=O)N>>CC(=O)N", "C=CC=C>>C=CC=C", "O>C>CO"]]
    spec = plan_spec(graphs, te=64, tn=32, tb=8).with_packs(2)
    batch = pack_graphs(graphs, [0.0] * 4, spec)
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                        depth=2, hidden_sizes=(16, 16),
                        dropout_ps=(0.0, 0.0))
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        want = apply(model, to_device(batch, "cpu"))
        got = apply(model.to(cuda), to_device(batch, cuda), spec).cpu()
        with pytest.raises(ValueError, match="PackSpec"):
            apply(model, to_device(batch, cuda))
    with pytest.raises(RuntimeError, match="no backward of its own"):
        fm.fused_model_forward(*kernel_inputs(model, to_device(batch, cuda)),
                               p=spec.p)
    mask = torch.from_numpy(batch.graph_mask > 0)
    torch.testing.assert_close(got[mask], want[mask], rtol=1e-4, atol=1e-5)


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)


def _l1(got, want):
    a = torch.cat([t.double().flatten() for t in got])
    b = torch.cat([t.double().flatten() for t in want])
    return float((a - b).abs().sum() / b.abs().sum())


def _assert_grads(act, grads, grads_ref, grads_f64):
    """Each gradient at 1e-4 of its plain version -- except with ReLU,
    where pre-activations within rounding distance of 0 may fall on
    different sides in two f32 evaluations: there the gradients, as one
    vector, are held to the float64 evaluation, at most max(3 x the f32
    plain version's relative L1 error, 1e-4) away from it (as in
    chip_smoke.py)."""
    for name, g, r in zip(fm.GRAD_NAMES, grads, grads_ref):
        assert g.shape == r.shape, name
    _held(ACTIVATIONS[act], grads, grads_ref, grads_f64)


def _f64(args):
    return [t.double() if t.is_floating_point() else t for t in args]


def _train_case(cuda, act, aggr, pooling, drop, seed=2):
    spec, batch = _batch(120, seed, 78, cuda)
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                        depth=3, hidden_sizes=(40,) * 3,
                        dropout_ps=(drop,) * 3, activation=act, aggr=aggr,
                        pooling=pooling, use_learnable_skip=True)
    model = init_params(cfg, torch.Generator().manual_seed(seed), cuda)
    with torch.no_grad():
        for w, v in zip(model.skip_weights, (0.8, -0.3, 1.2)):
            w.fill_(v)
    labels = torch.randn(batch.labels.shape, generator=torch.Generator()
                         .manual_seed(seed)).to(cuda)
    kw = dict(p=spec.p, act=ACTIVATIONS[act], aggr=aggr, pooling=pooling,
              train=drop > 0, seeds=[7, 2**31 - 2, 12345] if drop else None,
              dropout_ps=(drop,) * 3 if drop else ())
    with torch.no_grad():
        return (spec, batch, kernel_inputs(model, batch),
                adjoint_inputs(batch), labels, kw)


TRAIN_CASES = [("ReLU", "add", "add", 0.1), ("ReLU", "add", "add", 0.0),
               ("SiLU", "mean", "mean", 0.3), ("GELU", "mean", "add", 0.3),
               ("GELU", "add", "mean", 0.0), ("ReLU", "mean", "mean", 0.3)]


@pytest.mark.parametrize("act,aggr,pooling,drop", TRAIN_CASES)
def test_train_mode_forward_matches_plain(cuda, act, aggr, pooling, drop):
    spec, batch, args, _, _, kw = _train_case(cuda, act, aggr, pooling, drop)
    with torch.no_grad():
        got = fm.fused_model_forward(*args, **kw)
        want = fm.fused_model_forward_ref(*args, **kw)
        torch.cuda.synchronize()
    mask = batch.graph_mask > 0
    assert _rel(got[mask], want[mask]) <= 1e-4


@pytest.mark.parametrize("act,aggr,pooling,drop", TRAIN_CASES)
def test_train_kernel_matches_plain(cuda, act, aggr, pooling, drop):
    spec, batch, args, adj, labels, kw = _train_case(cuda, act, aggr,
                                                     pooling, drop)
    mask = batch.graph_mask
    before = fm.train_launches
    sse, grads = fm.fused_model_train(args, adj, labels, mask, **kw)
    assert fm.train_launches == before + 1
    sse_ref, grads_ref = fm.fused_model_train_ref(args, adj, labels, mask,
                                                  **kw)
    torch.cuda.synchronize()
    assert abs(float(sse) - float(sse_ref)) <= 1e-4 * abs(float(sse_ref))
    _assert_grads(act, grads, grads_ref, lambda: fm.fused_model_train_ref(
        _f64(args), adj, labels.double(), mask.double(), **kw)[1])


@pytest.mark.parametrize("act,aggr,pooling,drop", TRAIN_CASES[:3])
def test_vjp_kernel_matches_plain(cuda, act, aggr, pooling, drop):
    spec, batch, args, adj, labels, kw = _train_case(cuda, act, aggr,
                                                     pooling, drop)
    dpred = labels * batch.graph_mask
    before = fm.vjp_launches
    grads = fm.fused_model_vjp(args, adj, dpred, **kw)
    assert fm.vjp_launches == before + 1
    grads_ref = fm.fused_model_vjp_ref(args, adj, dpred, **kw)
    torch.cuda.synchronize()
    _assert_grads(act, grads, grads_ref, lambda: fm.fused_model_vjp_ref(
        _f64(args), adj, dpred.double(), **kw))


def test_autograd_through_apply_uses_the_vjp_kernel(cuda):
    """apply on the card with gradients enabled: the forward kernel, then
    the VJP kernel in backward; the gradients equal the CPU's autograd."""
    spec, batch = _batch(60, 3, 78, "cpu")
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                        depth=2, hidden_sizes=(24, 24),
                        dropout_ps=(0.2, 0.2), activation="SiLU")
    cpu = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    card = init_params(cfg, torch.Generator().manual_seed(4), cuda)
    grads = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        b = to_device(batch, dev)
        before = (fm.launches, fm.vjp_launches)
        out = apply(model, b, spec, train=True, seeds=[5, 6])
        ((out - b.labels) ** 2 * b.graph_mask).sum().backward()
        if dev != "cpu":
            assert (fm.launches, fm.vjp_launches) == (before[0] + 1,
                                                      before[1] + 1)
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    for name, want in grads[0].items():
        assert _rel(grads[1][name], want) <= 1e-4, name


def test_train_kernel_is_deterministic(cuda):
    """No atomics: two launches give the same bits."""
    spec, batch, args, adj, labels, kw = _train_case(cuda, "ReLU", "add",
                                                     "add", 0.1)
    a = fm.fused_model_train(args, adj, labels, batch.graph_mask, **kw)
    b = fm.fused_model_train(args, adj, labels, batch.graph_mask, **kw)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


# -- K2 and K3b as one cooperative grid over the card ----------------------

def _packs_case(cuda, p, act, aggr, pooling, drop, seed=3):
    """_train_case's model (depth 3, hidden 40, 78 node features) on the
    fewest synthetic graphs that fill exactly ``p`` packs (p = "many": more
    packs than the grid's blocks take in one round of a tile phase;
    "waves": more than two rounds of K3f's grid)."""
    def packed(graphs):
        spec = plan_spec(graphs, te=256, tn=128, tb=16)
        n = packs_needed(graphs, spec)
        while not place_graphs(graphs, spec.with_packs(n)):
            n += 1
        return spec.with_packs(n)

    rng = np.random.default_rng(seed)
    if p == "waves":    # more than two rounds of K3f's grid a tile phase
        blocks, n = fm.fwd_grid(10**4, 256, 40, device=cuda)[0], 256
        while True:
            graphs = synthetic_graphs(n, rng, node_feat_dim=78)
            spec = packed(graphs)
            if spec.p * 4 > 2 * blocks:
                break
            n *= 2
    elif p == "many":   # 4 tiles a pack at hidden 40
        graphs = synthetic_graphs(
            6 * (fm.bwd_grid(10**4, 256, 40, device=cuda)[0] // 4 + 20), rng,
            node_feat_dim=78)
        spec = packed(graphs)
    else:
        pool = synthetic_graphs(8 * p, rng, node_feat_dim=78)
        graphs = next(pool[:k] for k in range(1, len(pool) + 1)
                      if packed(pool[:k]).p == p)
        spec = packed(graphs)
    batch = to_device(pack_graphs(graphs, [0.0] * len(graphs), spec), cuda)
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                        depth=3, hidden_sizes=(40,) * 3,
                        dropout_ps=(drop,) * 3, activation=act, aggr=aggr,
                        pooling=pooling, use_learnable_skip=True)
    model = init_params(cfg, torch.Generator().manual_seed(seed), cuda)
    with torch.no_grad():
        for w, v in zip(model.skip_weights, (0.8, -0.3, 1.2)):
            w.fill_(v)
        args = kernel_inputs(model, batch)
    labels = torch.randn(batch.labels.shape, generator=torch.Generator()
                         .manual_seed(seed)).to(cuda)
    kw = dict(p=spec.p, act=ACTIVATIONS[act], aggr=aggr, pooling=pooling,
              train=drop > 0, seeds=[7, 2**31 - 2, 12345] if drop else None,
              dropout_ps=(drop,) * 3 if drop else ())
    return spec, batch, args, adjoint_inputs(batch), labels, kw


PACK_CASES = [(1, "ReLU", "add", "add", 0.1), (4, "ReLU", "mean", "mean", 0.0),
              (7, "GELU", "add", "mean", 0.3), ("many", "ReLU", "add", "add",
                                                 0.1),
              ("many", "SiLU", "mean", "add", 0.0)]


@pytest.mark.parametrize("mat_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,act,aggr,pooling,drop", PACK_CASES)
def test_k2_k3b_grid_match_plain(cuda, p, act, aggr, pooling, drop,
                                 mat_dtype):
    """K2 and K3b, one cooperative grid whatever p, against their plain
    versions at p = 1, 4, 7 and more packs than one round of the grid:
    f32 at 1e-4 (ReLU by the float64 rule), bf16 within rel-L2 5e-3 and
    cosine 0.999 of the bf16 plain version and by its share against the
    f32 plain version; a rerun bit for bit."""
    spec, batch, args, adj, labels, kw = _packs_case(cuda, p, act, aggr,
                                                     pooling, drop)
    if p != "many":
        assert spec.p == p
    mask = batch.graph_mask
    dpred = labels * mask
    kw = dict(kw, mat_dtype=mat_dtype)
    sse, grads = fm.fused_model_train(args, adj, labels, mask, **kw)
    again = fm.fused_model_train(args, adj, labels, mask, **kw)
    vjp = fm.fused_model_vjp(args, adj, dpred, **kw)
    vjp_again = fm.fused_model_vjp(args, adj, dpred, **kw)
    sse_ref, grads_ref = fm.fused_model_train_ref(args, adj, labels, mask,
                                                  **kw)
    vjp_ref = fm.fused_model_vjp_ref(args, adj, dpred, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sse, again[0])
    assert all(torch.equal(x, y) for x, y in zip(grads, again[1]))
    assert all(torch.equal(x, y) for x, y in zip(vjp, vjp_again))
    if mat_dtype == "float32":
        assert abs(float(sse) - float(sse_ref)) <= 1e-4 * abs(float(sse_ref))
        _assert_grads(act, grads, grads_ref, lambda: fm.fused_model_train_ref(
            _f64(args), adj, labels.double(), mask.double(), **kw)[1])
        _assert_grads(act, vjp, vjp_ref, lambda: fm.fused_model_vjp_ref(
            _f64(args), adj, dpred.double(), **kw))
        return
    f32 = dict(kw, mat_dtype="float32")
    grads32 = fm.fused_model_train_ref(args, adj, labels, mask, **f32)[1]
    vjp32 = fm.fused_model_vjp_ref(args, adj, dpred, **f32)
    assert _rel_l2([sse], [sse_ref]) <= 5e-3
    for got, want, want32 in ((grads, grads_ref, grads32),
                              (vjp, vjp_ref, vjp32)):
        assert _cos(got, want) >= 0.999
        assert _share(got, want, want32) <= 0.5


def test_k2_grid_size_does_not_change_the_result(cuda):
    """The shipped build takes one block per SM at a training batch's four
    packs (more blocks than packs) and two at a large batch; builds of the
    same source with a 7-block grid, with the phase clock, and forced to
    one or two blocks per SM give its outputs bit for bit (f32 and bf16,
    K2 and K3b, more packs than one round of the grid)."""
    from concurrent.futures import ThreadPoolExecutor

    from cgr_mpnn_3d_tpu_torch.ops import _build
    from cgr_mpnn_3d_tpu_torch.tools import k2_phases
    spec, batch, args, adj, labels, kw = _packs_case(cuda, "many", "ReLU",
                                                     "add", "add", 0.1)
    for md in ("float32", "bfloat16"):
        grid, per_sm, sms = fm.bwd_grid(4, 256, 400, md, cuda)
        assert (grid, per_sm) == (sms, 1) and grid > 4
        grid, per_sm, sms = fm.bwd_grid(spec.p, 256, 40, md, cuda)
        assert (grid, per_sm) == (2 * sms, 2) and spec.p * 4 > grid
    mask = batch.graph_mask

    def run():
        return [fm.fused_model_train(args, adj, labels, mask,
                                     **dict(kw, mat_dtype=md))
                for md in ("float32", "bfloat16")] + [
            fm.fused_model_vjp(args, adj, labels * mask,
                               **dict(kw, mat_dtype=md))
            for md in ("float32", "bfloat16")]

    def flat(res):
        return [res[0][0], *res[0][1], res[1][0], *res[1][1], *res[2],
                *res[3]]
    shipped = _build.load("fused_model_bwd")
    want = flat(run())
    defines = [{"CGR_GRID_BLOCKS": 7}, {k2_phases.DEFINE: None},
               {"CGR_BLOCKS_PER_SM": 1}, {"CGR_BLOCKS_PER_SM": 2}]
    with ThreadPoolExecutor(len(defines)) as pool:
        libs = list(pool.map(k2_phases.variant, defines))
    for d, lib in zip(defines, libs):
        _build._libs["fused_model_bwd"] = lib
        try:
            got = flat(run())
        finally:
            _build._libs["fused_model_bwd"] = shipped
        assert all(torch.equal(x, y) for x, y in zip(got, want)), d


def test_k2_phases_tool(cuda, capsys):
    """tools/k2_phases.py at a small size: every phase of the table is
    stamped, the stamped build equals the shipped one, and the wrapper's
    library is the shipped one again afterwards."""
    from cgr_mpnn_3d_tpu_torch.ops import _build
    from cgr_mpnn_3d_tpu_torch.tools import k2_phases
    shipped = _build.load("fused_model_bwd")
    out = k2_phases.main(["--small", "20", "--graphs", "60", "--repeats",
                          "2"])
    assert _build.load("fused_model_bwd") is shipped
    assert len(out) == 4 and all(r["equal"] for r in out.values())
    for r in out.values():
        names = {k.split("[")[0] for k in r["phases"]}
        assert names == set(k2_phases.PHASES[1:])
        assert sum(r["phases"].values()) == pytest.approx(r["span_ms"])
    assert "phases (ms, share of the span)" in capsys.readouterr().out


# -- K3f as one cooperative grid over the card ------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mat_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [1, 4, "waves"])
def test_k3f_grid_matches_plain(cuda, p, mat_dtype, train):
    """K3f, one cooperative grid whatever p, against its plain version at
    p = 1, 4 and more than two rounds of the grid, eval and train mode
    (dropout 0.1, add/add, learnable skips): f32 at 1e-4, bf16 within
    rel-L2 5e-3 of the bf16 plain version and by its share against the f32
    plain version; a rerun bit for bit."""
    spec, batch, args, _, _, kw = _packs_case(
        cuda, p, "ReLU", "add", "add", 0.1 if train else 0.0)
    if p != "waves":
        assert spec.p == p
    kw = dict(kw, mat_dtype=mat_dtype)
    before = fm.bf16_launches if mat_dtype == "bfloat16" else fm.launches
    with torch.no_grad():
        got = fm.fused_model_forward(*args, **kw)
        again = fm.fused_model_forward(*args, **kw)
        want = fm.fused_model_forward_ref(*args, **kw)
        want32 = fm.fused_model_forward_ref(*args,
                                            **dict(kw, mat_dtype="float32"))
    torch.cuda.synchronize()
    after = fm.bf16_launches if mat_dtype == "bfloat16" else fm.launches
    assert after == before + 2
    assert torch.equal(got, again)
    real = batch.graph_mask > 0
    got, want, want32 = got[real], want[real], want32[real]
    assert bool(torch.isfinite(got).all())
    if mat_dtype == "float32":
        assert _rel(got, want) <= 1e-4
    else:
        assert _rel_l2([got], [want]) <= 5e-3
        assert _share([got], [want], [want32]) <= 0.5


def test_k3f_grid_size_does_not_change_the_predictions(cuda):
    """K3f takes one block per SM at a request batch's four packs and two
    at a large batch; builds of its source forced to one or two blocks per
    SM give the shipped build's predictions bit for bit (f32 and bf16,
    eval and train mode, at p = 4 and more than two rounds of the grid).
    chip_smoke.py holds a 7-block grid, test_k2_phases_forward_mode the
    phase-clock build."""
    from concurrent.futures import ThreadPoolExecutor

    from cgr_mpnn_3d_tpu_torch.ops import _build
    from cgr_mpnn_3d_tpu_torch.tools import k2_phases
    for md in ("float32", "bfloat16"):
        grid, per_sm, sms = fm.fwd_grid(4, 256, 400, md, cuda)
        assert (grid, per_sm) == (sms, 1)
        grid, per_sm, sms = fm.fwd_grid(436, 256, 400, md, cuda)
        assert (grid, per_sm) == (2 * sms, 2)
    cases = [_packs_case(cuda, p, "ReLU", "add", "add", 0.1)
             for p in (4, "waves")]

    def run():
        out = []
        with torch.no_grad():
            for _, _, args, _, _, kw in cases:
                for md in ("float32", "bfloat16"):
                    for train in (False, True):
                        k = dict(kw, mat_dtype=md)
                        if not train:
                            k.update(train=False, seeds=None, dropout_ps=())
                        out.append(fm.fused_model_forward(*args, **k))
        return out
    shipped = _build.load("fused_model_fwd")
    want = run()
    assert all(torch.equal(x, y) for x, y in zip(run(), want))
    src = _build.CSRC / "fused_model_fwd.cu"
    defines = [{"CGR_BLOCKS_PER_SM": 1}, {"CGR_BLOCKS_PER_SM": 2}]
    with ThreadPoolExecutor(len(defines)) as pool:
        libs = list(pool.map(lambda d: k2_phases.variant(d, src), defines))
    for d, lib in zip(defines, libs):
        _build._libs["fused_model_fwd"] = lib
        try:
            got = run()
        finally:
            _build._libs["fused_model_fwd"] = shipped
        assert all(torch.equal(x, y) for x, y in zip(got, want)), d


def test_k2_phases_forward_mode(cuda, capsys):
    """tools/k2_phases.py --forward at a small size: K3f's forward phases
    are stamped, the stamped build equals the shipped one, and the
    wrapper's library is the shipped one again afterwards."""
    from cgr_mpnn_3d_tpu_torch.ops import _build
    from cgr_mpnn_3d_tpu_torch.tools import k2_phases
    shipped = _build.load("fused_model_fwd")
    out = k2_phases.main(["--forward", "--small", "20", "--graphs", "60",
                          "--repeats", "2"])
    assert _build.load("fused_model_fwd") is shipped
    assert len(out) == 4 and all(r["equal"] for r in out.values())
    for r in out.values():
        names = {k.split("[")[0] for k in r["phases"]}
        assert names == set(k2_phases.PHASES[1:7])
        assert sum(r["phases"].values()) == pytest.approx(r["span_ms"])
    assert "K3f float32" in capsys.readouterr().out


@pytest.mark.parametrize("forward", [False, True], ids=["K2", "K3f"])
def test_bwd_registers_tool(cuda, forward, capsys):
    """tools/bwd_registers.py at a small size, for K2 and with --forward
    for K3f: the builds forced to one and two blocks per SM give the
    shipped build's outputs bit for bit, each build is timed twice at each
    case, and the wrapper's library is the shipped one again."""
    from cgr_mpnn_3d_tpu_torch.ops import _build
    from cgr_mpnn_3d_tpu_torch.tools import bwd_registers
    name = "fused_model_fwd" if forward else "fused_model_bwd"
    shipped = _build.load(name)
    out = bwd_registers.main(["--small", "20", "--graphs", "60", "--repeats",
                              "2"] + (["--forward"] if forward else []))
    assert _build.load(name) is shipped
    assert len(out["equal"]) == 4 and all(out["equal"].values())
    assert all(len(v) == 2 for ms in out["ms"].values() for v in ms.values())
    assert ("K3f" if forward else "K2") + " float32" in capsys.readouterr().out


def _pool_case(cuda, seed, p=2, R=150, ca=200, GP=3, DN=150, H=40, F=24):
    """K11's forward inputs at small width with a pool ELL of DN entries a
    group (more than one chunk): group 0 of each pack every row of its pack
    in a seeded order, group 1 a few rows then sentinels, the rest rows of
    the other pack (out of pack) between sentinels."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(cuda)
    idx = torch.randint(0, ca, (p * R, 3), generator=gen)
    idx += (torch.arange(p * R) // R * ca)[:, None]
    idx[::7, 2] = p * ca                            # sentinels
    ell = torch.full((p * GP, DN), p * R, dtype=torch.int64)
    for q in range(p):
        ell[q * GP, :R] = torch.randperm(R, generator=gen) + q * R
        ell[q * GP + 1, :5] = torch.arange(5) + q * R
        other = ((q + 1) % p) * R
        ell[q * GP + 2, 1::3] = torch.arange(len(range(1, DN, 3))) + other
        ell[q * GP + 2, ::17] = torch.arange(len(range(0, DN, 17))) + q * R
    node_group = (torch.arange(p * R) // R * GP).to(torch.int32)
    ins = (rand(p * ca, H), rand(p * R, H, scale=0.5), rand(p * R, F),
           idx.to(torch.int32).to(cuda), node_group.to(cuda),
           ell.to(torch.int32).to(cuda))
    ws = (rand(H, H, scale=H ** -0.5), rand(F, H, scale=F ** -0.5),
          rand(H, scale=0.1))
    return ins, ws


@pytest.mark.parametrize("DN", [150, 32, 7])
@pytest.mark.parametrize("mat_dtype", ["float32", "bfloat16"])
def test_k11_split_pool_matches_plain(cuda, DN, mat_dtype):
    """K11's forward, its group pool an ordered split sum over chunks of
    the pool ELL (a group longer than one chunk, with sentinel and
    out-of-pack entries; one chunk exactly; fewer entries than a chunk),
    against the plain version: f32 at 1e-4, bf16 within rel-L2 5e-3 of the
    bf16 plain version and by its share against the f32 one; reruns bit
    for bit."""
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    ins, ws = _pool_case(cuda, 21, R=150 if DN == 150 else DN, DN=DN)
    if mat_dtype == "bfloat16":
        ins = (ins[0].bfloat16(), ins[1], ins[2].bfloat16(), *ins[3:])
    kw = dict(p=2, act="relu", mat_dtype=mat_dtype)
    with torch.no_grad():
        got = gl.gather_linear_pool_forward(*ins, *ws, **kw)
        again = gl.gather_linear_pool_forward(*ins, *ws, **kw)
        want = gl.gather_linear_pool_forward_ref(*ins, *ws, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert gl.pool_chunks(DN) == -(-DN // gl.POOL_CHUNK)
    if mat_dtype == "float32":
        assert _rel(got[0], want[0]) <= 1e-4
        assert _rel(got[1], want[1]) <= 1e-4
        return
    f32 = [t.float() if t.is_floating_point() else t for t in ins]
    with torch.no_grad():
        want32 = gl.gather_linear_pool_forward_ref(
            *f32, *ws, **dict(kw, mat_dtype="float32"))
    assert _rel_l2([got[1]], [want[1]]) <= 5e-3
    assert _share([got[1]], [want[1]], [want32[1]]) <= 0.5


# -- the layered kernels (K7, K5, K4) ---------------------------------------

def _held(act, got, want, want64):
    """Outputs of a backward kernel against its plain version: each at
    1e-4, except with ReLU, where they are held as one vector to the float64
    evaluation by the rule of _assert_grads."""
    if act != "relu":
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-4
        return
    exact = want64()
    assert _l1(got, exact) <= max(3 * _l1(want, exact), 1e-4)


def _layered_inputs(cuda, seed=5, H=40, F=78):
    spec, batch = _batch(120, seed, F, cuda)
    rng = np.random.default_rng(seed)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(cuda)
    return spec, batch, rand


def test_onehot_spmm_kernel_matches_plain(cuda):
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    spec, b, rand = _layered_inputs(cuda)
    h_e, h_n = rand(b.edge_nbr.shape[0], 40), rand(b.node_x.shape[0], 40)
    for src, idx, sign in ((h_e, b.edge_nbr, b.rev), (h_n, b.graph_nodes, None),
                           (h_e, b.node_inc, None)):
        before = sp.launches
        got = sp.onehot_spmm(src, idx, sign, p=spec.p)
        assert sp.launches == before + 1
        want = sp.onehot_spmm_ref(src, idx, sign, p=spec.p)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 1e-5
    # spmm: K7 forward, K7 over the transposed ELL backward
    src = h_n.clone().requires_grad_()
    before = (sp.launches, sp.bwd_launches)
    out = sp.spmm(src, b.graph_nodes, b.graph_of_node[:, None], p=spec.p)
    cot = rand(*out.shape)
    (got,) = torch.autograd.grad((out * cot).sum(), src)
    assert (sp.launches, sp.bwd_launches) == (before[0] + 1, before[1] + 1)
    with torch.enable_grad():
        ref = sp.onehot_spmm_ref(src, b.graph_nodes, p=spec.p)
        (want,) = torch.autograd.grad((ref * cot).sum(), src)
    assert _rel(got, want) <= 1e-5


SPMM_DEFINES = [{"CGR_SPMM_VEC_BYTES": 4}, {"CGR_SPMM_LANES": 32}]


def _spmm_cases(cuda):
    """K7's edges on a 120-graph batch: rows of F = 270 (1,080 and 540
    bytes, no multiple of 16) and H = 400, f32 and bf16 sources, an ELL
    of 40 entries a row (two index chunks; repeats and a tail of
    sentinels), D = 1, the sign row, and a source whose base lies off a
    16-byte boundary: [(name, src, idx, sign, mat_dtype)]."""
    spec, b, rand = _layered_inputs(cuda, F=270)
    NT, ET = b.node_x.shape[0], b.edge_nbr.shape[0]
    x, h = b.node_x, rand(ET, 400)
    wide = torch.full((b.graph_nodes.shape[0], 40), NT, dtype=torch.int32,
                      device=cuda)
    wide[:, :b.graph_nodes.shape[1]] = b.graph_nodes
    wide[::2, 33:39] = b.graph_nodes[::2, :6]
    off = rand(NT * 400 + 1)[1:].view(NT, 400)
    off16 = rand(NT * 270 + 1).bfloat16()[1:].view(NT, 270)
    cases = []
    for md in ("float32", "bfloat16"):
        cases += [("x[senders] 270", x, b.senders[:, None], None, md),
                  ("messages 400", h, b.edge_nbr, b.rev, md),
                  ("pool DN 40", rand(NT, 400), wide, None, md),
                  ("offset base", off, b.graph_nodes, None, md)]
    cases += [("x[senders] 270 bf16 src", x.bfloat16(), b.senders[:, None],
               None, "bfloat16"),
              ("offset bf16 base", off16, b.graph_nodes, None, "bfloat16"),
              ("messages bf16 src", h.bfloat16(), b.edge_nbr, b.rev,
               "bfloat16")]
    return spec.p, cases


def _spmm_run(cuda):
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    p, cases = _spmm_cases(cuda)
    with torch.no_grad():
        return [sp.onehot_spmm(s, i, g, p=p, mat_dtype=md)
                for _, s, i, g, md in cases]


def test_spmm_grid_matches_plain_and_reruns(cuda):
    """Every edge case at its plain version (the same operands summed in
    another order: 1e-5 of the largest value), reruns bit for bit, one
    launch a call on the counters."""
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    p, cases = _spmm_cases(cuda)
    got = _spmm_run(cuda)
    assert all(torch.equal(x, y) for x, y in zip(got, _spmm_run(cuda)))
    for (name, s, i, g, md), y in zip(cases, got):
        before = (sp.launches, sp.bf16_launches)
        with torch.no_grad():
            again = sp.onehot_spmm(s, i, g, p=p, mat_dtype=md)
        bf16 = md == "bfloat16"
        assert (sp.launches, sp.bf16_launches) == (before[0] + (not bf16),
                                                   before[1] + bf16), name
        assert torch.equal(again, y), name
        want = sp.onehot_spmm_ref(s, i, g, p=p, mat_dtype=md)
        assert y.dtype == torch.float32 and _rel(y, want) <= 1e-5, name


def test_spmm_forced_builds_are_bit_identical(cuda):
    """The builds forced to 4-byte loads and to one row a warp give the
    shipped build's outputs bit for bit on every edge case."""
    want = _spmm_run(cuda)
    for d, lib in zip(SPMM_DEFINES, _conv_variants("onehot_spmm",
                                                   SPMM_DEFINES)):
        got = _through("onehot_spmm", lib, lambda: _spmm_run(cuda))
        assert all(torch.equal(x, y) for x, y in zip(got, want)), d


def test_spmm_plan_is_the_wrappers_mirror(cuda):
    """The kernel's launch plan equals launch_plan's at the main paths'
    widths and at base addresses off every boundary."""
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    for rows, W, ss, os_ in ((6976, 400, 4, 4), (6976, 400, 2, 4),
                             (1024, 270, 4, 4), (1024, 270, 2, 4),
                             (512, 400, 4, 2), (64, 40, 4, 4),
                             (300, 7, 4, 4), (64, 1000, 4, 4)):
        for sptr in range(0, 64, ss):
            for optr in (0, 4, 8, 16, 24):
                want = sp.launch_plan(rows, W, ss, os_, 4096 + sptr,
                                      8192 + optr)
                assert sp.kernel_plan(rows, W, ss, os_, 4096 + sptr,
                                      8192 + optr) == want


def test_spmm_bf16_backward_stores_the_cast_sum(cuda, monkeypatch):
    """With a bf16 source the backward stores d_src in bf16 itself: the
    f32 sum of the same kernel cast, bit for bit, and the tensor the
    launch wrote is the gradient autograd returns (no cast after it); an
    f32 source's d_src stays f32."""
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    spec, b, rand = _layered_inputs(cuda, F=270)
    launched = []
    run = sp._run

    def recorded(*a, **k):
        launched.append(run(*a, **k))
        return launched[-1]
    for src, idx, bwd in ((b.node_x, b.senders[:, None], b.node_out),
                          (rand(b.node_x.shape[0], 400), b.graph_nodes,
                           b.graph_of_node[:, None])):
        for dt in (torch.bfloat16, torch.float32):
            s = src.to(dt).requires_grad_()
            out = sp.spmm(s, idx, bwd, p=spec.p, mat_dtype="bfloat16")
            g = rand(*out.shape)
            before = sp.bf16_bwd_launches
            launched.clear()
            monkeypatch.setattr(sp, "_run", recorded)
            (d,) = torch.autograd.grad(out, s, g)
            monkeypatch.setattr(sp, "_run", run)
            assert sp.bf16_bwd_launches == before + 1
            assert len(launched) == 1
            assert d.data_ptr() == launched[0].data_ptr()
            with torch.no_grad():
                f32 = sp.onehot_spmm(g, bwd, p=spec.p, mat_dtype="bfloat16")
            assert d.dtype == dt and torch.equal(d, f32.to(dt))


@pytest.mark.parametrize("stage,act,mean", [("edge_init", "relu", False),
                                            ("readout", "gelu", True),
                                            ("readout", "silu", False)])
def test_gather_linear_kernel_matches_plain(cuda, stage, act, mean):
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    spec, b, rand = _layered_inputs(cuda)
    H, F = 40, b.node_x.shape[1]
    ET, NT = b.edge_nbr.shape[0], b.node_x.shape[0]
    if stage == "edge_init":
        xa, xb, idx, adj = b.node_x, rand(ET, 14), b.senders[:, None], \
            b.node_out
    else:
        xa, xb, idx, adj = rand(ET, H), b.node_x, b.node_inc, \
            b.receivers[:, None]
    ws = (rand(xa.shape[1], H, scale=0.2), rand(xb.shape[1], H, scale=0.2),
          rand(H, scale=0.1))
    kw = dict(p=spec.p, act=act, mean=mean)
    before = (gl.launches, gl.bwd_launches)
    out = gl.gather_linear_forward(xa, xb, idx, *ws, **kw)
    want = gl.gather_linear_forward_ref(xa, xb, idx, *ws, **kw)
    g = rand(*out.shape)
    grads = gl.gather_linear_backward(xa, xb, idx, adj, *ws, out, g, **kw)
    assert (gl.launches, gl.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = gl.gather_linear_backward_ref(xa, xb, idx, adj, *ws, want, g, **kw)
    torch.cuda.synchronize()
    assert _rel(out, want) <= 1e-4
    _held(act, grads, ref, lambda: gl.gather_linear_backward_ref(
        *_f64([xa, xb]), idx, adj, *_f64(ws), want.double(), g.double(),
        **kw))
    again = gl.gather_linear_backward(xa, xb, idx, adj, *ws, out, g, **kw)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    part = gl.gather_linear_backward(xa, xb, idx, adj, *ws, out, g, **kw,
                                     needs=(False, True, False, True, False))
    assert part[0] is None and torch.equal(part[1], grads[1])


@pytest.mark.parametrize("act,mean,drop", [("relu", False, 0.1),
                                           ("silu", True, 0.0),
                                           ("gelu", False, 0.3)])
def test_conv_stack_kernel_matches_plain(cuda, act, mean, drop):
    from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
    spec, b, rand = _layered_inputs(cuda)
    ET, H, L = b.edge_nbr.shape[0], 40, 3
    h0 = rand(ET, H)
    ws = (rand(L, H, H, scale=0.2), rand(L, H, scale=0.1),
          torch.tensor([0.8, -0.3, 1.2], device=cuda))
    kw = dict(p=spec.p, act=act, mean=mean, train=drop > 0,
              seeds=[7, 2**31 - 2, 12345] if drop else None,
              dropout_ps=(drop,) * L if drop else ())
    idx = (b.edge_nbr, b.rev)
    before = (cs.launches, cs.bwd_launches)
    out = cs.conv_stack_forward(h0, *idx, *ws, **kw)
    want = cs.conv_stack_forward_ref(h0, *idx, *ws, **kw)
    g = rand(*out.shape)
    grads = cs.conv_stack_backward(h0, *idx, b.edge_nbr_rev, *ws, g, **kw)
    assert (cs.launches, cs.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = cs.conv_stack_backward_ref(h0, *idx, b.edge_nbr_rev, *ws, g, **kw)
    torch.cuda.synchronize()
    assert _rel(out, want) <= 1e-4
    _held(act, grads, ref, lambda: cs.conv_stack_backward_ref(
        h0.double(), *idx, b.edge_nbr_rev, *_f64(ws), g.double(), **kw))
    again = cs.conv_stack_backward(h0, *idx, b.edge_nbr_rev, *ws, g, **kw)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


def test_layered_apply_matches_whole_model(cuda):
    """apply with fuse_whole_model=False on the card: K5, K4, K5, K7
    forward (no K3f), their backward kernels under autograd (no K2, no
    K3b); predictions and gradients equal the whole-model kernels'."""
    import dataclasses
    from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    spec, batch = _batch(120, 6, 78, cuda)
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                        depth=3, hidden_sizes=(40,) * 3,
                        dropout_ps=(0.2,) * 3, activation="SiLU",
                        aggr="mean", pooling="mean", use_learnable_skip=True)
    out = {}
    for fuse in (True, False):
        model = init_params(dataclasses.replace(cfg, fuse_whole_model=fuse),
                            torch.Generator().manual_seed(8), cuda)
        def counts():
            return [(fm.launches, fm.vjp_launches)] + [
                (m.launches, m.bwd_launches) for m in (gl, cs, sp)]
        before = counts()
        pred = apply(model, batch, spec, train=True, seeds=[1, 2, 3])
        ((pred - batch.labels) ** 2 * batch.graph_mask).sum().backward()
        torch.cuda.synchronize()
        counts = [(a - c, b - d) for (a, b), (c, d) in zip(counts(), before)]
        assert counts == ([(1, 1), (0, 0), (0, 0), (0, 0)] if fuse else
                          [(0, 0), (2, 2), (1, 1), (1, 1)])
        out[fuse] = (pred.detach(), {n: p.grad for n, p in
                                     model.named_parameters()})
    mask = batch.graph_mask > 0
    assert _rel(out[False][0][mask], out[True][0][mask]) <= 1e-4
    for name, g in out[True][1].items():
        assert _rel(out[False][1][name], g) <= 1e-4, name


# -- capture mode: the per-layer conv kernel (K6), K7, the probe (P1) -------

@pytest.mark.parametrize("act,mean,drop,hin", [("relu", False, 0.1, 40),
                                               ("silu", True, 0.0, 40),
                                               ("gelu", False, 0.3, 40),
                                               ("relu", True, 0.0, 24)])
def test_fused_conv_kernel_matches_plain(cuda, act, mean, drop, hin):
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    spec, b, rand = _layered_inputs(cuda)
    ET, H = b.edge_nbr.shape[0], 40
    ins = (rand(ET, hin), rand(ET, H), b.edge_nbr, b.rev)
    ws = (rand(hin, H, scale=0.2), rand(H, scale=0.1),
          torch.tensor(0.8, device=cuda))
    kw = dict(p=spec.p, act=act, mean=mean, train=drop > 0,
              seed=2**31 - 2 if drop else None, dropout_p=drop)
    before = (fc.launches, fc.bwd_launches)
    out = fc.fused_conv_forward(*ins, *ws, **kw)
    want = fc.fused_conv_layer_ref(*ins, *ws, **kw)
    g = rand(*out.shape)
    bwd = (*ins, b.edge_nbr_rev, *ws)
    grads = fc.fused_conv_backward(*bwd, out, g, **kw)
    assert (fc.launches, fc.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = fc.fused_conv_backward_ref(*bwd, want, g, **kw)
    torch.cuda.synchronize()
    assert _rel(out, want) <= 1e-4
    assert [t.shape for t in grads] == [t.shape for t in ref]
    _held(act, grads, ref, lambda: fc.fused_conv_backward_ref(
        *_f64(ins), b.edge_nbr_rev, *_f64(ws), want.double(), g.double(),
        **kw))
    again = fc.fused_conv_backward(*bwd, out, g, **kw)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    part = fc.fused_conv_backward(*bwd, out, g, **kw,
                                  needs=(False, True, False, False, True))
    assert part[0] is None and torch.equal(part[1], grads[1])
    assert torch.equal(part[4], grads[4])


def test_capture_on_card_matches_cpu_and_layered(cuda):
    """apply(capture=True) on the card: K7 three times and K6 once per layer
    forward, the same backward except K7 over node_out (node features take
    no gradient); no K3f, K4 or K5.  Every activation equals the CPU's
    capture, and the predictions and gradients equal the layered path's."""
    import dataclasses
    from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    spec, batch = _batch(120, 9, 78, "cpu")
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                        depth=3, hidden_sizes=(40,) * 3,
                        dropout_ps=(0.2, 0.0, 0.3), activation="GELU",
                        aggr="mean", pooling="mean", use_learnable_skip=True)
    cpu = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    with torch.no_grad():
        for w, v in zip(cpu.skip_weights, (0.8, -0.3, 1.2)):
            w.fill_(v)
    card = init_params(cfg, torch.Generator().manual_seed(3), cuda)
    card.load_state_dict(cpu.state_dict())
    b_cpu, b_card = to_device(batch, "cpu"), to_device(batch, cuda)
    with torch.no_grad():
        want, acts_cpu = apply(cpu, b_cpu, spec, capture=True)
        with pytest.raises(ValueError, match="PackSpec"):
            apply(card, b_card, capture=True)

    def counts():
        return [(fm.launches, fm.vjp_launches)] + [
            (m.launches, m.bwd_launches) for m in (gl, cs, sp, fc)]
    before = counts()
    got, acts = apply(card, b_card, spec, train=True, seeds=[1, 2, 3],
                      capture=True)
    ((got - b_card.labels) ** 2 * b_card.graph_mask).sum().backward()
    torch.cuda.synchronize()
    assert [(a - c, d - e) for (a, d), (c, e) in zip(counts(), before)] == [
        (0, 0), (0, 0), (0, 0), (3, 2), (3, 3)]
    with torch.no_grad():
        got_eval, acts_eval = apply(card, b_card, spec, capture=True)
    for k, v in acts_cpu.items():
        assert _rel(acts_eval[k].cpu(), v) <= 1e-4, k
    mask = batch.graph_mask > 0
    assert _rel(got_eval.cpu()[mask], want[mask]) <= 1e-4
    layered = init_params(dataclasses.replace(cfg, fuse_whole_model=False),
                          torch.Generator().manual_seed(3), cuda)
    layered.load_state_dict(cpu.state_dict())
    pred = apply(layered, b_card, spec, train=True, seeds=[1, 2, 3])
    ((pred - b_card.labels) ** 2 * b_card.graph_mask).sum().backward()
    assert _rel(got.detach()[mask.to(cuda)],
                pred.detach()[mask.to(cuda)]) <= 1e-4
    g_lay = dict(layered.named_parameters())
    for name, prm in card.named_parameters():
        assert _rel(prm.grad, g_lay[name].grad) <= 1e-4, name


@pytest.mark.parametrize("fn", ["relu", "silu", "gelu", "gelu_bwd",
                                "gelu_bwd_from_out"])
def test_act_chain_kernel_matches_plain(cuda, fn):
    from cgr_mpnn_3d_tpu_torch.ops import act_chain as ac
    x = torch.randn((1000, 333), generator=torch.Generator().manual_seed(0))
    x = (3.0 * x).to(cuda)
    for k in (0, 1, 4):
        before = ac.launches
        got = ac.act_chain(x, fn, k)
        assert ac.launches == before + 1
        want = ac.act_chain_ref(x, fn, k)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 1e-4, k


# -- bf16 compute: K3f, K2 and K3b at mat_dtype bf16; the matmul probe P2 ---

def _rel_l2(got, want):
    a = torch.cat([t.double().flatten() for t in got])
    b = torch.cat([t.double().flatten() for t in want])
    return float((a - b).norm() / b.norm())


def _cos(got, want):
    a = torch.cat([t.double().flatten() for t in got])
    b = torch.cat([t.double().flatten() for t in want])
    return float(a @ b / (a.norm() * b.norm()))


def _share(got, want16, want32):
    """A bf16 result's rel-L2 to the bf16 plain version over its rel-L2 to
    the f32 one: at most 1/2 for a kernel that rounds where the plain
    version does, above that for one that runs f32 products."""
    return _rel_l2(got, want16) / max(_rel_l2(got, want32), 1e-300)


def _bf16_counts():
    return (fm.launches, fm.train_launches, fm.vjp_launches,
            fm.bf16_launches, fm.bf16_train_launches, fm.bf16_vjp_launches)


@pytest.mark.parametrize("act,aggr,pooling,drop", [
    ("ReLU", "add", "add", 0.1), ("SiLU", "mean", "mean", 0.3),
    ("GELU", "mean", "add", 0.0)])
def test_bf16_kernels_match_plain(cuda, act, aggr, pooling, drop):
    """The bf16 instantiation of K3f, K2 and K3b against their bf16 plain
    versions: predictions and SSE within rel-L2 5e-3, gradients at cosine
    >= 0.999 (the f32 sums run in other orders, which can flip a bf16
    rounding); predictions and gradients at most half as far from the bf16
    plain version as from the f32 one, which the f32 kernel on the same
    inputs is not; K2 and K3b reruns bit for bit; only the bf16 counters
    move; and bf16 differs from f32 within tests/test_bf16.py's 1.5e-2."""
    spec, batch, args, adj, labels, kw = _train_case(cuda, act, aggr,
                                                     pooling, drop)
    kw = dict(kw, mat_dtype="bfloat16")
    mask = batch.graph_mask
    m, dpred = mask > 0, labels * mask
    before = _bf16_counts()
    with torch.no_grad():
        preds = fm.fused_model_forward(*args, **kw)
        preds_ref = fm.fused_model_forward_ref(*args, **kw)
        preds32 = fm.fused_model_forward_ref(*args, **dict(
            kw, mat_dtype="float32"))
    sse, grads = fm.fused_model_train(args, adj, labels, mask, **kw)
    again = fm.fused_model_train(args, adj, labels, mask, **kw)
    sse_ref, grads_ref = fm.fused_model_train_ref(args, adj, labels, mask,
                                                  **kw)
    vjp = fm.fused_model_vjp(args, adj, dpred, **kw)
    vjp_again = fm.fused_model_vjp(args, adj, dpred, **kw)
    vjp_ref = fm.fused_model_vjp_ref(args, adj, dpred, **kw)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_bf16_counts(), before)] == [0, 0, 0, 1, 2,
                                                               2]
    f32 = dict(kw, mat_dtype="float32")
    grads32 = fm.fused_model_train_ref(args, adj, labels, mask, **f32)[1]
    vjp32 = fm.fused_model_vjp_ref(args, adj, dpred, **f32)
    with torch.no_grad():
        control = (fm.fused_model_forward(*args, **f32)[m],
                   fm.fused_model_train(args, adj, labels, mask, **f32)[1],
                   fm.fused_model_vjp(args, adj, dpred, **f32))
    for got, want, want32, ctrl in (
            ([preds[m]], [preds_ref[m]], [preds32[m]], [control[0]]),
            (grads, grads_ref, grads32, control[1]),
            (vjp, vjp_ref, vjp32, control[2])):
        assert _share(got, want, want32) <= 0.5
        assert _share(ctrl, want, want32) > 0.5
    assert _rel_l2([preds[m]], [preds_ref[m]]) <= 5e-3
    assert 0.0 < _rel_l2([preds[m]], [preds32[m]]) < 1.5e-2
    assert _rel_l2([sse], [sse_ref]) <= 5e-3
    assert _cos(grads, grads_ref) >= 0.999
    assert _cos(vjp, vjp_ref) >= 0.999
    assert torch.equal(sse, again[0])
    assert all(torch.equal(x, y) for x, y in zip(grads, again[1]))
    assert all(torch.equal(x, y) for x, y in zip(vjp, vjp_again))


def test_bf16_model_on_card_matches_cpu(cuda):
    """A bf16 model on the card: apply (K3f bf16, K3b bf16 under autograd)
    and the training step (one bf16 K2 launch) against the same model on
    the CPU (the plain versions at bf16), and at most half as far from it
    as from the model computing in f32 on the CPU."""
    spec, batch = _batch(60, 11, 78, "cpu")
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                        depth=2, hidden_sizes=(24, 24), dropout_ps=(0.2, 0.2),
                        activation="GELU", compute_dtype="bfloat16")
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    out = []
    for dev, conf in (("cpu", cfg), (cuda, cfg), ("cpu", f32)):
        model = init_params(conf, torch.Generator().manual_seed(4), dev)
        b = to_device(batch, dev)
        before = _bf16_counts()
        pred = apply(model, b, spec, train=True, seeds=[5, 6])
        ((pred - b.labels) ** 2 * b.graph_mask).sum().backward()
        vjp_grads = [p.grad.cpu() for p in model.parameters()]
        sse = fused_train_value_and_grad(model, b, spec, [5, 6])
        step_grads = [p.grad.cpu() for p in model.parameters()]
        if dev != "cpu":
            torch.cuda.synchronize()
            assert [a - c for a, c in zip(_bf16_counts(), before)] == [
                0, 0, 0, 1, 1, 1]
        out.append((pred.detach().cpu(), vjp_grads, sse.cpu(), step_grads))
    (p0, v0, s0, g0), (p1, v1, s1, g1), (p32, v32, _, g32) = out
    mask = batch.graph_mask > 0
    assert _rel_l2([p1[mask]], [p0[mask]]) <= 5e-3
    assert _rel_l2([s1], [s0]) <= 5e-3
    assert _cos(v1, v0) >= 0.999 and _cos(g1, g0) >= 0.999
    assert _share([p1[mask]], [p0[mask]], [p32[mask]]) <= 0.5
    assert _share(v1, v0, v32) <= 0.5 and _share(g1, g0, g32) <= 0.5


def test_no_cuda_tensor_reaches_a_plain_version(cuda, monkeypatch):
    """With every plain version of K3f, K2, K3b and P2 (and its int8
    transpose) replaced by one that raises, the wrappers, apply and the
    training step still run on the card, in f32 and in bf16."""
    from cgr_mpnn_3d_tpu_torch.models import cgr_mpnn as cm
    from cgr_mpnn_3d_tpu_torch.ops import mm_probe as mp

    def refuse(*a, **k):
        raise AssertionError("a plain version was called")
    for name in ("fused_model_forward_ref", "fused_model_train_ref",
                 "fused_model_vjp_ref"):
        monkeypatch.setattr(fm, name, refuse)
    monkeypatch.setattr(mp, "mm_probe_ref", refuse)
    monkeypatch.setattr(mp, "transpose_s8_ref", refuse)
    spec, batch = _batch(60, 12, 78, cuda)
    for dtype in ("float32", "bfloat16"):
        cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                            depth=2, hidden_sizes=(24, 24),
                            dropout_ps=(0.1, 0.1), compute_dtype=dtype)
        model = init_params(cfg, torch.Generator().manual_seed(1), cuda)
        pred = apply(model, batch, spec, train=True, seeds=[1, 2])
        pred.sum().backward()
        cm.fused_train_value_and_grad(model, batch, spec, [1, 2])
    a = torch.randint(-3, 4, (128, 128), dtype=torch.int8, device=cuda)
    mp.mm_probe(a, a)
    mp.mm_probe(a.bfloat16(), a.bfloat16())
    mp.transpose_s8(a)
    torch.cuda.synchronize()


@pytest.mark.parametrize("M,N,K", [(512, 512, 512), (256, 384, 192),
                                   (128, 128, 64), (384, 640, 1088)])
def test_mm_probe_kernel_matches_plain(cuda, M, N, K):
    """At the pipeline's edges: (128, 128, 64) is one K block, fewer than
    the 4 stages; N = 384 and 640 are no multiples of the 256-wide tile;
    K = 1088 is 17 bf16 K blocks (9 int8), so the ring wraps."""
    from cgr_mpnn_3d_tpu_torch.ops import mm_probe as mp
    gen = torch.Generator().manual_seed(M + K)
    a8 = torch.randint(-3, 4, (M, K), generator=gen, dtype=torch.int8)
    b8 = torch.randint(-3, 4, (K, N), generator=gen, dtype=torch.int8)
    a16 = torch.randn((M, K), generator=gen).bfloat16()
    b16 = torch.randn((K, N), generator=gen).bfloat16()
    before = mp.launches
    got8 = mp.mm_probe(a8.to(cuda), b8.to(cuda))
    got16 = mp.mm_probe(a16.to(cuda), b16.to(cuda))
    torch.cuda.synchronize()
    assert mp.launches == before + 2
    assert got8.dtype == torch.int8 and got16.dtype == torch.bfloat16
    assert torch.equal(got8.cpu(), mp.mm_probe_ref(a8, b8))
    assert _rel_l2([got16.cpu()], [mp.mm_probe_ref(a16, b16)]) <= 4e-3
    with pytest.raises(ValueError, match="multiples of 128"):
        mp.mm_probe(a8[:100].to(cuda), b8.to(cuda))


@pytest.mark.parametrize("M,N,K", [(256, 384, 192), (384, 640, 1088)])
def test_mm_probe_kernel_full_range(cuda, M, N, K):
    """int8 over [-128, 127]: sums far past the int8 range, wrapped to
    their low 8 bits, equal to the plain version; bf16 entries near 1e3
    within rel-L2 4e-3; a rerun equal bit for bit in both types."""
    from cgr_mpnn_3d_tpu_torch.ops import mm_probe as mp
    gen = torch.Generator().manual_seed(N + K)
    a8 = torch.randint(-128, 128, (M, K), generator=gen, dtype=torch.int8)
    b8 = torch.randint(-128, 128, (K, N), generator=gen, dtype=torch.int8)
    a16 = (1e3 + 30 * torch.randn((M, K), generator=gen)).bfloat16()
    b16 = (1e3 * torch.randn((K, N), generator=gen)).bfloat16()
    got8 = mp.mm_probe(a8.to(cuda), b8.to(cuda))
    got16 = mp.mm_probe(a16.to(cuda), b16.to(cuda))
    again8 = mp.mm_probe(a8.to(cuda), b8.to(cuda))
    again16 = mp.mm_probe(a16.to(cuda), b16.to(cuda))
    torch.cuda.synchronize()
    want8 = mp.mm_probe_ref(a8, b8)
    assert torch.equal(got8.cpu(), want8)
    assert (a8.double() @ b8.double()).abs().max() > 127 * 64
    assert _rel_l2([got16.cpu()], [mp.mm_probe_ref(a16, b16)]) <= 4e-3
    assert torch.equal(got8, again8) and torch.equal(got16, again16)


def test_mm_probe_parts_tool(cuda, capsys):
    """tools/mm_probe_parts.py at a small N: every variant builds, runs and
    (but for "no stores") equals the shipped build; the wrapper's library
    is the shipped one again afterwards."""
    from cgr_mpnn_3d_tpu_torch.ops import _build
    from cgr_mpnn_3d_tpu_torch.tools import mm_probe_parts
    shipped = _build.load("mm_probe")
    out = mm_probe_parts.main(["--n", "512", "--steps", "2",
                               "--repeats", "1"])
    assert _build.load("mm_probe") is shipped
    assert set(out["ms"]) == {"shipped", *mm_probe_parts.VARIANTS}
    assert all(len(v) == (2 if name == "shipped" else 1)
               for name, d in out["ms"].items() for v in d.values())
    assert set(out["waves"]) == {"M=512", "M=640"} and out["clocks"]
    assert "P2 bf16 running" in capsys.readouterr().out


@pytest.mark.parametrize("K,N", [(64, 64), (192, 384), (1088, 640)])
def test_mm_probe_transpose_matches_plain(cuda, K, N):
    """The int8 transpose mm_probe runs before an int8 product, alone:
    equal to b.t(), one launch on its counter."""
    from cgr_mpnn_3d_tpu_torch.ops import mm_probe as mp
    gen = torch.Generator().manual_seed(K)
    b = torch.randint(-128, 128, (K, N), generator=gen, dtype=torch.int8)
    before = (mp.transpose_launches, mp.launches)
    got = mp.transpose_s8(b.to(cuda))
    torch.cuda.synchronize()
    assert (mp.transpose_launches, mp.launches) == (before[0] + 1, before[1])
    assert got.shape == (N, K) and torch.equal(got.cpu(), b.t())
    with pytest.raises(ValueError, match="multiples of 64"):
        mp.transpose_s8(b[:, :32].contiguous().to(cuda))
    with pytest.raises(TypeError, match="int8"):
        mp.transpose_s8(b.bfloat16().to(cuda))


# -- bf16 compute in the layered and capture paths: K4-K7 at mat_dtype bf16 --

def _layered_counts():
    from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    return {name: (m.launches, m.bwd_launches, m.bf16_launches,
                   m.bf16_bwd_launches)
            for name, m in (("K4", cs), ("K5", gl), ("K6", fc), ("K7", sp))}


def _moved(before):
    return {k: tuple(a - b for a, b in zip(v, before[k]))
            for k, v in _layered_counts().items() if v != before[k]}


def _bf16_hold(got, want16, want32, ctrl):
    """The share hold: the bf16 kernel at most half as far from the bf16
    plain version as from the f32 one, the f32 kernel (control) not; and
    the bf16 kernel within rel-L2 5e-3 of the bf16 plain version."""
    assert _rel_l2(got, want16) <= 5e-3
    assert _share(got, want16, want32) <= 0.5
    assert _share(ctrl, want16, want32) > 0.5


def _f32(ts):
    return [t.float() if t.is_floating_point() else t for t in ts]


def test_bf16_onehot_spmm_kernel_matches_plain(cuda):
    from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
    spec, b, rand = _layered_inputs(cuda)
    h_e, h_n = rand(b.edge_nbr.shape[0], 40), rand(b.node_x.shape[0], 40)
    bf16 = dict(p=spec.p, mat_dtype="bfloat16")
    for src, idx, sign in ((h_e, b.edge_nbr, b.rev),
                           (h_n, b.graph_nodes, None)):
        before = _layered_counts()
        got = sp.onehot_spmm(src, idx, sign, **bf16)
        assert _moved(before) == {"K7": (0, 0, 1, 0)}
        assert got.dtype == torch.float32
        _bf16_hold([got], [sp.onehot_spmm_ref(src, idx, sign, **bf16)],
                   [sp.onehot_spmm_ref(src, idx, sign, p=spec.p)],
                   [sp.onehot_spmm(src, idx, sign, p=spec.p)])
    # a bf16 source (x[senders]) is read as it is
    x16 = b.node_x.bfloat16()
    assert torch.equal(sp.onehot_spmm(x16, b.senders[:, None], **bf16),
                       sp.onehot_spmm_ref(x16, b.senders[:, None], **bf16))
    # the backward: K7 bf16 over the transposed ELL, the gradient rounded
    src = h_n.clone().requires_grad_()
    cot = rand(b.graph_nodes.shape[0], 40)
    grads = {}
    for md in ("bfloat16", "float32"):
        before = _layered_counts()
        out = sp.spmm(src, b.graph_nodes, b.graph_of_node[:, None], p=spec.p,
                      mat_dtype=md)
        (grads[md],) = torch.autograd.grad((out * cot).sum(), src)
        want = {"bfloat16": (0, 0, 1, 1), "float32": (1, 1, 0, 0)}[md]
        assert _moved(before) == {"K7": want}
    with torch.enable_grad():
        refs = [torch.autograd.grad((sp.onehot_spmm_ref(
            src, b.graph_nodes, p=spec.p, mat_dtype=md) * cot).sum(), src)[0]
            for md in ("bfloat16", "float32")]
    _bf16_hold([grads["bfloat16"]], [refs[0]], [refs[1]],
               [grads["float32"]])


@pytest.mark.parametrize("stage,act,mean", [("edge_init", "relu", False),
                                            ("readout", "gelu", True),
                                            ("readout", "silu", False)])
def test_bf16_gather_linear_kernel_matches_plain(cuda, stage, act, mean):
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    spec, b, rand = _layered_inputs(cuda)
    H = 40
    ET, NT = b.edge_nbr.shape[0], b.node_x.shape[0]
    if stage == "edge_init":
        xa, xb, idx, adj = b.node_x, rand(ET, 14), b.senders[:, None], \
            b.node_out
        out_dtype = "bfloat16"
    else:
        xa, xb, idx, adj = rand(ET, H), b.node_x, b.node_inc, \
            b.receivers[:, None]
        out_dtype = "float32"
    xa, xb = xa.bfloat16(), xb.bfloat16()
    ws = (rand(xa.shape[1], H, scale=0.2), rand(xb.shape[1], H, scale=0.2),
          rand(H, scale=0.1))
    kw = dict(p=spec.p, act=act, mean=mean)
    k16 = dict(kw, mat_dtype="bfloat16", out_dtype=out_dtype)
    before = _layered_counts()
    out = gl.gather_linear_forward(xa, xb, idx, *ws, **k16)
    g = rand(*out.shape).to(out.dtype)
    grads = gl.gather_linear_backward(xa, xb, idx, adj, *ws, out, g, **k16)
    again = gl.gather_linear_backward(xa, xb, idx, adj, *ws, out, g, **k16)
    torch.cuda.synchronize()
    assert _moved(before) == {"K5": (0, 0, 1, 2)}
    assert out.dtype == (torch.bfloat16 if stage == "edge_init"
                         else torch.float32)
    assert [t.dtype for t in grads] == [torch.bfloat16] * 2 + \
        [torch.float32] * 3
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    want = gl.gather_linear_forward_ref(xa, xb, idx, *ws, **k16)
    ref = gl.gather_linear_backward_ref(xa, xb, idx, adj, *ws, want, g, **k16)
    f32 = [*_f32([xa, xb]), idx]
    want32 = gl.gather_linear_forward_ref(*f32, *ws, **kw)
    ref32 = gl.gather_linear_backward_ref(*f32[:3], adj, *ws, want32,
                                          g.float(), **kw)
    ctrl = gl.gather_linear_forward(*f32, *ws, **kw)
    ctrl_g = gl.gather_linear_backward(*f32[:3], adj, *ws, ctrl, g.float(),
                                       **kw)
    _bf16_hold([out], [want], [want32], [ctrl])
    _bf16_hold(grads, ref, ref32, ctrl_g)


@pytest.mark.parametrize("act,mean,drop", [("relu", False, 0.1),
                                           ("silu", True, 0.0),
                                           ("gelu", False, 0.3)])
def test_bf16_conv_stack_kernel_matches_plain(cuda, act, mean, drop):
    from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
    spec, b, rand = _layered_inputs(cuda)
    ET, H, L = b.edge_nbr.shape[0], 40, 3
    h0 = rand(ET, H).bfloat16()
    ws = (rand(L, H, H, scale=0.2), rand(L, H, scale=0.1),
          torch.tensor([0.8, -0.3, 1.2], device=cuda))
    kw = dict(p=spec.p, act=act, mean=mean, train=drop > 0,
              seeds=[7, 2**31 - 2, 12345] if drop else None,
              dropout_ps=(drop,) * L if drop else ())
    k16 = dict(kw, mat_dtype="bfloat16")
    idx = (b.edge_nbr, b.rev)
    before = _layered_counts()
    out = cs.conv_stack_forward(h0, *idx, *ws, **k16)
    g = rand(*out.shape).bfloat16()
    grads = cs.conv_stack_backward(h0, *idx, b.edge_nbr_rev, *ws, g, **k16)
    again = cs.conv_stack_backward(h0, *idx, b.edge_nbr_rev, *ws, g, **k16)
    torch.cuda.synchronize()
    assert _moved(before) == {"K4": (0, 0, 1, 2)}
    assert out.dtype == grads[0].dtype == torch.bfloat16
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    h32, g32 = h0.float(), g.float()
    _bf16_hold([out], [cs.conv_stack_forward_ref(h0, *idx, *ws, **k16)],
               [cs.conv_stack_forward_ref(h32, *idx, *ws, **kw)],
               [cs.conv_stack_forward(h32, *idx, *ws, **kw)])
    _bf16_hold(grads, cs.conv_stack_backward_ref(h0, *idx, b.edge_nbr_rev,
                                                 *ws, g, **k16),
               cs.conv_stack_backward_ref(h32, *idx, b.edge_nbr_rev, *ws,
                                          g32, **kw),
               cs.conv_stack_backward(h32, *idx, b.edge_nbr_rev, *ws, g32,
                                      **kw))


@pytest.mark.parametrize("act,mean,drop,hin", [("relu", False, 0.1, 40),
                                               ("gelu", True, 0.3, 40),
                                               ("silu", True, 0.0, 24)])
def test_bf16_fused_conv_kernel_matches_plain(cuda, act, mean, drop, hin):
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    spec, b, rand = _layered_inputs(cuda)
    ET, H = b.edge_nbr.shape[0], 40
    h, h0 = rand(ET, hin).bfloat16(), rand(ET, H).bfloat16()
    ws = (rand(hin, H, scale=0.2), rand(H, scale=0.1),
          torch.tensor(0.8, device=cuda))
    kw = dict(p=spec.p, act=act, mean=mean, train=drop > 0,
              seed=2**31 - 2 if drop else None, dropout_p=drop)
    k16 = dict(kw, mat_dtype="bfloat16")
    idx = (b.edge_nbr, b.rev)
    before = _layered_counts()
    out = fc.fused_conv_forward(h, h0, *idx, *ws, **k16)
    g = rand(*out.shape).bfloat16()
    grads = fc.fused_conv_backward(h, h0, *idx, b.edge_nbr_rev, *ws, out, g,
                                   **k16)
    again = fc.fused_conv_backward(h, h0, *idx, b.edge_nbr_rev, *ws, out, g,
                                   **k16)
    torch.cuda.synchronize()
    assert _moved(before) == {"K6": (0, 0, 1, 2)}
    assert [t.dtype for t in (out, *grads)] == [torch.bfloat16] * 3 + \
        [torch.float32] * 3
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    want = fc.fused_conv_layer_ref(h, h0, *idx, *ws, **k16)
    f32 = _f32([h, h0])
    want32 = fc.fused_conv_layer_ref(*f32, *idx, *ws, **kw)
    ctrl = fc.fused_conv_forward(*f32, *idx, *ws, **kw)
    _bf16_hold([out], [want], [want32], [ctrl])
    _bf16_hold(grads,
               fc.fused_conv_backward_ref(h, h0, *idx, b.edge_nbr_rev, *ws,
                                          want, g, **k16),
               fc.fused_conv_backward_ref(*f32, *idx, b.edge_nbr_rev, *ws,
                                          want32, g.float(), **kw),
               fc.fused_conv_backward(*f32, *idx, b.edge_nbr_rev, *ws, ctrl,
                                      g.float(), **kw))


@pytest.mark.parametrize("capture", [False, True], ids=["layered", "capture"])
def test_bf16_layered_and_capture_on_card_match_cpu(cuda, capture):
    """A bf16 model in the layered configuration and in capture mode on the
    card (the bf16 K5, K4, K7 or K7, K6 forward and backward, no f32 launch
    and no whole-model kernel) against the same model on the CPU (the plain
    versions at bf16), held by the share against the CPU's f32 run."""
    spec, batch = _batch(60, 13, 78, "cpu")
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                        depth=3, hidden_sizes=(40,) * 3,
                        dropout_ps=(0.2, 0.0, 0.3), activation="GELU",
                        aggr="mean", pooling="mean", use_learnable_skip=True,
                        fuse_whole_model=False, compute_dtype="bfloat16")
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    out = []
    for dev, conf in (("cpu", cfg), (cuda, cfg), ("cpu", f32)):
        model = init_params(conf, torch.Generator().manual_seed(4), dev)
        b = to_device(batch, dev)
        before, fm_before = _layered_counts(), _bf16_counts()
        pred = apply(model, b, spec, train=True, seeds=[5, 6, 7],
                     capture=capture)
        pred = pred[0] if capture else pred
        ((pred - b.labels) ** 2 * b.graph_mask).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert _bf16_counts() == fm_before
            assert _moved(before) == (
                {"K7": (0, 0, 3, 2), "K6": (0, 0, 3, 3)} if capture else
                {"K5": (0, 0, 2, 2), "K4": (0, 0, 1, 1),
                 "K7": (0, 0, 1, 1)})
        out.append((pred.detach().cpu(), [p.grad.cpu()
                                          for p in model.parameters()]))
    (p0, g0), (p1, g1), (p32, g32) = out
    mask = batch.graph_mask > 0
    assert _rel_l2([p1[mask]], [p0[mask]]) <= 5e-3
    assert _cos(g1, g0) >= 0.999
    assert _share([p1[mask]], [p0[mask]], [p32[mask]]) <= 0.5
    assert _share(g1, g0, g32) <= 0.5


# -- edge partitioning: K8/K9, K10/K11 and the EP step ------------------------

def _ep_case(cuda, n_ep=4, seed=11, F=78, wide=False):
    """A wired EP batch (a chain of 200 atoms cut across the shards, one of
    33 and six small graphs; with ``wide``, a random graph of 64 nodes and
    96 edge pairs, which every split cuts wide) as per-shard tensors on the
    card, with a seeded rand()."""
    from cgr_mpnn_3d_tpu_torch.chem.featurize import GraphArrays
    from cgr_mpnn_3d_tpu_torch.data.synthetic import chain_graph
    from cgr_mpnn_3d_tpu_torch.parallel import ep_shards, pack_shard_edges
    rng = np.random.default_rng(seed)
    if wide:
        u = rng.integers(0, 64, 96)
        v = (u + rng.integers(1, 64, 96)) % 64
        big = GraphArrays(
            rng.normal(size=(64, F)).astype(np.float32),
            rng.normal(size=(192, 14)).astype(np.float32),
            np.stack([u, v], 1).reshape(-1).astype(np.int32),
            np.stack([v, u], 1).reshape(-1).astype(np.int32),
            np.arange(192, dtype=np.int32) ^ 1)
    else:
        big = chain_graph(200, rng, F)
    graphs = [big, chain_graph(33, rng, F)] + \
        synthetic_graphs(6, rng, node_feat_dim=F)
    labels = [0.7 * i - 2.0 for i in range(len(graphs))]
    b, spec = pack_shard_edges(graphs, labels, n_ep, te=64, tn=32)
    assert any(spec.caps)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(cuda)
    return spec, ep_shards(b, cuda), rand


@pytest.mark.parametrize("act,global_mean,drop", [("relu", False, 0.1),
                                                  ("relu", True, 0.0),
                                                  ("gelu", True, 0.3),
                                                  ("silu", False, 0.0)])
def test_fused_conv_r_kernel_matches_plain(cuda, act, global_mean, drop):
    """K8 (K9 with the global scale) forward and backward against the plain
    version on a wired shard; the backward reruns bit for bit."""
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    spec, shards, rand = _ep_case(cuda)
    b = max(shards, key=lambda s: float(s.halo_mask.sum()))
    PE, PN, H = spec.pe, spec.pn, 40
    scale = (torch.cat([b.inv_deg, b.inv_deg.new_zeros(1)])[
        b.senders.long()].contiguous() if global_mean else None)
    ins = (rand(PE, H), rand(PN, H), rand(PE, H), b.edge_nbr, b.rev,
           b.senders)
    ws = (rand(H, H, scale=0.2), rand(H, scale=0.1),
          torch.tensor(0.8, device=cuda))
    kw = dict(p=spec.p, tn=spec.tn, scale=scale, act=act, train=drop > 0,
              seed=2**31 - 2 if drop else None, dropout_p=drop)
    key = "rm_" if global_mean else "r_"
    before = (getattr(fc, key + "launches"), getattr(fc, key + "bwd_launches"))
    out = fc.fused_conv_r_forward(*ins, *ws, **kw)
    want = fc.fused_conv_layer_r_ref(*ins, *ws, **kw)
    g = rand(*out.shape)
    bwd = (*ins, b.edge_nbr_rev, b.node_out, *ws)
    grads = fc.fused_conv_r_backward(*bwd, out, g, **kw)
    assert (getattr(fc, key + "launches"),
            getattr(fc, key + "bwd_launches")) == (before[0] + 1,
                                                   before[1] + 1)
    ref = fc.fused_conv_r_backward_ref(*bwd, want, g, **kw)
    torch.cuda.synchronize()
    assert _rel(out, want) <= 1e-4
    assert [t.shape for t in grads] == [t.shape for t in ref]
    kw64 = dict(kw, scale=None if scale is None else scale.double())
    _held(act, grads, ref, lambda: fc.fused_conv_r_backward_ref(
        *_f64(ins), b.edge_nbr_rev, b.node_out, *_f64(ws), want.double(),
        g.double(), **kw64))
    again = fc.fused_conv_r_backward(*bwd, out, g, **kw)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


@pytest.mark.parametrize("act,mean,pool", [("relu", False, True),
                                           ("gelu", True, True),
                                           ("relu", True, False),
                                           ("silu", False, False)])
def test_gather_linear_r_kernel_matches_plain(cuda, act, mean, pool):
    """K11 (K10 with the pool off) forward and backward against the plain
    version on a wired shard; the backward reruns bit for bit."""
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    spec, shards, rand = _ep_case(cuda)
    b = max(shards, key=lambda s: float(s.halo_mask.sum()))
    PE, PN, H, F = spec.pe, spec.pn, 40, 78
    ins = (rand(PE, H), rand(PN, H), rand(PN, F), b.node_inc)
    ws = (rand(H, H, scale=0.2), rand(F, H, scale=0.1), rand(H, scale=0.1))
    kw = dict(p=spec.p, act=act, mean=mean)
    key = "pool_" if pool else "r_"
    before = (getattr(gl, key + "launches"), getattr(gl, key + "bwd_launches"))
    if pool:
        tabs = (b.node_group, b.pool_ell)
        out, pooled = gl.gather_linear_pool_forward(*ins, *tabs, *ws, **kw)
        want, want_pool = gl.gather_linear_pool_forward_ref(*ins, *tabs, *ws,
                                                            **kw)
        g, gp = rand(*out.shape), rand(*pooled.shape)
        bwd = (*ins, b.dst[:, None], *tabs, *ws)

        def grads_of(fn, o, *extra):
            return fn(*bwd, o, g, gp, **kw)
        grads = grads_of(gl.gather_linear_pool_backward, out)
        ref = gl.gather_linear_pool_backward_ref(*bwd, want, g, gp, **kw)
        again = grads_of(gl.gather_linear_pool_backward, out)
        f64 = lambda: gl.gather_linear_pool_backward_ref(  # noqa: E731
            *_f64(ins), b.dst[:, None], *tabs, *_f64(ws), want.double(),
            g.double(), gp.double(), **kw)
    else:
        out = gl.gather_linear_r_forward(*ins, *ws, **kw)
        want = gl.gather_linear_r_forward_ref(*ins, *ws, **kw)
        g = rand(*out.shape)
        bwd = (*ins, b.dst[:, None], *ws)
        grads = gl.gather_linear_r_backward(*bwd, out, g, **kw)
        ref = gl.gather_linear_r_backward_ref(*bwd, want, g, **kw)
        again = gl.gather_linear_r_backward(*bwd, out, g, **kw)
        f64 = lambda: gl.gather_linear_r_backward_ref(  # noqa: E731
            *_f64(ins), b.dst[:, None], *_f64(ws), want.double(), g.double(),
            **kw)
    assert (getattr(gl, key + "launches"),
            getattr(gl, key + "bwd_launches")) == (before[0] + 1,
                                                   before[1] + 2)
    torch.cuda.synchronize()
    assert _rel(out, want) <= 1e-4
    if pool:
        assert _rel(pooled, want_pool) <= 1e-4
    assert [t.shape for t in grads] == [t.shape for t in ref]
    _held(act, grads, ref, f64)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


@pytest.mark.parametrize("act,aggr,pooling,n_ep,wide", [
    ("GELU", "add", "add", 4, False), ("SiLU", "mean", "mean", 2, False),
    ("GELU", "mean", "add", 4, True)])
def test_ep_step_on_card_matches_cpu(cuda, act, aggr, pooling, n_ep, wide):
    """The EP forward and its gradients on the card against the CPU (plain
    versions) on a wired batch: every shard launches K5 once, K8 (K9 for
    mean) once per layer and K11 once, forward and backward; a rerun of the
    gradients is bit-identical."""
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    from cgr_mpnn_3d_tpu_torch.parallel import ep_pack_forward
    spec, shards, _ = _ep_case(cuda, n_ep=n_ep, wide=wide)
    cpu = [type(s)(*(t.cpu() for t in s)) for s in shards]
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14, depth=3,
                        hidden_sizes=(40,) * 3, dropout_ps=(0.0,) * 3,
                        activation=act, aggr=aggr, pooling=pooling,
                        use_learnable_skip=True, fuse_whole_model=False)
    model = init_params(cfg, torch.Generator().manual_seed(3), cuda)
    ref = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    conv = "rm_" if aggr == "mean" else "r_"

    def counts():
        return (gl.launches, getattr(fc, conv + "launches"),
                gl.pool_launches, gl.bwd_launches,
                getattr(fc, conv + "bwd_launches"), gl.pool_bwd_launches)

    def grads_of(m, s):
        m.zero_grad(set_to_none=True)
        sse, preds = ep_pack_forward(m, s, spec)
        sse.backward()
        return preds.detach(), [p.grad.clone() for p in m.parameters()]

    before = counts()
    preds, grads = grads_of(model, shards)
    after = counts()
    assert [a - b_ for a, b_ in zip(after, before)] == [
        n_ep, 3 * n_ep, n_ep, n_ep, 3 * n_ep, n_ep]
    want, want_grads = grads_of(ref, cpu)
    torch.cuda.synchronize()
    assert _rel(preds.cpu(), want) <= 1e-4
    for g, w in zip(grads, want_grads):
        assert _rel(g.cpu(), w) <= 1e-4
    _, again = grads_of(model, shards)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


# -- EP at bf16, K6's linear activation, the hop exchange K12, and the EP
# -- step with --ep_rdma and --ep_overlap ------------------------------------

@pytest.mark.parametrize("act,global_mean,mean,drop", [
    ("relu", False, False, 0.1), ("relu", True, False, 0.0),
    ("gelu", True, False, 0.3), ("silu", False, True, 0.0)])
def test_bf16_fused_conv_r_kernel_matches_plain(cuda, act, global_mean, mean,
                                                drop):
    """K8 (K9 with the global scale) at bf16 against its bf16 plain version
    on a wired shard, forward and backward, by the share hold with the f32
    kernel as control; only the bf16 counters move; reruns bit for bit."""
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    spec, shards, rand = _ep_case(cuda)
    b = max(shards, key=lambda s: float(s.halo_mask.sum()))
    PE, PN, H = spec.pe, spec.pn, 40
    scale = (torch.cat([b.inv_deg, b.inv_deg.new_zeros(1)])[
        b.senders.long()].contiguous() if global_mean else None)
    h, r, h0 = rand(PE, H).bfloat16(), rand(PN, H), rand(PE, H).bfloat16()
    idx = (b.edge_nbr, b.rev, b.senders)
    ws = (rand(H, H, scale=0.2), rand(H, scale=0.1),
          torch.tensor(0.8, device=cuda))
    kw = dict(p=spec.p, tn=spec.tn, scale=scale, act=act, mean=mean,
              train=drop > 0, seed=2**31 - 2 if drop else None,
              dropout_p=drop)
    k16 = dict(kw, mat_dtype="bfloat16")
    key = "rm_" if global_mean else "r_"
    names = [p_ + key + s for p_ in ("", "bf16_")
             for s in ("launches", "bwd_launches")]
    before = [getattr(fc, n) for n in names]
    out = fc.fused_conv_r_forward(h, r, h0, *idx, *ws, **k16)
    g = rand(*out.shape).bfloat16()
    bwd = (h, r, h0, *idx, b.edge_nbr_rev, b.node_out, *ws)
    grads = fc.fused_conv_r_backward(*bwd, out, g, **k16)
    again = fc.fused_conv_r_backward(*bwd, out, g, **k16)
    torch.cuda.synchronize()
    assert [getattr(fc, n) - v for n, v in zip(names, before)] == [0, 0, 1, 2]
    assert [t.dtype for t in (out, *grads)] == [
        torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16] + \
        [torch.float32] * 3
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    f32 = (h.float(), r, h0.float())
    want = fc.fused_conv_layer_r_ref(h, r, h0, *idx, *ws, **k16)
    want32 = fc.fused_conv_layer_r_ref(*f32, *idx, *ws, **kw)
    ctrl = fc.fused_conv_r_forward(*f32, *idx, *ws, **kw)
    _bf16_hold([out], [want], [want32], [ctrl])
    bwd32 = (*f32, *idx, b.edge_nbr_rev, b.node_out, *ws)
    _bf16_hold(grads, fc.fused_conv_r_backward_ref(*bwd, want, g, **k16),
               fc.fused_conv_r_backward_ref(*bwd32, want32, g.float(), **kw),
               fc.fused_conv_r_backward(*bwd32, ctrl, g.float(), **kw))


@pytest.mark.parametrize("act,mean,pool", [("relu", False, True),
                                           ("gelu", True, True),
                                           ("silu", False, False)])
def test_bf16_gather_linear_r_kernel_matches_plain(cuda, act, mean, pool):
    """K11 (K10 with the pool off) at bf16 against its bf16 plain version,
    forward and backward, by the share hold with the f32 kernel as
    control; the output, the pool, xr's gradient f32; reruns bit for bit."""
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    spec, shards, rand = _ep_case(cuda)
    b = max(shards, key=lambda s: float(s.halo_mask.sum()))
    PE, PN, H, F = spec.pe, spec.pn, 40, 78
    ins = (rand(PE, H).bfloat16(), rand(PN, H), rand(PN, F).bfloat16(),
           b.node_inc)
    ins32 = (ins[0].float(), ins[1], ins[2].float(), b.node_inc)
    ws = (rand(H, H, scale=0.2), rand(F, H, scale=0.1), rand(H, scale=0.1))
    kw = dict(p=spec.p, act=act, mean=mean)
    k16 = dict(kw, mat_dtype="bfloat16")
    key = "pool_" if pool else "r_"
    names = [p_ + key + s for p_ in ("", "bf16_")
             for s in ("launches", "bwd_launches")]
    before = [getattr(gl, n) for n in names]
    tabs = (b.node_group, b.pool_ell) if pool else ()
    fwd = gl.gather_linear_pool_forward if pool else gl.gather_linear_r_forward
    fref = (gl.gather_linear_pool_forward_ref if pool
            else gl.gather_linear_r_forward_ref)
    bwd_fn = (gl.gather_linear_pool_backward if pool
              else gl.gather_linear_r_backward)
    bref = (gl.gather_linear_pool_backward_ref if pool
            else gl.gather_linear_r_backward_ref)

    def listed(v):
        return list(v) if isinstance(v, tuple) else [v]
    got = listed(fwd(*ins, *tabs, *ws, **k16))
    cots = [rand(*t.shape) for t in got]
    args = (*ins, b.dst[:, None], *tabs, *ws)
    args32 = (*ins32, b.dst[:, None], *tabs, *ws)
    grads = bwd_fn(*args, got[0], *cots, **k16)
    again = bwd_fn(*args, got[0], *cots, **k16)
    torch.cuda.synchronize()
    assert [getattr(gl, n) - v for n, v in zip(names, before)] == [0, 0, 1, 2]
    assert all(t.dtype == torch.float32 for t in got)
    assert [t.dtype for t in grads] == [torch.bfloat16, torch.float32,
                                        torch.bfloat16] + [torch.float32] * 3
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    want = listed(fref(*ins, *tabs, *ws, **k16))
    want32 = listed(fref(*ins32, *tabs, *ws, **kw))
    ctrl = listed(fwd(*ins32, *tabs, *ws, **kw))
    _bf16_hold(got, want, want32, ctrl)
    _bf16_hold(grads, bref(*args, want[0], *cots, **k16),
               bref(*args32, want32[0], *cots, **kw),
               bwd_fn(*args32, ctrl[0], *cots, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_conv_linear_kernel_matches_plain(cuda, dtype):
    """K6 with act="linear" (f32 output at either dtype, as the overlap
    path takes it): f32 against the plain version at 1e-4, bf16 by the
    share hold; only the linear counters move."""
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    spec, b, rand = _layered_inputs(cuda)
    ET, H = b.edge_nbr.shape[0], 40
    h, h0 = rand(ET, H), rand(ET, H)
    ws = (rand(H, H, scale=0.2), rand(H, scale=0.1),
          torch.tensor(0.8, device=cuda))
    kw = dict(p=spec.p, act="linear", out_dtype="float32")
    idx = (b.edge_nbr, b.rev)
    pre = "bf16_" if dtype == "bfloat16" else ""
    names = [pre + "linear_launches", pre + "linear_bwd_launches",
             "launches", "bwd_launches", "bf16_launches", "bf16_bwd_launches"]
    before = [getattr(fc, n) for n in names]
    ins = (h.bfloat16(), h0.bfloat16()) if pre else (h, h0)
    k = dict(kw, mat_dtype=dtype)
    out = fc.fused_conv_forward(*ins, *idx, *ws, **k)
    g = rand(*out.shape)
    grads = fc.fused_conv_backward(*ins, *idx, b.edge_nbr_rev, *ws, out, g,
                                   **k)
    torch.cuda.synchronize()
    assert [getattr(fc, n) - v for n, v in zip(names, before)] == \
        [1, 1, 0, 0, 0, 0]
    assert out.dtype == torch.float32
    want = fc.fused_conv_layer_ref(*ins, *idx, *ws, **k)
    ref = fc.fused_conv_backward_ref(*ins, *idx, b.edge_nbr_rev, *ws, want,
                                     g, **k)
    if not pre:
        assert _rel(out, want) <= 1e-4
        for x, y in zip(grads, ref):
            assert _rel(x, y) <= 1e-4
        return
    f32 = _f32(ins)
    k32 = dict(kw, mat_dtype="float32")
    _bf16_hold([out], [want], [fc.fused_conv_layer_ref(*f32, *idx, *ws,
                                                       **k32)],
               [fc.fused_conv_forward(*f32, *idx, *ws, **k32)])
    _bf16_hold(grads, ref,
               fc.fused_conv_backward_ref(*f32, *idx, b.edge_nbr_rev, *ws,
                                          want, g, **k32),
               fc.fused_conv_backward(*f32, *idx, b.edge_nbr_rev, *ws, out,
                                      g, **k32))


@pytest.mark.parametrize("caps", [(8, 0, 16), (8,), (0, 8, 0, 0, 0, 0, 8),
                                  (24, 8, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_exchange_kernel_matches_plain(cuda, caps, dtype):
    """K12 against ep_pack's ring copies, both directions and through its
    autograd backward, bit for bit; one launch per exchange whatever
    n_ep; no active hop returns the buffers."""
    from cgr_mpnn_3d_tpu_torch.parallel import ep_pack as ep
    from cgr_mpnn_3d_tpu_torch.parallel import rdma_exchange as rx
    n, tw, H = len(caps) + 1, sum(caps), 40
    gen = torch.Generator().manual_seed(len(caps))
    bufs = [torch.randn((tw, H), generator=gen).to(dtype).to(cuda)
            for _ in range(n)]
    for inverse in (False, True):
        before = (rx.launches, rx.bwd_launches)
        got = rx.ring_exchange_rdma(bufs, caps, inverse)
        assert (rx.launches, rx.bwd_launches) == (before[0] + 1, before[1])
        want = rx._ring_move(bufs, caps, inverse)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    leaves = [t.clone().requires_grad_() for t in bufs]
    outs = [rx.ring_exchange_rdma(leaves, caps), ep.ring_exchange(
        leaves, caps)]
    wts = [torch.randn((tw, H), generator=gen).to(dtype).to(cuda)
           for _ in range(n)]
    grads = [torch.autograd.grad(sum((o * w).sum() for o, w in zip(out, wts)),
                                 leaves) for out in outs]
    assert all(torch.equal(x, y) for x, y in zip(*grads))
    assert rx.ring_exchange_rdma(bufs, (0,) * (n - 1))[0] is bufs[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_exchange_allocates_anew_each_call(cuda, dtype):
    """K12's outputs are views of one allocation per call: they do not
    overlap, a second call of the same spec leaves the first call's
    outputs as they were, and the backward is the inverse exchange."""
    from cgr_mpnn_3d_tpu_torch.parallel import rdma_exchange as rx
    caps, H = (8, 0, 16), 40
    gen = torch.Generator().manual_seed(5)
    bufs = [torch.randn((24, H), generator=gen).to(dtype).to(cuda)
            for _ in range(4)]
    first = rx.ring_exchange_rdma(bufs, caps)
    kept = [t.clone() for t in first]
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in first)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert first[0].untyped_storage().data_ptr() == \
        first[3].untyped_storage().data_ptr()
    other = [torch.randn((24, H), generator=gen).to(dtype).to(cuda)
             for _ in range(4)]
    second = rx.ring_exchange_rdma(other, caps)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(
        second, rx._ring_move(other, caps, False)))
    leaves = [b.clone().requires_grad_() for b in bufs]
    cots = [torch.randn((24, H), generator=gen).to(dtype).to(cuda)
            for _ in range(4)]
    before = rx.bwd_launches
    grads = torch.autograd.grad(rx.ring_exchange_rdma(leaves, caps), leaves,
                                cots)
    assert rx.bwd_launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(
        grads, rx._ring_move(cots, caps, True)))


@pytest.mark.parametrize("aggr,n_ep", [("add", 4), ("mean", 2)])
def test_bf16_ep_step_on_card_matches_cpu(cuda, aggr, n_ep):
    """The bf16 EP forward and gradients on the card against the CPU (the
    bf16 plain versions) on a wired batch, held by the share against the
    CPU's f32 run: only the bf16 counters of K5, K8/K9 and K11 move."""
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    from cgr_mpnn_3d_tpu_torch.parallel import ep_pack_forward
    spec, shards, _ = _ep_case(cuda, n_ep=n_ep)
    cpu = [type(s)(*(t.cpu() for t in s)) for s in shards]
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14, depth=3,
                        hidden_sizes=(40,) * 3, dropout_ps=(0.2,) * 3,
                        activation="GELU", aggr=aggr,
                        use_learnable_skip=True, fuse_whole_model=False,
                        compute_dtype="bfloat16")
    conv = "rm_" if aggr == "mean" else "r_"
    names = [p_ + k + s for p_ in ("", "bf16_")
             for k, m in (("", gl), (conv, fc), ("pool_", gl))
             for s in ("launches", "bwd_launches")]
    mods = [gl, gl, fc, fc, gl, gl] * 2
    seeds = torch.randint(0, 2**31 - 1, (n_ep, 3), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(9))
    out = []
    for dev, c, s in (("cpu", cfg, cpu), (cuda, cfg, shards),
                      ("cpu", dataclasses.replace(
                          cfg, compute_dtype="float32"), cpu)):
        model = init_params(c, torch.Generator().manual_seed(3), dev)
        before = [getattr(m, n) for m, n in zip(mods, names)]
        sse, preds = ep_pack_forward(model, s, spec, train=True, seeds=seeds)
        sse.backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            moved = [getattr(m, n) - v for m, n, v in zip(mods, names,
                                                          before)]
            assert moved == [0] * 6 + [n_ep, n_ep, 3 * n_ep, 3 * n_ep,
                                       n_ep, n_ep]
        out.append((preds.detach().cpu(), [p.grad.cpu()
                                           for p in model.parameters()]))
    (p0, g0), (p1, g1), (p32, g32) = out
    assert _rel_l2([p1], [p0]) <= 5e-3 and _cos(g1, g0) >= 0.999
    assert _share([p1], [p0], [p32]) <= 0.5 and _share(g1, g0, g32) <= 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ep_rdma_and_overlap_on_card(cuda, dtype):
    """On a wired batch at n_ep 4: --ep_rdma gives the same loss and
    gradients bit for bit, with one K12 launch per exchange each way and
    no ring copy; --ep_overlap (K6 linear per layer) matches the K8 path
    (f32 at 1e-4, bf16 within rel-L2 5e-3 and gradient cosine 0.999)."""
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    from cgr_mpnn_3d_tpu_torch.parallel import ep_pack as ep
    from cgr_mpnn_3d_tpu_torch.parallel import rdma_exchange as rx
    spec, shards, _ = _ep_case(cuda, n_ep=4)
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14, depth=3,
                        hidden_sizes=(40,) * 3, dropout_ps=(0.2,) * 3,
                        activation="GELU", use_learnable_skip=True,
                        fuse_whole_model=False, compute_dtype=dtype)
    seeds = torch.randint(0, 2**31 - 1, (4, 3), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(9))
    res = {}
    for name, kw in (("ring", {}), ("rdma", dict(ep_rdma_exchange=True)),
                     ("overlap", dict(ep_overlap=True))):
        model = init_params(dataclasses.replace(cfg, **kw),
                            torch.Generator().manual_seed(3), cuda)
        before = (rx.launches, rx.bwd_launches, ep.ring_moves,
                  fc.linear_launches + fc.bf16_linear_launches)
        sse, preds = ep.ep_pack_forward(model, shards, spec, train=True,
                                        seeds=seeds)
        sse.backward()
        torch.cuda.synchronize()
        after = (rx.launches, rx.bwd_launches, ep.ring_moves,
                 fc.linear_launches + fc.bf16_linear_launches)
        moved = [a - b_ for a, b_ in zip(after, before)]
        # 2 exchanges per wired layer and 1 in the readout
        assert moved == {"ring": [0, 0, 14, 0], "rdma": [7, 7, 0, 0],
                         "overlap": [0, 0, 14, 12]}[name]
        res[name] = (sse.detach(), preds.detach(),
                     [p.grad for p in model.parameters()])
    assert torch.equal(res["rdma"][0], res["ring"][0])
    assert all(torch.equal(x, y) for x, y in zip(res["rdma"][2],
                                                 res["ring"][2]))
    (_, p0, g0), (_, p1, g1) = res["ring"], res["overlap"]
    if dtype == "float32":
        assert _rel(p1, p0) <= 1e-4
        assert _rel_l2(g1, g0) <= 1e-4
    else:
        assert _rel_l2([p1], [p0]) <= 5e-3 and _cos(g1, g0) >= 0.999


def test_no_cuda_tensor_reaches_an_ep_plain_version(cuda, monkeypatch):
    """With the plain versions of K6, K8/K9, K10/K11 and K12 (the ring
    copies) replaced by ones that raise, the wired EP step runs on the card
    at bf16 with --ep_rdma, and with --ep_overlap."""
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    from cgr_mpnn_3d_tpu_torch.parallel import ep_pack as ep
    from cgr_mpnn_3d_tpu_torch.parallel import rdma_exchange as rx

    def refuse(*a, **k):
        raise AssertionError("a plain version was called")
    for mod, names in ((fc, ("fused_conv_layer_ref", "fused_conv_backward_ref",
                             "fused_conv_layer_r_ref",
                             "fused_conv_r_backward_ref")),
                       (gl, ("gather_linear_r_forward_ref",
                             "gather_linear_pool_forward_ref",
                             "gather_linear_r_backward_ref",
                             "gather_linear_pool_backward_ref")),
                       (rx, ("_ring_move",))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    spec, shards, _ = _ep_case(cuda, n_ep=4)
    seeds = torch.randint(0, 2**31 - 1, (4, 3), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(9))
    for kw in (dict(ep_rdma_exchange=True), dict(ep_overlap=True,
                                                 ep_rdma_exchange=True)):
        cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                            depth=3, hidden_sizes=(40,) * 3,
                            dropout_ps=(0.2,) * 3, fuse_whole_model=False,
                            compute_dtype="bfloat16", **kw)
        model = init_params(cfg, torch.Generator().manual_seed(3), cuda)
        sse, _ = ep.ep_pack_forward(model, shards, spec, train=True,
                                    seeds=seeds)
        sse.backward()
    torch.cuda.synchronize()


# -- the conv grid (csrc/conv_grid.cuh) ---------------------------------------

# forced builds of fused_conv.cu: a 7-block grid, 32-row tiles, 64-row
# tiles at one block an SM
CONV_DEFINES = [{"CGR_GRID_BLOCKS": 7}, {"CGR_CONV_BM": 32},
                {"CGR_CONV_BM": 64, "CGR_BLOCKS_PER_SM": 1}]


def _conv_variants(name, defines):
    from concurrent.futures import ThreadPoolExecutor

    from cgr_mpnn_3d_tpu_torch.ops import _build
    from cgr_mpnn_3d_tpu_torch.tools import k2_phases
    src = _build.CSRC / f"{name}.cu"
    with ThreadPoolExecutor(len(defines)) as pool:
        return list(pool.map(lambda d: k2_phases.variant(d, src), defines))


def _through(name, lib, fn):
    from cgr_mpnn_3d_tpu_torch.ops import _build
    shipped = _build.load(name)
    _build._libs[name] = lib
    try:
        return fn()
    finally:
        _build._libs[name] = shipped


def _flat(v):
    if isinstance(v, (tuple, list)):
        return [t for x in v for t in _flat(x)]
    return [] if v is None else [v]


@pytest.mark.parametrize("mat_dtype", ["float32", "bfloat16"])
def test_conv_grid_forced_builds_and_reruns_are_bit_identical(cuda,
                                                              mat_dtype):
    """K6 (ReLU, SiLU, GELU and linear; add and mean; train mode) and K8/K9
    forward and backward: a rerun and the builds forced to a 7-block grid,
    32-row tiles and 64-row tiles at one block an SM give the shipped
    build's outputs bit for bit."""
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    spec, b, rand = _layered_inputs(cuda)
    sd = torch.bfloat16 if mat_dtype == "bfloat16" else torch.float32
    ET, H = b.edge_nbr.shape[0], 40
    ins = (rand(ET, H).to(sd), rand(ET, H).to(sd), b.edge_nbr, b.rev)
    ws = (rand(H, H, scale=0.2), rand(H, scale=0.1),
          torch.tensor(0.8, device=cuda))
    g = rand(ET, H).to(sd)
    espec, shards, erand = _ep_case(cuda)
    e = max(shards, key=lambda s: float(s.halo_mask.sum()))
    scale = torch.cat([e.inv_deg, e.inv_deg.new_zeros(1)])[
        e.senders.long()].contiguous()
    rins = (erand(espec.pe, H).to(sd), erand(espec.pn, H),
            erand(espec.pe, H).to(sd), e.edge_nbr, e.rev, e.senders)
    rg = erand(espec.pe, H).to(sd)

    def run():
        out = []
        with torch.no_grad():
            for act, mean in (("relu", False), ("silu", True),
                              ("gelu", False), ("linear", True)):
                kw = dict(p=spec.p, act=act, mean=mean, train=True,
                          seed=2**31 - 3, dropout_p=0.2, mat_dtype=mat_dtype,
                          out_dtype="float32" if act == "linear" else None)
                y = fc.fused_conv_forward(*ins, *ws, **kw)
                gg = g.float() if act == "linear" else g
                out += [y, *fc.fused_conv_backward(*ins, b.edge_nbr_rev, *ws,
                                                   y, gg, **kw)]
            for sc in (None, scale):
                kw = dict(p=espec.p, tn=espec.tn, scale=sc, train=True,
                          seed=77, dropout_p=0.1, mat_dtype=mat_dtype)
                y = fc.fused_conv_r_forward(*rins, *ws, **kw)
                out += [y, *fc.fused_conv_r_backward(
                    *rins, e.edge_nbr_rev, e.node_out, *ws, y, rg, **kw)]
        return _flat(out)
    want = run()
    assert all(torch.isfinite(t).all() for t in want)
    assert all(torch.equal(x, y) for x, y in zip(run(), want))
    for d, lib in zip(CONV_DEFINES, _conv_variants("fused_conv",
                                                   CONV_DEFINES)):
        got = _through("fused_conv", lib, run)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), d


@pytest.mark.parametrize("mat_dtype", ["float32", "bfloat16"])
def test_conv_stack_on_the_conv_grid_is_bit_identical(cuda, mat_dtype):
    """K4 runs the conv grid's layer: a rerun and a 7-block grid give its
    outputs and gradients bit for bit (its plain-version holds are
    test_conv_stack_kernel_matches_plain and the bf16 twin)."""
    from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
    spec, b, rand = _layered_inputs(cuda)
    sd = torch.bfloat16 if mat_dtype == "bfloat16" else torch.float32
    ET, H, L = b.edge_nbr.shape[0], 40, 3
    h0 = rand(ET, H).to(sd)
    ws = (rand(L, H, H, scale=0.2), rand(L, H, scale=0.1),
          torch.tensor([1.0, 0.7, 1.3], device=cuda))
    g = rand(ET, H).to(sd)

    def run():
        out = []
        with torch.no_grad():
            for act, mean in (("relu", False), ("gelu", True)):
                kw = dict(p=spec.p, act=act, mean=mean, train=True,
                          seeds=[5, 6, 7], dropout_ps=(0.1,) * L,
                          mat_dtype=mat_dtype)
                out.append(cs.conv_stack_forward(h0, b.edge_nbr, b.rev, *ws,
                                                 **kw))
                out += list(cs.conv_stack_backward(
                    h0, b.edge_nbr, b.rev, b.edge_nbr_rev, *ws, g, **kw))
        return out
    want = run()
    assert all(torch.equal(x, y) for x, y in zip(run(), want))
    (lib,) = _conv_variants("conv_stack", [{"CGR_GRID_BLOCKS": 7}])
    got = _through("conv_stack", lib, run)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cuLaunchCooperativeKernel")


def _launches_of_one_call(fn, module) -> tuple[int, dict, list]:
    """(kernel launches, counters moved, device kernels) of one call of
    ``fn``: the kernel-launch runtime calls torch.profiler records in the
    active step of a profile whose warm-up step (calls of ``fn`` for at
    least 50 ms) starts the tracer -- the counting of
    chip_smoke.py::kernel_launches --, the launch counters of the wrapper
    ``module`` that one call moves (each counts the launches of one
    kernel), and the names of the device kernels the active step recorded.
    A later profiling session in the same process can lose the device
    records while the runtime calls are always recorded, so the launches
    are counted from the runtime calls and the names are checked by
    :func:`_assert_kernel` whenever the device records are there; and a
    session can hand over device records of its warm-up step too, so only
    the kernels that started inside the active step count."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    names = [n for n in dir(module) if n.endswith("launches")]
    before = {n: getattr(module, n) for n in names}
    with torch.no_grad():
        fn()
    torch.cuda.synchronize()
    moved = {n: getattr(module, n) - before[n] for n in names
             if getattr(module, n) != before[n]}
    with torch.no_grad(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1,
                              repeat=1)) as prof:
        t0, n = time.perf_counter(), 0
        while n < 2 or time.perf_counter() - t0 < 0.05:
            fn()
            torch.cuda.synchronize()
            n += 1
        prof.step()
        fn()
        torch.cuda.synchronize()
        prof.step()
    events = prof.events()
    active = max(e.time_range.start for e in events
                 if e.name.startswith("ProfilerStep")
                 and e.device_type == DeviceType.CPU)
    return (sum(e.count for e in prof.key_averages()
                if e.key in LAUNCH_CALLS), moved,
            [e.name for e in events
             if e.device_type == DeviceType.CUDA
             and e.time_range.start >= active
             # the step's own annotation is recorded on the device too
             and not e.name.startswith(("Memcpy", "Memset",
                                        "ProfilerStep"))])


def _assert_kernel(got, counter, kernel):
    """One launch, the wrapper's ``counter`` moved by one, and -- where the
    profile recorded device kernels -- exactly one, named ``kernel``."""
    launches, moved, kernels = got
    assert (launches, moved) == (1, {counter: 1}), (counter, got)
    assert not kernels or (len(kernels) == 1 and kernel in kernels[0]), \
        (kernel, got)


def test_conv_grid_is_one_launch_a_direction(cuda):
    """A K6 or K8 call is one kernel launch forward and one backward
    (torch.profiler's launch calls, the wrapper's forward or backward
    counter, and the device kernel's name where the profile recorded it),
    on the grid the shape rule picks."""
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    spec, b, rand = _layered_inputs(cuda)
    ET, H = b.edge_nbr.shape[0], 40
    ins = (rand(ET, H), rand(ET, H), b.edge_nbr, b.rev)
    ws = (rand(H, H, scale=0.2), rand(H, scale=0.1),
          torch.tensor(0.8, device=cuda))
    kw = dict(p=spec.p, act="gelu", train=True, seed=3, dropout_p=0.1)
    with torch.no_grad():
        y = fc.fused_conv_forward(*ins, *ws, **kw)
    g = rand(ET, H)
    fwd = _launches_of_one_call(
        lambda: fc.fused_conv_forward(*ins, *ws, **kw), fc)
    bwd = _launches_of_one_call(lambda: fc.fused_conv_backward(
        *ins, b.edge_nbr_rev, *ws, y, g, **kw), fc)
    _assert_kernel(fwd, "launches", "conv_fwd_kernel")
    _assert_kernel(bwd, "bwd_launches", "conv_bwd_kernel")
    for p, bm in ((4, 32), (436, 64)):
        blocks, tile_rows, per_sm, sms = fc.conv_grid(p, 256, 400, 400)
        assert tile_rows == fc.conv_bm(p * 256, 400, sms) == bm
        assert per_sm == fc.conv_blocks_per_sm(p * 256, 400, bm, sms)
        assert blocks == per_sm * sms


def test_conv_phases_tool(cuda, capsys):
    """tools/conv_phases.py: the stamped build of the conv grid equals the
    shipped one on every case, and each phase takes a positive time no
    longer than the span."""
    from cgr_mpnn_3d_tpu_torch.tools import conv_phases
    out = conv_phases.main(["--graphs", "60", "--repeats", "2", "--probe"])
    assert any(k.endswith(" bwd") and "dpre" in v for k, v in out.items())
    for key, res in out.items():
        if key.startswith("probe"):
            assert res > 0
            continue
        assert all(0 < v <= res["span"] + 1e-9 for v in res.values()), key
    assert "conv_phases" in capsys.readouterr().out


# -- the gather-linear grid (K5, K10/K11 in csrc/gather_linear.cu) -----------

# forced builds of gather_linear.cu: a 7-block grid, 32-row tiles, 64-row
# tiles at one and at two blocks an SM
GLIN_DEFINES = [{"CGR_GRID_BLOCKS": 7}, {"CGR_CONV_BM": 32},
                {"CGR_CONV_BM": 64, "CGR_BLOCKS_PER_SM": 1},
                {"CGR_CONV_BM": 64, "CGR_BLOCKS_PER_SM": 2}]


def _glin_run(cuda, mat_dtype):
    """K5 (edge_init, readout; ReLU, SiLU, GELU; add and mean) and K10 and
    K11 (a pool ELL of 150 entries a group: five chunks) forward and
    backward at small width: every output, flattened."""
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    spec, b, rand = _layered_inputs(cuda)
    bf16 = mat_dtype == "bfloat16"
    sd = torch.bfloat16 if bf16 else torch.float32
    H, ET = 40, b.edge_nbr.shape[0]
    x, e, h = b.node_x.to(sd), rand(ET, 14).to(sd), rand(ET, H).to(sd)
    pins, pws = _pool_case(cuda, 31)
    if bf16:
        pins = (pins[0].bfloat16(), pins[1], pins[2].bfloat16(), *pins[3:])
    out = []
    with torch.no_grad():
        for stage, act, mean in (("edge_init", "relu", False),
                                 ("edge_init", "silu", False),
                                 ("readout", "gelu", True),
                                 ("readout", "relu", False)):
            if stage == "edge_init":
                xa, xb, idx, adj = x, e, b.senders[:, None], b.node_out
            else:
                xa, xb, idx, adj = h, x, b.node_inc, b.receivers[:, None]
            ws = (rand(xa.shape[1], H, scale=0.2),
                  rand(xb.shape[1], H, scale=0.2), rand(H, scale=0.1))
            kw = dict(p=spec.p, act=act, mean=mean, mat_dtype=mat_dtype,
                      out_dtype=mat_dtype if stage == "edge_init"
                      else "float32")
            y = gl.gather_linear_forward(xa, xb, idx, *ws, **kw)
            g = rand(*y.shape).to(y.dtype)
            out += [y, *gl.gather_linear_backward(xa, xb, idx, adj, *ws, y,
                                                  g, **kw)]
        xa, xr, xb, idx, ng, ell = pins
        adj = torch.full((xa.shape[0], 1), xb.shape[0], dtype=torch.int32,
                         device=cuda)
        for act, mean in (("relu", False), ("silu", True)):
            kw = dict(p=2, act=act, mean=mean, mat_dtype=mat_dtype)
            y = gl.gather_linear_r_forward(xa, xr, xb, idx, *pws, **kw)
            g = rand(*y.shape)
            out += [y, *gl.gather_linear_r_backward(xa, xr, xb, idx, adj,
                                                    *pws, y, g, **kw)]
            y, pool = gl.gather_linear_pool_forward(*pins, *pws, **kw)
            gp = rand(*pool.shape)
            out += [y, pool, *gl.gather_linear_pool_backward(
                xa, xr, xb, idx, adj, ng, ell, *pws, y, g, gp, **kw)]
    return _flat(out)


@pytest.mark.parametrize("mat_dtype", ["float32", "bfloat16"])
def test_glin_grid_forced_builds_and_reruns_are_bit_identical(cuda,
                                                              mat_dtype):
    """K5, K10 and K11 (DN > 32) forward and backward: a rerun and the
    builds forced to a 7-block grid, 32-row tiles and 64-row tiles at one
    and at two blocks an SM give the shipped build's outputs bit for
    bit."""
    want = _glin_run(cuda, mat_dtype)
    assert all(torch.isfinite(t).all() for t in want)
    assert all(torch.equal(x, y) for x, y in zip(_glin_run(cuda, mat_dtype),
                                                 want))
    for d, lib in zip(GLIN_DEFINES, _conv_variants("gather_linear",
                                                   GLIN_DEFINES)):
        got = _through("gather_linear", lib,
                       lambda: _glin_run(cuda, mat_dtype))
        assert all(torch.equal(x, y) for x, y in zip(got, want)), d


def test_glin_grid_is_one_launch_a_direction(cuda):
    """A K5 or K11 call is one kernel launch forward and one backward
    (torch.profiler's launch calls, the wrapper's counter of that kernel
    and direction, and the device kernel's name where the profile recorded
    it), on the grid the shape rule picks, with the scratch bytes the
    wrapper's mirror gives."""
    from cgr_mpnn_3d_tpu_torch.ops import _build
    from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
    spec, b, rand = _layered_inputs(cuda)
    H, ET = 40, b.edge_nbr.shape[0]
    ins = (rand(ET, H), b.node_x, b.node_inc)
    ws = (rand(H, H, scale=0.2), rand(b.node_x.shape[1], H, scale=0.2),
          rand(H, scale=0.1))
    kw = dict(p=spec.p, act="gelu", mean=True)
    with torch.no_grad():
        y = gl.gather_linear_forward(*ins, *ws, **kw)
    g = rand(*y.shape)
    pins, pws = _pool_case(cuda, 33)
    with torch.no_grad():
        py, pool = gl.gather_linear_pool_forward(*pins, *pws, p=2)
    adj = torch.full((pins[0].shape[0], 1), pins[2].shape[0],
                     dtype=torch.int32, device=cuda)
    gp, pg = rand(*pool.shape), rand(*py.shape)
    for name, kernel, fn in (
            ("launches", "glin_fwd_kernel",
             lambda: gl.gather_linear_forward(*ins, *ws, **kw)),
            ("bwd_launches", "glin_bwd_kernel",
             lambda: gl.gather_linear_backward(
                 *ins, b.receivers[:, None], *ws, y, g, **kw)),
            ("pool_launches", "glin_fwd_kernel",
             lambda: gl.gather_linear_pool_forward(*pins, *pws, p=2)),
            ("pool_bwd_launches", "glin_bwd_kernel",
             lambda: gl.gather_linear_pool_backward(
                 *pins[:4], adj, *pins[4:], *pws, py, pg, gp, p=2))):
        _assert_kernel(_launches_of_one_call(fn, gl), name, kernel)
    for p, R, FA, FB, bm in ((4, 256, 270, 14, 32), (436, 256, 270, 14, 64),
                             (8, 72, 400, 270, 32)):
        for backward in (False, True):
            blocks, rows_, per_sm, sms = gl.glin_grid(p, R, FA, FB, 400,
                                                      backward=backward)
            assert (rows_, per_sm) == gl.glin_tiles(p * R, FA, FB, 400,
                                                    backward, sms)
            assert rows_ == bm and blocks == per_sm * sms
    lib = _build.load("gather_linear")
    for mat, md in ((0, "float32"), (1, "bfloat16")):
        for p, R, FA, FB, GP, chunks in ((4, 256, 270, 14, 0, 1),
                                         (8, 72, 400, 270, 24, 2),
                                         (3, 7, 5, 3, 2, 1)):
            S = 4
            assert lib.cgr_gather_linear_fwd_scratch_bytes(
                p, R, FA, FB, 400, GP, chunks, mat) == gl.scratch_bytes(
                    False, p, R, FA, FB, 400, md, GP=GP, chunks=chunks)
            assert lib.cgr_gather_linear_bwd_scratch_bytes(
                p, R, FA, FB, 400, S, mat) == gl.scratch_bytes(
                    True, p, R, FA, FB, 400, md, S)


def test_glin_phases_tool(cuda, capsys):
    """tools/glin_phases.py: the stamped build equals the shipped one on
    every case, and each phase takes a positive time no longer than the
    span."""
    from cgr_mpnn_3d_tpu_torch.tools import glin_phases
    out = glin_phases.main(["--graphs", "60", "--val", "20", "--repeats",
                            "2", "--probe"])
    assert any(k.endswith(" bwd") and "products" in v for k, v in out.items()
               if isinstance(v, dict))
    for key, res in out.items():
        if key.startswith("probe"):
            assert res > 0
        else:
            assert all(0 < v <= res["span"] + 1e-9 for v in res.values()), key
    assert "glin_phases" in capsys.readouterr().out


def test_glin_ties_tool(cuda, capsys):
    """tools/glin_ties.py on the card: the kernel's gradients by the float64
    rule (at most 3 x the plain version's L1, or 1e-4), whatever masks
    differ between its out and the plain version's pre-activation."""
    from cgr_mpnn_3d_tpu_torch.tools import glin_ties
    out = glin_ties.main(["--graphs", "60", "--seeds", "2"])
    assert len(out) == 4
    for r in out:
        assert 0 <= r["flips"] < r["n"]
        assert r["l1_kernel"] <= max(3 * r["l1_plain"], 1e-4), r
    assert "glin_ties K5 edge_init" in capsys.readouterr().out


def test_predict_on_native_features_matches_the_python_twin(cuda, tmp_path):
    """``predict`` on the card over a corpus slice featurized by the native
    C++ featurizer against the same call over the pure-Python twin's
    graphs: predictions within 1e-4, through the forward kernel."""
    import csv
    from pathlib import Path

    from cgr_mpnn_3d_tpu_torch.data import ChemDataset
    from cgr_mpnn_3d_tpu_torch.data.descriptors import \
        synthetic_descriptors_npz
    from cgr_mpnn_3d_tpu_torch.train import predict
    corpus = Path(__file__).resolve().parent / "corpus_reactions.csv"
    with open(corpus, newline="") as f:
        rows = list(csv.reader(f))[:81]
    path = tmp_path / "slice.csv"
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    synthetic_descriptors_npz(path, tmp_path / "slice.npz", 8)
    preds = []
    for use_native in (True, False):
        ds = ChemDataset(str(path), data_npz_path=str(tmp_path / "slice.npz"),
                         use_native=use_native)
        ds.prefeaturize(num_workers=2)
        cfg = CGRMPNNConfig(num_node_features=ds.num_node_features,
                            num_edge_features=ds.num_edge_features, depth=3,
                            hidden_sizes=(64,) * 3, dropout_ps=(0.0,) * 3)
        model = init_params(cfg, torch.Generator().manual_seed(0), cuda)
        before = fm.launches
        preds.append(predict(model, ds, plan_spec(
            [ds.graph(i) for i in range(len(ds))]), 32, cuda))
        assert fm.launches > before
    native_pred, python_pred = preds
    assert native_pred.shape == (80,) and np.isfinite(native_pred).all()
    scale = max(float(np.abs(python_pred).max()), 1e-30)
    assert float(np.abs(native_pred - python_pred).max()) / scale <= 1e-4


# -- the trainer's device-resident modes ----------------------------------------

SEEDS = [7, 2**31 - 2, 12345]


@pytest.mark.parametrize("kernel", ["K2", "K4", "K8"])
def test_device_seeds_give_the_host_seeds_bits(cuda, kernel):
    """Seeds already on the card (an int32 tensor; K8 a 0-dim row of it)
    build the dropout table there and give the outputs of host seeds bit
    for bit, forward and backward."""
    from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
    from cgr_mpnn_3d_tpu_torch.ops import fused_conv as fc
    dev_seeds = torch.tensor(SEEDS, dtype=torch.int32).to(cuda)
    if kernel == "K2":
        _, batch, args, adj, labels, kw = _train_case(cuda, "ReLU", "add",
                                                      "add", 0.3)

        def run(seeds):
            return fm.fused_model_train(args, adj, labels,
                                        batch.graph_mask.float(),
                                        **dict(kw, seeds=seeds))
    elif kernel == "K4":
        spec, b, rand = _layered_inputs(cuda)
        ET, H, L = b.edge_nbr.shape[0], 40, 3
        h0, g = rand(ET, H), rand(ET, H)
        ws = (rand(L, H, H, scale=0.2), rand(L, H, scale=0.1),
              torch.tensor([0.8, -0.3, 1.2], device=cuda))
        idx = (b.edge_nbr, b.rev)

        def run(seeds):
            kw = dict(p=spec.p, act="relu", train=True, seeds=seeds,
                      dropout_ps=(0.3,) * L)
            return (cs.conv_stack_forward(h0, *idx, *ws, **kw),
                    *cs.conv_stack_backward(h0, *idx, b.edge_nbr_rev, *ws, g,
                                            **kw))
    else:
        spec, shards, rand = _ep_case(cuda)
        b = max(shards, key=lambda s: float(s.halo_mask.sum()))
        H = 40
        ins = (rand(spec.pe, H), rand(spec.pn, H), rand(spec.pe, H),
               b.edge_nbr, b.rev, b.senders)
        ws = (rand(H, H, scale=0.2), rand(H, scale=0.1),
              torch.tensor(0.8, device=cuda))
        g = rand(spec.pe, H)

        def run(seeds):
            kw = dict(p=spec.p, tn=spec.tn, act="relu", train=True,
                      seed=seeds[1], dropout_p=0.3)
            out = fc.fused_conv_r_forward(*ins, *ws, **kw)
            return (out, *fc.fused_conv_r_backward(
                *ins, b.edge_nbr_rev, b.node_out, *ws, out, g, **kw))
    host, on_card = _flat(run(SEEDS)), _flat(run(dev_seeds))
    torch.cuda.synchronize()
    assert len(host) == len(on_card) > 1
    assert all(torch.equal(x, y) for x, y in zip(host, on_card))


def _demo_trainer(cuda_or_cpu, tmp_path, name, **kw):
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset
    from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer
    ds = ChemDataset(str(Path(__file__).resolve().parent.parent
                         / "examples" / "demo.csv"))
    cfg = CGRMPNNConfig(num_node_features=ds.num_node_features,
                        num_edge_features=ds.num_edge_features, depth=3,
                        hidden_sizes=(64,) * 3, dropout_ps=(0.2,) * 3)
    spec = plan_spec([ds.graph(i) for i in range(len(ds))], te=64, tn=32,
                     tb=4)
    return RxnGraphTrainer(name=name, cfg=cfg, train_data=ds, val_data=ds,
                           spec=spec, batch_size=2, val_frequency=1, seed=4,
                           gamma=0.9, num_epochs=3,
                           model_save_dir=str(tmp_path / name),
                           device=cuda_or_cpu, reuse_packs=True, **kw)


def test_device_epoch_on_card_equals_the_host_loop(cuda, tmp_path):
    """The whole-model trainer's staged epochs on the card: losses and
    parameters equal its host loop's bit for bit over 3 epochs (dropout
    0.2, gamma 0.9), one K2 launch a step, and every step loop runs under
    torch.cuda.set_sync_debug_mode("error"): no call in it waits for the
    card."""
    host = _demo_trainer(cuda, tmp_path, "host")
    dev = _demo_trainer(cuda, tmp_path, "dev", device_epoch=True)
    run_steps = dev._run_steps

    def strict(batches, seeds):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run_steps(batches, seeds)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    dev._run_steps = strict
    out_h = host.train()
    before = fm.train_launches
    out_d = dev.train()
    assert fm.train_launches - before == out_d["steps"] == 15
    assert out_d["train_losses"] == out_h["train_losses"]
    assert out_d["val_losses"] == out_h["val_losses"]
    for x, y in zip(host.model.parameters(), dev.model.parameters()):
        assert torch.equal(x, y)
    assert (host.step, host._stream) == (dev.step, dev._stream)
