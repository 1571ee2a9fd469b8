"""The CUDA kernels on the card against their plain versions (needs a GPU
and nvcc; skips elsewhere): the forward (eval and train mode), the training
step and the VJP.  Run on a GPU machine with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX, which a GPU machine for
the port need not have.)
"""

import itertools

import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu_torch.chem import RxnGraph
from cgr_mpnn_3d_tpu_torch.data import (pack_graphs, packs_needed,
                                        place_graphs, plan_spec, to_device)
from cgr_mpnn_3d_tpu_torch.data.synthetic import synthetic_graphs
from cgr_mpnn_3d_tpu_torch.models import (ACTIVATIONS, CGRMPNNConfig,
                                          adjoint_inputs, apply, init_params,
                                          kernel_inputs)
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
        if act != "ReLU":
            assert _rel(g, r) <= 1e-4, name
    if act == "ReLU":
        assert _l1(grads, grads_f64()) <= max(
            3 * _l1(grads_ref, grads_f64()), 1e-4)


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
