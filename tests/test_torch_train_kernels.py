"""The port's training kernels' plain versions against the JAX package on
the CPU.

* the hash-dropout bits and ``k_dact`` against ``ops/pallas_fused.py``;
* the forward's train mode (``fused_model_forward_ref``) against the JAX
  whole-model kernel K3f in interpret mode with the same seeds;
* the plain training step (``fused_model_train_ref``) against the JAX
  kernel K2 (``fused_model_train``) in interpret mode, seeds passed
  through ``kernel_flat_params``;
* the plain VJP (``fused_model_vjp_ref``) against ``jax.grad`` through
  ``apply(use_pallas=True, pallas_interpret=True)`` (the K3b kernel);
* the model's training half: ``apply(train=True)`` on the gather path,
  ``fused_model`` and ``fused_train_value_and_grad`` against autograd.

Tolerances: sse rtol 1e-4; each gradient max|delta| / max|JAX| <= 1e-4
(f32; the sums run in other orders than the one-hot matmuls); dropout bits
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgr_mpnn_3d_tpu.models as jm
from cgr_mpnn_3d_tpu.chem import RxnGraph
from cgr_mpnn_3d_tpu.data import pack_graphs, plan_spec
from cgr_mpnn_3d_tpu.models.cgr_mpnn import kernel_flat_params
from cgr_mpnn_3d_tpu.models.cgr_mpnn import kernel_seeds as j_kernel_seeds
from cgr_mpnn_3d_tpu.ops.dispatch import build_model_indices
from cgr_mpnn_3d_tpu.ops.pallas_fused import (_hash_bits,
                                              hash_dropout_keep_full, k_dact,
                                              k_dropout_mask)
from cgr_mpnn_3d_tpu.ops.pallas_model import (ModelKernelSpec,
                                              fused_model_train)
from cgr_mpnn_3d_tpu_torch.data import to_device
from cgr_mpnn_3d_tpu_torch.models import (CGRMPNN, CGRMPNNConfig,
                                          adjoint_inputs, apply,
                                          fused_train_value_and_grad,
                                          kernel_inputs, kernel_seeds,
                                          params_from_jax)
from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
from cgr_mpnn_3d_tpu_torch.ops import kernel_math

SMILES = ["CCO>>CC=O", "CC(=O)N>>CC(=O)N", "C=CC=C>>C=CC=C",
          "CCO>C>CCO", "O>C>CO", "N>C>CN", "CC>>CC",
          "[N:1]([H:2])([H:3])[H:4]>>[N:1]([H:2])[H:3].[H:4]"]
LABELS = [float(i) for i in range(len(SMILES))]
KACT = {"ReLU": "relu", "SiLU": "silu", "GELU": "gelu"}
SEEDS = [11, 2**31 - 5, 777]
SKIPS = (0.8, -0.3, 1.2)


@pytest.fixture(scope="module")
def packed():
    graphs = [RxnGraph(s).arrays for s in SMILES]
    spec = plan_spec(graphs, te=64, tn=32, tb=8).with_packs(2)
    batch = pack_graphs(graphs, LABELS, spec)
    return spec, batch, to_device(batch, "cpu")


def _kw(act="ReLU", aggr="add", pooling="add", drop=0.0, depth=3):
    return dict(num_node_features=78, num_edge_features=14, depth=depth,
                hidden_sizes=(16,) * depth, dropout_ps=(drop,) * depth,
                activation=act, aggr=aggr, pooling=pooling,
                use_learnable_skip=True)


def _models(seed, **kw):
    """(JAX params, port model with the same weights)."""
    params = jm.init_params(jax.random.PRNGKey(seed), jm.CGRMPNNConfig(**kw))
    params["skip_weights"] = [jnp.asarray(v) for v in SKIPS[:kw["depth"]]]
    model = CGRMPNN(CGRMPNNConfig(**kw))
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, model


def _kernel_kw(spec, act, aggr, pooling, drop, seeds=SEEDS, depth=3):
    return dict(p=spec.p, act=KACT[act], aggr=aggr, pooling=pooling,
                train=True, seeds=list(seeds), dropout_ps=(drop,) * depth)


def _mspec(spec, b, act, aggr, pooling, drop, depth=3):
    return ModelKernelSpec(
        p=spec.p, d_nbr=b.edge_nbr.shape[1], dn_pool=b.graph_nodes.shape[1],
        depth=depth, dropout_ps=(drop,) * depth, train=True,
        learnable_skip=True, mat_dtype=jnp.float32, interpret=True,
        act=KACT[act], aggr=aggr, pooling=pooling)


def _assert_grads(got, want):
    for name, g, w in zip(fm.GRAD_NAMES, got, want):
        w = np.asarray(w, np.float32).reshape(tuple(g.shape))
        err = np.abs(g.detach().numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (name, err)


# -- K1 helpers ---------------------------------------------------------------

@pytest.mark.parametrize("seed,pack", [(0, 0), (12345, 3), (2**31 - 2, 70001),
                                       (-7, 1)])
def test_hash_bits_match_jax_bit_for_bit(seed, pack):
    rows = torch.arange(64)[:, None]
    cols = torch.arange(40)[None, :]
    want = np.asarray(_hash_bits((64, 40), jnp.int32(seed), pack))
    got = kernel_math.hash_bits(rows, cols, seed, pack).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(
        kernel_math.k_dropout_mask((64, 40), seed, pack, 0.7).numpy(),
        np.asarray(k_dropout_mask((64, 40), jnp.int32(seed), pack, 0.7)))
    for rate in (0.1, 0.5, 0.0):
        np.testing.assert_array_equal(
            kernel_math.hash_dropout_keep_full(3 * 64, 40, 64, seed,
                                               rate).numpy(),
            np.asarray(hash_dropout_keep_full(3 * 64, 40, 64,
                                              jnp.int32(seed), rate)))


@pytest.mark.parametrize("name", ["relu", "silu", "gelu"])
def test_k_dact_matches_jax(name):
    x = np.linspace(-12.0, 12.0, 4001, dtype=np.float32)
    np.testing.assert_allclose(
        kernel_math.k_dact(name, torch.from_numpy(x)).numpy(),
        np.asarray(k_dact(name, jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        kernel_math.k_dact("tanh", torch.from_numpy(x))


# -- forward, train mode --------------------------------------------------------

@pytest.mark.parametrize("act,aggr,pooling", [("ReLU", "add", "add"),
                                              ("GELU", "mean", "mean")])
def test_train_forward_plain_matches_interpret_k3f(packed, act, aggr,
                                                   pooling):
    """fused_model_forward_ref(train=True) against JAX apply through K3f
    with the seeds its rng derives; the gather path of apply(train=True)
    gives the same predictions."""
    spec, b, tb = packed
    kw = _kw(act, aggr, pooling, drop=0.3)
    params, model = _models(1, **kw)
    cfg_m = jm.CGRMPNNConfig(**kw, use_pallas=True, pallas_interpret=True)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jm.apply(params, b, cfg_m, spec, train=True, rng=rng))
    seeds = np.asarray(j_kernel_seeds(cfg_m, rng)).tolist()
    mask = b.graph_mask > 0
    with torch.no_grad():
        got = fm.fused_model_forward_ref(
            *kernel_inputs(model, tb),
            **_kernel_kw(spec, act, aggr, pooling, 0.3, seeds))
        gather = apply(model, tb, spec, train=True, seeds=seeds)
        evald = apply(model, tb, spec)
    np.testing.assert_allclose(got.numpy()[mask], want[mask], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gather.numpy()[mask], got.numpy()[mask],
                               rtol=1e-4, atol=1e-4)
    assert not np.allclose(evald.numpy()[mask], got.numpy()[mask])


# -- K2 -----------------------------------------------------------------------------

K2_CASES = [("ReLU", "add", "add", 0.0), ("ReLU", "mean", "mean", 0.3),
            ("SiLU", "add", "mean", 0.0), ("SiLU", "mean", "add", 0.3),
            ("GELU", "add", "add", 0.3), ("GELU", "mean", "mean", 0.0)]


@pytest.mark.parametrize("act,aggr,pooling,drop", K2_CASES)
def test_plain_train_step_matches_interpret_k2(packed, act, aggr, pooling,
                                               drop):
    spec, b, tb = packed
    kw = _kw(act, aggr, pooling, drop)
    params, model = _models(0, **kw)
    idxs = build_model_indices(b, spec.p)
    flat = kernel_flat_params(params, jm.CGRMPNNConfig(**kw), 78,
                              jnp.asarray(SEEDS, jnp.int32))
    sse_j, g_j = fused_model_train(
        _mspec(spec, b, act, aggr, pooling, drop), jnp.asarray(b.node_x),
        jnp.asarray(b.edge_attr),
        (idxs.gather_fwd, idxs.msg_fwd, idxs.inc_fwd, idxs.pool_fwd), flat,
        jnp.asarray(b.labels), jnp.asarray(b.graph_mask))
    sse, grads = fm.fused_model_train_ref(
        kernel_inputs(model, tb), adjoint_inputs(tb), tb.labels,
        tb.graph_mask, **_kernel_kw(spec, act, aggr, pooling, drop))
    np.testing.assert_allclose(float(sse), float(sse_j), rtol=1e-4)
    _assert_grads(grads, g_j)
    # the wrapper takes the plain version for CPU tensors
    sse_w, grads_w = fm.fused_model_train(
        kernel_inputs(model, tb), adjoint_inputs(tb), tb.labels,
        tb.graph_mask, **_kernel_kw(spec, act, aggr, pooling, drop))
    assert torch.equal(sse_w, sse)
    assert all(torch.equal(x, y) for x, y in zip(grads_w, grads))


# -- K3b ----------------------------------------------------------------------------

@pytest.mark.parametrize("act,aggr,pooling,drop", [
    ("ReLU", "add", "add", 0.3), ("SiLU", "mean", "mean", 0.0),
    ("GELU", "mean", "add", 0.3)])
def test_plain_vjp_matches_jax_grad_through_interpret_kernels(
        packed, act, aggr, pooling, drop):
    spec, b, tb = packed
    kw = _kw(act, aggr, pooling, drop)
    params, model = _models(2, **kw)
    cfg_m = jm.CGRMPNNConfig(**kw, use_pallas=True, pallas_interpret=True)
    rng = jax.random.PRNGKey(9)
    dpred = np.random.default_rng(0).standard_normal(
        b.labels.shape).astype(np.float32)
    g_j = jax.grad(lambda p: jnp.sum(
        jm.apply(p, b, cfg_m, spec, train=True, rng=rng) * dpred))(params)
    seeds = np.asarray(j_kernel_seeds(cfg_m, rng)).tolist()
    grads = fm.fused_model_vjp_ref(
        kernel_inputs(model, tb), adjoint_inputs(tb), torch.from_numpy(dpred),
        **_kernel_kw(spec, act, aggr, pooling, drop, seeds))
    F = 78
    want = (g_j["edge_init"]["w"][:F], g_j["edge_init"]["w"][F:],
            g_j["edge_init"]["b"],
            jnp.stack([c["w"] for c in g_j["convs"]]),
            jnp.stack([c["b"] for c in g_j["convs"]]),
            jnp.stack(g_j["skip_weights"]),
            g_j["edge_to_node"]["w"][F:], g_j["edge_to_node"]["w"][:F],
            g_j["edge_to_node"]["b"], g_j["ffn"]["w"], g_j["ffn"]["b"])
    _assert_grads(grads, want)
    # the autograd wrapper on CPU tensors gives the same VJP
    ws = [t.detach().requires_grad_() for t in kernel_inputs(model, tb)[7:]]
    out = fm.fused_model([*kernel_inputs(model, tb)[:7], *ws],
                         adjoint_inputs(tb),
                         **_kernel_kw(spec, act, aggr, pooling, drop, seeds))
    auto = torch.autograd.grad((out * torch.from_numpy(dpred)).sum(), ws)
    for a, g in zip(auto, grads):
        torch.testing.assert_close(a, g)


# -- the model's training half ------------------------------------------------------

def test_fused_train_value_and_grad_writes_autograd_grads(packed):
    """The one-call step equals autograd of the masked SSE through
    apply(train=True) on the gather path, gradient for gradient."""
    spec, b, tb = packed
    _, model = _models(3, **_kw("SiLU", "mean", "add", 0.3))
    seeds = kernel_seeds(model.cfg, torch.Generator().manual_seed(0))
    assert seeds.dtype == torch.int32 and seeds.shape == (3,)
    assert int(seeds.min()) >= 0
    sse = fused_train_value_and_grad(model, tb, spec, seeds)
    got = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    preds = apply(model, tb, spec, train=True, seeds=seeds)
    want = (((preds - tb.labels) * tb.graph_mask) ** 2).sum()
    want.backward()
    torch.testing.assert_close(sse, want.detach(), rtol=1e-5, atol=1e-5)
    for n, p in model.named_parameters():
        torch.testing.assert_close(got[n], p.grad, rtol=1e-4, atol=1e-5,
                                   msg=n)


def test_train_mode_checks(packed):
    spec, b, tb = packed
    _, model = _models(0, **_kw())
    args = kernel_inputs(model, tb)
    kkw = dict(p=spec.p, act="relu", aggr="add", pooling="add")
    with torch.no_grad():
        with pytest.raises(ValueError, match="one seed and one drop rate"):
            fm.fused_model_forward(*args, **kkw, train=True)
        with pytest.raises(ValueError, match="one seed and one drop rate"):
            fm.fused_model_forward(*args, **kkw, train=True, seeds=[1, 2],
                                   dropout_ps=(0.1, 0.1))
        with pytest.raises(ValueError, match=r"\[0, 1\)"):
            fm.fused_model_forward(*args, **kkw, train=True, seeds=SEEDS,
                                   dropout_ps=(0.1, 1.0, 0.1))
        with pytest.raises(ValueError, match="seeds"):
            apply(model, tb, spec, train=True)
        with pytest.raises(ValueError, match="labels has shape"):
            fm.fused_model_train(args, adjoint_inputs(tb), tb.labels[:-1],
                                 tb.graph_mask, **kkw)


def test_k2_phases_tool_matches_the_source():
    """tools/k2_phases.py's define and phase table are the kernels': the
    phase clock sits under ``#ifdef DEFINE`` in fused_model_grid.cuh (the
    shipped builds, which no flag of ops/_build.py defines, stamp
    nothing), its table equals PHASES, and the stamps run through its ids
    in order: K2's (fused_model_bwd.cu around the shared forward phases)
    through every id, K3f's (fused_model_fwd.cu) through the forward's."""
    import re
    from cgr_mpnn_3d_tpu_torch.ops import _build
    from cgr_mpnn_3d_tpu_torch.tools import k2_phases
    grid = (_build.CSRC / "fused_model_grid.cuh").read_text()
    start = grid.index(f"#ifdef {k2_phases.DEFINE}\n")
    clock = grid[start:grid.index("#else\n#define CGR_STAMP", start)]
    table = re.search(r"kPhaseNames\[\] = \{(.*?)\};", clock, re.S).group(1)
    assert tuple(re.findall(r'"([^"]+)"', table)) == k2_phases.PHASES
    assert "#define CGR_STAMP(id, layer) phase_stamp(id, layer)" in clock
    assert "#else\n#define CGR_STAMP(id, layer)\n#endif" in grid

    def ids(text):
        return [int(i) for i in re.findall(r"CGR_STAMP\((\d+), ", text)]
    shared = ids(grid[grid.index("void forward_phases("):])
    bwd = (_build.CSRC / "fused_model_bwd.cu").read_text()
    fwd = (_build.CSRC / "fused_model_fwd.cu").read_text()
    for src, last in ((bwd, len(k2_phases.PHASES)), (fwd, 7)):
        assert "forward_phases<kBf16>(" in src
        head, tail = src.split("forward_phases<kBf16>(", 1)
        assert ids(head)[-1:] + shared + ids(tail) == list(range(last))
        assert "getenv" not in src
    assert not any(k2_phases.DEFINE in f for f in _build.NVCC_FLAGS)
