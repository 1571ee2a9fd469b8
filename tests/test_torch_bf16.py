"""bf16 compute of the port on the CPU: the plain versions of the
whole-model kernels at ``mat_dtype="bfloat16"`` against the JAX kernels in
interpret mode, the model and the trainer against tests/test_bf16.py's
bounds, the training CLI end to end, an unsupported compute_dtype, and
the matmul probe P2 against the JAX tool's own Pallas kernel (the
layered, capture and XLA paths at bf16: tests/test_torch_layered_bf16.py).

Inputs are made from seeds with numpy (weights by ``jax.random`` and copied
into the port) at test_bf16.py's shapes: the first 16 corpus reactions in 4
packs of te=128/tn=64/tb=8, depth 3, hidden 32.

Tolerances:

* plain K3f, K2, K3b against the JAX bf16 kernels: the rel-L2 distance of
  the predictions, the loss and the flattened gradients is at most a
  quarter of the JAX bf16 kernel's own distance to its f32 run and at most
  5e-3 (both round at the same places; only the order of f32 sums differs,
  which can flip a rounding), and the port's bf16 output differs from its
  f32 output;
* the model against the f32 oracle (JAX's XLA path at f32): test_bf16.py's
  rel-L2 < 1.5e-2 for predictions, loss rtol 2e-2, gradient cosine > 0.995
  and rel-L2 < 0.1, and the training duel's 1.25 x + 0.05 on the RMSE;
* P2: int8 exactly; bf16 rel-L2 4e-3 from the JAX tool's result and from a
  float64 product of the same bf16 inputs.
"""

import dataclasses
import functools
import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import cgr_mpnn_3d_tpu.models as jm
from cgr_mpnn_3d_tpu.chem import RxnGraph
from cgr_mpnn_3d_tpu.data import pack_graphs, plan_spec
from cgr_mpnn_3d_tpu.models.cgr_mpnn import kernel_flat_params
from cgr_mpnn_3d_tpu.ops.dispatch import build_model_indices
from cgr_mpnn_3d_tpu.ops.pallas_fused import \
    mean_colscale as j_mean_colscale
from cgr_mpnn_3d_tpu.ops.pallas_model import (ModelKernelSpec, fused_model,
                                              fused_model_train)
from cgr_mpnn_3d_tpu.train.trainer import sse_loss as j_sse_loss
from cgr_mpnn_3d_tpu_torch.data import to_device
from cgr_mpnn_3d_tpu_torch.models import (CGRMPNN, CGRMPNNConfig,
                                          adjoint_inputs, apply,
                                          fused_train_value_and_grad,
                                          init_params, kernel_inputs,
                                          kernel_seeds, params_from_jax)
from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
from cgr_mpnn_3d_tpu_torch.ops import kernel_math
from cgr_mpnn_3d_tpu_torch.ops import mm_probe as mp
from cgr_mpnn_3d_tpu_torch.train import set_epoch_lr, sse_loss

REPO = Path(__file__).resolve().parent.parent
KACT = {"ReLU": "relu", "SiLU": "silu", "GELU": "gelu"}
SEEDS = [11, 2**31 - 5, 777]
SKIPS = (0.8, -0.3, 1.2)
CASES = [("ReLU", "add", "add"), ("SiLU", "mean", "mean"),
         ("GELU", "mean", "add")]
DROP = 0.1


@pytest.fixture(scope="module")
def corpus():
    rows = (REPO / "tests" / "corpus_reactions.csv"
            ).read_text().splitlines()[1:]
    return [RxnGraph(r.split(",")[0]).arrays for r in rows if r.strip()][:96]


@pytest.fixture(scope="module")
def packed(corpus):
    gs = corpus[:16]
    spec = plan_spec(gs, te=128, tn=64, tb=8).with_packs(4)
    batch = pack_graphs(gs, [float(i % 7 - 3) for i in range(16)], spec)
    return spec, batch, to_device(batch, "cpu")


def _rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(ts) -> np.ndarray:
    return np.concatenate([np.asarray(t, np.float64).ravel() for t in ts])


def _kw(batch, act, aggr, pooling, drop=DROP, dtype="float32"):
    F, Fe = batch.node_x.shape[1], batch.edge_attr.shape[1]
    return dict(num_node_features=F, num_edge_features=Fe, depth=3,
                hidden_sizes=(32,) * 3, dropout_ps=(drop,) * 3,
                activation=act, aggr=aggr, pooling=pooling,
                use_learnable_skip=True, compute_dtype=dtype)


def _jax_kw(kw):
    return {k: v for k, v in kw.items() if k != "compute_dtype"}


def _models(seed, kw):
    """(JAX params, port model with the same weights)."""
    params = jm.init_params(jax.random.PRNGKey(seed),
                            jm.CGRMPNNConfig(**_jax_kw(kw)))
    params["skip_weights"] = [jnp.asarray(v) for v in SKIPS]
    model = CGRMPNN(CGRMPNNConfig(**kw))
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, model


class _JaxKernels:
    """The JAX whole-model kernels of one case in interpret mode, at bf16
    and at f32, with the case's weights, seeds and train-mode dropout."""

    def __init__(self, packed, case):
        spec, b, tb = packed
        act, aggr, pooling = case
        self.kw = _kw(b, act, aggr, pooling)
        self.params, self.model = _models(CASES.index(case), self.kw)
        self.b, self.tb, self.spec = b, tb, spec
        idxs = build_model_indices(b, spec.p)
        self.idxs = (idxs.gather_fwd, idxs.msg_fwd, idxs.inc_fwd,
                     idxs.pool_fwd)
        self.flat = kernel_flat_params(
            self.params, jm.CGRMPNNConfig(**_jax_kw(self.kw)),
            b.node_x.shape[1], jnp.asarray(SEEDS, jnp.int32))
        self.dpred = np.random.default_rng(3).standard_normal(
            b.labels.shape).astype(np.float32) * b.graph_mask
        self.port_kw = dict(p=spec.p, act=KACT[act], aggr=aggr,
                            pooling=pooling, train=True, seeds=SEEDS,
                            dropout_ps=(DROP,) * 3)

    def mspec(self, md):
        return ModelKernelSpec(
            p=self.spec.p, d_nbr=self.b.edge_nbr.shape[1],
            dn_pool=self.b.graph_nodes.shape[1], depth=3,
            dropout_ps=(DROP,) * 3, train=True, learnable_skip=True,
            mat_dtype=md, interpret=True, act=self.port_kw["act"],
            aggr=self.port_kw["aggr"], pooling=self.port_kw["pooling"])

    def xe(self, md):
        return (jnp.asarray(self.b.node_x).astype(md),
                jnp.asarray(self.b.edge_attr).astype(md))

    @functools.lru_cache(maxsize=None)
    def forward(self, md):
        return np.asarray(fused_model(self.mspec(md), *self.xe(md),
                                      *self.idxs, *self.flat))

    @functools.lru_cache(maxsize=None)
    def train(self, md):
        sse, g = fused_model_train(self.mspec(md), *self.xe(md), self.idxs,
                                   self.flat, jnp.asarray(self.b.labels),
                                   jnp.asarray(self.b.graph_mask))
        return float(sse), _flat(g)

    @functools.lru_cache(maxsize=None)
    def vjp(self, md):
        _, pull = jax.vjp(lambda *w: fused_model(
            self.mspec(md), *self.xe(md), *self.idxs, *w, self.flat[-1]),
            *self.flat[:-1])
        return _flat(pull(jnp.asarray(self.dpred)))


@pytest.fixture(scope="module")
def jax_kernels(packed):
    return {case: _JaxKernels(packed, case) for case in CASES}


def _held_to_jax(port16, port32, jax16, jax32, what):
    """The port's bf16 result against the JAX bf16 kernel's: rel-L2 at
    most a quarter of the JAX kernel's bf16-vs-f32 distance and 5e-3; the
    port's bf16 differs from its f32."""
    own = _rel_l2(jax16, jax32)
    err = _rel_l2(port16, jax16)
    assert err <= min(0.25 * own, 5e-3), (what, err, own)
    assert _rel_l2(port16, port32) > 0.0, what


# -- helpers ---------------------------------------------------------------

def test_round_bf16_matches_jax_astype():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 10,
                        # exact ties between two bf16 values, both parities
                        (1.0 + np.arange(1, 64, 2) * 2.0**-8).astype(
                            np.float32)])
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))
    got = kernel_math.round_bf16(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # float64 operands (the float64 evaluations) round the same way
    np.testing.assert_array_equal(
        kernel_math.round_bf16(torch.from_numpy(x).double()).numpy(), want)


def test_bf16_mean_scale_is_the_one_hot_entry():
    """mean_colscale(valid, "bfloat16") equals the entries of the JAX
    kernels' bf16 one-hot matrix (pallas_fused.mean_colscale)."""
    deg = np.arange(0, 13)
    onehot = (np.arange(12)[:, None] < deg[None, :]).astype(np.float32)
    want = np.asarray(j_mean_colscale(jnp.asarray(onehot, jnp.bfloat16),
                                      jnp.bfloat16).astype(jnp.float32))
    valid = torch.from_numpy(onehot.T > 0)
    got = kernel_math.mean_colscale(valid, "bfloat16").numpy()
    np.testing.assert_array_equal(got[deg > 0], want.max(axis=0)[deg > 0])
    f32 = kernel_math.mean_colscale(valid).numpy()
    assert not np.array_equal(got, f32)


# -- the plain kernels against the JAX kernels -------------------------------

@pytest.mark.parametrize("case", CASES)
def test_plain_k3f_bf16_matches_interpret_k3f(jax_kernels, case):
    k = jax_kernels[case]
    mask = k.b.graph_mask > 0
    with torch.no_grad():
        args = kernel_inputs(k.model, k.tb)
        got = {md: fm.fused_model_forward_ref(*args, **k.port_kw,
                                              mat_dtype=md).numpy()[mask]
               for md in ("bfloat16", "float32")}
        wrapped = fm.fused_model_forward(*args, **k.port_kw,
                                         mat_dtype="bfloat16")
    _held_to_jax(got["bfloat16"], got["float32"],
                 k.forward(jnp.bfloat16)[mask], k.forward(jnp.float32)[mask],
                 "preds")
    assert np.array_equal(wrapped.numpy()[mask], got["bfloat16"])


@pytest.mark.parametrize("case", CASES)
def test_plain_k2_bf16_matches_interpret_k2(jax_kernels, case):
    k = jax_kernels[case]
    args, adj = kernel_inputs(k.model, k.tb), adjoint_inputs(k.tb)
    got = {md: fm.fused_model_train_ref(args, adj, k.tb.labels,
                                        k.tb.graph_mask, **k.port_kw,
                                        mat_dtype=md)
           for md in ("bfloat16", "float32")}
    (s16, g16), (s32, g32) = got["bfloat16"], got["float32"]
    (j16, jg16), (j32, jg32) = k.train(jnp.bfloat16), k.train(jnp.float32)
    _held_to_jax([float(s16)], [float(s32)], [j16], [j32], "sse")
    _held_to_jax(_flat(x.detach() for x in g16),
                 _flat(x.detach() for x in g32), jg16, jg32, "grads")
    # the wrapper takes the plain version for CPU tensors
    sw, gw = fm.fused_model_train(args, adj, k.tb.labels, k.tb.graph_mask,
                                  **k.port_kw, mat_dtype="bfloat16")
    assert torch.equal(sw, s16)
    assert all(torch.equal(x, y) for x, y in zip(gw, g16))


@pytest.mark.parametrize("case", CASES)
def test_plain_k3b_bf16_matches_jax_vjp(jax_kernels, case):
    k = jax_kernels[case]
    args, adj = kernel_inputs(k.model, k.tb), adjoint_inputs(k.tb)
    dpred = torch.from_numpy(k.dpred)
    got = {md: _flat(g.detach() for g in fm.fused_model_vjp_ref(
        args, adj, dpred, **k.port_kw, mat_dtype=md))
        for md in ("bfloat16", "float32")}
    _held_to_jax(got["bfloat16"], got["float32"], k.vjp(jnp.bfloat16),
                 k.vjp(jnp.float32), "vjp")
    # the autograd wrapper on CPU tensors gives the same VJP
    ws = [t.detach().requires_grad_() for t in args[7:]]
    out = fm.fused_model([*args[:7], *ws], adj, **k.port_kw,
                         mat_dtype="bfloat16")
    auto = torch.autograd.grad((out * dpred).sum(), ws)
    np.testing.assert_array_equal(_flat(a.detach() for a in auto),
                                  got["bfloat16"])


# -- the model against the f32 oracle ------------------------------------------

def _oracle(corpus, n, aggr="add", pooling="add", seed=1, labels=None):
    """(JAX params, port bf16 model, PackSpec, JAX batch, port batch) of
    test_bf16.py's setup: n corpus graphs, depth 2, hidden 32, no dropout."""
    gs = corpus[:n]
    spec = plan_spec(gs, te=128, tn=64, tb=8).with_packs(4)
    b = pack_graphs(gs, labels or [0.0] * n, spec)
    kw = dict(num_node_features=gs[0].node_feats.shape[1],
              num_edge_features=gs[0].edge_feats.shape[1], depth=2,
              hidden_sizes=(32, 32), dropout_ps=(0.0, 0.0), aggr=aggr,
              pooling=pooling)
    params = jm.init_params(jax.random.PRNGKey(seed), jm.CGRMPNNConfig(**kw))
    model = CGRMPNN(CGRMPNNConfig(**kw, compute_dtype="bfloat16"))
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, model, jm.CGRMPNNConfig(**kw), spec, b, to_device(b,
                                                                      "cpu")


@pytest.mark.parametrize("aggr,pooling", [("add", "add"), ("mean", "mean"),
                                          ("mean", "add")])
def test_apply_bf16_close_to_f32_oracle(corpus, aggr, pooling):
    params, model, jcfg, spec, b, tb = _oracle(corpus, 16, aggr, pooling)
    want = np.asarray(jm.apply(params, b, jcfg))
    with torch.no_grad():
        got = apply(model, tb, spec).numpy()
        model.cfg = dataclasses.replace(model.cfg, compute_dtype="float32")
        f32 = apply(model, tb, spec).numpy()
    mask = b.graph_mask > 0
    err = _rel_l2(got[mask], want[mask])
    assert 0.0 < err < 1.5e-2, err
    assert _rel_l2(f32[mask], want[mask]) < 1e-5


def test_train_step_bf16_tracks_f32_oracle(corpus):
    labels = [float(i % 7 - 3) for i in range(16)]
    params, model, jcfg, spec, b, tb = _oracle(corpus, 16, seed=2,
                                               labels=labels)
    l32, g32 = jax.value_and_grad(j_sse_loss)(params, b, jcfg, False, None)
    sse = fused_train_value_and_grad(model, tb, spec)
    np.testing.assert_allclose(float(sse), float(l32), rtol=2e-2)
    assert float(sse) != pytest.approx(float(l32), rel=1e-7, abs=0.0)
    # the JAX pytree's leaves are in jax_leaf_names order
    from cgr_mpnn_3d_tpu_torch.models import jax_leaf_names
    named = dict(model.named_parameters())
    flat16 = _flat(named[n].grad.reshape(-1)
                   for n in jax_leaf_names(model.cfg))
    flat32 = _flat(jax.tree_util.tree_leaves(g32))
    cos = float(flat16 @ flat32
                / (np.linalg.norm(flat16) * np.linalg.norm(flat32)))
    assert cos > 0.995, cos
    assert _rel_l2(flat16, flat32) < 0.1


def test_training_duel_bf16_vs_f32(corpus):
    """test_bf16.py::TestTrainingDuel with the port: one teacher, the same
    seeds and recipe (Adam-amsgrad, per-epoch lr decay, MSE-sum, dropout
    0.1) trained at f32 and at bf16 through the port's training step; the
    final RMSE lands in the same place."""
    gs = corpus
    F, Fe = gs[0].node_feats.shape[1], gs[0].edge_feats.shape[1]
    base = dict(num_node_features=F, num_edge_features=Fe, depth=2,
                hidden_sizes=(32, 32))
    teacher = init_params(CGRMPNNConfig(**base, dropout_ps=(0.0, 0.0)),
                          torch.Generator().manual_seed(5), "cpu")
    spec = plan_spec(gs, te=128, tn=64, tb=8).with_packs(8)
    batches = []
    for i in range(0, len(gs), 32):
        b = to_device(pack_graphs(gs[i:i + 32], [0.0] * 32, spec), "cpu")
        with torch.no_grad():
            y = apply(teacher, b)
        batches.append(b._replace(labels=y))
    lr, wd, gamma, n_epochs = 5e-3, 1e-5, 0.95, 12

    def train_at(dtype):
        cfg = CGRMPNNConfig(**base, dropout_ps=(0.1, 0.1),
                            compute_dtype=dtype)
        model = init_params(cfg, torch.Generator().manual_seed(13), "cpu")
        opt = torch.optim.Adam(model.parameters(), lr=lr, weight_decay=wd,
                               amsgrad=True)
        gen = torch.Generator().manual_seed(0)
        for epoch in range(n_epochs):
            set_epoch_lr(opt, lr, gamma, epoch)
            for b in batches:
                fused_train_value_and_grad(model, b, spec,
                                           kernel_seeds(cfg, gen))
                opt.step()
        with torch.no_grad():
            sse = sum(float(sse_loss(model, b, spec)) for b in batches)
        return math.sqrt(sse / len(gs))

    rmse32, rmse16 = train_at("float32"), train_at("bfloat16")
    assert rmse16 < rmse32 * 1.25 + 0.05, (rmse16, rmse32)
    assert rmse32 < rmse16 * 1.25 + 0.05, (rmse32, rmse16)
    assert rmse16 != rmse32


def test_cli_train_bf16_on_the_cpu(tmp_path, monkeypatch):
    """cli.train with --compute_dtype bfloat16 end to end on the CPU: every
    training step, validation and the gradient histograms (autograd
    through the plain forward on the CPU) go through the whole-model
    kernels' plain versions at bf16; the test after training loads the
    checkpoint in f32, as the JAX CLI does."""
    from cgr_mpnn_3d_tpu_torch.cli import train as cli_train
    from cgr_mpnn_3d_tpu_torch.data.descriptors import \
        synthetic_descriptors_npz
    demo = REPO / "examples" / "demo.csv"
    (tmp_path / "datasets").mkdir()
    for split in ("train", "val", "test"):
        (tmp_path / "datasets" / f"{split}.csv").write_text(demo.read_text())
        synthetic_descriptors_npz(demo, tmp_path / "datasets" / f"{split}.npz",
                                  8)
    monkeypatch.chdir(tmp_path)
    seen = {"fwd": set(), "train": set()}

    def spy(key, fn):
        def wrapped(*a, **kw):
            seen[key].add(kw.get("mat_dtype", "float32"))
            return fn(*a, **kw)
        return wrapped
    # the entry points as apply, the trainer and the histograms call them
    for key, name in (("fwd", "fused_model_forward_ref"),
                      ("train", "fused_model_train")):
        monkeypatch.setattr(fm, name, spy(key, getattr(fm, name)))
    from cgr_mpnn_3d_tpu_torch.models import cgr_mpnn as cm
    monkeypatch.setattr(cm, "fused_model_train", fm.fused_model_train)
    import cgr_mpnn_3d_tpu_torch.train as tr
    real_load, loaded = tr.load_model, []

    def load_model(*a, **kw):
        out = real_load(*a, **kw)
        loaded.append(out[1].compute_dtype)
        return out
    monkeypatch.setattr(tr, "load_model", load_model)
    res = cli_train.main([
        "--name", "CGR-MPNN-3D", "-d", "2", "--hidden_sizes", "16",
        "--dropout_ps", "0.1", "-ne", "2", "-bs", "4", "--val_frequency",
        "1", "--data_path", "datasets", "--save_path", "saved",
        "--device", "cpu", "--log_histograms", "--compute_dtype",
        "bfloat16"])
    assert seen == {"fwd": {"bfloat16"}, "train": {"bfloat16"}}
    assert loaded == ["float32"]
    assert len(res["train_losses"]) == len(res["val_losses"]) == 2
    assert np.isfinite(res["train_losses"] + res["val_losses"]).all()
    assert np.isfinite(res["test_losses"])
    (log,) = (tmp_path / "runs").glob("*.jsonl")
    events = [json.loads(line).get("event")
              for line in log.read_text().splitlines()]
    assert events.count("histograms/grads") == 2


def test_unsupported_compute_dtype_raises(packed):
    _, b, _ = packed
    kw = _kw(b, "ReLU", "add", "add", dtype="bfloat16")
    with pytest.raises(ValueError, match="compute_dtype"):
        CGRMPNNConfig(**{**kw, "compute_dtype": "float16"})


# -- P2 -------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tool():
    """tools/int8_microbench.py, loaded by its path, at N = 512 and one
    step, its pallas_call in interpret mode (the tool passes no flag)."""
    spec = importlib.util.spec_from_file_location(
        "int8_microbench", REPO / "tools" / "int8_microbench.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.N, tool.STEPS = 512, 1
    tool.pl = type("pl", (), {"pallas_call": functools.partial(
        pl.pallas_call, interpret=True), "BlockSpec": pl.BlockSpec})
    return tool


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_p2_plain_matches_the_jax_tool(jax_tool, dtype):
    """The tool's Pallas kernel, one step from c: c · c.  The plain version
    on the same c: int8 exactly, bf16 within 4e-3 rel-L2 (and both within
    4e-3 of float64 on the same bf16 inputs)."""
    rng = np.random.default_rng(7)
    if dtype == "int8":
        c = rng.integers(-3, 4, (512, 512)).astype(np.int8)
        loop, _ = jax_tool.pallas_mm(jnp.int8, jnp.int32)
    else:
        c = np.asarray(jnp.asarray(rng.standard_normal((512, 512)),
                                   jnp.bfloat16))
        loop, _ = jax_tool.pallas_mm(jnp.bfloat16, jnp.float32)
    want = np.asarray(loop(jnp.asarray(c)))
    t = torch.from_numpy(c) if dtype == "int8" else \
        torch.from_numpy(c.astype(np.float32)).bfloat16()
    got = mp.mm_probe_ref(t, t)
    assert torch.equal(mp.mm_probe(t, t), got)
    if dtype == "int8":
        exact = (c.astype(np.int64) @ c.astype(np.int64)).astype(np.int8)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), exact)
        return
    got = got.float().numpy()
    want = want.astype(np.float32)
    exact = c.astype(np.float64) @ c.astype(np.float64)
    assert _rel_l2(got, want) <= 4e-3
    assert _rel_l2(got, exact) <= 4e-3 and _rel_l2(want, exact) <= 4e-3


@pytest.mark.parametrize("seed", [3, 11])
def test_p2_plain_matches_the_jax_tool_full_range(jax_tool, seed):
    """int8 over [-128, 127], where the sums leave the int8 range by far
    and only their low 8 bits remain: the tool's Pallas kernel (one step
    from c: c · c, at the fixture's N = 512, the tool's row block) and
    the plain version, exactly.  The card tests hold the kernel to this
    plain version."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-128, 128, (512, 512)).astype(np.int8)
    loop, _ = jax_tool.pallas_mm(jnp.int8, jnp.int32)
    want = np.asarray(loop(jnp.asarray(c)))
    got = mp.mm_probe_ref(torch.from_numpy(c), torch.from_numpy(c))
    exact = c.astype(np.int64) @ c.astype(np.int64)
    assert np.abs(exact).max() > 127 * 512
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.int8))


def test_p2_transpose_plain_on_the_cpu():
    """The int8 transpose wrapper on CPU tensors: its plain version,
    b.t() laid out row-major."""
    b = torch.from_numpy(np.random.default_rng(5).integers(
        -128, 128, (64, 192)).astype(np.int8))
    got = mp.transpose_s8(b)
    assert got.is_contiguous() and torch.equal(got, b.t())
    assert torch.equal(mp.transpose_s8_ref(b), got)


def test_p2_parts_variants_match_the_source():
    """tools/mm_probe_parts.py builds its variants by replacing text of
    csrc/mm_probe.cu: each text it replaces is there exactly once."""
    from cgr_mpnn_3d_tpu_torch.ops import _build
    from cgr_mpnn_3d_tpu_torch.tools import mm_probe_parts
    src = (_build.CSRC / "mm_probe.cu").read_text()
    for name, (old, new) in mm_probe_parts.VARIANTS.items():
        assert src.count(old) == 1, name
        assert src.replace(old, new) != src


def test_p2_tool_runs_on_the_cpu(capsys):
    from cgr_mpnn_3d_tpu_torch.tools import int8_microbench
    out = int8_microbench.main(["--cpu", "--n", "128", "--steps", "1",
                                "--repeats", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device=cpu n=128")
    assert [ln[:len(name)] for ln, name in zip(lines[1:5],
                                               int8_microbench.LINES)] == \
        list(int8_microbench.LINES)
    assert lines[5].startswith("int8/bf16 speedup: cuBLAS")
    assert set(out["tops"]) == set(int8_microbench.LINES)
    assert all(np.isfinite(v) and v > 0 for v in out["tops"].values())
    json.dumps(out)
    with pytest.raises(TypeError, match="bfloat16 or two int8"):
        mp.mm_probe_ref(torch.zeros(4, 4), torch.zeros(4, 4))
    with pytest.raises(ValueError, match="do not multiply"):
        mp.mm_probe_ref(torch.zeros(4, 4, dtype=torch.int8),
                        torch.zeros(8, 4, dtype=torch.int8))
