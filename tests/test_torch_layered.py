"""The layered-kernel configuration (``CGRMPNNConfig(fuse_whole_model=False)``)
of the port on the CPU, where each kernel takes its plain version:

* ``apply`` and the parameter gradients of the masked SSE against JAX
  ``apply`` with ``use_pallas=True, pallas_interpret=True,
  fuse_whole_model=False`` (K5 -> K4 -> K5 -> K7 in interpret mode), in
  eval and train mode, weights carried across by ``params_from_jax``;
* the layered and the whole-model configurations compute the same
  function, and train to the same per-epoch RMSE.

Tolerances: predictions rtol = atol = 1e-4; gradients max|delta| /
max|JAX| <= 1e-4; per-epoch RMSE of the two configurations 1e-5 relative.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgr_mpnn_3d_tpu.models as jm
from cgr_mpnn_3d_tpu.chem import RxnGraph
from cgr_mpnn_3d_tpu.data import pack_graphs, plan_spec
from cgr_mpnn_3d_tpu.models.cgr_mpnn import kernel_seeds as j_kernel_seeds
from cgr_mpnn_3d_tpu_torch.data import ChemDataset, to_device
from cgr_mpnn_3d_tpu_torch.data import plan_spec as t_plan_spec
from cgr_mpnn_3d_tpu_torch.models import (CGRMPNN, CGRMPNNConfig, apply,
                                          params_from_jax,
                                          supports_fused_train)
from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
from cgr_mpnn_3d_tpu_torch.ops import gather_linear as gl
from cgr_mpnn_3d_tpu_torch.ops import onehot_spmm as sp
from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer

SMILES = ["CCO>>CC=O", "CC(=O)N>>CC(=O)N", "C=CC=C>>C=CC=C",
          "CCO>C>CCO", "O>C>CO", "N>C>CN", "CC>>CC",
          "[N:1]([H:2])([H:3])[H:4]>>[N:1]([H:2])[H:3].[H:4]"]
LABELS = [float(i) for i in range(len(SMILES))]
SKIPS = (0.8, -0.3, 1.2)
DEMO = Path(__file__).resolve().parent.parent / "examples" / "demo.csv"


@pytest.fixture(scope="module")
def packed():
    graphs = [RxnGraph(s).arrays for s in SMILES]
    spec = plan_spec(graphs, te=64, tn=32, tb=8).with_packs(2)
    batch = pack_graphs(graphs, LABELS, spec)
    return spec, batch, to_device(batch, "cpu")


def _kw(act, aggr, pooling, learnable, drop):
    return dict(num_node_features=78, num_edge_features=14, depth=3,
                hidden_sizes=(16,) * 3, dropout_ps=(drop,) * 3,
                activation=act, aggr=aggr, pooling=pooling,
                use_learnable_skip=learnable)


def _counts():
    return [(m.launches, m.bwd_launches) for m in (gl, cs, sp)]


CASES = [("ReLU", "add", "add", False, 0.0, False),
         ("GELU", "mean", "mean", True, 0.0, False),
         ("SiLU", "add", "mean", True, 0.3, True)]


@pytest.mark.parametrize("act,aggr,pooling,learnable,drop,train", CASES)
def test_layered_apply_and_grads_match_jax(packed, act, aggr, pooling,
                                           learnable, drop, train):
    spec, b, tb = packed
    kw = _kw(act, aggr, pooling, learnable, drop)
    params = jm.init_params(jax.random.PRNGKey(0), jm.CGRMPNNConfig(**kw))
    if learnable:
        params["skip_weights"] = [jnp.asarray(v) for v in SKIPS]
    cfg_j = jm.CGRMPNNConfig(**kw, use_pallas=True, pallas_interpret=True,
                             fuse_whole_model=False)
    rng = jax.random.PRNGKey(7) if train else None
    y, m = jnp.asarray(b.labels), jnp.asarray(b.graph_mask)

    def loss(p):
        pred = jm.apply(p, b, cfg_j, spec, train=train, rng=rng)
        return jnp.sum(m * (pred - y) ** 2), pred

    (_, want), g_j = jax.value_and_grad(loss, has_aux=True)(params)

    cfg = CGRMPNNConfig(**kw, fuse_whole_model=False)
    assert not supports_fused_train(cfg)
    model = CGRMPNN(cfg)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    seeds = (np.asarray(j_kernel_seeds(cfg_j, rng)).tolist() if train
             else None)
    before = _counts()
    pred = apply(model, tb, spec, train=train, seeds=seeds)
    ((pred - tb.labels) ** 2 * tb.graph_mask).sum().backward()
    assert _counts() == before            # the CPU launches no kernel
    mask = b.graph_mask > 0
    np.testing.assert_allclose(pred.detach().numpy()[mask],
                               np.asarray(want)[mask], rtol=1e-4, atol=1e-4)
    want_g = params_from_jax(jax.tree_util.tree_map(np.asarray, g_j))
    for name, prm in model.named_parameters():
        w = want_g[name].numpy().reshape(tuple(prm.shape))
        err = np.abs(prm.grad.numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (name, err)


def test_layered_equals_whole_model(packed):
    """The two configurations share the hash dropout, so in train mode too
    they compute the same predictions and gradients (on the CPU the
    whole-model configuration takes the plain gather ops)."""
    spec, b, tb = packed
    kw = _kw("GELU", "mean", "add", True, 0.2)
    out = []
    for fuse in (True, False):
        model = CGRMPNN(CGRMPNNConfig(**kw, fuse_whole_model=fuse),
                        torch.Generator().manual_seed(5))
        pred = apply(model, tb, spec, train=True, seeds=[3, 4, 5])
        ((pred - tb.labels) ** 2 * tb.graph_mask).sum().backward()
        out.append((pred.detach(), {n: p.grad for n, p in
                                    model.named_parameters()}))
    mask = tb.graph_mask > 0
    torch.testing.assert_close(out[1][0][mask], out[0][0][mask], rtol=1e-5,
                               atol=1e-5)
    for name, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][name], g, rtol=1e-4, atol=1e-5,
                                   msg=name)
    with pytest.raises(ValueError, match="seeds"):
        apply(CGRMPNN(CGRMPNNConfig(**kw, fuse_whole_model=False)), tb, spec,
              train=True)


def test_trainer_layered_matches_whole_model(tmp_path):
    """Two epochs of the trainer with each configuration, on the same data
    and seeds: the same per-epoch RMSE."""
    ds = ChemDataset(str(DEMO))
    spec = t_plan_spec([ds.graph(i) for i in range(len(ds))], te=64, tn=32,
                       tb=4)
    cfg = CGRMPNNConfig(num_node_features=ds.num_node_features,
                        num_edge_features=ds.num_edge_features, depth=2,
                        hidden_sizes=(12, 12), dropout_ps=(0.2, 0.2),
                        aggr="mean", use_learnable_skip=True)
    res = {}
    for fuse in (True, False):
        tr = RxnGraphTrainer(
            name=f"f{int(fuse)}", cfg=dataclasses.replace(
                cfg, fuse_whole_model=fuse),
            train_data=ds, val_data=ds, spec=spec, lr=1e-3, num_epochs=2,
            batch_size=4, val_frequency=1, seed=4,
            model_save_dir=str(tmp_path / str(fuse)), device="cpu")
        res[fuse] = tr.train()
    assert res[False]["steps"] == res[True]["steps"] > 0
    for key in ("train_losses", "val_losses"):
        np.testing.assert_allclose(res[False][key], res[True][key],
                                   rtol=1e-5)
