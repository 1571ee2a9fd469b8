"""Serving end to end on the CPU: a checkpoint written by the JAX package
serves in the port with the same predictions, and one written by the port
loads in the JAX package."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgr_mpnn_3d_tpu.models as jm
from cgr_mpnn_3d_tpu.cli.predict import \
    activation_energy_prediction as j_predict
from cgr_mpnn_3d_tpu.data.descriptors import synthetic_descriptors_npz
from cgr_mpnn_3d_tpu.train import load_model as j_load_model
from cgr_mpnn_3d_tpu.train import save_checkpoint as j_save
from cgr_mpnn_3d_tpu_torch.cli.predict import \
    activation_energy_prediction as t_predict
from cgr_mpnn_3d_tpu_torch.cli.predict import main as t_main
from cgr_mpnn_3d_tpu_torch.data import ChemDataset, plan_spec
from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig, init_params
from cgr_mpnn_3d_tpu_torch.train import (evaluate, load_model, predict,
                                         save_checkpoint)

REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "examples" / "demo.csv"


def _meta(F, depth, hidden, act="ReLU", aggr="add", pooling="add",
          skip=False):
    return {"name": "CGR-MPNN-3D", "model": {
        "num_node_features": F, "num_edge_features": 14, "depth": depth,
        "hidden_sizes": [hidden] * depth, "dropout_ps": [0.0] * depth,
        "activation": act, "aggr": aggr, "pooling": pooling,
        "use_learnable_skip": skip}}


@pytest.fixture(scope="module")
def demo_npz(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    synthetic_descriptors_npz(DEMO, d / "demo.npz", dim_per_structure=4)
    return d / "demo.npz"


@pytest.mark.parametrize("act,aggr,pooling,skip", [
    ("ReLU", "add", "add", False), ("GELU", "mean", "mean", True)])
def test_jax_checkpoint_serves_identically(tmp_path, demo_npz, act, aggr,
                                           pooling, skip):
    """The JAX package saves a training-state checkpoint (params followed
    by optimizer-like leaves and a step); both packages' predict entry
    points serve it on the CPU and agree at rtol 1e-4."""
    meta = _meta(78 + 12, 2, 16, act, aggr, pooling, skip)
    jcfg = jm.CGRMPNNConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in meta["model"].items()})
    params = jm.init_params(jax.random.PRNGKey(4), jcfg)
    if skip:
        params["skip_weights"] = [jnp.asarray(0.7), jnp.asarray(-0.2)]
    state = (params, {"mu": jax.tree_util.tree_map(jnp.zeros_like, params)},
             jnp.asarray(3))
    ckpt = j_save(tmp_path / "CGR-MPNN-3D.npz", state, meta)

    kw = dict(input_smiles=str(DEMO), npz_path=str(demo_npz),
              model_path=str(ckpt), output_results=str(tmp_path / "r.txt"))
    want = j_predict(**kw)
    got = t_predict(**kw, device="cpu", store_results=True,
                    output_format="json")
    assert [r["Reaction_ID"] for r in got] == list(range(1, 11))
    np.testing.assert_allclose([r["Activation Energy"] for r in got],
                               [r["Activation Energy"] for r in want],
                               rtol=1e-4, atol=1e-5)
    assert json.load(open(tmp_path / "r.json")) == got


def test_port_checkpoint_loads_in_jax(tmp_path, demo_npz):
    meta = _meta(78 + 12, 3, 8, "SiLU", skip=True)
    cfg = CGRMPNNConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in meta["model"].items()})
    model = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    with torch.no_grad():
        for l, w in enumerate(model.skip_weights):
            w.fill_(0.5 + l)
    ckpt = save_checkpoint(tmp_path / "m.npz", model, meta)
    params, jcfg, _ = j_load_model(ckpt)
    assert jcfg.use_learnable_skip and jcfg.activation == "SiLU"
    state = model.state_dict()
    np.testing.assert_array_equal(params["edge_init"]["w"],
                                  state["edge_init.w"].numpy())
    np.testing.assert_array_equal(params["convs"][2]["b"],
                                  state["convs.2.b"].numpy())
    assert float(params["skip_weights"][1]) == 1.5
    # and back: the port reloads its own file
    back, cfg2, meta2 = load_model(ckpt, device="cpu")
    assert cfg2 == cfg and meta2["num_leaves"] == len(state)
    for name, v in back.state_dict().items():
        assert torch.equal(v, state[name]), name


def test_predict_restores_row_order(tmp_path, demo_npz):
    """Batches smaller than the demo set force several windows and
    first-fit backfill; predictions still come back in row order, equal
    to one-row-at-a-time serving."""
    meta = _meta(78 + 12, 2, 16)
    cfg = CGRMPNNConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in meta["model"].items()})
    model = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    ds = ChemDataset(str(DEMO), data_npz_path=str(demo_npz))
    spec = plan_spec([ds.graph(i) for i in range(len(ds))], te=64, tn=32,
                     tb=4)
    full = predict(model, ds, spec, batch_size=64, device="cpu")
    small = predict(model, ds, spec, batch_size=3, device="cpu")
    np.testing.assert_allclose(small, full, rtol=1e-5, atol=1e-6)
    res = evaluate(model, ds, spec, batch_size=4, device="cpu")
    np.testing.assert_allclose(res["predictions"], full, rtol=1e-5,
                               atol=1e-6)
    assert res["test_losses"] == pytest.approx(
        float(np.sqrt(np.mean((full - ds.labels) ** 2))), rel=1e-5)


def test_cli_main_prints_table(tmp_path, demo_npz, capsys):
    meta = _meta(78 + 12, 2, 16)
    cfg = CGRMPNNConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in meta["model"].items()})
    ckpt = save_checkpoint(tmp_path / "m.npz", init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), meta)
    t_main(["--data_path_smiles", str(DEMO), "--data_path_model", str(ckpt),
            "--data_path_npz", str(demo_npz), "--device", "cpu",
            "--batch_size", "4", "--print_results", "--store_results",
            "--data_path_results", str(tmp_path / "out.txt")])
    text = (tmp_path / "out.txt").read_text()
    assert "| Reaction ID |" in text and "Activation Energy" in text
    assert "Predicted Activation Energies" in capsys.readouterr().out
