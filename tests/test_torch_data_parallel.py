"""Data parallelism of the port (``--dp N``: every group in one process,
``parallel/data_parallel.py`` and the trainer's ``n_dp``) on the CPU:

* one data-parallel step at n_dp 2 and 4, whole-model (K2's plain version
  per group) and layered (autograd through K5, K4, K7's plain versions),
  against JAX ``make_dp_train_step`` on the same groups (the whole-model
  case through JAX's one-kernel step in interpret mode): the loss and the
  parameters after one Adam step at rtol 1e-4; the eval step against
  ``make_dp_eval_step``;
* the all-masked filler batch gives exactly 0 loss and 0 gradients (add
  and mean pooling, both configurations), and a group of it changes
  nothing, bit for bit;
* a dp step equals a single-device step on a batch of all the groups'
  graphs;
* ``RxnGraphTrainer(n_dp=2)`` against the JAX trainer over 3 epochs
  (dropout 0, from one JAX init checkpoint): the host loop,
  ``reuse_packs`` + ``device_epoch`` and ``n_dp=2, n_ep=2``, per-epoch RMSE
  at rtol 1e-4; ``device_epoch`` bit for bit with the host loop at epoch 0;
* a dp mid-epoch resume, bit for bit; ``cli.train.main --dp 2`` on the CPU.
"""

import csv
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cgr_mpnn_3d_tpu.data as jdata
import cgr_mpnn_3d_tpu.models as jm
from cgr_mpnn_3d_tpu.parallel import make_dp_eval_step as j_dp_eval
from cgr_mpnn_3d_tpu.parallel import make_dp_train_step as j_dp_train
from cgr_mpnn_3d_tpu.parallel import make_mesh
from cgr_mpnn_3d_tpu.parallel import stack_batches as j_stack
from cgr_mpnn_3d_tpu.train import RxnGraphTrainer as JaxTrainer
from cgr_mpnn_3d_tpu.train import TrainState, make_optimizer
from cgr_mpnn_3d_tpu_torch.data import (ChemDataset, empty_batch,
                                        pack_graphs, packs_needed, plan_spec,
                                        to_device)
from cgr_mpnn_3d_tpu_torch.data.descriptors import synthetic_descriptors_npz
from cgr_mpnn_3d_tpu_torch.models import (CGRMPNN, CGRMPNNConfig,
                                          jax_leaf_names, params_from_jax)
from cgr_mpnn_3d_tpu_torch.models.cgr_mpnn import (fused_train_sse_and_grads,
                                                   sse_loss)
from cgr_mpnn_3d_tpu_torch.parallel import (make_dp_eval_step,
                                            make_dp_train_step,
                                            stack_batches)
from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer, load_checkpoint

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "corpus_reactions.csv"
DEMO = REPO / "examples" / "demo.csv"
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def corpus():
    """The first 16 corpus reactions, featurized."""
    ds = ChemDataset(str(CORPUS))
    return [ds.graph(i) for i in range(16)], [float(v) for v in
                                              ds.labels[:16]], ds


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """48 corpus rows to train on and the next 16 to validate on."""
    d = tmp_path_factory.mktemp("splits")
    with open(CORPUS, newline="") as f:
        header, *rows = list(csv.reader(f))
    for name, part in (("train", rows[:48]), ("val", rows[48:64])):
        with open(d / f"{name}.csv", "w", newline="") as f:
            csv.writer(f).writerows([header, *part])
    return d


def _cfg(ds, **kw):
    return {**dict(num_node_features=ds.num_node_features,
                   num_edge_features=ds.num_edge_features, depth=2,
                   hidden_sizes=(16, 16), dropout_ps=(0.0, 0.0),
                   use_learnable_skip=True), **kw}


def _groups(graphs, labels, n_dp):
    """(spec, the n_dp groups' packed batches): consecutive slices of
    the graphs, each packed at one spec."""
    k = len(graphs) // n_dp
    spec = plan_spec(graphs, te=64, tn=32, tb=4)
    spec = spec.with_packs(max(packs_needed(graphs[g * k:(g + 1) * k], spec)
                               for g in range(n_dp)) + 1)
    return spec, [pack_graphs(graphs[g * k:(g + 1) * k],
                              labels[g * k:(g + 1) * k], spec)
                  for g in range(n_dp)]


def _port_model(cfg, params):
    model = CGRMPNN(cfg)
    model.load_state_dict(params_from_jax(params))
    return model


def _adam(model):
    return torch.optim.Adam(model.parameters(), lr=1e-3, weight_decay=1e-5,
                            amsgrad=True)


@pytest.mark.parametrize("n_dp", [2, 4])
@pytest.mark.parametrize("fuse", [True, False], ids=["whole-model",
                                                     "layered"])
def test_dp_step_matches_jax(corpus, n_dp, fuse):
    graphs, labels, ds = corpus
    spec, batches = _groups(graphs, labels, n_dp)
    jcfg = jm.CGRMPNNConfig(**_cfg(ds))
    params = jm.init_params(jax.random.PRNGKey(3), jcfg)
    params["skip_weights"] = [jnp.asarray(0.7), jnp.asarray(1.3)]
    mesh = make_mesh(n_dp=n_dp, n_ep=1, devices=jax.devices()[:n_dp])
    run_cfg = (dataclasses.replace(jcfg, use_pallas=True,
                                   pallas_interpret=True) if fuse else jcfg)
    jspec = jdata.PackSpec(**vars(spec))
    opt = make_optimizer(1e-3, 1e-5, 1.0, 1)
    jbatches = j_stack([jdata.PackedGraphBatch(*b) for b in batches])
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32),
                       jax.random.PRNGKey(1))
    new_state, jloss, _ = j_dp_train(opt, run_cfg, mesh, spec=jspec)(
        state, jbatches)

    model = _port_model(CGRMPNNConfig(**_cfg(ds, fuse_whole_model=fuse)),
                        params)
    adam = _adam(model)
    groups = to_device(stack_batches(batches), "cpu")
    loss = make_dp_train_step(model, spec)(groups, None)
    adam.step()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    state_t = model.state_dict()
    for name, leaf in zip(jax_leaf_names(model.cfg),
                          jax.tree_util.tree_leaves(new_state.params)):
        np.testing.assert_allclose(state_t[name].numpy(), np.asarray(leaf),
                                   err_msg=name, **TOL)

    sse = make_dp_eval_step(model, spec)(groups)
    want = j_dp_eval(jcfg, mesh, spec=jspec)(new_state.params, jbatches)
    np.testing.assert_allclose(float(sse), float(want), rtol=1e-4)


@pytest.mark.parametrize("pooling", ["add", "mean"])
@pytest.mark.parametrize("fuse", [True, False], ids=["whole-model",
                                                     "layered"])
def test_the_filler_is_exact_zero(corpus, pooling, fuse):
    """An all-masked batch: SSE 0 and every gradient 0, exactly, in the
    training step (K2's plain version, or autograd through the layered
    kernels' plain versions) and in eval (K3f's plain version); a dp step
    whose second group is the filler equals the first group's step bit for
    bit."""
    graphs, labels, ds = corpus
    spec, (b0,) = _groups(graphs[:8], labels[:8], 1)
    cfg = CGRMPNNConfig(**_cfg(ds, pooling=pooling, aggr=pooling,
                               fuse_whole_model=fuse,
                               dropout_ps=(0.2, 0.2)))
    model = CGRMPNN(cfg, torch.Generator().manual_seed(2))
    filler = to_device(empty_batch(spec, ds.num_node_features,
                                   ds.num_edge_features), "cpu")
    seeds = torch.tensor([[5, 9], [7, 3]], dtype=torch.int32)
    sse, grads = fused_train_sse_and_grads(model, filler, spec, seeds[1])
    assert float(sse) == 0.0
    assert all(float(g.abs().max()) == 0.0 for g in grads)
    model.zero_grad(set_to_none=True)
    sse = sse_loss(model, filler, spec, train=True, seeds=seeds[1])
    sse.backward()
    assert float(sse.detach()) == 0.0
    assert all(float(p.grad.abs().max()) == 0.0 for p in model.parameters())
    with torch.no_grad():
        assert float(sse_loss(model, filler, spec)) == 0.0

    step = make_dp_train_step(model, spec)
    one = step(to_device(stack_batches([b0]), "cpu"), seeds[:1])
    g_one = [p.grad.clone() for p in model.parameters()]
    two = step(to_device(stack_batches([b0, empty_batch(
        spec, ds.num_node_features, ds.num_edge_features)]), "cpu"), seeds)
    assert float(one) == float(two) > 0
    for a, p in zip(g_one, model.parameters()):
        assert torch.equal(a, p.grad)


@pytest.mark.parametrize("fuse", [True, False], ids=["whole-model",
                                                     "layered"])
def test_a_dp_step_equals_one_step_on_the_concatenated_graphs(corpus, fuse):
    """Two groups of 8 graphs against one batch of the 16: the loss, the
    gradients and the parameters after Adam (the groups' gradients are
    summed, not averaged)."""
    graphs, labels, ds = corpus
    cfg = CGRMPNNConfig(**_cfg(ds, fuse_whole_model=fuse))
    models = [CGRMPNN(cfg, torch.Generator().manual_seed(4))
              for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    spec, batches = _groups(graphs, labels, 2)
    loss_dp = make_dp_train_step(models[0], spec)(
        to_device(stack_batches(batches), "cpu"), None)
    spec1, (whole,) = _groups(graphs, labels, 1)
    loss_1 = make_dp_train_step(models[1], spec1)(
        to_device(stack_batches([whole]), "cpu"), None)
    np.testing.assert_allclose(float(loss_dp), float(loss_1), rtol=1e-5)
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-4, atol=1e-5)
    for m in models:
        _adam(m).step()
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   **TOL)


# -- the trainer --------------------------------------------------------------

def _trainers(splits, tmp, resume=None, **kw):
    """(JAX trainer, port trainer) on the same splits and hyperparameters,
    dropout 0."""
    jt_data = [jdata.ChemDataset(str(splits / f"{s}.csv"))
               for s in ("train", "val")]
    pt_data = [ChemDataset(str(splits / f"{s}.csv"))
               for s in ("train", "val")]
    spec = plan_spec([pt_data[0].graph(i) for i in range(len(pt_data[0]))])
    hp = dict(lr=1e-3, weight_decay=1e-5, gamma=0.9, num_epochs=3,
              batch_size=12, val_frequency=1, seed=0, resume_from=resume,
              n_dp=2)
    hp.update(kw)
    jt = JaxTrainer(name="j", cfg=jm.CGRMPNNConfig(**_cfg(pt_data[0])),
                    train_data=jt_data[0], val_data=jt_data[1],
                    spec=jdata.PackSpec(**vars(spec)),
                    model_save_dir=str(tmp / "j"), **hp)
    pt = RxnGraphTrainer(name="t", cfg=CGRMPNNConfig(**_cfg(pt_data[0])),
                         train_data=pt_data[0], val_data=pt_data[1],
                         spec=spec, model_save_dir=str(tmp / "t"),
                         device="cpu", **hp)
    return jt, pt


@pytest.mark.parametrize("mode", [
    {}, dict(reuse_packs=True, device_epoch=True),
    dict(n_ep=2, ep_te=64, ep_tn=32)],
    ids=["host_loop", "device_epoch", "dp2_ep2"])
def test_dp_trainer_matches_the_jax_trainer(splits, tmp_path, mode):
    """n_dp=2 over 3 epochs, both trainers from one JAX init checkpoint:
    per-epoch train and val RMSE at rtol 1e-4 and the final parameters
    within 1e-3 of max |JAX| (the groups' seeds differ between the
    packages' dropout, so dropout is 0)."""
    jt, _ = _trainers(splits, tmp_path, **mode)
    jt._epoch_done = -1
    init = jt.save(tmp_path / "init.npz")
    jt, pt = _trainers(splits, tmp_path, resume=str(init), **mode)
    out_j, out_t = jt.train(), pt.train()
    np.testing.assert_allclose(out_t["train_losses"], out_j["train_losses"],
                               rtol=1e-4)
    np.testing.assert_allclose(out_t["val_losses"], out_j["val_losses"],
                               rtol=1e-4)
    # 48 graphs in batches of 6, two a step: 4 steps an epoch
    assert out_t["steps"] == int(jt.state.step) == 12
    if "device_epoch" in mode:
        assert pt._staged[1] == 4
    state = pt.model.state_dict()
    for name, leaf in zip(jax_leaf_names(pt.cfg),
                          jax.tree_util.tree_leaves(jt.state.params)):
        want = np.asarray(leaf)
        err = np.abs(state[name].numpy() - want).max()
        assert err <= 1e-3 * np.abs(want).max(), (name, err)


def _demo_trainer(tmp, name, **kw):
    """Depth 2, hidden 12, dropout 0.2, gamma 0.9 on the demo set: batches
    of 2, 3 groups of 2 a step (the last one padded with the filler)."""
    ds = ChemDataset(str(DEMO))
    cfg = CGRMPNNConfig(num_node_features=ds.num_node_features,
                        num_edge_features=ds.num_edge_features, depth=2,
                        hidden_sizes=(12, 12), dropout_ps=(0.2, 0.2))
    spec = plan_spec([ds.graph(i) for i in range(len(ds))], te=64, tn=32,
                     tb=4)
    return RxnGraphTrainer(name=name, cfg=cfg, train_data=ds, val_data=ds,
                           spec=spec, batch_size=4, val_frequency=1, seed=4,
                           gamma=0.9, model_save_dir=str(tmp / name),
                           device="cpu", n_dp=2, **{"num_epochs": 3, **kw})


def _leaves(tr) -> list:
    return load_checkpoint(tr.save(Path(tr.model_save_dir) / "x.npz"))[0]


def test_dp_device_epoch_equals_the_host_loop_at_epoch_0(tmp_path):
    """The staged epoch-0 groups run in the host loop's order at epoch 0,
    bit for bit (dropout 0.2); later epochs shuffle whole steps from seed
    + epoch, as JAX's scan does."""
    host = _demo_trainer(tmp_path, "h", reuse_packs=True, num_epochs=1)
    dev = _demo_trainer(tmp_path, "d", reuse_packs=True, device_epoch=True,
                        num_epochs=1)
    assert host.train()["train_losses"] == dev.train()["train_losses"]
    for i, (x, y) in enumerate(zip(_leaves(host), _leaves(dev))):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
    staged, S = dev._stage_epoch()
    assert S == 3 and tuple(staged.labels.shape[:2]) == (3, 2)
    assert float(staged.graph_mask[2, 1].sum()) == 0.0


def test_dp_mid_epoch_resume_is_bit_identical(tmp_path):
    straight = _demo_trainer(tmp_path / "a", "a", log_histograms=False)
    straight.train()
    interrupted = _demo_trainer(tmp_path / "b", "b", ckpt_every_steps=2)
    calls = {"n": 0}
    step = interrupted._train_step

    def preempt(batch):
        calls["n"] += 1
        if calls["n"] == 6:          # epoch 1, step 3 of 3
            raise KeyboardInterrupt
        return step(batch)
    interrupted._train_step = preempt
    with pytest.raises(KeyboardInterrupt):
        interrupted.train()
    latest = tmp_path / "b" / "b" / "b.latest.npz"
    meta = json.loads(latest.with_suffix(".json").read_text())
    assert meta["mid_epoch"] == {"epoch": 1, "steps_done": 2}
    resumed = _demo_trainer(tmp_path / "b", "b", resume_from=str(latest))
    resumed.train()
    for i, (x, y) in enumerate(zip(_leaves(straight), _leaves(resumed))):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
    assert resumed.step == straight.step == 9


def test_cli_train_with_dp_on_the_cpu(tmp_path, monkeypatch):
    """cli.train --dp 2 trains and tests on the CPU, with the gradient
    histograms of group 0's first batch; --reuse_packs --device_epoch
    equals --reuse_packs at epoch 0; --steps_per_call is refused with the
    JAX trainer's words."""
    from cgr_mpnn_3d_tpu_torch.cli import train as cli_train
    monkeypatch.chdir(tmp_path)
    data = tmp_path / "datasets"
    data.mkdir()
    for split in ("train", "val", "test"):
        (data / f"{split}.csv").write_text(DEMO.read_text())
        synthetic_descriptors_npz(data / f"{split}.csv",
                                  data / f"{split}.npz", 8)
    argv = ["--name", "CGR-MPNN-3D", "-d", "2", "--hidden_sizes", "16",
            "--dropout_ps", "0.1", "-bs", "4", "--val_frequency", "1",
            "--data_path", str(data), "--save_path", "saved", "--device",
            "cpu", "--dp", "2"]
    res = cli_train.main(argv + ["-ne", "2", "--log_histograms"])
    assert res["steps"] == 6 and np.isfinite(res["test_losses"])
    hist = [json.loads(line)["event"]
            for f in (tmp_path / "runs").glob("*.jsonl")
            for line in f.read_text().splitlines() if "histograms" in line]
    assert hist == ["histograms/params", "histograms/grads"] * 2
    one = cli_train.main(argv + ["-ne", "1", "--skip_test",
                                 "--reuse_packs"])
    dev = cli_train.main(argv + ["-ne", "1", "--skip_test",
                                 "--reuse_packs", "--device_epoch"])
    assert one["train_losses"] == dev["train_losses"]
    with pytest.raises(ValueError, match="single-device only"):
        cli_train.main(argv + ["-ne", "1", "--steps_per_call", "2"])
