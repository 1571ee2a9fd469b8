"""The trainer's device-resident modes on the CPU: ``device_epoch`` and
``steps_per_call`` (``cgr_mpnn_3d_tpu_torch/train/trainer.py``).

* a staged epoch equals the ``reuse_packs`` host loop bit for bit (losses,
  parameters, Adam, step, seed stream) over 3 epochs with dropout 0.2 and
  gamma 0.9, whole-model at f32 and bf16 and layered; so do chunks of 2
  and 3 steps (a remainder) against single steps;
* both against the JAX trainer's modes from one JAX init checkpoint at
  dropout 0: per-epoch RMSE rtol 1e-4, final parameters within 1e-3 of
  max |JAX| per leaf (as tests/test_torch_trainer.py holds the host loop);
  so are EP's (n_ep 2) staged epochs on the corpus split and on a wired
  set, over 3 epochs, which holds their later-epoch order (the loader's
  order over the staged epoch-0 grouping) to the reference's;
* EP (n_ep 2) on the cut-free corpus split and on a wired set: epoch 0 bit
  for bit with the host loop, and over 3 epochs the loss falls and stays
  within rtol 0.05 of it (JAX's ``test_ep2_device_epoch_learns``);
* a poisoned label: a staged epoch raises FloatingPointError with the
  epoch-start state back bit for bit; a poisoned chunk is rolled back bit
  for bit and training goes on;
* the refusals of the JAX trainer, with its key words, and
  ``cli.train.main`` with each mode on ``--device cpu``.
"""

import csv
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import cgr_mpnn_3d_tpu.data as jdata
import cgr_mpnn_3d_tpu.models as jm
from cgr_mpnn_3d_tpu.data.synthetic import synthetic_graphs
from cgr_mpnn_3d_tpu.train import RxnGraphTrainer as JaxTrainer
from cgr_mpnn_3d_tpu_torch.data import ChemDataset, plan_spec
from cgr_mpnn_3d_tpu_torch.data.batch import PackSpec
from cgr_mpnn_3d_tpu_torch.data.descriptors import synthetic_descriptors_npz
from cgr_mpnn_3d_tpu_torch.data.synthetic import chain_graph
from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig, jax_leaf_names
from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer, load_checkpoint
from cgr_mpnn_3d_tpu_torch.train.trainer import set_epoch_lr

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "corpus_reactions.csv"
DEMO = REPO / "examples" / "demo.csv"


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


def _leaves(tr) -> list:
    """Parameters, Adam's moments and step, and the seed stream, as a
    checkpoint holds them."""
    return load_checkpoint(tr.save(Path(tr.model_save_dir) / "x.npz"))[0]


def _same_state(a, b) -> None:
    for i, (x, y) in enumerate(zip(_leaves(a), _leaves(b))):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
    assert (a.step, a._stream) == (b.step, b._stream)


def _demo_trainer(tmp, name, dataset=None, cfg_kw=None, **kw):
    """Depth 2, hidden 12, dropout 0.2, gamma 0.9 on the demo set, 5 steps
    an epoch."""
    ds = dataset or ChemDataset(str(DEMO))
    cfg = CGRMPNNConfig(num_node_features=ds.num_node_features,
                        num_edge_features=ds.num_edge_features, depth=2,
                        hidden_sizes=(12, 12), dropout_ps=(0.2, 0.2),
                        **(cfg_kw or {}))
    spec = plan_spec([ds.graph(i) for i in range(len(ds))], te=64, tn=32,
                     tb=4)
    return RxnGraphTrainer(name=name, cfg=cfg, train_data=ds, val_data=ds,
                           spec=spec, batch_size=2, val_frequency=1, seed=4,
                           gamma=0.9, model_save_dir=str(tmp / name),
                           device="cpu", **{"num_epochs": 3, **kw})


# -- the port against its own host loop --------------------------------------

@pytest.mark.parametrize("cfg_kw", [
    {}, {"compute_dtype": "bfloat16"}, {"fuse_whole_model": False}],
    ids=["whole-model", "whole-model-bf16", "layered"])
def test_device_epoch_equals_the_host_loop(tmp_path, cfg_kw):
    host = _demo_trainer(tmp_path, "host", cfg_kw=cfg_kw, reuse_packs=True)
    dev = _demo_trainer(tmp_path, "dev", cfg_kw=cfg_kw, reuse_packs=True,
                        device_epoch=True)
    out_h, out_d = host.train(), dev.train()
    assert len(dev.train_loader) >= 4
    assert any(not np.array_equal(dev.train_loader.batch_order(e),
                                  np.arange(len(dev.train_loader)))
               for e in (1, 2))
    assert out_d["train_losses"] == out_h["train_losses"]
    assert out_d["val_losses"] == out_h["val_losses"]
    assert out_d["steps"] == out_h["steps"] == 15
    _same_state(host, dev)


@pytest.mark.parametrize("K", [2, 3])
def test_steps_per_call_equals_single_steps(tmp_path, K):
    """Chunks of K (5 steps an epoch: 3 leaves a remainder of 2 single
    steps, 2 one of 1), bit for bit, with a mid-epoch checkpoint each time
    a multiple of 2 steps is crossed."""
    one = _demo_trainer(tmp_path, "one")
    many = _demo_trainer(tmp_path, "many", steps_per_call=K,
                         ckpt_every_steps=2)
    out_1, out_k = one.train(), many.train()
    assert out_k["train_losses"] == out_1["train_losses"]
    assert out_k["val_losses"] == out_1["val_losses"]
    _same_state(one, many)


# -- the port against the JAX trainer ------------------------------------------

def _trainers(splits, tmp, resume=None, data=None, **kw):
    """(JAX trainer, port trainer) on the same splits (or on ``data``, to
    train and validate on) and hyperparameters, dropout 0."""
    if data is None:
        jt_data = [jdata.ChemDataset(str(splits / f"{s}.csv"))
                   for s in ("train", "val")]
        pt_data = [ChemDataset(str(splits / f"{s}.csv"))
                   for s in ("train", "val")]
    else:
        jt_data = pt_data = [data, data]
    F, Fe = pt_data[0].num_node_features, pt_data[0].num_edge_features
    spec = plan_spec([pt_data[0].graph(i) for i in range(len(pt_data[0]))])
    cfg = dict(num_node_features=F, num_edge_features=Fe, depth=2,
               hidden_sizes=(16, 16), dropout_ps=(0.0, 0.0),
               use_learnable_skip=True)
    hp = dict(lr=1e-3, weight_decay=1e-5, gamma=0.9, num_epochs=3,
              batch_size=12, val_frequency=1, seed=0, resume_from=resume)
    hp.update(kw)
    jt = JaxTrainer(name="j", cfg=jm.CGRMPNNConfig(**cfg),
                    train_data=jt_data[0], val_data=jt_data[1],
                    spec=jdata.PackSpec(**vars(spec)),
                    model_save_dir=str(tmp / "j"), **hp)
    pt = RxnGraphTrainer(name="t", cfg=CGRMPNNConfig(**cfg),
                         train_data=pt_data[0], val_data=pt_data[1],
                         spec=spec, model_save_dir=str(tmp / "t"),
                         device="cpu", **hp)
    return jt, pt


_EP_STAGED = dict(n_ep=2, ep_te=64, ep_tn=32, reuse_packs=True,
                  device_epoch=True)


@pytest.mark.parametrize("mode,data", [
    (dict(reuse_packs=True, device_epoch=True), "corpus"),
    (dict(steps_per_call=2), "corpus"),
    (_EP_STAGED, "corpus"),
    ({**_EP_STAGED, "batch_size": 4}, "wired")],
    ids=["device_epoch", "steps_per_call_2", "ep2_device_epoch-corpus",
         "ep2_device_epoch-wired"])
def test_modes_match_the_jax_trainer(splits, tmp_path, mode, data):
    """Per-epoch RMSE over 3 epochs against the JAX trainer in the same
    mode.  EP stages the epoch-0 grouping, runs it in that order at epoch
    0 and in the loader's order over it later, as the reference does: the
    later epochs are held as tightly as the first."""
    dataset = _GraphSet() if data == "wired" else None
    jt, _ = _trainers(splits, tmp_path, data=dataset)
    jt._epoch_done = -1
    init = jt.save(tmp_path / "init.npz")
    jt, pt = _trainers(splits, tmp_path, resume=str(init), data=dataset,
                       **mode)
    out_j, out_t = jt.train(), pt.train()
    np.testing.assert_allclose(out_t["train_losses"], out_j["train_losses"],
                               rtol=1e-4)
    np.testing.assert_allclose(out_t["val_losses"], out_j["val_losses"],
                               rtol=1e-4)
    assert out_t["steps"] == int(jt.state.step) >= 12
    if pt.n_ep > 1:
        spec, S = pt._staged[0][0], pt._staged[1]
        assert any(spec.caps) == (data == "wired")
        assert any(not np.array_equal(pt.train_loader.batch_order(e),
                                      np.arange(S)) for e in (1, 2))
    state = pt.model.state_dict()
    for name, leaf in zip(jax_leaf_names(pt.cfg),
                          jax.tree_util.tree_leaves(jt.state.params)):
        want = np.asarray(leaf)
        err = np.abs(state[name].numpy() - want).max()
        assert err <= 1e-3 * np.abs(want).max(), (name, err)


# -- edge partitioning ---------------------------------------------------------

class _GraphSet:
    """A ChemDataset stand-in over graphs in memory: two chains that the
    EP packer cuts across the shards, among small graphs."""

    def __init__(self, seed=11):
        rng = np.random.default_rng(seed)
        self.graphs = ([chain_graph(60, rng, 20), chain_graph(40, rng, 20)]
                       + synthetic_graphs(14, rng, node_feat_dim=20))
        self.labels = rng.standard_normal(len(self.graphs)).astype(np.float32)
        self.use_npz = False
        self.num_node_features, self.num_edge_features = 20, 14

    def __len__(self):
        return len(self.graphs)

    def graph(self, i):
        return self.graphs[i]


def _ep_trainers(tmp, dataset, **kw):
    cfg = CGRMPNNConfig(num_node_features=dataset.num_node_features,
                        num_edge_features=dataset.num_edge_features, depth=2,
                        hidden_sizes=(16, 16), dropout_ps=(0.2, 0.2))
    common = dict(cfg=cfg, train_data=dataset, val_data=dataset,
                  spec=PackSpec(), lr=5e-3, gamma=0.9, num_epochs=3,
                  val_frequency=1, seed=2, device="cpu", n_ep=2, ep_te=64,
                  ep_tn=32, reuse_packs=True, **kw)
    return (RxnGraphTrainer(name="h", model_save_dir=str(tmp / "h"),
                            **common),
            RxnGraphTrainer(name="d", model_save_dir=str(tmp / "d"),
                            device_epoch=True, **common))


@pytest.mark.parametrize("data", ["corpus", "wired"])
def test_ep_device_epoch_tracks_the_host_loop(splits, tmp_path, data):
    ds = (ChemDataset(str(splits / "train.csv")) if data == "corpus"
          else _GraphSet())
    bs = 12 if data == "corpus" else 4
    host, dev = _ep_trainers(tmp_path, ds, batch_size=bs)
    out_h = host.train()
    # epoch 0 runs the staged (epoch-0) order: bit for bit with a host
    # loop's epoch 0
    first, dev0 = _epoch_and_state(dev, 0)
    host0 = _epoch_and_state(_ep_trainers(tmp_path / "b", ds,
                                          batch_size=bs)[0], 0)
    assert first == host0[0] == out_h["train_losses"][0]
    for i, (x, y) in enumerate(zip(dev0, host0[1])):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
    spec, _ = dev._staged[0]
    assert any(spec.caps) == (data == "wired")
    assert dev._staged[1] >= 4
    # later epochs shuffle the staged order, the host loop reshuffles
    # the cache: the same learning, not the same bits
    losses = [first] + dev.train()["train_losses"]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, out_h["train_losses"], rtol=0.05)


def _epoch_and_state(tr, epoch: int) -> tuple:
    """(the epoch's train RMSE, the state's leaves) after one epoch of
    ``tr``, whose ``train()`` then starts at the next."""
    set_epoch_lr(tr.optimizer, tr.lr, tr.gamma, epoch)
    rmse = tr._train_epoch(epoch)
    tr.start_epoch = epoch + 1
    return rmse, _leaves(tr)


# -- the NaN guards -------------------------------------------------------------

def test_a_poisoned_staged_epoch_rolls_back_and_raises(tmp_path, capsys):
    tr = _demo_trainer(tmp_path, "p", reuse_packs=True, device_epoch=True)
    _epoch_and_state(tr, 0)
    before = _leaves(tr)
    step, stream = tr.step, list(tr._stream)
    staged, S = tr._stage_epoch()
    staged.labels[S // 2, 0] = float("inf")
    with pytest.raises(FloatingPointError, match="staged epoch 1"):
        tr._train_epoch(1)
    assert "device_epoch (epoch rolled back)" in capsys.readouterr().out
    for i, (x, y) in enumerate(zip(before, _leaves(tr))):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
    assert (tr.step, tr._stream) == (step, stream)


def test_a_poisoned_chunk_rolls_back_and_training_goes_on(tmp_path, capsys):
    ds = ChemDataset(str(DEMO))
    tr = _demo_trainer(tmp_path, "c", ds, steps_per_call=2, num_epochs=1)
    # a chunk alone: a poisoned first one leaves Adam without state; after
    # a good one, a poisoned one puts the state back bit for bit
    good = list(tr.train_loader)[:2]
    bad = [good[0], good[1]._replace(
        labels=np.full_like(good[1].labels, np.nan))]
    init = [p.detach().clone() for p in tr.model.parameters()]
    assert not np.isfinite(tr._train_chunk(tr._device_batches(bad))).all()
    assert not tr.optimizer.state and (tr.step, tr._stream[1]) == (0, 0)
    for x, y in zip(init, tr.model.parameters()):
        assert torch.equal(x, y)
    tr._train_chunk(tr._device_batches(good))
    before = _leaves(tr)
    step, stream = tr.step, list(tr._stream)
    assert not np.isfinite(tr._train_chunk(tr._device_batches(bad))).all()
    for i, (x, y) in enumerate(zip(before, _leaves(tr))):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
    assert (tr.step, tr._stream) == (step, stream)
    # in an epoch: the chunk that holds row 3 is skipped, the others train
    ds.labels[3] = np.nan
    tr2 = _demo_trainer(tmp_path, "c2", ds, steps_per_call=2, num_epochs=1)
    batches = list(tr2.train_loader)
    (j,) = [j for j, b in enumerate(batches) if 3 in b.row_ids]
    lost = 1 if j >= len(batches) // 2 * 2 else 2
    tr2.train()
    assert "non_finite_loss" in capsys.readouterr().out
    assert tr2.step == len(batches) - lost
    assert all(torch.isfinite(p).all() for p in tr2.model.parameters())


# -- refusals -------------------------------------------------------------------

@pytest.mark.parametrize("kw,words", [
    (dict(steps_per_call=2, n_ep=2), "single-device only"),
    (dict(device_epoch=True), "requires --reuse_packs"),
    (dict(device_epoch=True, reuse_packs=True, ckpt_every_steps=2),
     "ckpt_every_steps"),
    (dict(device_epoch=True, reuse_packs=True, steps_per_call=2),
     "steps_per_call")])
def test_the_modes_refuse_what_the_jax_trainer_refuses(tmp_path, kw, words):
    with pytest.raises(ValueError, match=words):
        _demo_trainer(tmp_path, "r", **kw)


def test_device_epoch_refuses_a_mid_epoch_checkpoint(tmp_path):
    tr = _demo_trainer(tmp_path, "m", ckpt_every_steps=2, num_epochs=1)
    tr.train()
    latest = tmp_path / "m" / "m.latest.npz"
    tr._epoch_done = 0
    tr.save(latest, mid_epoch=(1, 2))
    with pytest.raises(ValueError, match="MID-epoch"):
        _demo_trainer(tmp_path, "m", reuse_packs=True, device_epoch=True,
                      resume_from=str(latest))


# -- CLI ------------------------------------------------------------------------

@pytest.mark.parametrize("flags,plain", [
    (["--reuse_packs", "--device_epoch"], ["--reuse_packs"]),
    (["--steps_per_call", "2"], [])], ids=["device_epoch", "steps_per_call"])
def test_cli_modes_equal_the_host_loop(tmp_path, monkeypatch, flags, plain):
    """cli.train with each mode on the CPU: the per-epoch losses of the
    host loop with the same batches, bit for bit, and the staged MB line."""
    from cgr_mpnn_3d_tpu_torch.cli import train as cli_train
    monkeypatch.chdir(tmp_path)
    data = tmp_path / "datasets"
    data.mkdir()
    for split in ("train", "val"):
        (data / f"{split}.csv").write_text(DEMO.read_text())
        synthetic_descriptors_npz(data / f"{split}.csv",
                                  data / f"{split}.npz", 8)
    argv = ["--name", "CGR-MPNN-3D", "-d", "2", "--hidden_sizes", "16",
            "--dropout_ps", "0.1", "-ne", "3", "-bs", "2", "-g", "0.9",
            "--val_frequency", "1", "--data_path", str(data),
            "--save_path", "saved", "--device", "cpu", "--skip_test"]
    want = cli_train.main(argv + plain)
    got = cli_train.main(argv + flags)
    assert got["train_losses"] == want["train_losses"]
    assert got["val_losses"] == want["val_losses"]
    assert got["steps"] == want["steps"] == 15
    log = (tmp_path / "runs").glob("*.jsonl")
    staged = [json.loads(line) for f in log
              for line in f.read_text().splitlines()
              if "device_epoch_staged_mb" in line]
    assert len(staged) == ("--device_epoch" in flags)
