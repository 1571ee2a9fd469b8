"""The port's training path on the CPU against the JAX package.

* the shuffled loader emits the JAX loader's windows, epoch by epoch;
* a 3-epoch trajectory (dropout 0, f32) started from one JAX checkpoint
  saved before step 0 and resumed by both trainers: per-epoch train/val
  RMSE rtol 1e-4, final params max|delta| / max|JAX| <= 1e-3 per leaf;
* checkpoints cross-load both ways with equal params and Adam moments;
* a mid-epoch resume continues bit-identically; the NaN guard rolls back;
* ``cli.train.main`` and ``cli.test.main`` run end to end with
  ``--device cpu``.
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
from cgr_mpnn_3d_tpu.train import RxnGraphTrainer as JaxTrainer
from cgr_mpnn_3d_tpu.train.checkpoint import restore_into as j_restore_into
from cgr_mpnn_3d_tpu_torch.data import ChemDataset, PackedLoader, plan_spec
from cgr_mpnn_3d_tpu_torch.data.descriptors import synthetic_descriptors_npz
from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig, jax_leaf_names
from cgr_mpnn_3d_tpu_torch.train import (MetricsLogger, RxnGraphTrainer,
                                         StepTimer, load_checkpoint)

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


def _cfg_kw(F, Fe, **kw):
    base = dict(num_node_features=F, num_edge_features=Fe, depth=2,
                hidden_sizes=(16, 16), dropout_ps=(0.0, 0.0),
                use_learnable_skip=True)
    return {**base, **kw}


def _trainers(splits, tmp, resume=None, **kw):
    """(JAX trainer, port trainer) on the same splits and hyperparameters."""
    jt_data = [jdata.ChemDataset(str(splits / f"{s}.csv"))
               for s in ("train", "val")]
    pt_data = [ChemDataset(str(splits / f"{s}.csv")) for s in ("train", "val")]
    F, Fe = pt_data[0].num_node_features, pt_data[0].num_edge_features
    spec = plan_spec([pt_data[0].graph(i) for i in range(len(pt_data[0]))])
    hp = dict(lr=1e-3, weight_decay=1e-5, gamma=0.9, num_epochs=3,
              batch_size=16, val_frequency=1, seed=0, resume_from=resume)
    hp.update(kw)
    jt = JaxTrainer(name="j", cfg=jm.CGRMPNNConfig(**_cfg_kw(F, Fe)),
                    train_data=jt_data[0], val_data=jt_data[1],
                    spec=jdata.PackSpec(**vars(spec)),
                    model_save_dir=str(tmp / "j"), **hp)
    pt = RxnGraphTrainer(name="t", cfg=CGRMPNNConfig(**_cfg_kw(F, Fe)),
                         train_data=pt_data[0], val_data=pt_data[1],
                         spec=spec, model_save_dir=str(tmp / "t"),
                         device="cpu", **hp)
    return jt, pt


def _jax_init_checkpoint(splits, tmp) -> Path:
    jt, _ = _trainers(splits, tmp)
    jt._epoch_done = -1
    return jt.save(tmp / "init.npz")


def _port_leaves(pt):
    return load_checkpoint(pt.save(Path(pt.model_save_dir) / "x.npz"))[0]


# -- loader ------------------------------------------------------------------

@pytest.mark.parametrize("batch_size,drop_last", [(12, False), (20, True)])
def test_shuffled_loader_windows_equal_the_jax_loaders(splits, batch_size,
                                                       drop_last):
    jds = jdata.ChemDataset(str(splits / "train.csv"))
    pds = ChemDataset(str(splits / "train.csv"))
    spec = plan_spec([pds.graph(i) for i in range(len(pds))], te=64, tn=32,
                     tb=8)
    kw = dict(batch_size=batch_size, shuffle=True, seed=3,
              drop_last=drop_last)
    jl = jdata.PackedLoader(jds, jdata.PackSpec(**vars(spec)), **kw)
    pl = PackedLoader(pds, spec, **kw)
    assert pl.spec == spec.with_packs(jl.spec.p) and len(pl) == len(jl)
    orders = []
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl.prefetch())
        assert len(jb) == len(pb) > 1
        for a, b in zip(jb, pb):
            for name, x, y in zip(a._fields, a, b):
                np.testing.assert_array_equal(np.asarray(x), y, err_msg=name)
        orders.append(np.concatenate([b.row_ids for b in pb]))
        assert len(list(pl)) == len(pb)
    assert not np.array_equal(orders[0], orders[1])


# -- trajectory ---------------------------------------------------------------

def test_trajectory_matches_the_jax_trainer(splits, tmp_path):
    init = _jax_init_checkpoint(splits, tmp_path)
    jt, pt = _trainers(splits, tmp_path, resume=str(init))
    out_j, out_t = jt.train(), pt.train()
    np.testing.assert_allclose(out_t["train_losses"], out_j["train_losses"],
                               rtol=1e-4)
    np.testing.assert_allclose(out_t["val_losses"], out_j["val_losses"],
                               rtol=1e-4)
    assert out_t["steps"] == int(jt.state.step) >= 9
    flat = jax.tree_util.tree_leaves(jt.state.params)
    state = pt.model.state_dict()
    for name, leaf in zip(jax_leaf_names(pt.cfg), flat):
        want = np.asarray(leaf)
        err = np.abs(state[name].numpy() - want).max()
        assert err <= 1e-3 * np.abs(want).max(), (name, err)


def test_reused_packs_and_loader_workers_match_the_jax_trainer(splits,
                                                                tmp_path):
    """reuse_packs with two loader workers: the same per-epoch RMSE as
    the JAX trainer with the same flags (rtol 1e-4, as the straight run),
    and the same steps."""
    init = _jax_init_checkpoint(splits, tmp_path)
    jt, pt = _trainers(splits, tmp_path, resume=str(init), reuse_packs=True,
                       loader_workers=2)
    assert pt.train_loader.reuse_packs and pt.val_loader.workers == 2
    out_j, out_t = jt.train(), pt.train()
    np.testing.assert_allclose(out_t["train_losses"], out_j["train_losses"],
                               rtol=1e-4)
    np.testing.assert_allclose(out_t["val_losses"], out_j["val_losses"],
                               rtol=1e-4)
    assert out_t["steps"] == int(jt.state.step) >= 9


# -- checkpoints --------------------------------------------------------------

def test_checkpoints_cross_load_both_ways(splits, tmp_path):
    jt, pt = _trainers(splits, tmp_path, num_epochs=1)
    jt.train()
    pt.train()
    P = len(jax_leaf_names(pt.cfg))
    j_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jt.state)]
    t_leaves = _port_leaves(pt)
    assert len(j_leaves) == len(t_leaves) == 4 * P + 5
    for a, b in zip(j_leaves, t_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
    # the JAX trainer takes the port's checkpoint ...
    restored = j_restore_into(jt.state, t_leaves)
    for a, b in zip(jax.tree_util.tree_leaves(restored), t_leaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    # ... and the port resumes the JAX one: params, moments, step
    jpath = Path(jt.model_save_dir) / "j.latest.npz"
    _, pt2 = _trainers(splits, tmp_path / "b", resume=str(jpath),
                       num_epochs=1)
    back = _port_leaves(pt2)
    j_saved = load_checkpoint(jpath)[0]
    for i, (a, b) in enumerate(zip(back[:-1], j_saved[:-1])):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    assert pt2.start_epoch == 1 and pt2.step == int(jt.state.step)
    # a JAX PRNG key is not the port's seed stream: a fresh one starts
    np.testing.assert_array_equal(back[-1], [0, 0])
    assert json.loads(Path(jpath).with_suffix(".json").read_text()).get(
        "seed_stream") is None


def _small_trainer(tmp, name, dataset, **kw):
    cfg = CGRMPNNConfig(num_node_features=dataset.num_node_features,
                        num_edge_features=dataset.num_edge_features, depth=2,
                        hidden_sizes=(12, 12), dropout_ps=(0.2, 0.2))
    spec = plan_spec([dataset.graph(i) for i in range(len(dataset))],
                     te=64, tn=32, tb=4)
    return RxnGraphTrainer(name=name, cfg=cfg, train_data=dataset,
                           val_data=dataset, spec=spec, batch_size=2,
                           val_frequency=1, seed=4, model_save_dir=str(tmp),
                           device="cpu", **{"num_epochs": 2, **kw})


def test_mid_epoch_resume_is_bit_identical(tmp_path):
    ds = ChemDataset(str(DEMO))
    straight = _small_trainer(tmp_path / "a", "a", ds)
    straight.train()

    interrupted = _small_trainer(tmp_path / "b", "b", ds, ckpt_every_steps=2)
    calls = {"n": 0}
    step = interrupted._train_step

    def preempt(batch):
        calls["n"] += 1
        if calls["n"] == 8:          # epoch 1, step 3 of 5
            raise KeyboardInterrupt
        return step(batch)
    interrupted._train_step = preempt
    with pytest.raises(KeyboardInterrupt):
        interrupted.train()
    latest = tmp_path / "b" / "b.latest.npz"
    meta = json.loads(latest.with_suffix(".json").read_text())
    assert meta["mid_epoch"] == {"epoch": 1, "steps_done": 2}

    resumed = _small_trainer(tmp_path / "b", "b", ds, resume_from=str(latest))
    assert (resumed.start_epoch, resumed._skip_steps) == (1, 2)
    resumed.train()
    a, b = _port_leaves(straight), _port_leaves(resumed)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
    assert resumed.step == straight.step == 10


def test_nan_guard_rolls_back(tmp_path, capsys):
    ds = ChemDataset(str(DEMO))
    tr = _small_trainer(tmp_path, "n", ds, num_epochs=1)
    before = _port_leaves(tr)
    ds.labels[:] = np.nan                  # every step's loss is NaN
    with pytest.raises(FloatingPointError, match="3 consecutive"):
        tr.train()
    assert "non_finite_loss" in capsys.readouterr().out
    for i, (x, y) in enumerate(zip(before, _port_leaves(tr))):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
    # one bad batch among good ones: its update is skipped, training goes on
    ds2 = ChemDataset(str(DEMO))
    ds2.labels[3] = np.nan
    tr2 = _small_trainer(tmp_path / "2", "m", ds2, num_epochs=1)
    tr2.train()
    assert tr2.step == 4
    assert all(torch.isfinite(p).all() for p in tr2.model.parameters())


# -- logging ------------------------------------------------------------------

def test_metrics_logger_and_step_timer(tmp_path):
    log = MetricsLogger("run", log_dir=tmp_path, config={"a": 1},
                        stdout=False)
    log.log({"train_loss": 1.5, "epoch": 0})
    log.log_histograms("grads", {"w": torch.tensor([1.0, float("nan"), 3.0]),
                                 "b": torch.zeros(0)}, epoch=0, bins=4)
    log.finish()
    recs = [json.loads(line) for line in
            (tmp_path / "run.jsonl").read_text().splitlines()]
    assert [r.get("event") for r in recs] == ["config", None,
                                              "histograms/grads"]
    assert recs[2]["hist"]["w"]["nonfinite"] == 1
    assert sum(recs[2]["hist"]["w"]["counts"]) == 2
    timer = StepTimer(warmup=1)
    assert timer.stats() == {}
    for _ in range(4):
        timer.tick()
    assert set(timer.stats()) == {"step_time_mean_s", "step_time_p50_s",
                                  "step_time_p99_s", "steps_per_s"}


# -- CLI ----------------------------------------------------------------------

def test_cli_train_and_test_run_on_the_cpu(tmp_path, monkeypatch):
    from cgr_mpnn_3d_tpu_torch.cli import test as cli_test
    from cgr_mpnn_3d_tpu_torch.cli import train as cli_train
    monkeypatch.chdir(tmp_path)
    data = tmp_path / "datasets"
    data.mkdir()
    for split in ("train", "val"):
        (data / f"{split}.csv").write_text(DEMO.read_text())
        synthetic_descriptors_npz(data / f"{split}.csv",
                                  data / f"{split}.npz", 8)
    argv = ["--name", "CGR-MPNN-3D", "-d", "2", "--hidden_sizes", "16",
            "--dropout_ps", "0.1", "-ne", "2", "-bs", "4",
            "--val_frequency", "1", "--data_path", str(data),
            "--save_path", "saved", "--device", "cpu", "--log_histograms"]
    with pytest.raises(FileNotFoundError, match="test.csv"):
        cli_train.main(argv)               # checked before training
    (data / "test.csv").write_text(DEMO.read_text())
    with pytest.raises(FileNotFoundError, match="test.npz"):
        cli_train.main(argv)
    synthetic_descriptors_npz(data / "test.csv", data / "test.npz", 8)
    res = cli_train.main(argv)
    assert len(res["train_losses"]) == 2 and res["steps"] == 6
    assert np.isfinite(res["test_losses"])
    study = json.loads((tmp_path / "hyperparameter_study" /
                        "CGR-MPNN-3D_hyperparameter_study.json").read_text())
    (name,) = study
    assert name.startswith("CGR-MPNN-3D_d-2_h-16-16_p-0.1-0.1_ReLU")
    assert study[name]["test_losses"] == res["test_losses"]
    hist = [json.loads(line)["event"] for line in
            (tmp_path / "runs" / f"{name}.jsonl").read_text().splitlines()
            if "histograms" in line]
    assert hist == ["histograms/params", "histograms/grads"] * 2
    out = cli_test.main(["--path_trained_model", f"saved/{name}.npz",
                         "--data_path", str(data), "--device", "cpu",
                         "--save_result"])
    assert out["test_losses"] == pytest.approx(res["test_losses"])


def test_cli_loader_modes_and_the_feature_cache(tmp_path, monkeypatch):
    """cli.train with --reuse_packs --loader_workers 2 --num_workers 2 on
    the CPU: the feature cache is written beside each split's CSV, and the
    per-epoch losses equal --loader_workers 1 bit for bit (the same
    batches) -- also in a second run that loads the cache."""
    from cgr_mpnn_3d_tpu_torch.cli import train as cli_train
    monkeypatch.chdir(tmp_path)
    data = tmp_path / "datasets"
    data.mkdir()
    for split in ("train", "val"):
        (data / f"{split}.csv").write_text(DEMO.read_text())
    argv = ["-d", "2", "--hidden_sizes", "16", "--dropout_ps", "0.1", "-ne",
            "3", "-bs", "4", "--val_frequency", "1", "--data_path",
            str(data), "--save_path", "saved", "--device", "cpu",
            "--skip_test", "--reuse_packs", "--num_workers", "2"]
    two = cli_train.main(argv + ["--loader_workers", "2"])
    for split in ("train", "val"):
        assert (data / f"{split}.csv.featcache.npz").exists()
    one = cli_train.main(argv + ["--loader_workers", "1"])
    assert two["train_losses"] == one["train_losses"]
    assert two["val_losses"] == one["val_losses"]
    assert two["steps"] == one["steps"] == 9


@pytest.mark.parametrize("env,flags,exc,text", [
    ({"JAX_NUM_PROCESSES": "2"}, [], ValueError,
     "2-process run needs a multi-device mesh: pass --dp/--ep"),
    ({"JAX_COORDINATOR_ADDRESS": "localhost:12355"}, ["--dp", "2"],
     ValueError, "JAX_COORDINATOR_ADDRESS without a process count"),
    ({"WORLD_SIZE": "2"}, ["--reuse_packs", "--device_epoch"], ValueError,
     "2-process run needs a multi-device mesh: pass --dp/--ep"),
    ({"JAX_NUM_PROCESSES": "3"}, ["--ep", "2"], ValueError,
     "the port takes two layouts, (a) whole dp groups a rank"),
    ({"WORLD_SIZE": "4"}, ["--dp", "2"], ValueError,
     "(b) one EP shard a rank (dp*ep = 2 must equal 4)"),
    ({"WORLD_SIZE": "2"}, ["--dp", "2"], ValueError,
     "WORLD_SIZE=2 without ['RANK', 'MASTER_ADDR', 'MASTER_PORT']")])
def test_cli_refusals_name_their_roadmap_items(monkeypatch, env, flags, exc,
                                               text):
    """cli/train.py refuses, before any rendezvous and before any data is
    read, a multi-process launch that the port does not take: dp*ep = 1 on
    several processes, a layout other than whole dp groups a rank or one
    EP shard a rank (ROADMAP.md section 3), and an incomplete launch
    environment."""
    from cgr_mpnn_3d_tpu_torch.cli import train as cli_train
    from cgr_mpnn_3d_tpu_torch.parallel import multihost
    for key in multihost.LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(exc) as err:
        cli_train.main(["-ne", "1", "--data_path", "missing", "--device",
                        "cpu"] + flags)
    assert text in str(err.value)
    assert not multihost.world_size() > 1


class _Rendezvous(Exception):
    """Raised in place of the process group's rendezvous."""


@pytest.mark.parametrize("env", [
    {"WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "localhost",
     "MASTER_PORT": "12355"},
    {"JAX_COORDINATOR_ADDRESS": "localhost:12355", "JAX_NUM_PROCESSES": "2",
     "JAX_PROCESS_ID": "0"}])
def test_cli_takes_ep_rdma_with_one_shard_a_rank(monkeypatch, env):
    """--ep 2 --ep_rdma over 2 processes (one EP shard a rank, whose hop
    exchanges cross ranks through the cross-rank K12) passes cli/train.py's
    launch check: ``check_launch`` gives layout (b), and ``main`` goes on
    to the rendezvous (stubbed here) before reading any data."""
    from cgr_mpnn_3d_tpu_torch.cli import train as cli_train
    from cgr_mpnn_3d_tpu_torch.parallel import multihost
    for key in multihost.LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    lay = multihost.check_launch(1, 2, ep_rdma=True)
    assert (lay.kind, lay.cells) == ("shards", [(0, int(
        env.get("RANK", env.get("JAX_PROCESS_ID"))))])

    def rendezvous(*a, **kw):
        raise _Rendezvous
    monkeypatch.setattr(multihost, "initialize", rendezvous)
    with pytest.raises(_Rendezvous):
        cli_train.main(["-ne", "1", "--data_path", "missing", "--device",
                        "cpu", "--skip_test", "--ep", "2", "--ep_rdma"])
    assert not multihost.world_size() > 1
