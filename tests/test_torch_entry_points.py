"""The port's last entry points against the JAX package's, on the CPU:

* ``cli/sweep.py``: ``sample_config`` and ``TPESampler`` give JAX's exact
  config sequence over 20 ask/tell rounds on the shipped
  ``hyperparameter_study/sweep_config.json`` (and in TPE's own regime);
  the study file, failed-trial records, the ranking, the unknown-key and
  unknown-method refusals, and a real trial through the port's
  ``cli/train.py`` on ``--device cpu``;
* ``cli/runbook.py``: the demo plumbing with overridden gates (both
  models, the hidden-512 and dtype legs), the exit status that follows the
  gates, and a missing split raising with its files named;
* ``chem/rdkit_check.py``: ``verify_corpus`` with the fake backends of
  tests/test_corpus.py, and no RDKit here;
* ``train/profiler.py::trace``: a Chrome trace written on the CPU, nothing
  when disabled;
* ``python -m cgr_mpnn_3d_tpu_torch``: its help names the port's entry
  points, with JAX's exit codes.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "examples" / "demo.csv"
CORPUS = REPO / "tests" / "corpus_reactions.csv"
SWEEP = REPO / "hyperparameter_study" / "sweep_config.json"


@pytest.fixture
def datasets(tmp_path):
    """train/val/test = the demo set, with synthetic descriptor npz."""
    from cgr_mpnn_3d_tpu_torch.data.descriptors import \
        synthetic_descriptors_npz
    d = tmp_path / "datasets"
    d.mkdir()
    for split in ("train", "val", "test"):
        shutil.copy(DEMO, d / f"{split}.csv")
        synthetic_descriptors_npz(str(d / f"{split}.csv"),
                                  str(d / f"{split}.npz"), 4)
    return d


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------

def _loss(c: dict) -> float:
    """A deterministic loss of a shipped-space config."""
    return (4.0 * (np.log10(c["lr"]) + 3.0) ** 2 + (c["depth"] - 4) ** 2
            + 1e-3 * c["hidden_sizes"][0] / 100 + c["dropout_ps"][0]
            + np.log10(c["weight_decay"]) / 10 + (c["gamma"] - 0.95) ** 2
            + c["batch_size"] / 64 + c["num_epochs"] / 40
            + (0.5 if c["learnable_skip"] else 0.0))


@pytest.mark.parametrize("kw", [{}, {"n_startup": 4, "explore": 0.0},
                                {"n_startup": 6, "gamma": 0.3, "seed": 3}])
def test_tpe_gives_jax_config_sequence(kw):
    from cgr_mpnn_3d_tpu.cli.sweep import TPESampler as JTPE
    from cgr_mpnn_3d_tpu_torch.cli.sweep import TPESampler
    space = json.loads(SWEEP.read_text())["parameters"]
    kw = dict({"seed": 0}, **kw)
    a, b = TPESampler(space, **kw), JTPE(space, **kw)
    for _ in range(20):
        ca, cb = a.ask(), b.ask()
        assert ca == cb
        a.tell(ca, _loss(ca))
        b.tell(cb, _loss(cb))
    assert len(a._obs) == 20


def test_sample_config_gives_jax_draws():
    from cgr_mpnn_3d_tpu.cli.sweep import sample_config as jsample
    from cgr_mpnn_3d_tpu_torch.cli.sweep import sample_config
    space = json.loads(SWEEP.read_text())["parameters"]
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(20):
        assert sample_config(space, ra) == jsample(space, rb)
    with pytest.raises(ValueError, match="unsupported parameter spec"):
        sample_config({"x": {"distribution": "normal"}}, ra)


@pytest.mark.parametrize("method", ["bayes", "random"])
def test_run_sweep_study_file_equals_jax(tmp_path, method):
    """The same trials, statuses and losses as JAX's run_sweep (a trial
    that raises is recorded as failed, with its error, and the sweep goes
    on); evaluate_sweep ranks failed trials last."""
    from cgr_mpnn_3d_tpu.cli.sweep import run_sweep as jrun
    from cgr_mpnn_3d_tpu_torch.cli.sweep import evaluate_sweep, run_sweep
    space = json.loads(SWEEP.read_text())

    def train_fn(c):
        if c["depth"] == 6:
            raise RuntimeError("boom at depth 6")
        return {"train_loss": _loss(c) / 2, "val_loss": _loss(c)}

    space["method"] = method
    got = run_sweep(space, 16, tmp_path / "t.jsonl", seed=2,
                    train_fn=train_fn)
    want = jrun(space, 16, tmp_path / "j.jsonl", seed=2, train_fn=train_fn)
    strip = lambda rs: [{k: v for k, v in r.items() if k != "run_id"}  # noqa
                        for r in rs]
    assert strip(got) == strip(want)
    lines = [json.loads(s) for s in (tmp_path / "t.jsonl").read_text()
             .splitlines()]
    assert strip(lines) == strip(got)
    failed = [r for r in got if r["status"] == "failed"]
    assert failed and all("boom" in r["error"] for r in failed)
    ranked = evaluate_sweep(tmp_path / "t.jsonl", str(tmp_path / "o.json"))
    assert ranked[-1]["status"] == "failed"
    assert ranked[0]["val_loss"] == min(r.get("val_loss", np.inf)
                                        for r in got)
    assert json.loads((tmp_path / "o.json").read_text()) == ranked


def test_sweep_refusals(tmp_path):
    from cgr_mpnn_3d_tpu_torch.cli import sweep
    with pytest.raises(ValueError, match="grid"):
        sweep.run_sweep({"method": "grid", "parameters": {}}, 1,
                        tmp_path / "s.jsonl", train_fn=lambda c: {})
    with pytest.raises(ValueError, match="bogus_knob"):
        sweep._default_train_fn({"bogus_knob": 1}, device="cpu")


def test_default_train_fn_maps_keys_and_device(monkeypatch):
    from cgr_mpnn_3d_tpu_torch.cli import sweep
    from cgr_mpnn_3d_tpu_torch.cli import train as train_mod
    seen = {}

    def fake_train(args):
        seen.update(vars(args))
        return {"train_losses": [2.0, 1.0], "val_losses": [3.0]}

    monkeypatch.setattr(train_mod, "train", fake_train)
    out = sweep._default_train_fn({"activation_fn": "GELU", "depth": 3,
                                   "aggr": "mean", "seed": 7, "gpu_id": 1,
                                   "dropout_ps": [0.1, 0.2, 0.3]},
                                  device="cpu")
    assert (seen["activation_fn"], seen["aggr"], seen["seed"]) == \
        ("GELU", "mean", 7)
    assert seen["hidden_sizes"] == [300] * 3
    assert seen["dropout_ps"] == [0.1, 0.2, 0.3]
    assert seen["device"] == "cpu" and seen["skip_test"]
    assert out == {"train_loss": 1.0, "val_loss": 3.0,
                   "train_losses": [2.0, 1.0], "val_losses": [3.0]}


def test_sweep_trains_through_the_cli_on_cpu(datasets, tmp_path,
                                             monkeypatch):
    """``main`` on a one-trial bayes sweep file: the trial trains through
    cli/train.py on --device cpu and the study ranks it."""
    from cgr_mpnn_3d_tpu_torch.cli.sweep import main
    monkeypatch.chdir(tmp_path)
    cfg = {"method": "bayes", "parameters": {
        "name": {"value": "CGR-MPNN-3D"}, "depth": {"values": [2]},
        "hidden_sizes": {"values": [[16]]},
        "dropout_ps": {"values": [[0.0]]},
        "lr": {"distribution": "log_uniform_values", "min": 1e-3,
               "max": 3e-3},
        "num_epochs": {"value": 1}, "batch_size": {"value": 8},
        "data_path": {"value": str(datasets)},
        "save_path": {"value": str(tmp_path / "saved")}}}
    (tmp_path / "sweep.json").write_text(json.dumps(cfg))
    ranked = main(["-p", str(tmp_path / "sweep.json"), "-c", "1",
                   "--study", str(tmp_path / "s.jsonl"), "--device", "cpu"])
    assert len(ranked) == 1 and ranked[0]["status"] == "ok"
    assert np.isfinite(ranked[0]["val_loss"])
    assert list((tmp_path / "saved").glob("CGR-MPNN-3D_*.npz"))
    again = main(["--evaluate", "--study", str(tmp_path / "s.jsonl")])
    assert again == ranked


# ---------------------------------------------------------------------------
# runbook
# ---------------------------------------------------------------------------

def _runbook(datasets, tmp_path, *extra):
    return ["--data_path", str(datasets), "--save_path",
            str(tmp_path / "saved"), "--summary", str(tmp_path / "s.json"),
            "--epochs", "1", "--depth", "2", "--hidden", "16",
            "--compute_dtype", "float32", "--device", "cpu", *extra]


def test_runbook_demo_end_to_end(datasets, tmp_path, monkeypatch):
    """Both models trained, tested and gated (gates overridden: the demo
    labels cannot reach the published RMSEs)."""
    from cgr_mpnn_3d_tpu_torch.cli.runbook import main
    monkeypatch.chdir(tmp_path)
    main(_runbook(datasets, tmp_path, "--gate_cgr", "1000", "--gate_3d",
                  "1000"))
    s = json.loads((tmp_path / "s.json").read_text())
    assert s["all_passed"] is True
    assert set(s["gates"]) == {"CGR", "CGR-MPNN-3D"}
    assert s["featurizer_rdkit_check"].startswith("skipped")
    assert s["config"]["device"] == "cpu"
    for g in s["gates"].values():
        assert g["passed"] and 0 < g["test_rmse_kcal_mol"] < 1000
        assert Path(g["checkpoint"]).exists()


def test_runbook_h512_and_dtype_legs(datasets, tmp_path, monkeypatch):
    from cgr_mpnn_3d_tpu_torch.cli.runbook import main
    monkeypatch.chdir(tmp_path)
    main(_runbook(datasets, tmp_path, "--skip_3d", "--gate_cgr", "1000",
                  "--gate_tolerance", "5.0", "--compare_h512",
                  "--compare_f32"))
    s = json.loads((tmp_path / "s.json").read_text())
    assert set(s["gates"]) == {"CGR", "H512_vs_H400",
                               "dtype_float32_vs_bfloat16"}
    assert "512" in s["gates"]["H512_vs_H400"]["checkpoint"]
    leg = s["gates"]["dtype_float32_vs_bfloat16"]
    # the retrain does not overwrite the main gate's checkpoint
    assert leg["checkpoint"] != s["gates"]["CGR"]["checkpoint"]
    assert Path(leg["checkpoint"]).exists()
    assert leg["rmse_main"] > 0 and leg["rmse_other"] > 0


def test_runbook_gate_failure_exits_nonzero(datasets, tmp_path,
                                            monkeypatch):
    from cgr_mpnn_3d_tpu_torch.cli.runbook import main
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        main(_runbook(datasets, tmp_path, "--skip_3d", "--gate_cgr",
                      "0.0001"))
    assert e.value.code == 1
    s = json.loads((tmp_path / "s.json").read_text())
    assert s["all_passed"] is False and not s["gates"]["CGR"]["passed"]


def test_runbook_missing_split_raises(datasets, tmp_path, monkeypatch):
    """Where JAX downloads a missing split, the port raises and names the
    files; --pack_q is not a flag."""
    from cgr_mpnn_3d_tpu_torch.cli.runbook import main, missing_splits
    monkeypatch.chdir(tmp_path)
    (datasets / "val.csv").unlink()
    (datasets / "test.npz").unlink()
    with pytest.raises(FileNotFoundError) as e:
        main(_runbook(datasets, tmp_path))
    assert "val.csv" in str(e.value) and "test.npz" in str(e.value)
    assert missing_splits(datasets, False) == [str(datasets / "val.csv")]
    assert not (tmp_path / "s.json").exists()
    with pytest.raises(SystemExit):
        main(_runbook(datasets, tmp_path, "--pack_q", "2"))


# ---------------------------------------------------------------------------
# rdkit_check, trace, __main__
# ---------------------------------------------------------------------------

def _self_backend(smi):
    from cgr_mpnn_3d_tpu_torch.chem import RxnGraph
    a = RxnGraph(smi).arrays
    return a.node_feats, a.edge_feats, a.senders, a.receivers


def _drifted(what):
    def backend(smi):
        x, e, s, r = _self_backend(smi)
        if what == "node":
            x = x.copy()
            x[:, 20] = 1.0 - x[:, 20]   # one degree one-hot flipped
        elif what == "shape":
            e = e[:-2]
        else:
            s, r = r, s
        return x, e, s, r
    return backend


def test_verify_corpus_with_fake_backends():
    from cgr_mpnn_3d_tpu_torch.chem import rdkit_check as rc
    assert rc.rdkit_available() is False
    rep = rc.verify_corpus(str(CORPUS), backend=_self_backend, limit=25)
    assert rep == {"checked": 25, "mismatches": 0}
    for what, match in (("node", "node features disagree"),
                        ("shape", "edge features shapes disagree"),
                        ("topology", "edge topology")):
        with pytest.raises(rc.FeaturizerDrift, match=match):
            rc.verify_corpus(str(CORPUS), backend=_drifted(what), limit=5)
    with pytest.raises(ImportError, match="RDKit"):
        rc.verify_corpus(str(CORPUS))


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, capsys):
    import torch

    from cgr_mpnn_3d_tpu_torch.train import trace
    a = torch.randn(64, 64)
    with trace(str(tmp_path / "off"), enabled=False):
        a @ a
    assert not (tmp_path / "off").exists()
    with trace(str(tmp_path / "t")):
        a @ a
    files = list((tmp_path / "t").glob("trace-*.json"))
    assert len(files) == 1
    assert str(files[0]) in capsys.readouterr().out
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_main_help_and_exit_codes():
    out = subprocess.run([sys.executable, "-m", "cgr_mpnn_3d_tpu_torch"],
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0
    for mod in ("train", "test", "predict", "sweep", "runbook", "bench_ops"):
        assert f"python -m cgr_mpnn_3d_tpu_torch.cli.{mod}" in out.stdout
        assert (REPO / "cgr_mpnn_3d_tpu_torch" / "cli" / f"{mod}.py").exists()
    assert "cgr_mpnn_3d_tpu.cli" not in out.stdout
    bad = subprocess.run([sys.executable, "-m", "cgr_mpnn_3d_tpu_torch",
                          "x"], cwd=str(REPO), capture_output=True,
                         text=True, timeout=120)
    jbad = subprocess.run([sys.executable, "-m", "cgr_mpnn_3d_tpu", "x"],
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=120)
    assert bad.returncode == jbad.returncode == 1
