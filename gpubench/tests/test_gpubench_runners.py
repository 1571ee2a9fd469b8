"""The runner, not the kind's name, says what a cell's window feeds and
which controls it has: a kind that no file of ``gpubench/`` names reports
the end-to-end metrics of its ``WINDOW`` through ``run_cell`` and runs
each of its ``CONTROLS`` through calibrate's loop; each cell reports the
metrics it reported before the runners declared them; a runner refuses a
configuration it cannot run before any input is made."""

from __future__ import annotations

import json
import shutil

import pytest

from gpubench import calibrate, run, spec
from gpubench.tests.conftest import REPORTED, tiny

SEED = 2**31 + 13
SCREEN = "cgr_mpnn_3d.screen"

# a kind of its own: screen's requests under another name, with a control
# set that no table elsewhere holds
PROBE = '''"""A throwaway kind: the screen's requests under another name."""
from gpubench import spec

_screen = spec.kind("screen")
WINDOW = _screen.WINDOW
CONTROLS = ("alter",)
check_config = _screen.check_config
inputs, setup, stretch = _screen.inputs, _screen.setup, _screen.stretch
check, control = _screen.check, _screen.control


def window(ctx):
    _screen.window(ctx)
'''


@pytest.fixture
def probe_copy(tmp_path, monkeypatch):
    """A copy of the harness with one more cell, of the kind
    ``geometry_probe``, whose cell is listed by the end-to-end metrics of
    requests; ``spec`` reads the copy."""
    here = tmp_path / "gpubench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (here / "kinds" / "geometry_probe.py").write_text(PROBE)
    trf = spec.traffic("screen")
    trf["kind"] = "geometry_probe"
    (here / "traffic" / "geometry_probe.json").write_text(json.dumps(trf))
    cell = "cgr_mpnn_3d.geometry_probe"
    shutil.copy(here / "limits" / f"{SCREEN}.json",
                here / "limits" / f"{cell}.json")
    bench = spec.benchmark()
    bench["workloads"].append({"name": cell, "config": "cgr_mpnn_3d",
                               "traffic": "geometry_probe", "chips": 1,
                               "why": "a kind of its own"})
    for m in bench["end_to_end"]:
        if m["name"] in ("screen_graphs_per_s", "screen_request_ms_p95"):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    return cell


def test_a_new_kind_reports_the_metrics_of_its_window(probe_copy):
    cfg, trf = tiny(probe_copy)
    assert trf["kind"] == "geometry_probe"
    r = run.run_cell(probe_copy, SEED, 0.2, False, device="cpu", config=cfg,
                     traffic=trf)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"screen_graphs_per_s",
                                 "screen_request_ms_p95", "setup_s"}


def test_calibrate_runs_each_control_of_a_new_kind(probe_copy):
    cfg, trf = tiny(probe_copy)
    got = list(calibrate.controls(probe_copy, SEED, 0.2, "cpu", config=cfg,
                                  traffic=trf))
    assert [v for v, _ in got] == ["alter"]
    lim = spec.limits(probe_copy)
    assert got[0][1]["pred_gap"] > lim["pred_gap"], got


@pytest.mark.parametrize("cell", sorted(c for c, t in REPORTED if not t))
def test_each_cell_reports_the_metrics_it_reported(cell):
    """The end-to-end metrics; ``test_gpubench_spans`` checks the
    per-layer ones of a traced run."""
    cfg, trf = tiny(cell)
    r = run.run_cell(cell, SEED, 0.2, False, device="cpu", config=cfg,
                     traffic=trf)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == REPORTED[cell, False]


@pytest.mark.parametrize("kind,window,controls", [
    ("screen", "requests", ("tf32", "alter")),
    ("train_staged", "epochs", ("tf32", "half"))])
def test_runners_declare_their_window_and_controls(kind, window, controls):
    drv = spec.kind(kind)
    assert (drv.WINDOW, drv.CONTROLS) == (window, controls)


@pytest.mark.parametrize("cell", [SCREEN, "cgr_mpnn_3d.train_staged",
                                  "cgr.train_staged"])
@pytest.mark.parametrize("fault", ["node_features_off_by_one",
                                   "key_missing"])
def test_check_config_refuses_a_malformed_configuration(cell, fault):
    bench = spec.benchmark()
    w = spec.workload(bench, cell)
    cfg = spec.config(bench, w["config"])
    drv = spec.kind(spec.traffic(w["traffic"])["kind"])
    drv.check_config(cfg)
    if fault == "key_missing":
        del cfg["hidden"]
    else:
        cfg["node_features"] += 1
    word = "hidden" if fault == "key_missing" else "node_features"
    with pytest.raises(ValueError, match=word):
        drv.check_config(cfg)
    with pytest.raises(ValueError, match=word):
        run.run_cell(cell, SEED, 0.2, False, device="cpu", config=cfg)
