"""``BENCHMARK.json`` and the files it names are whole and within the
limits of its format; the yardstick's arithmetic and trace reduction hold on
small cases; the module check compares whole top-level names."""

from __future__ import annotations

import importlib.util
import json
import re
import sys

import numpy as np
import pytest

from gpubench import card, cost, data, spec, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert len(bench["command"]) <= 32
    assert all(TEXT.match(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["config"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in bench[group]}) == len(bench[group])
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_every_named_file_parses(bench):
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        trf = spec.traffic(w["traffic"])
        assert (spec.HERE / "kinds" / f"{trf['kind']}.py").exists()
        spec.kind(trf["kind"]).check_config(spec.config(bench, w["config"]))
        assert spec.limits(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        path = spec.HERE / "metrics" / f"{m['name']}.py"
        module = importlib.util.module_from_spec(
            importlib.util.spec_from_file_location("m", path))
        module.__spec__.loader.exec_module(module)
        assert callable(module.read)


def test_each_cell_reports_what_its_metrics_move(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for w in cells:
        e2e = spec.metrics_of(bench, w, False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert spec.metrics_of(bench, w, True)
    for m in bench["per_layer"]:
        moved = next(e for e in bench["end_to_end"]
                     if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in cells
            assert w in moved.get("workloads", cells), (m["name"], w)


def _brute(batch, H, L):
    """Operation counts by walking the real rows one at a time."""
    F, Fe = batch.node_x.shape[1], batch.edge_attr.shape[1]
    NT, ET = batch.node_x.shape[0], batch.edge_attr.shape[0]
    edges = [e for e in range(ET) if batch.senders[e] < NT]
    nodes = [n for g in batch.graph_nodes for n in g if n < NT]
    graphs = [g for g in batch.graph_nodes if (g < NT).any()]
    nbr = sum(1 for e in range(ET) for k in batch.edge_nbr[e] if k < ET)
    inc = sum(1 for n in range(NT) for k in batch.node_inc[n] if k < ET)
    fwd = 0
    for _ in nodes:
        fwd += 2 * F * H + 2 * (F + H) * H
    for _ in edges:
        fwd += 2 * Fe * H + L * 2 * H * H
    fwd += 2 * H * len(graphs)
    adds = (L * (nbr + len(edges)) + inc + len(nodes)) * H
    bwd = (4 * H * len(graphs) + len(nodes) * (4 * H * H + 4 * F * H)
           + len(edges) * (4 * L * H * H + 2 * Fe * H))
    return fwd, adds, bwd


def test_costs_equal_a_brute_force_count():
    from cgr_mpnn_3d_tpu_torch.chem import RxnGraph
    from cgr_mpnn_3d_tpu_torch.data.batch import pack_graphs, plan_spec
    smiles, labels = data.corpus()
    graphs = [RxnGraph(s).arrays for s in smiles[:20]]
    spec_ = plan_spec(graphs).with_packs(2)
    batch = pack_graphs(graphs, labels[:20], spec_)
    H, L = 8, 3
    fwd, adds, bwd = _brute(batch, H, L)
    f = cost.forward_cost(batch, H, L)
    t = cost.train_cost(batch, H, L)
    assert f[:2] == (fwd, adds)
    assert t[:2] == (fwd + bwd, 2 * adds)
    assert t[2] > f[2] > 0
    ms, by = cost.bound(f)
    assert ms > 0 and by in ("operations", "bytes")


def test_trace_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (8, 20)]
    assert trace.union_length(iv, 0, 10) == 6
    assert trace.gaps(iv, 0, 10) == [(3, 5), (6, 8)]
    assert trace.gaps([], 1, 2) == [(1, 2)]
    idle = trace._name_gaps([(3, 5), (6, 8)],
                            [(0, 10, "outer"), (2, 4.5, "inner")])
    assert idle == {"inner": 2e-6, "outer": 2e-6}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in ("jax_like", "cgr_mpnn_3d_tpu_torch.models"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert card.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cgr_mpnn_3d_tpu.ops", sys)
    assert card.forbidden_modules() == ["cgr_mpnn_3d_tpu.ops"]


def test_inputs_follow_the_seed():
    a = data.descriptors(data.corpus()[0][:5], 4, 2**31 + 5, "x")
    b = data.descriptors(data.corpus()[0][:5], 4, 2**31 + 5, "x")
    c = data.descriptors(data.corpus()[0][:5], 4, 2**31 + 6, "x")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert json.dumps(data.draw_rows(5, 1, "t").tolist())


def test_device_busy_counts_device_work_only():
    import torch
    window_s, busy_s, ops = trace.device_busy(lambda: torch.ones(64).sum())
    assert window_s > 0
    if not torch.cuda.is_available():
        assert (busy_s, ops) == (0.0, [])
