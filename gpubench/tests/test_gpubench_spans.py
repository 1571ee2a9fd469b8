"""The readers of the program's spans and counters (``gpubench/spans.py``
and the ``program_span`` / ``program_counter`` metrics): a ``--trace 1``
run of each cell on the CPU at a tiny width reports a number for each of
them that lists the cell, exactly the per-layer metrics it reported before
the runners declared their windows, and still comes out correct; a
program without ``utils/tracing.py`` makes each of them return None, not
raise."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
import torch

from gpubench import run, spec
from gpubench.tests.conftest import REPORTED, tiny

SEED = 2**31 + 11
CELLS = ["cgr_mpnn_3d.train_staged", "cgr.train_staged",
         "cgr_mpnn_3d.screen"]


def _program_metrics(cell: str | None = None) -> list[str]:
    return [m["name"] for m in spec.benchmark()["per_layer"]
            if m["source"] in ("program_span", "program_counter")
            and (cell is None or cell in m["workloads"])]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_every_program_metric_of_the_cell(cell):
    cfg, trf = tiny(cell)
    r = run.run_cell(cell, SEED, 0.2, True, device="cpu", config=cfg,
                     traffic=trf)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == REPORTED[cell, True]
    for name in _program_metrics(cell):
        assert name in r["metrics"], (name, sorted(r["metrics"]))
        assert r["metrics"][name]["value"] > 0, (name, r["metrics"][name])


def test_every_program_metric_reads_none_without_the_programs_tracing(
        monkeypatch):
    import cgr_mpnn_3d_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "cgr_mpnn_3d_tpu_torch.utils.tracing",
                        None)
    names = _program_metrics()
    assert len(names) >= 6
    for name in names:
        kind = "screen" if name.endswith(".screen") else "train_staged"
        ctx = SimpleNamespace(traffic={"kind": kind, "val_frequency": 5},
                              program={}, device=torch.device("cpu"))
        assert spec.reader(name).read(ctx) is None, name
