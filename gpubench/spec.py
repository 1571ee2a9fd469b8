"""``BENCHMARK.json`` and the files it names, found by name:

* a configuration's file is its ``file`` entry (``configs/<name>.json``);
* a traffic mix is ``traffic/<mix>.json``; its ``kind`` names the runner
  ``kinds/<kind>.py`` that generates and runs it, and whose ``WINDOW``
  tells the end-to-end readers what its window counted;
* a cell's limits on its compared numbers are ``limits/<cell>.json``;
* a metric's reader is ``metrics/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "ROOT", "benchmark", "workload", "config", "traffic",
           "limits", "metrics_of", "kind", "runner", "reader"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"gpubench: no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return _json(ROOT / entry["file"])


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return _json(HERE / "limits" / f"{cell}.json")


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics (an
    entry without ``workloads`` is every cell's), or with ``trace`` the
    per-layer ones whose ``workloads`` list it."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise SystemExit(f"gpubench: {path} is missing")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    """The runner of a traffic kind."""
    return _module(HERE / "kinds" / f"{name}.py", f"gpubench.kinds.{name}")


def runner(ctx):
    """The runner of the kind that ``ctx``'s traffic runs."""
    return kind(ctx.traffic["kind"])


def reader(name: str):
    """The reader of a metric: a module with ``read(ctx)``."""
    return _module(HERE / "metrics" / f"{name}.py",
                   f"gpubench.metrics.{name.replace('.', '_')}")
