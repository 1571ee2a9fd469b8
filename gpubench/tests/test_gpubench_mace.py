"""The geometry cell on the CPU at a tiny width (the look for a card
skipped): a sound run is correct and reports the end-to-end metrics of its
window and, traced, its six per-layer names (those that need a card read
nothing here); faults planted in the program's MACE (the order-3 term, the
envelope, the second interaction) and the controls (TF32; an ordinary
row's answer off by 1) come out not correct, the row gap seeing a unit's
fault that one large row hides from ``pred_gap``; ``check_config`` refuses
node features that do not hold three descriptor sets of MACE's width."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench import run, spec

SEED = 2**31 + 17
CELL = "mace_mp_small_cgr_3d.screen_geometry"
TRACED = {"mace_ms.screen_geometry", "copy_in_mb.screen_geometry",
          "device_idle.screen_geometry"}
PER_LAYER = TRACED | {"mace_interaction_roofline.screen_geometry",
                      "mace_product_roofline.screen_geometry",
                      "mfu.screen_geometry"}


def tiny() -> tuple[dict, dict]:
    """The cell at 16 MACE channels, head hidden 16, depth 2, 48 rows."""
    bench = spec.benchmark()
    w = spec.workload(bench, CELL)
    cfg = spec.config(bench, w["config"])
    cfg["mace"] = dict(cfg["mace"], channels=16)
    dim = 16 * cfg["mace"]["interactions"]
    cfg.update(hidden=16, depth=2, descriptor_dim=dim,
               node_features=cfg["cgr_node_features"] + 3 * dim)
    trf = dict(spec.traffic(w["traffic"]), library_rows=48, batch_size=16)
    return cfg, trf


def _run(trace: bool = False) -> dict:
    cfg, trf = tiny()
    return run.run_cell(CELL, SEED, 0.2, trace, device="cpu", config=cfg,
                        traffic=trf)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct_and_reports_its_metrics(trace):
    r = _run(trace)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"pred_gap", "pred_gap_row",
                                "descriptor_gap"}
    want = TRACED if trace else {"screen_graphs_per_s",
                                 "screen_request_ms_p95", "setup_s"}
    assert set(r["metrics"]) == want
    names = {m["name"] for m in spec.benchmark()["per_layer"]
             if CELL in m["workloads"]}
    assert names == PER_LAYER


def _no_order_3(orig):
    def basis(correlation=3):
        b = dict(orig(correlation))
        keep = b["ptr"][1 + 4]
        b["mono"], b["coef"] = b["mono"][:keep], b["coef"][:keep]
        b["ptr"] = b["ptr"][:1 + 1 + 4]
        b["path_poly"] = [*b["path_poly"][:2],
                          [(-1, 0.0)] * len(b["path_poly"][2])]
        return b
    return basis


def _no_envelope(orig):
    def radial(r, n, r_max, p):
        return orig(r, n, r_max, 1000)
    return radial


def _one_interaction(orig):
    def interaction(pos, struct_ptr, hup, radial, r_max, p):
        msg = orig(pos, struct_ptr, hup, radial, r_max, p)
        _one_interaction.calls += 1
        return msg if _one_interaction.calls % 2 else msg * 0.0
    _one_interaction.calls = 0
    return interaction


@pytest.mark.parametrize("fault", ["order_3_dropped", "envelope_removed",
                                   "second_interaction_skipped"])
def test_mace_fault_is_not_correct(fault, monkeypatch):
    from cgr_mpnn_3d_tpu_torch.models import mace as models_mace
    from cgr_mpnn_3d_tpu_torch.ops import mace as ops_mace
    if fault == "order_3_dropped":
        monkeypatch.setattr(models_mace, "product_basis",
                            _no_order_3(models_mace.product_basis))
    elif fault == "envelope_removed":
        monkeypatch.setattr(ops_mace, "radial_basis",
                            _no_envelope(ops_mace.radial_basis))
    else:
        monkeypatch.setattr(ops_mace, "mace_interaction_ref",
                            _one_interaction(ops_mace.mace_interaction_ref))
    r = _run()
    assert not r["correct"], r["checks"]
    assert r["checks"]["descriptor_gap"]["value"] > \
        r["checks"]["descriptor_gap"]["limit"]


@pytest.mark.parametrize("variant", ["tf32", "alter"])
def test_control_fails_both_limits(variant):
    from gpubench import calibrate
    cfg, trf = tiny()
    got = dict(calibrate.controls(CELL, SEED, 0.2, "cpu", config=cfg,
                                  traffic=trf))
    lim = spec.limits(CELL)
    assert got[variant]["descriptor_gap"] > lim["descriptor_gap"], got
    assert got[variant]["pred_gap_row"] > lim["pred_gap_row"], got
    if variant == "tf32":
        assert got[variant]["pred_gap"] > lim["pred_gap"], got


def test_row_gap_sees_an_ordinary_row_moved_by_a_unit():
    """One row hundreds of times the others hides a unit's fault from
    ``pred_gap``, not from ``pred_gap_row``; a row near 0 reads its
    rounding against the median row."""
    from gpubench import compare, compare_mace
    lim = spec.limits(CELL)
    ref = np.array([4e4, 12.0, 8.0, -5.0, 0.01, 20.0])
    moved = ref.copy()
    moved[1] += 1.0
    assert compare.prediction_gap([moved], ref) < lim["pred_gap"]
    assert compare_mace.row_prediction_gap([moved], ref) > \
        lim["pred_gap_row"]
    rounded = ref * (1 + 1e-7)
    rounded[4] += 1e-6
    assert compare_mace.row_prediction_gap([rounded], ref) < \
        lim["pred_gap_row"]
    assert compare_mace.row_prediction_gap([ref[:-1]], ref) == np.inf


@pytest.mark.parametrize("field,delta", [("node_features", 1),
                                         ("descriptor_dim", 64)])
def test_check_config_refuses_node_features_off_the_mace_width(field,
                                                               delta):
    bench = spec.benchmark()
    cfg = spec.config(bench, "mace_mp_small_cgr_3d")
    drv = spec.kind("screen_geometry")
    drv.check_config(cfg)
    assert cfg["node_features"] == 78 + 3 * 256
    cfg[field] += delta
    if field == "descriptor_dim":
        cfg["node_features"] = cfg["cgr_node_features"] + 3 * cfg[field]
    with pytest.raises(ValueError, match="node_features"):
        drv.check_config(cfg)
    with pytest.raises(ValueError, match="node_features"):
        run.run_cell(CELL, SEED, 0.2, False, device="cpu", config=cfg)


def test_reference_is_float32_without_tf32_and_imports_no_program():
    import ast
    import inspect
    from gpubench.reference import mace
    tree = ast.parse(inspect.getsource(mace))
    names = [a.name for n in ast.walk(tree)
             if isinstance(n, (ast.Import, ast.ImportFrom))
             for a in n.names] + [n.module or "" for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)]
    assert not any(n.startswith(("cgr_mpnn_3d_tpu", "jax")) for n in names)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        w = mace.make_weights(tiny()[0]["mace"], 1, "cpu")
        assert all(t.dtype == torch.float32 for t in w.values())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
