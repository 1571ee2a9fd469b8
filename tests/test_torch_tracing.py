"""The port's spans and counters (``utils/tracing.py``) on the CPU.

* off, a span is one shared object that records nothing;
* a span log keeps each span's parent, and self time is the duration less
  the children's;
* under ``torch.profiler`` the spans are events of the trace;
* a tiny training run and a ``predict`` call open the spans their layers
  name, once per epoch, step, validation, save or batch;
* ``copy_in_bytes`` counts the bytes ``to_device`` moves, and
  ``launch_counts`` reads the kernel wrappers' module counters.
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu_torch.data import ChemDataset, PackedLoader, plan_spec
from cgr_mpnn_3d_tpu_torch.data.batch import to_device
from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig, init_params
from cgr_mpnn_3d_tpu_torch.ops import _launch
from cgr_mpnn_3d_tpu_torch.ops import conv_stack as cs
from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm
from cgr_mpnn_3d_tpu_torch.train.evaluate import predict
from cgr_mpnn_3d_tpu_torch.utils import tracing
from cgr_mpnn_3d_tpu_torch.utils.tracing import counters, span, span_log
from test_torch_trainer import _small_trainer

DEMO = Path(__file__).resolve().parent.parent / "examples" / "demo.csv"


def test_off_span_is_one_shared_object_that_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = span("train.step"), span("predict.pack", request=3)
    assert a is b
    with a as inside:
        assert inside is a
    with span_log() as log:
        with span("x"):
            pass
    with span("y"):
        pass
    assert [r.name for r in log.records] == ["x"]


def test_span_log_keeps_parents_and_self_time():
    with span_log() as log:
        with span("outer", epoch=2):
            time.sleep(0.002)
            with span("inner"):
                time.sleep(0.003)
            with span("inner"):
                time.sleep(0.001)
        with span("alone"):
            pass
    outer, first, second, alone = log.records
    assert [r.parent for r in log.records] == [-1, 0, 0, -1]
    assert outer.attrs == {"epoch": 2} and first.attrs == {}
    s = log.summary()
    assert s["inner"]["count"] == 2 and s["outer"]["count"] == 1
    kids = first.seconds + second.seconds
    assert s["outer"]["total_s"] == pytest.approx(outer.seconds)
    assert s["outer"]["self_s"] == pytest.approx(outer.seconds - kids)
    assert s["inner"]["self_s"] == pytest.approx(s["inner"]["total_s"])
    assert 0.0 < s["outer"]["self_s"] < s["outer"]["total_s"]


def test_profiler_records_the_spans_as_events():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span_log() as log:
            with span("predict.request", request=7):
                with span("predict.forward", request=7):
                    torch.ones(8).sum()
    names = [e.name for e in prof.events()]
    assert names.count("predict.request") == 1
    assert names.count("predict.forward") == 1
    assert [r.name for r in log.records] == ["predict.request",
                                             "predict.forward"]


def _bests(vals):
    best, n = float("inf"), 0
    for v in vals:
        if v < best:
            best, n = v, n + 1
    return n


@pytest.mark.parametrize("mode", ["staged", "host_loop"])
def test_training_opens_a_span_per_epoch_step_validation_and_save(
        tmp_path, capsys, mode):
    ds = ChemDataset(str(DEMO))
    kw = (dict(reuse_packs=True, device_epoch=True) if mode == "staged"
          else {})
    tr = _small_trainer(tmp_path, "s", ds, num_epochs=3, **kw)
    with span_log() as log:
        out = tr.train()
    s = log.summary()
    n = {k: v["count"] for k, v in s.items()}
    epochs = len(out["train_losses"])
    assert n["train.run"] == 1
    assert n["train.epoch"] == epochs == 3
    assert n["train.step"] == out["steps"] > epochs
    assert n["train.validate"] == len(out["val_losses"]) == epochs
    assert n["train.save"] == epochs + _bests(out["val_losses"])
    assert "model.grads" in n         # the plain K2 on the CPU: no ops.k2
    records = log.records
    run = log.named("train.run")[0]
    assert run.parent == -1
    for r in log.named("train.epoch"):
        assert records[r.parent] is run
    assert [r.attrs["epoch"] for r in log.named("train.epoch")] == [0, 1, 2]
    for r in log.named("train.step"):
        assert records[r.parent].name == "train.epoch"
    if mode == "staged":
        assert n["train.stage"] == 1 and n["train.snapshot"] == epochs
        # one loss read an epoch and one a validation batch
        assert n["train.readback"] > epochs
        printed = [ln for ln in capsys.readouterr().out.splitlines()
                   if "device_epoch_staged_mb" in ln]
        mb = float(printed[0].split(":")[1].rstrip("}"))
        assert mb == counters()["staged_bytes"] / 2**20 > 0
    else:
        assert "train.stage" not in n
        # each host step reads its loss inside the step
        steps = {id(r) for r in log.named("train.step")}
        inner = [r for r in log.named("train.readback")
                 if id(records[r.parent]) in steps]
        assert len(inner) == out["steps"]


def test_predict_spans_carry_the_request_id():
    ds = ChemDataset(str(DEMO))
    spec = plan_spec([ds.graph(i) for i in range(len(ds))], te=64, tn=32,
                     tb=4)
    cfg = CGRMPNNConfig(num_node_features=ds.num_node_features,
                        num_edge_features=ds.num_edge_features, depth=2,
                        hidden_sizes=(8, 8), dropout_ps=(0.0, 0.0))
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").eval()
    packed = list(PackedLoader(ds, spec, batch_size=3))
    batches = len(packed)
    assert batches > 1
    before = counters()
    with span_log() as log:
        a = predict(model, ds, spec, batch_size=3, device="cpu")
        b = predict(model, ds, spec, batch_size=3, device="cpu")
    np.testing.assert_array_equal(a, b)
    first, second = log.named("predict.request")
    rid = first.attrs["request"]
    assert second.attrs["request"] == rid + 1
    mine = [r for r in log.records
            if r.attrs.get("request") == rid and r is not first]
    n = {k: sum(r.name == k for r in mine)
         for k in ("predict.pack", "predict.copy", "predict.forward",
                   "predict.readback", "predict.order")}
    # the pack of each batch, and the next() that finds the loader's end
    assert n == {"predict.pack": batches + 1, "predict.copy": batches,
                 "predict.forward": batches, "predict.readback": batches,
                 "predict.order": 1}
    assert all(log.records[r.parent] is first for r in mine)
    after = counters()
    # every prediction slot read back, f32, in each of the two calls
    slots = sum(b.graph_mask.size for b in packed)
    assert after["copy_out_bytes"] - before["copy_out_bytes"] == 2 * 4 * slots


def test_copy_in_counts_the_bytes_to_device_moves():
    ds = ChemDataset(str(DEMO))
    spec = plan_spec([ds.graph(i) for i in range(len(ds))])
    batch = next(iter(PackedLoader(ds, spec, batch_size=4)))
    before = counters()["copy_in_bytes"]
    moved = to_device(batch, "cpu")
    assert counters()["copy_in_bytes"] - before == sum(
        np.asarray(a).nbytes for a in batch) == sum(t.nbytes for t in moved)


def test_launch_counts_equal_the_module_globals(monkeypatch):
    monkeypatch.setattr(fm, "train_launches", 5)
    monkeypatch.setattr(cs, "bwd_launches", 2)
    monkeypatch.setattr(fm, "bf16_vjp_launches", fm.bf16_vjp_launches)
    _launch.count_launch(vars(fm), "bfloat16", False, "vjp_")
    got = _launch.launch_counts()
    assert got["fused_model.train_launches"] == 5
    assert got["conv_stack.bwd_launches"] == 2
    assert got["fused_model.bf16_vjp_launches"] == fm.bf16_vjp_launches >= 1
    for key, value in got.items():
        module, name = key.rsplit(".", 1)
        mod = __import__(f"cgr_mpnn_3d_tpu_torch.ops.{module}",
                         fromlist=[name])
        assert getattr(mod, name) == value
    assert {k: v for k, v in tracing.counters().items()
            if k in got} == got
