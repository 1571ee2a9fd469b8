"""The comparison that decides ``correct`` fails what it must: a run of
the harness on the CPU at a tiny width (the look for a card skipped) with
the timed path broken underneath comes out not correct, also where the
fault acts only past the first epoch or on one leaf's gradient; a sound
run comes out correct, and the control (the reference put in the
program's place in TF32) fails one of the cell's numbers under the cell's
own limits."""

from __future__ import annotations

import importlib
import tempfile
from pathlib import Path

import pytest
import torch

from gpubench import run, spec
from gpubench.tests.conftest import tiny

SEED = 2**31 + 7
TRAIN_CELLS = ["cgr_mpnn_3d.train_staged", "cgr.train_staged"]
SCREEN = "cgr_mpnn_3d.screen"


def _run(cell: str) -> dict:
    cfg, trf = tiny(cell)
    return run.run_cell(cell, SEED, 0.2, False, device="cpu", config=cfg,
                        traffic=trf)


def _frozen_lr(optimizer, lr, gamma, epoch):
    """A step that returns its state unchanged: every update of size 0."""
    for group in optimizer.param_groups:
        group["lr"] = 0.0


def _frozen_after_first(set_epoch_lr):
    """The state left unchanged from the second epoch on."""
    def plant(optimizer, lr, gamma, epoch):
        set_epoch_lr(optimizer, lr if epoch == 0 else 0.0, gamma, epoch)
    return plant


def _no_decay(set_epoch_lr):
    """The learning rate's decay left out: every epoch at epoch 0's."""
    def plant(optimizer, lr, gamma, epoch):
        set_epoch_lr(optimizer, lr, gamma, 0)
    return plant


def _conv_grad_doubled(orig):
    """One conv layer's weight gradient twice its size (as a dropout
    scale left out would make it): Adam's update hides it."""
    def step(model, batch, spec, seeds=None):
        sse = orig(model, batch, spec, seeds)
        dict(model.named_parameters())["convs.0.w"].grad.mul_(2.0)
        return sse
    return step


def _half_batch(orig):
    """Half of the batch left out, the mean taken over the rest: the SSE of
    the earlier half of the real graphs, and its gradients, doubled."""
    def step(model, batch, spec, seeds=None):
        mask = batch.graph_mask.clone()
        real = torch.nonzero(mask).flatten()
        mask[real[(len(real) + 1) // 2:]] = 0.0
        sse = orig(model, batch._replace(graph_mask=mask), spec, seeds)
        for p in model.parameters():
            p.grad.mul_(2.0)
        return 2.0 * sse
    return step


def _altered(orig):
    """An answer altered where it is produced: the first slot's prediction
    of every batch moved by 1."""
    def apply(model, batch, spec=None, **kw):
        out = orig(model, batch, spec, **kw).clone()
        out[0] += 1.0
        return out
    return apply


def _half_answers(orig):
    """Half of each batch left out: the later half of the slots' answers
    never computed (left at 0)."""
    def apply(model, batch, spec=None, **kw):
        out = orig(model, batch, spec, **kw).clone()
        out[out.shape[0] // 2:] = 0.0
        return out
    return apply


@pytest.mark.parametrize("cell", TRAIN_CELLS + [SCREEN])
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "state_unchanged_after_first_epoch",
                                   "conv_grad_doubled"])
def test_training_fault_is_not_correct(cell, fault, monkeypatch):
    trainer = importlib.import_module("cgr_mpnn_3d_tpu_torch.train.trainer")
    if fault == "state_unchanged":
        monkeypatch.setattr(trainer, "set_epoch_lr", _frozen_lr)
    elif fault == "state_unchanged_after_first_epoch":
        monkeypatch.setattr(trainer, "set_epoch_lr",
                            _frozen_after_first(trainer.set_epoch_lr))
    else:
        plant = (_half_batch if fault == "half_batch"
                 else _conv_grad_doubled)
        monkeypatch.setattr(trainer, "fused_train_value_and_grad",
                            plant(trainer.fused_train_value_and_grad))
    r = _run(cell)
    assert not r["correct"], r["checks"]


def test_learning_rate_decay_left_out_is_not_correct(monkeypatch):
    """Only the 3D cell decays its learning rate (gamma 0.9); the decay
    first acts in the window, past epoch 0."""
    trainer = importlib.import_module("cgr_mpnn_3d_tpu_torch.train.trainer")
    monkeypatch.setattr(trainer, "set_epoch_lr",
                        _no_decay(trainer.set_epoch_lr))
    r = _run("cgr_mpnn_3d.train_staged")
    assert not r["correct"], r["checks"]
    assert r["checks"]["update_gap"]["value"] > 10 * r["checks"][
        "update_gap"]["limit"]


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
def test_screen_fault_is_not_correct(fault, monkeypatch):
    evaluate = importlib.import_module(
        "cgr_mpnn_3d_tpu_torch.train.evaluate")
    plant = _altered if fault == "altered_answer" else _half_answers
    monkeypatch.setattr(evaluate, "apply", plant(evaluate.apply))
    r = _run(SCREEN)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", TRAIN_CELLS + [SCREEN])
def test_control_fails_a_limit(cell):
    cfg, trf = tiny(cell)
    lim = spec.limits(cell)
    drv = spec.kind(trf["kind"])
    for seed in (SEED, SEED + 1, SEED + 2):
        with tempfile.TemporaryDirectory() as tmp:
            ctx = run.Context(cell, seed, 0.2, False, torch.device("cpu"),
                              cfg, trf, Path(tmp), 0.0)
            drv.inputs(ctx)
            drv.setup(ctx)
            drv.window(ctx)
            numbers = drv.control(ctx, "tf32")
        assert any(v > lim[k] for k, v in numbers.items()), numbers
