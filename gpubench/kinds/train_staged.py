"""Training in staged epochs: ``RxnGraphTrainer(reuse_packs=True,
device_epoch=True).train()``, the README recipe's fast mode.

* inputs   train and val rows drawn from the corpus with their synthetic
           descriptors, and the initial weights drawn on the device;
* set-up   the splits written as the training entry point reads them, the
           datasets featurized, the trainer built and given the weights;
           epoch 0 (staging, every kernel built, validation, checkpoint)
           with its first three steps kept (each loss, the first step's
           gradients, the parameters after the third); then epochs 1 to
           ``val_frequency`` in one call, timed: a validation period as
           the window runs it, which sets the window's length;
* window   one ``train()`` call over a whole number of validation periods
           (``val_frequency`` epochs) that lasts about ``--seconds``: every
           step, validation and per-epoch checkpoint; the state it starts
           from (parameters, Adam's moments) is copied before it, and its
           first three steps are kept as epoch 0's;
* stretch  one more validation period, traced;
* check    the reference follows epoch 0's first three steps from the
           initial weights, and the window's from the state it started
           from, at that epoch's learning rate, order and dropout seeds.
"""

from __future__ import annotations

import math
import os
import time

import torch

from .. import compare, data
from ..reference.model import Dims, make_weights
from ..reference.runs import first_steps

STEPS = 3
WINDOW = "epochs"
CONTROLS = ("tf32", "half")
# the configuration's keys that this runner and its readers read
KEYS = ("cgr_node_features", "descriptor_dim", "node_features",
        "edge_features", "hidden", "depth", "dropout", "activation", "aggr",
        "pooling", "learnable_skip", "compute_dtype", "lr", "gamma",
        "weight_decay", "betas", "eps", "batch_size", "te", "tn", "tb")


def check_config(cfg: dict) -> None:
    """Raise ValueError for a configuration this runner cannot run."""
    data.check_cgr_config(cfg, KEYS)


def _dims(cfg: dict) -> Dims:
    return Dims(cfg["node_features"], cfg["edge_features"], cfg["hidden"],
                cfg["depth"])


def inputs(ctx) -> None:
    cfg, trf = ctx.config, ctx.traffic
    smiles, labels = data.corpus()
    dim = cfg["descriptor_dim"]
    for split in ("train", "val"):
        rows = data.draw_rows(trf[f"{split}_rows"], ctx.seed, split)
        s = [smiles[i] for i in rows]
        ctx.inputs[split] = (s, labels[rows], data.descriptors(
            s, dim, ctx.seed, split) if dim else None)
    ctx.inputs["weights"] = make_weights(_dims(cfg), ctx.seed, ctx.device)


def _hp(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("depth", "dropout", "lr", "gamma",
                                "weight_decay",
                                "betas", "eps", "batch_size", "te", "tn",
                                "tb")}


class _Capture:
    """The program over its next ``steps`` optimizer steps: each step's
    loss, the first step's gradients as the optimizer gets them, and the
    parameters after the last; then it takes itself off, so that the steps
    after pay nothing."""

    def __init__(self, trainer, steps: int):
        self.trainer, self.steps, self.n = trainer, steps, 0
        self.losses, self.g1, self.p = [], None, None
        named = list(trainer.model.named_parameters())
        opt = trainer.optimizer
        grads = trainer._grads

        def wrapped(batch, seeds):
            loss = grads(batch, seeds)
            self.losses.append(loss.detach().clone())
            return loss

        def unhook(batch, seeds):
            # off from the step after the last: a hook cannot take itself
            # off while the optimizer runs its hooks
            self.close()
            return grads(batch, seeds)

        def before_step(*_):
            if self.g1 is None:
                self.g1 = {n: p.grad.detach().clone() for n, p in named}

        def after_step(*_):
            self.n += 1
            if self.n == steps:
                self.p = {n: p.detach().clone() for n, p in named}
                self.pre.remove()
                trainer._grads = unhook

        trainer._grads = wrapped
        self.pre = opt.register_step_pre_hook(before_step)
        self.post = opt.register_step_post_hook(after_step)

    def close(self) -> None:
        self.pre.remove()
        self.post.remove()
        self.trainer.__dict__.pop("_grads", None)

    def result(self) -> dict:
        self.close()
        if self.p is None:
            raise RuntimeError(f"the epoch ran {self.n} optimizer steps, "
                               f"fewer than {self.steps}")
        return {"losses": [float(v) for v in self.losses[:self.steps]],
                "g1": self.g1, "p": self.p}


def _epochs(ctx, n: int) -> dict:
    """``n`` more epochs in one ``train()`` call."""
    trainer = ctx.program["trainer"]
    trainer.start_epoch = ctx.program["next_epoch"]
    trainer.num_epochs = trainer.start_epoch + n
    ctx.program["next_epoch"] += n
    return trainer.train()


def setup(ctx) -> None:
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, plan_spec
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig
    from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer

    cfg, trf = ctx.config, ctx.traffic
    workers = max(1, (os.cpu_count() or 2) // 2)
    sets = {}
    for split in ("train", "val"):
        s, y, f = ctx.inputs[split]
        csv, npz = data.write_split(ctx.tmp / "datasets", split, s, y, f)
        sets[split] = ChemDataset(str(csv), None if npz is None
                                  else str(npz))
        sets[split].prefeaturize(num_workers=workers, cache=True)
    train = sets["train"]
    ctx.mark("datasets")
    if (train.num_node_features, train.num_edge_features) != (
            cfg["node_features"], cfg["edge_features"]):
        raise ValueError("the featurized widths differ from the "
                         "configuration's")
    spec = plan_spec([train.graph(i) for i in range(len(train))],
                     te=cfg["te"], tn=cfg["tn"], tb=cfg["tb"])
    model_cfg = CGRMPNNConfig(
        num_node_features=cfg["node_features"],
        num_edge_features=cfg["edge_features"], depth=cfg["depth"],
        hidden_sizes=(cfg["hidden"],) * cfg["depth"],
        dropout_ps=(cfg["dropout"],) * cfg["depth"],
        activation=cfg["activation"], aggr=cfg["aggr"],
        pooling=cfg["pooling"], use_learnable_skip=cfg["learnable_skip"],
        compute_dtype=cfg["compute_dtype"])
    trainer = RxnGraphTrainer(
        name=ctx.cell, cfg=model_cfg, train_data=train,
        val_data=sets["val"], spec=spec, lr=cfg["lr"],
        weight_decay=cfg["weight_decay"], gamma=cfg["gamma"], num_epochs=1,
        batch_size=cfg["batch_size"], val_frequency=trf["val_frequency"],
        model_save_dir=str(ctx.tmp / "saved"), seed=ctx.seed,
        device=ctx.device, reuse_packs=trf["reuse_packs"],
        device_epoch=trf["device_epoch"])
    trainer.model.load_state_dict(ctx.inputs["weights"])
    ctx.program.update(trainer=trainer, spec=trainer.train_loader.spec,
                       next_epoch=0)
    ctx.mark("trainer")
    cap = _Capture(trainer, STEPS)
    try:
        _epochs(ctx, 1)
    finally:
        ctx.out["start"] = cap.result()
    ctx.mark("epoch0")
    t0 = time.perf_counter()
    _epochs(ctx, trf["val_frequency"])
    _sync(ctx)
    ctx.program["period_s"] = time.perf_counter() - t0


def _sync(ctx) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def window(ctx) -> None:
    period = ctx.traffic["val_frequency"]
    n = period * max(1, round(ctx.seconds / ctx.program["period_s"]))
    trainer = ctx.program["trainer"]
    steps = len(trainer.train_loader.cached_batches())
    ctx.out["window_from"] = _state(trainer, ctx.program["next_epoch"])
    cap = _Capture(trainer, STEPS)
    failed = 0
    t0 = time.perf_counter()
    try:
        _epochs(ctx, n)
    except FloatingPointError:
        failed = 1
    _sync(ctx)
    end = time.perf_counter()
    cap.close()
    ctx.out["window"] = None if failed else cap.result()
    ctx.window = {"seconds": end - t0, "epochs": n,
                  "graphs": n * len(ctx.inputs["train"][0]),
                  "attempted": n * steps, "failed": failed}


def _state(trainer, epoch: int) -> dict:
    """A copy of the training state before ``epoch``: the parameters and
    Adam's moments by name."""
    keys = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")
    with torch.no_grad():
        named = list(trainer.model.named_parameters())
        return {"epoch": epoch,
                "p": {n: p.detach().clone() for n, p in named},
                "adam": {n: [trainer.optimizer.state[p][k].clone()
                             for k in keys] for n, p in named}}


def stretch(ctx) -> None:
    _epochs(ctx, ctx.traffic["val_frequency"])


def _stretches(ctx, looks: bool, control: dict) -> list[dict]:
    """Each stretch's numbers: epoch 0's first steps from the initial
    weights, then the window's from the state it started from (the
    program's own: the reference cannot follow every step in between, as a
    ReLU input within rounding of 0 makes two sound runs part)."""
    s, y, f = ctx.inputs["train"]
    hp = _hp(ctx.config)
    w0 = ctx.out["window_from"]
    starts = [("start", ctx.inputs["weights"], {}),
              ("window", w0["p"], {"epoch": w0["epoch"], "adam": w0["adam"]})]
    out = []
    for name, p0, at in starts:
        ref = first_steps(s, f, y, p0, hp, ctx.seed, ctx.device, STEPS,
                          **at)
        prog = ctx.out[name] if not control else first_steps(
            s, f, y, p0, hp, ctx.seed, ctx.device, STEPS, **at, **control)
        if prog is None:
            out.append({})
            continue
        nums = compare.training_gaps(prog, ref, p0)
        if looks:
            nums.update(compare.training_looks(prog, ref, p0))
        out.append(nums)
    return out


def check(ctx, looks: bool = False, **control) -> dict:
    """The compared numbers, each the larger of the two stretches' (with
    ``looks``, also each stretch's numbers under "start" and "window")."""
    parts = _stretches(ctx, looks, control)
    names = ("loss_gap", "grad_gap_worst", "head_grad_gap", "update_gap")
    out = {k: max(p.get(k, math.inf) for p in parts) for k in names}
    if looks:
        out.update(start=parts[0], window=parts[1])
    return out


def control(ctx, variant: str, looks: bool = False) -> dict:
    """The numbers with the reference in the program's place: computed in
    TF32 (``"tf32"``), or with half of each batch left out and the SSE of
    the rest doubled (``"half"``)."""
    return check(ctx, looks, **{variant: True})
