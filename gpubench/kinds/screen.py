"""Library screening: one client sends ``predict`` requests back to back
(a closed loop), each over the whole library, as the predicting entry
point calls it with its ``--batch_size``.

* inputs   the library's rows drawn from the corpus with their synthetic
           descriptors, and the weights drawn on the device;
* set-up   the library written as the entry point reads it and featurized
           (the feature cache of a repeat screen), its pack plan, the model
           given the weights in eval mode, and one warm request;
* window   requests until ``--seconds`` have passed, each timed on the
           host from its call to its predictions in row order;
* stretch  three more requests, traced;
* check    every request's predictions against the reference's.
"""

from __future__ import annotations

import time

from .. import compare, data
from ..reference.model import Dims, make_weights
from ..reference.runs import predictions

TRACED_REQUESTS = 3
WINDOW = "requests"
CONTROLS = ("tf32", "alter")
# the configuration's keys that this runner and its readers read
KEYS = ("cgr_node_features", "descriptor_dim", "node_features",
        "edge_features", "hidden", "depth", "dropout", "activation", "aggr",
        "pooling", "learnable_skip", "compute_dtype")


def check_config(cfg: dict) -> None:
    """Raise ValueError for a configuration this runner cannot run."""
    data.check_cgr_config(cfg, KEYS)


def inputs(ctx) -> None:
    cfg = ctx.config
    smiles, labels = data.corpus()
    rows = data.draw_rows(ctx.traffic["library_rows"], ctx.seed, "library")
    s = [smiles[i] for i in rows]
    dim = cfg["descriptor_dim"]
    ctx.inputs["library"] = (s, labels[rows], data.descriptors(
        s, dim, ctx.seed, "library") if dim else None)
    ctx.inputs["weights"] = make_weights(
        Dims(cfg["node_features"], cfg["edge_features"], cfg["hidden"],
             cfg["depth"]), ctx.seed, ctx.device)


def setup(ctx) -> None:
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, plan_spec
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNN, CGRMPNNConfig

    cfg = ctx.config
    s, y, f = ctx.inputs["library"]
    csv, npz = data.write_split(ctx.tmp / "library", "library", s, y, f)
    library = ChemDataset(str(csv), None if npz is None else str(npz))
    library.prefeaturize()
    ctx.mark("library")
    spec = plan_spec([library.graph(i) for i in range(len(library))])
    model = CGRMPNN(CGRMPNNConfig(
        num_node_features=cfg["node_features"],
        num_edge_features=cfg["edge_features"], depth=cfg["depth"],
        hidden_sizes=(cfg["hidden"],) * cfg["depth"],
        dropout_ps=(cfg["dropout"],) * cfg["depth"],
        activation=cfg["activation"], aggr=cfg["aggr"],
        pooling=cfg["pooling"], use_learnable_skip=cfg["learnable_skip"],
        compute_dtype=cfg["compute_dtype"]))
    model.load_state_dict(ctx.inputs["weights"])
    model = model.to(ctx.device).eval()
    ctx.program.update(model=model, library=library, spec=spec,
                       batch_size=ctx.traffic["batch_size"])
    _request(ctx)


def _request(ctx):
    from cgr_mpnn_3d_tpu_torch.train.evaluate import predict
    p = ctx.program
    return predict(p["model"], p["library"], p["spec"],
                   batch_size=p["batch_size"], device=ctx.device)


def window(ctx) -> None:
    answers, seconds, failed = [], [], 0
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        try:
            answers.append(_request(ctx))
        except (RuntimeError, ValueError):
            failed += 1
            answers.append(None)
        end = time.perf_counter()
        seconds.append(end - t)
        if end - t0 >= ctx.seconds:
            break
    ctx.out = {"answers": answers}
    ctx.window = {"seconds": end - t0, "request_s": seconds,
                  "graphs": len(answers) * len(ctx.inputs["library"][0]),
                  "attempted": len(answers), "failed": failed}


def stretch(ctx) -> None:
    for _ in range(TRACED_REQUESTS):
        _request(ctx)


def check(ctx, looks: bool = False, tf32: bool = False,
          alter: bool = False) -> dict:
    """``pred_gap``, a widest gap already (``looks`` adds nothing)."""
    s, _, f = ctx.inputs["library"]
    depth = ctx.config["depth"]
    ref = predictions(s, f, ctx.inputs["weights"], depth, ctx.device)
    if tf32 or alter:
        answer = predictions(s, f, ctx.inputs["weights"], depth, ctx.device,
                             tf32=tf32)
        if alter:
            answer[0] += 1.0
        answers = [answer]
    else:
        answers = [a if a is not None else () for a in ctx.out["answers"]]
    return {"pred_gap": compare.prediction_gap(answers, ref)}


def control(ctx, variant: str, looks: bool = False) -> dict:
    """``pred_gap`` with the reference in the program's place: computed in
    TF32 (``"tf32"``), or with one answer altered (``"alter"``)."""
    return check(ctx, looks, **{variant: True})
