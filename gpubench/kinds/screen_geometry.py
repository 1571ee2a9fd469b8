"""Library screening from geometries: one client sends ``predict`` requests
back to back (a closed loop), each over the whole library, with the MACE
descriptors of every reaction's reactant, TS and product computed inside
the request, as the predicting entry point does with ``--mace_model``.

* inputs   the library's rows drawn from the corpus, their geometries
           (``gpubench.geometry``), and the head's and MACE's weights drawn
           on the device;
* set-up   the library written as the entry point reads it (a csv and an
           xyz), featurized and its geometries parsed, its pack plan, both
           models given the weights in eval mode, and one warm request;
* window   requests until ``--seconds`` have passed, each timed on the
           host from its call (geometries in) to its predictions in row
           order; the last request's descriptors are kept as the timed
           path made them (:class:`_Kept` around the MACE model it is
           given);
* stretch  three more requests, traced;
* check    every request's predictions against the reference's, over the
           largest (``pred_gap``) and over each row's own scale
           (``pred_gap_row``), and the last request's descriptors against
           the reference MACE's (``descriptor_gap``).
"""

from __future__ import annotations

import time

import numpy as np

from .. import compare, compare_mace, data, geometry
from ..reference import mace as ref_mace
from ..reference.chem.mol import mol_from_smiles
from ..reference.model import Dims, make_weights
from ..reference.runs import predictions

TRACED_REQUESTS = 3
WINDOW = "requests"
CONTROLS = ("tf32", "alter")
KEYS = ("cgr_node_features", "descriptor_dim", "node_features",
        "edge_features", "hidden", "depth", "dropout", "activation", "aggr",
        "pooling", "learnable_skip", "compute_dtype", "mace")
MACE_KEYS = ("channels", "interactions", "max_ell", "bessel",
             "polynomial_cutoff", "radial_mlp", "correlation", "elements",
             "r_max", "avg_num_neighbors")


def check_config(cfg: dict) -> None:
    """Raise ValueError for a configuration this runner cannot run: the
    CGR keys, the MACE block, and node features of the CGR's plus the
    three structures' descriptors of every interaction's channels."""
    data.check_cgr_config(cfg, KEYS)
    m = cfg["mace"]
    missing = sorted(set(MACE_KEYS) - set(m))
    if missing:
        raise ValueError(f"configuration {cfg.get('name')!r}: its mace "
                         f"block lacks {missing}")
    if cfg["descriptor_dim"] != m["channels"] * m["interactions"]:
        raise ValueError(
            f"configuration {cfg.get('name')!r}: descriptor_dim "
            f"{cfg['descriptor_dim']} is not channels x interactions = "
            f"{m['channels'] * m['interactions']}, so node_features "
            f"{cfg['node_features']} does not fit MACE")


def _mace_cfg(cfg: dict):
    from cgr_mpnn_3d_tpu_torch.models import MACEConfig
    m = cfg["mace"]
    return MACEConfig(
        num_channels=m["channels"], num_interactions=m["interactions"],
        max_ell=m["max_ell"], num_bessel=m["bessel"],
        num_polynomial_cutoff=m["polynomial_cutoff"],
        radial_mlp=tuple(m["radial_mlp"]), correlation=m["correlation"],
        num_elements=m["elements"], r_max=m["r_max"],
        avg_num_neighbors=m["avg_num_neighbors"])


def inputs(ctx) -> None:
    cfg = ctx.config
    smiles, labels = data.corpus()
    rows = data.draw_rows(ctx.traffic["library_rows"], ctx.seed, "library")
    s = [smiles[i] for i in rows]
    geos = geometry.geometries(s, data.rng(ctx.seed, "geometry"))
    ctx.inputs["library"] = (s, labels[rows], geos)
    ctx.inputs["weights"] = make_weights(
        Dims(cfg["node_features"], cfg["edge_features"], cfg["hidden"],
             cfg["depth"]), ctx.seed, ctx.device)
    ctx.inputs["mace_weights"] = ref_mace.make_weights(
        cfg["mace"], ctx.seed, ctx.device)


def setup(ctx) -> None:
    from cgr_mpnn_3d_tpu_torch.data import GeometryDataset, plan_spec
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNN, CGRMPNNConfig, MACE

    cfg = ctx.config
    s, y, geos = ctx.inputs["library"]
    csv, _ = data.write_split(ctx.tmp / "library", "library", s, y, None)
    xyz = geometry.write_xyz(ctx.tmp / "library" / "library.xyz", geos)
    library = GeometryDataset(str(csv), str(xyz))
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
    mace = MACE(_mace_cfg(cfg))
    mace.load_state_dict(ctx.inputs["mace_weights"])
    mace = mace.to(ctx.device).eval()
    ctx.program.update(model=model.to(ctx.device).eval(), mace=mace,
                       kept=_Kept(mace), library=library, spec=spec,
                       batch_size=ctx.traffic["batch_size"])
    _request(ctx)
    ctx.program["rows"] = _window_rows(ctx)


class _Kept:
    """The program's MACE as ``predict`` is given it: ``descriptors`` is the
    model's, and each call's (structure offsets, descriptors) is kept in
    ``calls``, which every request starts afresh."""

    def __init__(self, mace):
        self.mace, self.cfg, self.calls = mace, mace.cfg, []

    def descriptors(self, pos, z, struct_ptr, tiles, n_edges):
        out = self.mace.descriptors(pos, z, struct_ptr, tiles, n_edges)
        self.calls.append((struct_ptr, out))
        return out


def _window_rows(ctx) -> list:
    """The rows of each window a request packs, in slot order (the pack
    plan is fixed, so every request packs the same windows)."""
    from cgr_mpnn_3d_tpu_torch.data.loader import PackedLoader
    p = ctx.program
    return [np.asarray(b.row_ids)[np.asarray(b.graph_mask) > 0]
            for b in PackedLoader(p["library"], p["spec"],
                                  batch_size=p["batch_size"])]


def _request(ctx):
    from cgr_mpnn_3d_tpu_torch.train.evaluate import predict
    p = ctx.program
    p["kept"].calls = []
    return predict(p["model"], p["library"], p["spec"],
                   batch_size=p["batch_size"], device=ctx.device,
                   mace=p["kept"])


def window(ctx) -> None:
    answers, seconds, failed, kept = [], [], 0, []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        try:
            answers.append(_request(ctx))
            kept = ctx.program["kept"].calls
        except (RuntimeError, ValueError):
            failed += 1
            answers.append(None)
        end = time.perf_counter()
        seconds.append(end - t)
        if end - t0 >= ctx.seconds:
            break
    rows = ctx.program["rows"]
    ctx.out = {"answers": answers, "descriptors": [
        (r, ptr.cpu().numpy(), d.cpu().numpy())
        for r, (ptr, d) in zip(rows, kept)] if len(kept) == len(rows)
        else []}
    ctx.window = {"seconds": end - t0, "request_s": seconds,
                  "graphs": len(answers) * len(ctx.inputs["library"][0]),
                  "attempted": len(answers), "failed": failed}


def stretch(ctx) -> None:
    for _ in range(TRACED_REQUESTS):
        _request(ctx)


def _xyz_rank(smiles: str) -> np.ndarray:
    """Graph node i's xyz atom: the rank of its map number."""
    maps = [a.map_num for a in mol_from_smiles(smiles.split(">")[0]).atoms]
    return np.argsort(np.argsort(maps, kind="stable"))


def reference(ctx, tf32: bool = False) -> tuple[list, np.ndarray]:
    """(the reference MACE's descriptors of every row's three structures,
    [n, D] numpy in xyz order a structure; its predictions of every
    row)."""
    s, _, geos = ctx.inputs["library"]
    structures = [(z - 1, pos[k]) for z, pos in geos for k in range(3)]
    desc = [d.cpu().numpy() for d in ref_mace.descriptors(
        structures, ctx.inputs["mace_weights"], ctx.config["mace"],
        ctx.device, tf32=tf32)]
    feats = []
    for i, smi in enumerate(s):
        order = _xyz_rank(smi)
        feats.append(np.concatenate([desc[3 * i + k][order]
                                     for k in range(3)], 1))
    preds = predictions(s, feats, ctx.inputs["weights"],
                        ctx.config["depth"], ctx.device, tf32=tf32)
    return desc, preds


def check(ctx, looks: bool = False, tf32: bool = False,
          alter: bool = False) -> dict:
    """``pred_gap``, ``pred_gap_row`` and ``descriptor_gap``, widest gaps
    already (``looks`` adds nothing)."""
    desc, ref = reference(ctx)
    if tf32 or alter:
        d_ans, answer = reference(ctx, tf32=tf32)
        if alter:
            answer[np.argsort(np.abs(answer))[len(answer) // 2]] += 1.0
            d_ans[0] = d_ans[0].copy()
            d_ans[0].flat[0] += 1e-3 * max(np.abs(d).max() for d in d_ans)
        answers = [answer]
        blocks = [(d_ans[i], d) for i, d in enumerate(desc)]
    else:
        answers = [a if a is not None else () for a in ctx.out["answers"]]
        blocks = compare_mace.program_blocks(ctx.out["descriptors"], desc)
    return {"pred_gap": compare.prediction_gap(answers, ref),
            "pred_gap_row": compare_mace.row_prediction_gap(answers, ref),
            "descriptor_gap": compare_mace.descriptor_gap(blocks)}


def control(ctx, variant: str, looks: bool = False) -> dict:
    """The gaps with the reference in the program's place: computed in
    TF32 (``"tf32"``: the radial MLP's and the head's products), or with
    the median row's answer off by 1 and one descriptor off by a
    thousandth of the largest (``"alter"``)."""
    return check(ctx, looks, **{variant: True})
