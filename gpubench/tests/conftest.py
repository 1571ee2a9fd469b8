"""CPU copies of the cells at a tiny width, shared by the tests here."""

from __future__ import annotations

from gpubench import spec


def tiny(cell: str) -> tuple[dict, dict]:
    """(config, traffic) of ``cell`` at hidden 16, depth 2, 4 descriptors
    a structure and a few hundred rows; the cell's hyperparameters and
    limits are kept."""
    bench = spec.benchmark()
    w = spec.workload(bench, cell)
    cfg = spec.config(bench, w["config"])
    dim = 4 if cfg["descriptor_dim"] else 0
    cfg.update(hidden=16, depth=2, descriptor_dim=dim,
               node_features=cfg["cgr_node_features"] + 3 * dim)
    trf = spec.traffic(w["traffic"])
    trf.update({k: v for k, v in (("train_rows", 300), ("val_rows", 60),
                                  ("library_rows", 400),
                                  ("batch_size", 128)) if k in trf})
    return cfg, trf

