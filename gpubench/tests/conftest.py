"""CPU copies of the cells at a tiny width, shared by the tests here."""

from __future__ import annotations

from gpubench import spec

# the metrics a tiny CPU run of each cell reports, without and with
# --trace 1; the readers that need a card read nothing there
REPORTED = {
    ("cgr_mpnn_3d.train_staged", False): {"train_graphs_per_s", "setup_s"},
    ("cgr_mpnn_3d.train_staged", True): {
        "device_idle.train", "validation_ms.train",
        "checkpoint_save_ms.train", "step_dispatch_us.train",
        "copy_in_mb.train"},
    ("cgr.train_staged", False): {"setup_s"},
    ("cgr.train_staged", True): {"train_graphs_per_s.host_paced"},
    ("cgr_mpnn_3d.screen", False): {"screen_graphs_per_s",
                                    "screen_request_ms_p95", "setup_s"},
    ("cgr_mpnn_3d.screen", True): {"pack_ms.screen", "device_idle.screen",
                                   "request_pack_ms.screen",
                                   "copy_in_mb.screen"},
}


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

