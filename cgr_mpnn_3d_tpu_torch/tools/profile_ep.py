"""Micro-profile of the EP forward's parts on one card, at bf16.

The counterpart of ``tools/profile_ep.py``: it packs ``--graphs`` seeded
synthetic graphs (F = 78 + 192, sorted by size) for one shard at te 128 /
tn 64 and times each hot op of the EP forward alone, then the EP forward
and forward + backward, with the README model (depth 4, hidden 400,
``compute_dtype="bfloat16"``).  Rows, in the JAX tool's order (its
``main`` rows, then its ``--fused`` rows):

    K7 inc [PE->PN]            ops/onehot_spmm.py on bf16 h (spmm_t inc)
    K7 src_gather [PN->PE]     the same on f32 node rows
    plain node_incoming_sum    ops/segment.py (the XLA ELL sum)
    plain gather_nodes src     ops/segment.py (the XLA gather)
    pairswap                   the reverse-edge swap of the XLA path
    dense lin [PE,H]x[H,H]     torch.matmul on bf16 (a yardstick)
    edge_init x_src gather     K7 on bf16 x
    pool node_incoming_sum     the XLA pool over graph_nodes
    ep fwd / ep fwd+bwd        parallel/ep_pack.py at n_ep 1 (zero cut:
                               K5, K4, K11)
    K6 fwd                     fused_conv_layer fwd (ops/fused_conv.py)
    K10 readout fwd            gather_linear_r_forward, r_s = 0: the only
                               caller of K10, as in JAX
    pool ELL fwd               node_incoming_sum over graph_nodes
    K5 edge_init fwd           gather_linear_forward (bf16 output)

JAX's ``msg_t build`` row has no counterpart: the port's packer builds the
ELL arrays on the host.  Each row is the best of ``--repeats`` runs of
``--steps`` calls between two CUDA events, after a warm-up call.
``--cpu`` runs every row on the CPU (plain versions, host clock: the CPU's
times, not the card's).

  python -m cgr_mpnn_3d_tpu_torch.tools.profile_ep [--cpu] [--graphs 2500]
      [--steps 32] [--repeats 3]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

__all__ = ["main", "ROWS"]

ROWS = ("K7 inc [PE->PN]", "K7 src_gather [PN->PE]",
        "plain node_incoming_sum inc", "plain gather_nodes src", "pairswap",
        "dense lin [PE,H]x[H,H]", "edge_init x_src gather [PN->PE,F]",
        "pool node_incoming_sum", "ep fwd", "ep fwd+bwd", "K6 fwd",
        "K10 readout fwd", "pool ELL fwd", "K5 edge_init fwd")


def main(argv=None) -> dict:
    """Time every row and print it; returns {"device", "spec", "ms": {row:
    ms per call}, "launches": K10's launches in its row}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--graphs", type=int, default=2500)
    ap.add_argument("--hidden", type=int, default=400)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..data.synthetic import synthetic_graphs
    from ..models import CGRMPNNConfig, init_params
    from ..ops import gather_linear as gl
    from ..ops.fused_conv import fused_conv_forward
    from ..ops.onehot_spmm import onehot_spmm
    from ..ops.segment import gather_nodes, node_incoming_sum
    from ..parallel import ep_pack_forward, ep_shards, pack_shard_edges
    from ..utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    nf, H, md = 78 + 192, args.hidden, "bfloat16"
    graphs = synthetic_graphs(args.graphs, np.random.default_rng(args.seed),
                              node_feat_dim=nf)
    graphs.sort(key=lambda g: -g.num_edges)
    host, spec = pack_shard_edges(graphs, [0.0] * len(graphs), 1, te=128,
                                  tn=64)
    b = ep_shards(host, dev)[0]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={kind} spec: p={spec.p}, d={spec.d}, d2={spec.d2}, "
          f"dn={spec.dn}, b={spec.b}, pe={spec.pe}, pn={spec.pn}")
    cfg = CGRMPNNConfig(num_node_features=nf, num_edge_features=14, depth=4,
                        hidden_sizes=(H,) * 4, dropout_ps=(0.0,) * 4,
                        compute_dtype=md, fuse_whole_model=False)
    model = init_params(cfg, torch.Generator().manual_seed(args.seed), dev)
    p, PE, PN = spec.p, spec.pe, spec.pn
    h = torch.ones((PE, H), device=dev, dtype=torch.bfloat16)
    a_nodes = torch.ones((PN, H), device=dev)
    x = torch.ones((PN, nf), device=dev, dtype=torch.bfloat16)
    e = b.edge_attr.to(torch.bfloat16)
    w16 = model.convs[0].w.to(torch.bfloat16)
    skip = torch.ones((), device=dev)
    r_s = torch.zeros((PN, H), device=dev)
    wei, wen = model.edge_init, model.edge_to_node
    k7 = dict(p=p, mat_dtype=md)

    def ep_fwd():
        with torch.no_grad():
            ep_pack_forward(model, [b], spec)

    def ep_fwd_bwd():
        model.zero_grad(set_to_none=True)
        ep_pack_forward(model, [b], spec)[0].backward()

    calls = {
        ROWS[0]: lambda: onehot_spmm(h, b.node_inc, **k7),
        ROWS[1]: lambda: onehot_spmm(a_nodes, b.senders[:, None], **k7),
        ROWS[2]: lambda: node_incoming_sum(h, b.node_inc),
        ROWS[3]: lambda: gather_nodes(a_nodes, b.senders),
        ROWS[4]: lambda: h.reshape(-1, 2, H).flip(1).reshape(h.shape),
        ROWS[5]: lambda: torch.matmul(h, w16),
        ROWS[6]: lambda: onehot_spmm(x, b.senders[:, None], **k7),
        ROWS[7]: lambda: node_incoming_sum(a_nodes, b.graph_nodes),
        ROWS[10]: lambda: fused_conv_forward(
            h, h, b.edge_nbr, b.rev, model.convs[0].w, model.convs[0].b,
            skip, p=p, mat_dtype=md),
        ROWS[11]: lambda: gl.gather_linear_r_forward(
            h, r_s, x, b.node_inc, wen.w[nf:], wen.w[:nf], wen.b, p=p,
            mat_dtype=md),
        ROWS[12]: lambda: node_incoming_sum(a_nodes, b.graph_nodes),
        ROWS[13]: lambda: gl.gather_linear_forward(
            x, e, b.senders[:, None], wei.w[:nf], wei.w[nf:], wei.b, p=p,
            mat_dtype=md, out_dtype=md)}
    calls[ROWS[8]], calls[ROWS[9]] = ep_fwd, ep_fwd_bwd

    def seconds(fn) -> float:
        fn()                                  # build + warm up
        best = float("inf")
        for _ in range(args.repeats):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.steps):
                    fn()
                end.record()
                torch.cuda.synchronize(dev)
                t = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    fn()
                t = time.perf_counter() - t0
            best = min(best, t / args.steps)
        return best

    ms = {}
    for name in ROWS:
        before = gl.bf16_r_launches
        with torch.no_grad() if name != ROWS[9] else torch.enable_grad():
            ms[name] = seconds(calls[name]) * 1e3
        if name == ROWS[11]:
            launches = gl.bf16_r_launches - before
        print(f"{name:34s} {ms[name]:8.3f} ms/iter")
    return {"device": kind, "spec": vars(spec), "ms": ms,
            "launches": launches}


if __name__ == "__main__":
    main()
