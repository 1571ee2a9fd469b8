"""The plain reference agrees with ``cgr_mpnn_3d_tpu_torch`` on the CPU at
a tiny width: the frozen placement, predictions, one training step's loss
and gradients under the hash dropout, and one Adam update."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench import data
from gpubench.reference import pack
from gpubench.reference.model import (Dims, adam_amsgrad, graph_set,
                                      make_weights, sse_and_grads,
                                      step_seeds)
from gpubench.reference.runs import featurize, predictions

SEED = 2**31 + 11
DIM = 4
ROWS = 200
BS = 64


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """(ChemDataset of the port, SMILES, labels, descriptors)."""
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset
    smiles, labels = data.corpus()
    idx = data.draw_rows(ROWS, SEED, "train")
    s = [smiles[i] for i in idx]
    f = data.descriptors(s, DIM, SEED, "train")
    csv, npz = data.write_split(tmp_path_factory.mktemp("d"), "train", s,
                                labels[idx], f)
    ds = ChemDataset(str(csv), str(npz))
    ds.prefeaturize()
    return ds, s, labels[idx], f


def _model(ds, depth=2, hidden=16, dropout=0.1):
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNN, CGRMPNNConfig
    d = Dims(ds.num_node_features, ds.num_edge_features, hidden, depth)
    w = make_weights(d, SEED, "cpu")
    model = CGRMPNN(CGRMPNNConfig(
        num_node_features=d.F, num_edge_features=d.Fe, depth=depth,
        hidden_sizes=(hidden,) * depth, dropout_ps=(dropout,) * depth))
    model.load_state_dict(w)
    return model, w


def _program_batches(ds):
    from cgr_mpnn_3d_tpu_torch.data import PackedLoader, plan_spec
    spec = plan_spec([ds.graph(i) for i in range(len(ds))])
    loader = PackedLoader(ds, spec, batch_size=BS, shuffle=True, seed=SEED,
                          reuse_packs=True)
    return loader, loader.cached_batches()


def _plan(s):
    graphs = featurize(s)
    geo = pack.geometry(graphs, 256, 128, 16, BS)
    return graphs, pack.plan_windows(pack.epoch_order(len(graphs), SEED),
                                     graphs.__getitem__, geo, BS)


def test_featurizer_copy_matches_the_port(rows):
    ds, s, _, _ = rows
    for i, g in enumerate(featurize(s)):
        p = ds.graph(i)
        for a, b in zip((g.node_feats, g.edge_feats, g.senders, g.receivers,
                         g.rev_edge_index),
                        (p.node_feats, p.edge_feats, p.senders, p.receivers,
                         p.rev_edge_index)):
            np.testing.assert_array_equal(a, b)


def test_frozen_plan_places_rows_as_the_loader(rows):
    """Every cached batch holds the planned rows, each graph at its
    planned pack and first edge row."""
    ds, s, _, _ = rows
    loader, cache = _program_batches(ds)
    graphs, plan = _plan(s)
    assert len(plan) == len(cache)
    te, tn = loader.spec.te, loader.spec.tn
    for batch, planned in zip(cache, plan):
        for row, pk, off in planned:
            slot = int(np.flatnonzero(batch.row_ids == row)[0])
            assert slot // loader.spec.tb == pk
            node = int(batch.graph_nodes[slot, 0])
            first = int(np.flatnonzero((batch.senders >= node) & (
                batch.senders < node + graphs[row].num_nodes))[0])
            assert node // tn == pk and first == pk * te + off


def test_predictions_match(rows):
    from cgr_mpnn_3d_tpu_torch.data import plan_spec
    from cgr_mpnn_3d_tpu_torch.train.evaluate import predict
    ds, s, _, f = rows
    model, w = _model(ds)
    spec = plan_spec([ds.graph(i) for i in range(len(ds))])
    got = predict(model.eval(), ds, spec, batch_size=128, device="cpu")
    ref = predictions(s, f, w, 2, "cpu", block=64)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_training_step_and_adam_update_match(rows):
    """The program's step on its first cached batch against the reference
    on the planned rows: the SSE, every gradient, and one Adam update."""
    from cgr_mpnn_3d_tpu_torch.data.batch import to_device
    from cgr_mpnn_3d_tpu_torch.models import fused_train_value_and_grad
    ds, s, y, f = rows
    model, w = _model(ds)
    loader, cache = _program_batches(ds)
    graphs, plan = _plan(s)
    seeds = step_seeds(SEED, 0, 2)
    sse = float(fused_train_value_and_grad(
        model, to_device(cache[0], "cpu"), loader.spec,
        torch.tensor(seeds, dtype=torch.int32)))
    batch = plan[0]
    gs = graph_set([graphs[r] for r, _, _ in batch],
                   [f[r] for r, _, _ in batch], y[[r for r, _, _ in batch]],
                   "cpu", [(pk, off) for _, pk, off in batch])
    ref_sse, ref_grads = sse_and_grads(w, gs, 2, seeds, [0.1, 0.1])
    assert abs(sse - ref_sse) <= 1e-5 * abs(ref_sse)
    named = dict(model.named_parameters())
    for n, g in ref_grads.items():
        scale = float(g.abs().max()) or 1.0
        assert float((named[n].grad - g).abs().max()) <= 1e-5 * scale, n
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, weight_decay=1e-5,
                           amsgrad=True)
    for p in model.parameters():
        p.grad = ref_grads[next(k for k, v in named.items() if v is p)]
    opt.step()
    ref_w = {n: t.clone() for n, t in w.items()}
    adam_amsgrad(ref_w, ref_grads, {}, 1, 1e-3, 1e-5)
    for n, p in named.items():
        torch.testing.assert_close(p.detach(), ref_w[n], rtol=1e-6,
                                   atol=1e-7)
