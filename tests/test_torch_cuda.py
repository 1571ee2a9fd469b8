"""The CUDA kernel on the card against its plain version (needs a GPU and
nvcc; skips elsewhere).  Run on a GPU machine with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX, which a GPU machine for
the port need not have.)
"""

import itertools

import numpy as np
import pytest
import torch

from cgr_mpnn_3d_tpu_torch.chem import RxnGraph
from cgr_mpnn_3d_tpu_torch.data import (pack_graphs, packs_needed,
                                        place_graphs, plan_spec, to_device)
from cgr_mpnn_3d_tpu_torch.data.synthetic import synthetic_graphs
from cgr_mpnn_3d_tpu_torch.models import (ACTIVATIONS, CGRMPNNConfig, apply,
                                          init_params, kernel_inputs)
from cgr_mpnn_3d_tpu_torch.ops import fused_model as fm

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(n, seed, F, device, te=256, tn=128, tb=16):
    graphs = synthetic_graphs(n, np.random.default_rng(seed),
                              node_feat_dim=F)
    spec = plan_spec(graphs, te=te, tn=tn, tb=tb)
    p = packs_needed(graphs, spec)
    while not place_graphs(graphs, spec.with_packs(p)):
        p += 1
    spec = spec.with_packs(p)
    return spec, to_device(pack_graphs(graphs, [0.0] * n, spec), device)


@pytest.mark.parametrize("act,aggr,pooling", list(itertools.product(
    ["ReLU", "SiLU", "GELU"], ["add", "mean"], ["add", "mean"])))
def test_kernel_matches_plain_version(cuda, act, aggr, pooling):
    spec, batch = _batch(120, 0, 78, cuda)
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                        depth=3, hidden_sizes=(40,) * 3,
                        dropout_ps=(0.0,) * 3, activation=act, aggr=aggr,
                        pooling=pooling, use_learnable_skip=True)
    model = init_params(cfg, torch.Generator().manual_seed(1), cuda)
    with torch.no_grad():
        for w, v in zip(model.skip_weights, (0.8, -0.3, 1.2)):
            w.fill_(v)
        args = kernel_inputs(model, batch)
        kw = dict(p=spec.p, act=ACTIVATIONS[act], aggr=aggr,
                  pooling=pooling)
        before = fm.launches
        got = fm.fused_model_forward(*args, **kw)
        assert fm.launches == before + 1
        want = fm.fused_model_forward_ref(*args, **kw)
        torch.cuda.synchronize()
    mask = batch.graph_mask > 0
    torch.testing.assert_close(got[mask], want[mask], rtol=1e-4, atol=1e-5)


def test_apply_on_card_matches_cpu(cuda):
    graphs = [RxnGraph(s).arrays for s in
              ["CCO>>CC=O", "CC(=O)N>>CC(=O)N", "C=CC=C>>C=CC=C", "O>C>CO"]]
    spec = plan_spec(graphs, te=64, tn=32, tb=8).with_packs(2)
    batch = pack_graphs(graphs, [0.0] * 4, spec)
    cfg = CGRMPNNConfig(num_node_features=78, num_edge_features=14,
                        depth=2, hidden_sizes=(16, 16),
                        dropout_ps=(0.0, 0.0))
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        want = apply(model, to_device(batch, "cpu"))
        got = apply(model.to(cuda), to_device(batch, cuda), spec).cpu()
        with pytest.raises(ValueError, match="PackSpec"):
            apply(model, to_device(batch, cuda))
    with pytest.raises(RuntimeError, match="no backward"):
        apply(model, to_device(batch, cuda), spec)
    mask = torch.from_numpy(batch.graph_mask > 0)
    torch.testing.assert_close(got[mask], want[mask], rtol=1e-4, atol=1e-5)
