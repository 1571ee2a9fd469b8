"""The PyTorch port stands alone: no JAX and nothing of the JAX package in
any of its modules or in chip_smoke.py, and no silent CPU fallback."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "cgr_mpnn_3d_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "cgr_mpnn_3d_tpu"


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter (tests/conftest.py imports jax in this one)
    imports every module of the port; neither jax nor the JAX package may
    appear in sys.modules."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import cgr_mpnn_3d_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__,"
        " p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps({'mods': mods, 'loaded': sorted(sys.modules)}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, check=True,
                         timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["mods"]) >= 20
    assert [m for m in res["loaded"] if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]))
def test_source_imports_no_jax(path):
    """No import statement of the port or of chip_smoke.py names jax or
    the JAX package, even one that would only run inside a function."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_resolve_device(no_cuda):
    from cgr_mpnn_3d_tpu_torch.utils import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """Called without device="cpu", every entry point raises instead of
    running on the CPU."""
    from cgr_mpnn_3d_tpu_torch.cli.predict import (
        activation_energy_prediction, main)
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, PackSpec
    from cgr_mpnn_3d_tpu_torch.data.descriptors import \
        synthetic_descriptors_npz
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig, init_params
    from cgr_mpnn_3d_tpu_torch.train import (evaluate, load_model, predict,
                                             save_checkpoint)

    cfg = CGRMPNNConfig(num_node_features=90, num_edge_features=14, depth=2,
                        hidden_sizes=(8, 8), dropout_ps=(0.0, 0.0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ckpt = save_checkpoint(tmp_path / "m.npz", model, {"model": {
        "num_node_features": 90, "num_edge_features": 14, "depth": 2,
        "hidden_sizes": [8, 8], "dropout_ps": [0.0, 0.0]}})
    demo = REPO / "examples" / "demo.csv"
    synthetic_descriptors_npz(demo, tmp_path / "d.npz", 4)
    ds = ChemDataset(str(demo), data_npz_path=str(tmp_path / "d.npz"))
    for call in (lambda: load_model(ckpt),
                 lambda: predict(model, ds, PackSpec()),
                 lambda: evaluate(model, ds, PackSpec()),
                 lambda: activation_energy_prediction(
                     str(demo), model_path=str(ckpt),
                     npz_path=str(tmp_path / "d.npz")),
                 lambda: main(["--data_path_smiles", str(demo),
                               "--data_path_model", str(ckpt),
                               "--data_path_npz", str(tmp_path / "d.npz")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the same request runs when the CPU is asked for
    res = activation_energy_prediction(
        str(demo), model_path=str(ckpt), npz_path=str(tmp_path / "d.npz"),
        device="cpu", output_results=str(tmp_path / "r.txt"))
    assert len(res) == 10
    assert np.isfinite([r["Activation Energy"] for r in res]).all()


def test_predict_without_descriptor_npz_names_the_missing_step(tmp_path):
    from cgr_mpnn_3d_tpu_torch.cli.predict import activation_energy_prediction
    with pytest.raises(NotImplementedError, match="data_path_npz"):
        activation_energy_prediction(str(REPO / "examples" / "demo.csv"),
                                     str(REPO / "examples" / "demo.xyz"),
                                     device="cpu")


def test_chip_smoke_fails_without_cuda(no_cuda):
    """chip_smoke.py exits non-zero and prints no result line here."""
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
