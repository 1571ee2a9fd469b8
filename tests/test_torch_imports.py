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
    kernels = {f"cgr_mpnn_3d_tpu_torch.{m}" for m in
               ("ops.onehot_spmm", "ops.gather_linear", "ops.conv_stack",
                "ops._launch", "ops.fused_conv", "ops.act_chain",
                "ops.mm_probe", "cli.bench_ops", "tools.gelu_roofline",
                "tools.int8_microbench", "tools.bwd_registers",
                "parallel.edge_partition", "parallel.ep_pack",
                "parallel.ep_loader", "parallel.rdma_exchange",
                "tools.profile_ep", "tools.mm_probe_parts",
                "tools.k2_phases", "tools.k12_host", "tools.k7_host",
                "tools.k12_ranks",
                "native", "data.dataset", "data.loader",
                "data.descriptors", "data.preprocess",
                "parallel.data_parallel", "parallel.multihost",
                "cli.sweep", "cli.runbook", "chem.rdkit_check",
                "train.profiler", "__main__")}
    assert kernels <= set(res["mods"])
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


def test_the_port_opens_nothing_of_the_jax_package(tmp_path):
    """A fresh interpreter featurizes, caches, packs and reuses packs
    through the port's native library and its Python twins, under an audit
    hook: no file opened and no library loaded lies under
    ``cgr_mpnn_3d_tpu/`` (its ``native/libcgrfeat.so`` included), and
    none is mapped into the process."""
    code = (
        "import json, sys\n"
        "seen = []\n"
        "def hook(event, args):\n"
        "    if event in ('open', 'ctypes.dlopen') and args and args[0]:\n"
        "        seen.append(str(args[0]))\n"
        "sys.addaudithook(hook)\n"
        "from cgr_mpnn_3d_tpu_torch import native\n"
        "from cgr_mpnn_3d_tpu_torch.data import (ChemDataset, PackedLoader,"
        " plan_spec)\n"
        f"csv = {str(tmp_path / 'demo.csv')!r}\n"
        f"open(csv, 'w').write(open({str(REPO / 'examples' / 'demo.csv')!r})"
        ".read())\n"
        "for use_native in (True, False):\n"
        "    ds = ChemDataset(csv, use_native=use_native)\n"
        "    ds.prefeaturize(num_workers=2, cache=True)\n"
        "    spec = plan_spec([ds.graph(i) for i in range(len(ds))])\n"
        "    for reuse in (False, True):\n"
        "        list(PackedLoader(ds, spec, batch_size=4, workers=2,\n"
        "                          reuse_packs=reuse, shuffle=True,\n"
        "                          use_native=use_native).prefetch())\n"
        "native.featurize('CCO', 'mol')\n"
        "maps = open('/proc/self/maps').read().split()\n"
        "print(json.dumps({'seen': seen, 'maps': maps}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, check=True,
                         timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    jax_pkg = str(REPO / "cgr_mpnn_3d_tpu") + "/"
    opened = [p for p in res["seen"] + res["maps"] if jax_pkg in p
              or p.startswith("cgr_mpnn_3d_tpu/")]
    assert opened == []
    assert any("libcgrfeat-" in p and "cgr_mpnn_3d_tpu_torch/build/" in p
               for p in res["maps"])


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
    from cgr_mpnn_3d_tpu_torch.cli import test as cli_test
    from cgr_mpnn_3d_tpu_torch.cli import train as cli_train
    from cgr_mpnn_3d_tpu_torch.cli.predict import (
        activation_energy_prediction, main)
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, PackSpec
    from cgr_mpnn_3d_tpu_torch.data.descriptors import \
        synthetic_descriptors_npz
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig, init_params
    from cgr_mpnn_3d_tpu_torch.train import (RxnGraphTrainer, evaluate,
                                             load_model, predict,
                                             save_checkpoint)

    cfg = CGRMPNNConfig(num_node_features=90, num_edge_features=14, depth=2,
                        hidden_sizes=(8, 8), dropout_ps=(0.0, 0.0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    meta = {"model": {"num_node_features": 90, "num_edge_features": 14,
                      "depth": 2, "hidden_sizes": [8, 8],
                      "dropout_ps": [0.0, 0.0]}}
    ckpt = save_checkpoint(tmp_path / "m.npz", model, meta)
    # cli.test infers the model's name from the file name
    named = save_checkpoint(tmp_path / "CGR-MPNN-3D_m.npz", model, meta)
    demo = REPO / "examples" / "demo.csv"
    synthetic_descriptors_npz(demo, tmp_path / "d.npz", 4)
    ds = ChemDataset(str(demo), data_npz_path=str(tmp_path / "d.npz"))
    for split in ("train", "val", "test"):
        (tmp_path / f"{split}.csv").write_text(demo.read_text())
        (tmp_path / f"{split}.npz").write_bytes(
            (tmp_path / "d.npz").read_bytes())
    train_argv = ["--name", "CGR-MPNN-3D", "-d", "2", "--hidden_sizes", "8",
                  "--data_path", str(tmp_path), "--save_path",
                  str(tmp_path / "saved")]
    for call in (lambda: load_model(ckpt),
                 lambda: RxnGraphTrainer("t", cfg, ds, ds, PackSpec()),
                 lambda: RxnGraphTrainer("t", cfg, ds, ds, PackSpec(),
                                         n_ep=2),
                 lambda: cli_train.main(train_argv),
                 lambda: cli_train.main(train_argv + ["--ep", "2"]),
                 lambda: cli_test.main(["--path_trained_model", str(named),
                                        "--data_path", str(tmp_path)]),
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
    """Without a descriptor npz, predict runs the xyz -> descriptor step,
    whose MACE backend needs the optional mace-torch package: the call
    raises ImportError naming it, falls back to nothing and writes no npz
    beside the xyz file."""
    from cgr_mpnn_3d_tpu_torch.cli.predict import activation_energy_prediction
    before = sorted(p.name for p in (REPO / "examples").iterdir())
    with pytest.raises(ImportError, match="mace-torch"):
        activation_energy_prediction(str(REPO / "examples" / "demo.csv"),
                                     str(REPO / "examples" / "demo.xyz"),
                                     device="cpu")
    assert sorted(p.name for p in (REPO / "examples").iterdir()) == before


def test_chip_smoke_fails_without_cuda(no_cuda):
    """chip_smoke.py exits non-zero and prints no result line here."""
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
