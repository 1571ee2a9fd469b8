"""Inference CLI: activation energies for a SMILES csv, on the card.

The counterpart of ``cgr_mpnn_3d_tpu/cli/predict.py`` with the same flags,
plus ``--device`` (default ``cuda``) and ``--batch_size``.  Requests are
featurized by the native C++ featurizer (``native/``); the entry point's
``use_native=False`` takes the pure-Python twin.  The descriptors come
from a precomputed ``.npz`` (``--data_path_npz``) or, without one, from the
xyz file (``--data_path_coordinates``): ``data.descriptors.
process_xyz_to_npz`` writes ``<xyz stem>.npz`` beside it on ``device``
through the MACE backend (the optional ``mace-torch`` package; without it
the call raises ImportError and writes nothing), and the request is served
from that file.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..data import ChemDataset, plan_spec
from ..data.descriptors import process_xyz_to_npz
from ..train import load_model, predict
from ..utils import AsciiTable


def activation_energy_prediction(
        input_smiles: str, input_coordinates: str = "",
        output_results: str = "", model_path: str = "",
        print_results: bool = False, store_results: bool = False,
        output_format: str = "text", npz_path: str | None = None,
        device: str | torch.device = "cuda", batch_size: int = 64,
        use_native: bool | None = None) -> list:
    data_path_smiles = Path(input_smiles)
    data_path_results = (Path(output_results) if output_results
                         else Path("results.txt"))
    if data_path_results.is_dir():
        data_path_results /= "results.txt"
    if not data_path_smiles.is_file():
        raise FileNotFoundError(f"SMILES file not found: {data_path_smiles}")
    if npz_path is None:
        data_path_coordinates = Path(input_coordinates)
        if not data_path_coordinates.is_file():
            raise FileNotFoundError(
                f"3D coordinates file not found: {data_path_coordinates}")
        npz = data_path_coordinates.parent / (data_path_coordinates.stem
                                              + ".npz")
        process_xyz_to_npz(data_path_smiles, data_path_coordinates, npz,
                           device=str(device))
        npz_path = str(npz)

    model, cfg, _ = load_model(model_path, device)
    pred_data = ChemDataset(str(data_path_smiles), data_npz_path=npz_path,
                            use_native=use_native)
    if pred_data.num_node_features != cfg.num_node_features:
        raise ValueError(
            f"model expects {cfg.num_node_features} node features but the "
            f"input provides {pred_data.num_node_features} — a CGR-MPNN-3D "
            "model needs matching MACE descriptors (--data_path_npz / "
            "--data_path_coordinates)")
    pred_data.prefeaturize()
    graphs = [pred_data.graph(i) for i in range(len(pred_data))]
    preds = predict(model, pred_data, plan_spec(graphs), batch_size, device)

    table = AsciiTable(["Reaction ID", "Activation Energy [kcal/mol]"])
    results = []
    for i, ea in enumerate(preds):
        results.append({"Reaction_ID": i + 1, "Activation Energy": float(ea)})
        table.add_row([i + 1, f"{float(ea):.3f}"])

    if print_results:
        print("\nPredicted Activation Energies:\n")
        print(table)

    if store_results:
        if output_format == "text":
            with open(data_path_results, "w") as f:
                f.write("Predicted Activation Energies:\n\n")
                f.write(str(table))
        elif output_format == "json":
            with open(data_path_results.with_suffix(".json"), "w") as f:
                json.dump(results, f, indent=4)
        else:
            raise ValueError("Unsupported output format. Use 'text' or 'json'.")
        print(f"\nResults saved to: {data_path_results}")
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Predict activation energies of chemical reactions via "
                    "the CGR MPNN 3D GNN (PyTorch, CUDA kernel).")
    ap.add_argument("--data_path_smiles", default="examples/demo.csv")
    ap.add_argument("--data_path_coordinates", default="examples/demo.xyz")
    ap.add_argument("--data_path_model",
                    default="saved_models/CGR-MPNN-3D.npz")
    ap.add_argument("--data_path_results", default="results.txt")
    ap.add_argument("--data_path_npz", default=None,
                    help="precomputed descriptor npz (skips MACE)")
    ap.add_argument("--store_results", action="store_true")
    ap.add_argument("--print_results", action="store_true")
    ap.add_argument("--output_format", default="text",
                    choices=["text", "json"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch_size", type=int, default=64)
    args = ap.parse_args(argv)

    activation_energy_prediction(
        args.data_path_smiles, args.data_path_coordinates,
        args.data_path_results, args.data_path_model, args.print_results,
        args.store_results, args.output_format, args.data_path_npz,
        args.device, args.batch_size)


if __name__ == "__main__":
    main()
