"""The T1x reproduction run-book with RMSE gates: the counterpart of
``cgr_mpnn_3d_tpu/cli/runbook.py`` over the port's ``cli/train.py`` and
``cli/test.py``.

    python -m cgr_mpnn_3d_tpu_torch.cli.runbook --data_path datasets

Steps: (0) where RDKit is importable, the featurizer is checked against it
on the vendored corpus (``chem/rdkit_check.py``); (1) the splits must be
in ``--data_path`` (``train/val/test.csv``, and their ``.npz`` descriptors
for the 3D model): a missing one raises and names the files, since this
package downloads nothing; (2) train the CGR 2D baseline with the README's
configuration (depth 4, hidden 400, dropout 0.1, ReLU, lr 1e-4, 50 epochs,
weight decay 1e-5, batch 64, gamma 0.9), (3) gate its test RMSE at 9.22
kcal/mol, (4) train CGR-MPNN-3D on the same configuration, (5) gate it at
5.21.  ``--compare_h512`` and ``--compare_f32`` add a hidden-512 leg and a
leg at the other compute dtype.  Writes a JSON summary and exits 1 if a
gate fails.  Every model trains and is tested on ``--device`` (default
``cuda``).  ``--pack_q`` is not a flag here: ``cli/train.py`` has no
sub-packs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

# the original model's published test RMSEs (kcal/mol)
GATE_CGR_RMSE = 9.22
GATE_3D_RMSE = 5.21


def _reference_train_args(name: str, args) -> list[str]:
    """The README's configuration as ``cli.train`` arguments."""
    return [
        "--name", name, "-d", str(args.depth),
        "--hidden_sizes", *([str(args.hidden)] * args.depth),
        "--dropout_ps", *(["0.1"] * args.depth), "-af", "ReLU",
        "-lr", "1e-4", "-ne", str(args.epochs),
        "--weight_decay", "1e-5", "-bs", "64", "-g", "0.9",
        "--data_path", args.data_path, "--save_path", args.save_path,
        "--val_frequency", "5", "--skip_test",
        "--compute_dtype", args.compute_dtype, "--device", args.device,
    ]


def missing_splits(data: Path, need_npz: bool) -> list[str]:
    """The split files the run needs that ``data`` lacks (the descriptor
    npz files too with ``need_npz``)."""
    kinds = ("csv", "npz") if need_npz else ("csv",)
    need = [f"{s}.{k}" for k in kinds for s in ("train", "val", "test")]
    return [str(data / f) for f in need if not (data / f).exists()]


def run(args) -> dict:
    from .test import test as run_test
    from .train import build_arg_parser as train_parser
    from .train import run_name, train

    data = Path(args.data_path)
    summary: dict = {"gates": {}, "config": vars(args).copy(),
                     "started": time.strftime("%Y-%m-%d %H:%M:%S")}

    # 0. featurizer drift gate: where RDKit imports, every vector of the
    # vendored corpus is derived from RDKit and compared -- a wrong
    # perception rule fails the run-book BEFORE training
    from ..chem.rdkit_check import rdkit_available, verify_corpus
    corpus = (Path(__file__).resolve().parent.parent.parent / "tests"
              / "corpus_reactions.csv")
    if rdkit_available() and corpus.exists():
        print("== RDKit detected: verifying featurizer against the "
              "differential corpus")
        rep = verify_corpus(str(corpus))   # raises FeaturizerDrift loudly
        summary["featurizer_rdkit_check"] = rep
        print(f"== featurizer parity vs RDKit OK ({rep['checked']} "
              f"reactions)")
    else:
        summary["featurizer_rdkit_check"] = "skipped (no rdkit here)"
        print("== RDKit not importable: featurizer drift gate skipped "
              "(self-refereed corpus tests still apply)")

    # 1. the splits: this package downloads nothing
    missing = missing_splits(data, not args.skip_3d)
    if missing:
        raise FileNotFoundError(
            f"missing split files: {', '.join(missing)} -- prepare the T1x "
            f"splits first (the .npz files hold the MACE descriptors of "
            f"the 3D model; --skip_3d runs without them)")

    plan = [("CGR", args.gate_cgr)]
    if not args.skip_3d:
        plan.append(("CGR-MPNN-3D", args.gate_3d))

    ok = True
    for name, gate in plan:
        print(f"== training {name} ({args.epochs} epochs)")
        targs = train_parser().parse_args(_reference_train_args(name, args))
        train(targs)
        ckpt = Path(args.save_path) / f"{run_name(targs)}.npz"
        print(f"== evaluating {name} from {ckpt}")
        res = run_test(name, str(ckpt), data_path=args.data_path,
                       plot_results=False, save_plot="",
                       device=args.device)
        rmse = float(res["test_losses"])
        passed = rmse <= gate * (1.0 + args.gate_tolerance)
        ok &= passed
        summary["gates"][name] = {
            "test_rmse_kcal_mol": rmse, "gate": gate,
            "tolerance": args.gate_tolerance,
            "passed": bool(passed), "checkpoint": str(ckpt)}
        print(f"== {name}: test RMSE {rmse:.3f} kcal/mol "
              f"(gate {gate} +{args.gate_tolerance:.0%}) -> "
              f"{'PASS' if passed else 'FAIL'}")

    if args.compare_h512 and plan:
        # hidden-512 accuracy leg: H=512 must train at least as well as
        # the README's H=400 configuration on the same data
        import copy
        base_name = plan[-1][0]
        rmse400 = summary["gates"][base_name]["test_rmse_kcal_mol"]
        a512 = copy.copy(args)
        a512.hidden = 512
        # same pipeline name (the CLI's --name selects CGR vs 3D inputs,
        # reference parity); run_name encodes h-512 so checkpoints differ
        print(f"== training {base_name} at hidden=512 (accuracy leg)")
        targs = train_parser().parse_args(
            _reference_train_args(base_name, a512))
        train(targs)
        ckpt = Path(args.save_path) / f"{run_name(targs)}.npz"
        res = run_test(base_name, str(ckpt), data_path=args.data_path,
                       plot_results=False, save_plot="",
                       device=args.device)
        rmse512 = float(res["test_losses"])
        passed = rmse512 <= rmse400 * (1.0 + args.gate_tolerance)
        ok &= passed
        summary["gates"]["H512_vs_H400"] = {
            "test_rmse_kcal_mol": rmse512, "gate": rmse400,
            "tolerance": args.gate_tolerance, "passed": bool(passed),
            "checkpoint": str(ckpt)}
        print(f"== {base_name}@H512: test RMSE {rmse512:.3f} vs H400 "
              f"{rmse400:.3f} (+{args.gate_tolerance:.0%}) -> "
              f"{'PASS' if passed else 'FAIL'}")

    if args.compare_f32 and plan:
        # dtype gate on the real task: retrain the last model at the other
        # dtype and require both final RMSEs to land together, which
        # separates dtype from recipe
        import copy
        base_name = plan[-1][0]
        rmse_main = summary["gates"][base_name]["test_rmse_kcal_mol"]
        other = ("float32" if args.compute_dtype == "bfloat16"
                 else "bfloat16")
        adt = copy.copy(args)
        adt.compute_dtype = other
        # run_name does NOT encode the compute dtype, so the retrain must
        # land in its own save dir or it would clobber the main gate's
        # checkpoint (the artifact rmse_main was measured from)
        adt.save_path = f"{args.save_path}_{other}"
        print(f"== training {base_name} at {other} (dtype gate)")
        targs = train_parser().parse_args(
            _reference_train_args(base_name, adt))
        train(targs)
        ckpt = Path(adt.save_path) / f"{run_name(targs)}.npz"
        res = run_test(base_name, str(ckpt), data_path=args.data_path,
                       plot_results=False, save_plot="",
                       device=args.device)
        rmse_other = float(res["test_losses"])
        tol = args.gate_tolerance
        passed = (rmse_main <= rmse_other * (1.0 + tol) + 0.05
                  and rmse_other <= rmse_main * (1.0 + tol) + 0.05)
        ok &= passed
        summary["gates"][f"dtype_{args.compute_dtype}_vs_{other}"] = {
            "rmse_main": rmse_main, "rmse_other": rmse_other,
            "tolerance": tol, "passed": bool(passed),
            "checkpoint": str(ckpt)}
        print(f"== {base_name}: {args.compute_dtype} RMSE "
              f"{rmse_main:.3f} vs {other} {rmse_other:.3f} "
              f"(+/-{tol:.0%}) -> {'PASS' if passed else 'FAIL'}")

    summary["all_passed"] = bool(ok)
    out = Path(args.summary)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=2, default=float))
    print(f"== summary -> {out}")
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="T1x reproduction run-book with RMSE gates")
    ap.add_argument("--data_path", default="datasets")
    ap.add_argument("--save_path", default="saved_models")
    ap.add_argument("--summary", default="runbook_summary.json")
    ap.add_argument("--epochs", default=50, type=int)
    ap.add_argument("--depth", default=4, type=int)
    ap.add_argument("--hidden", default=400, type=int)
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["float32", "bfloat16"],
                    help="operand type of the kernels' products; if the "
                         "T1x gate fails at bf16, rerun with float32 to "
                         "separate dtype from recipe")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device every model trains and tests on")
    ap.add_argument("--gate_cgr", default=GATE_CGR_RMSE, type=float)
    ap.add_argument("--gate_3d", default=GATE_3D_RMSE, type=float)
    ap.add_argument("--gate_tolerance", default=0.05, type=float,
                    help="relative slack on the gates (seed variance)")
    ap.add_argument("--skip_3d", action="store_true",
                    help="run only the 2D CGR baseline")
    ap.add_argument("--compare_h512", action="store_true",
                    help="also train at hidden 512 and gate its test "
                         "RMSE against the H=400 run")
    ap.add_argument("--compare_f32", action="store_true",
                    help="dtype gate on the real task: retrain the last "
                         "model at the other compute dtype and require "
                         "both test RMSEs to land together")
    args = ap.parse_args(argv)
    summary = run(args)
    if not summary["all_passed"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
