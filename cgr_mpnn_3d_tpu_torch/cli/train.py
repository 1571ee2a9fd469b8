"""Train CLI: the counterpart of ``cgr_mpnn_3d_tpu/cli/train.py``, with its
flags (but ``--pack_q``) plus ``--device`` (default ``cuda``), in one
process or as every rank of a multi-process launch.

Usage (the README's model):
  python -m cgr_mpnn_3d_tpu_torch.cli.train --name CGR-MPNN-3D -d 4 \\
      --hidden_sizes 400 --dropout_ps 0.1 -af ReLU -lr 1e-4 -ne 50 \\
      --weight_decay 1e-5 -bs 64 -g 0.9 --data_path datasets \\
      [--compute_dtype bfloat16] [--dp 2] [--ep 2] [--reuse_packs
      --device_epoch | --steps_per_call 4]

``--data_path`` holds ``train.csv`` and ``val.csv`` (and ``test.csv`` unless
``--skip_test``), plus ``<split>.npz`` descriptors for CGR-MPNN-3D; a
missing split raises.  After training, the best checkpoint is evaluated on
the test split and the results merge into
``hyperparameter_study/<name>_hyperparameter_study.json``.

``--compute_dtype bfloat16`` trains and validates with the whole-model
kernels' bf16 products (on the CPU their plain versions at bf16);
parameters and Adam stay f32.  The test after training loads the
checkpoint in f32, as the JAX CLI does.

``--dp N`` splits every step's batch into N data-parallel groups of
ceil(batch_size / N) graphs (a short last group padded with an all-masked
batch) and runs every group in this process on the one device, summing
the groups' losses and gradients (``parallel/data_parallel.py``): one
training-kernel launch a group and step in the whole-model configuration.

``--ep N`` shards every batch's edges over N shards in the pack-local
layout (``parallel/ep_pack.py``, tiles ``--ep_te`` x ``--ep_tn``), every
shard of a step in this process on one device, at either
``--compute_dtype``; ``--ep_overlap`` runs its wired layers through the
linear conv kernel plus a compact correction, and ``--ep_rdma`` sends every
exchange through the hop-exchange kernel.  With ``--dp`` each group's
batch is sharded so.

The splits are featurized by the native C++ featurizer on ``--num_workers``
threads (default half the CPUs) and cached beside each CSV
(``<split>.csv.featcache.npz``, the JAX package's format).
``--reuse_packs`` packs each epoch's batches once and reuses them, shuffling
batch order per epoch, under ``--ep`` too.  ``--loader_workers N`` parses
for the JAX command line's sake and packing stays serial: one background
thread packs ahead of the device (``data/loader.py``).

``--steps_per_call K`` (single device) moves K batches to the card in one
transfer and runs their K steps with one read of their losses; the NaN
guard then rolls back whole chunks.  ``--reuse_packs --device_epoch`` stages
the reused packs on the card once and runs each epoch's steps with no
host-to-device copy and no host read inside; a non-finite loss rolls the
epoch back and stops the run.  Under ``--dp`` and ``--ep`` the staged
order is the epoch-0 grouping, shuffled as a whole in later epochs.

Several processes: the same command on every rank, launched by torchrun
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``)
or with the JAX CLI's variables (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), e.g. two ranks sharing one card:
  torchrun --nproc_per_node 2 -m cgr_mpnn_3d_tpu_torch.cli.train ... --dp 2
The ranks join a gloo process group (``parallel/multihost.py``) and split
the ``[dp, ep]`` grid in one of two layouts: whole dp groups a rank (the
rank count divides ``--dp``), or one EP shard a rank (rank count = dp x
ep).  Before any data is read or any rendezvous, another layout, ``dp x ep
= 1``, an incomplete launch environment and ``--ep_rdma`` with one shard a
rank raise, naming the ROADMAP.md item.  The ranks sum each step's loss
and gradients, so their run is the single-process run with the same
``--dp``/``--ep``; the primary (rank 0) alone writes the checkpoints, the
metrics log and the results, tests the model and prints the summary.

Not ported: ``--pack_q`` (left out on purpose: ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="CLI tool for training the CGR MPNN 3D Graph Neural "
                    "Network (PyTorch, CUDA kernels).")
    ap.add_argument("-n", "--name", default="CGR",
                    choices=["CGR", "CGR-MPNN-3D"],
                    help="Type of the model to be trained")
    ap.add_argument("-d", "--depth", default=3, type=int)
    ap.add_argument("--hidden_sizes", default=None, nargs="+", type=int)
    ap.add_argument("--dropout_ps", default=None, nargs="+", type=float)
    ap.add_argument("-af", "--activation_fn", default="ReLU",
                    choices=["ReLU", "SiLU", "GELU"])
    ap.add_argument("--aggr", default="add", choices=["add", "mean"],
                    help="D-MPNN aggregation")
    ap.add_argument("--pooling", default="add", choices=["add", "mean"],
                    help="graph pooling (sum or mean over the graph's nodes)")
    ap.add_argument("--save_path", default="saved_models")
    ap.add_argument("--learnable_skip", action="store_true")
    ap.add_argument("--compute_dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="operand type of the kernels' products (bf16 "
                         "runs them on the tensor cores)")
    ap.add_argument("-lr", "--learning_rate", default=1e-3, type=float)
    ap.add_argument("-ne", "--num_epochs", default=30, type=int)
    ap.add_argument("--weight_decay", default=0.0, type=float)
    ap.add_argument("-bs", "--batch_size", default=32, type=int)
    ap.add_argument("-g", "--gamma", default=1.0, type=float)
    ap.add_argument("--data_path", default="datasets")
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--val_frequency", default=5, type=int)
    ap.add_argument("--resume", default=None,
                    help="training checkpoint to resume from")
    ap.add_argument("--use_logger", action="store_true",
                    help="log to wandb if available (JSONL always written)")
    ap.add_argument("--log_histograms", action="store_true",
                    help="per-parameter histograms of the params and of one "
                         "batch's gradients once per epoch, to JSONL (and "
                         "wandb when attached)")
    ap.add_argument("--pack_te", default=256, type=int)
    ap.add_argument("--pack_tn", default=128, type=int)
    ap.add_argument("--pack_tb", default=16, type=int)
    ap.add_argument("--skip_test", action="store_true")
    ap.add_argument("--ckpt_every_steps", default=0, type=int,
                    help="save {name}.latest.npz every N successful train "
                         "steps within an epoch; --resume continues from it "
                         "bit-identically (0 = per-epoch)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ep", default=1, type=int,
                    help="edge-partition shards: each batch's edges are "
                         "sharded over ep shards in pack-local layout, "
                         "every shard of a step in this process (over "
                         "dp x ep ranks: one shard a rank)")
    ap.add_argument("--ep_te", default=128, type=int,
                    help="EP pack tile: edge slots per pack (grows when a "
                         "shard-local graph fragment exceeds it)")
    ap.add_argument("--ep_tn", default=72, type=int,
                    help="EP pack tile: node slots per pack")
    ap.add_argument("--ep_overlap", action="store_true",
                    help="wired EP layers through the linear-activation "
                         "conv kernel plus the compact boundary correction "
                         "(one stream: nothing overlaps yet)")
    ap.add_argument("--ep_rdma", action="store_true",
                    help="EP exchanges through the hop-exchange kernel "
                         "(K12): one launch for every hop and shard")
    ap.add_argument("--dp", default=1, type=int,
                    help="data-parallel groups a step, each of "
                         "ceil(batch_size / dp) graphs, every group in this "
                         "process on the one device, or split over the "
                         "ranks of a multi-process launch (gradients "
                         "summed)")
    ap.add_argument("--num_workers", default=None, type=int,
                    help="featurization threads (default: half the CPUs)")
    ap.add_argument("--loader_workers", default=1, type=int,
                    help="accepted for the JAX command line; the port "
                         "packs on one background thread")
    ap.add_argument("--reuse_packs", action="store_true",
                    help="pack each epoch once and reuse its batches in "
                         "later epochs, shuffling batch order")
    ap.add_argument("--device_epoch", action="store_true",
                    help="with --reuse_packs: stage the packed epoch on the "
                         "device once and run each epoch with no host copy "
                         "or read inside; the NaN guard is per epoch (a "
                         "non-finite loss rolls the epoch back and stops "
                         "the run); under --ep the epoch-0 grouping is "
                         "staged and later epochs shuffle it")
    ap.add_argument("--steps_per_call", default=1, type=int,
                    help="train steps per host read of the losses (single "
                         "device): their batches move in one transfer; the "
                         "NaN guard rolls back a whole chunk")
    return ap


def run_name(args) -> str:
    """Config-encoding run name."""
    return "_".join([
        args.name,
        f"d-{args.depth}",
        "h-" + "-".join(str(i) for i in args.hidden_sizes),
        "p-" + "-".join(str(i) for i in args.dropout_ps),
        args.activation_fn,
        f"s-{'t' if args.learnable_skip else 'f'}",
        f"l-{args.learning_rate}",
        f"e-{args.num_epochs}",
        f"w-{args.weight_decay}",
        f"b-{args.batch_size}",
        f"g-{args.gamma}",
    ])


def split_dataset(data_path: str | Path, split: str, name: str):
    """The ``split`` dataset of ``data_path`` (csv, plus the descriptor npz
    for CGR-MPNN-3D); a missing file raises and names it."""
    from ..data import ChemDataset
    if name not in ("CGR", "CGR-MPNN-3D"):
        raise NameError(f"Unknown model with name '{name}'.")
    csv = Path(data_path) / f"{split}.csv"
    npz = Path(data_path) / f"{split}.npz" if name == "CGR-MPNN-3D" else None
    for f in (csv, npz):
        if f is not None and not f.exists():
            raise FileNotFoundError(
                f"{f} not found: the {split} split must be prepared first "
                "(this package downloads nothing)")
    return ChemDataset(str(csv), data_npz_path=None if npz is None
                       else str(npz))


def train(args) -> dict:
    from ..data import plan_spec
    from ..models import CGRMPNNConfig
    from ..parallel import multihost
    from ..train import MetricsLogger, RxnGraphTrainer
    from ..utils import resolve_device

    # the rendezvous before any device query (a no-op in one process)
    multihost.initialize()
    device = resolve_device(args.device)
    train_data = split_dataset(args.data_path, "train", args.name)
    val_data = split_dataset(args.data_path, "val", args.name)
    cfg = CGRMPNNConfig(
        num_node_features=train_data.num_node_features,
        num_edge_features=train_data.num_edge_features,
        depth=args.depth,
        hidden_sizes=tuple(args.hidden_sizes),
        dropout_ps=tuple(args.dropout_ps),
        activation=args.activation_fn,
        aggr=args.aggr,
        pooling=args.pooling,
        use_learnable_skip=args.learnable_skip,
        compute_dtype=args.compute_dtype,
        ep_rdma_exchange=args.ep_rdma,
        ep_overlap=args.ep_overlap,
    )
    workers = (args.num_workers if args.num_workers is not None
               else max(1, (os.cpu_count() or 2) // 2))
    print(f"Featurizing training set ({workers} workers)...")
    train_data.prefeaturize(num_workers=workers, cache=True)
    val_data.prefeaturize(num_workers=workers, cache=True)
    graphs = [train_data.graph(i) for i in range(len(train_data))]
    spec = plan_spec(graphs, te=args.pack_te, tn=args.pack_tn,
                     tb=args.pack_tb)

    name = run_name(args)
    # every rank computes the same losses: the primary alone logs them
    logger = (MetricsLogger(name, config=vars_config(args),
                            use_wandb=args.use_logger)
              if multihost.is_primary() else None)
    trainer = RxnGraphTrainer(
        name=name, cfg=cfg, train_data=train_data, val_data=val_data,
        spec=spec, lr=args.learning_rate, weight_decay=args.weight_decay,
        gamma=args.gamma, num_epochs=args.num_epochs,
        batch_size=args.batch_size, val_frequency=args.val_frequency,
        model_save_dir=args.save_path, seed=args.seed, logger=logger,
        log_histograms=args.log_histograms, resume_from=args.resume,
        ckpt_every_steps=args.ckpt_every_steps, device=device, n_dp=args.dp,
        n_ep=args.ep,
        ep_te=args.ep_te, ep_tn=args.ep_tn,
        loader_workers=args.loader_workers, reuse_packs=args.reuse_packs,
        steps_per_call=args.steps_per_call, device_epoch=args.device_epoch)
    return trainer.train()


def vars_config(args) -> dict:
    return {
        "depth": args.depth, "hidden_sizes": args.hidden_sizes,
        "dropout_ps": args.dropout_ps, "activation_fn": args.activation_fn,
        "learnable_skip": args.learnable_skip, "lr": args.learning_rate,
        "num_epochs": args.num_epochs, "weight_decay": args.weight_decay,
        "batch_size": args.batch_size, "gamma": args.gamma,
    }


def main(argv=None) -> dict:
    """Train, test and record; returns the run's results (train/val RMSE
    per epoch, steps, test RMSE and MAE; on a rank but the primary, the
    training's alone)."""
    args = build_arg_parser().parse_args(argv)
    if args.hidden_sizes is None:
        args.hidden_sizes = [300] * args.depth
    if args.dropout_ps is None:
        args.dropout_ps = [0.02] * args.depth
    if len(args.hidden_sizes) == 1:
        args.hidden_sizes = args.hidden_sizes * args.depth
    if len(args.dropout_ps) == 1:
        args.dropout_ps = args.dropout_ps * args.depth

    from ..parallel import multihost
    # the layout before any data is read and before the rendezvous
    multihost.check_launch(args.dp, args.ep, args.ep_rdma)
    if not args.skip_test:
        # fail before training, not after it
        split_dataset(args.data_path, "test", args.name)
    name = run_name(args)
    meta = {name: {"metadata": vars_config(args)}}
    print("Metadata of the training:")
    for k, v in vars_config(args).items():
        print(f"{k}: {v}")

    meta[name].update(train(args))
    if not multihost.is_primary():
        return meta[name]     # the test and the results are the primary's

    if not args.skip_test:
        from .test import test
        test_result = test(args.name, f"{args.save_path}/{name}.npz",
                           data_path=args.data_path, plot_results=False,
                           device=args.device)
        meta[name].update(**{k: float(v) for k, v in test_result.items()
                             if np.isscalar(v)})

    from ..utils import json_dumper
    out_dir = Path("hyperparameter_study")
    out_dir.mkdir(parents=True, exist_ok=True)
    json_dumper(str(out_dir / f"{args.name}_hyperparameter_study.json"), meta)
    print(json.dumps({k: v for k, v in meta[name].items()
                      if k != "metadata"}, default=str, indent=2))
    return meta[name]


if __name__ == "__main__":
    main()
