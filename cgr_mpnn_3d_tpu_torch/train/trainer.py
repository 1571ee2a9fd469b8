"""Training loop: the counterpart of ``cgr_mpnn_3d_tpu/train/trainer.py::
RxnGraphTrainer``, on one device or over the ranks of a torch.distributed
process group.

* optimizer   ``torch.optim.Adam(lr, weight_decay=wd, amsgrad=True)`` -- what
              the JAX trainer emulates (``scale_by_torch_amsgrad`` after
              ``add_decayed_weights``);
* schedule    lr = lr·gamma**epoch, set at the start of every epoch
              (``set_epoch_lr``: torch ExponentialLR stepped per epoch);
* loss        the masked SSE over real graphs; epoch RMSE =
              sqrt(sum of SSE / number of rows);
* step        on the card ONE launch of the training kernel computes the
              loss and every gradient (``models.fused_train_value_and_grad``);
              on the CPU its plain version.  With
              ``cfg.fuse_whole_model=False`` the step is autograd of the
              masked SSE through the layered kernels' autograd Functions
              (their backward kernels on the card, plain versions on the
              CPU);
* dtype       ``cfg.compute_dtype`` reaches the step, validation and the
              histograms (bf16: the kernels' bf16 instantiation on the
              card, their plain versions on the CPU); parameters and Adam
              stay f32, as in the JAX trainer;
* dropout     the kernels' hash dropout, with one int32 seed per conv layer
              drawn per step from the trainer's CPU ``torch.Generator``,
              re-seeded from (seed, draws) -- so a CPU run and a card run see
              the same masks, and a resumed run the same seeds;
* validation  every ``val_frequency`` epochs and after the last; the best
              validation RMSE saves ``<name>.npz``, every epoch
              ``<name>.latest.npz``, and ``ckpt_every_steps`` saves the
              latest state inside an epoch, from which ``resume_from``
              continues bit-identically (the loader fast-forwards);
* NaN guard   a non-finite loss skips its update (the state stays at the
              last good step, seeds included); ``max_bad_steps``
              consecutive ones abort the run;
* DP          with ``n_dp > 1`` (JAX ``trainer.py:299``, :402-420, :525-540)
              each loader packs batches of ceil(batch_size / n_dp) graphs,
              ``n_dp`` consecutive ones make one step's groups (a short
              last group padded with ``data.empty_batch``, whose loss and
              gradients are exactly 0), and every group runs in this
              process on the one device: ``parallel.data_parallel``'s step
              sums the groups' SSEs and gradients in group order (JAX
              ``psum``s them), one seed row per group; validation sums the
              groups' SSEs.  A mid-epoch resume counts groups as steps,
              and the histograms sample group 0's first batch.
* EP          with ``n_ep > 1`` (JAX ``trainer.py:299-313``, :355-386) the
              batches come from ``parallel.EPPackLoader`` (``ep_te`` /
              ``ep_tn`` tiles) as (spec, batch) with leaves [n_dp, n_ep,
              ...], and every group and shard of a step runs in this
              process: the step and the validation step are
              ``parallel.ep_pack``'s, keyed by the loader's spec (rebuilt
              when the pins grow), with one dropout seed per group, shard
              and layer, at either ``compute_dtype`` and with the config's
              ``ep_overlap`` and ``ep_rdma_exchange``; the gradient
              histograms are skipped there, as in JAX.

* loaders     ``reuse_packs`` packs each loader's epoch once and reuses
              its batches in later epochs (batch order shuffled from seed
              + epoch); ``loader_workers`` is accepted and packing stays
              serial (``data/loader.py``); both reach the EP loader too, as
              in JAX (``trainer.py:300-326``).
* chunks      ``steps_per_call`` K > 1 (single device; JAX :448-454,
              :749-823): K consecutive loader batches go to the device in
              one transfer with their K seed rows, their K steps run with
              no host read between them, and the chunk's losses are read
              once at its end; the remainder runs as single steps.  The NaN
              guard works per chunk: a non-finite chunk restores the state
              taken before it (parameters, Adam, step, seed stream) and
              counts one bad; ``max_bad_steps`` in a row abort.
* device epoch ``device_epoch`` (needs ``reuse_packs``; JAX :615-736): the
              reused pack cache is staged on the device once ([S, ...];
              single device in cache order; DP and EP the epoch-0
              iteration's S steps, [S, n_dp, ...] and [S, n_dp, n_ep,
              ...]), and each epoch draws its S seed rows and copies them
              over once, runs its steps on views of the staged rows in the
              loader's order (DP and EP: epoch 0 the identity, later
              epochs whole steps shuffled from seed + epoch), with no
              host-to-device copy and no host read inside, and reads its
              [S] losses once.  A non-finite
              loss restores the epoch-start state and raises
              FloatingPointError.  ``ckpt_every_steps``, ``steps_per_call``
              and a mid-epoch resume are refused, as in JAX.  Both modes
              always step the optimizer and roll back from a snapshot of
              device-side copies (JAX gets that from its immutable state).
* ranks       in a multi-process run (``parallel.multihost.initialize``
              joined a gloo group; JAX :221-279, :495-510, :542-613) every
              rank builds this same trainer and holds the cells of the
              [n_dp, n_ep] grid that ``multihost.layout`` gives it: whole
              groups (layout a) or one EP shard (layout b; its collectives
              cross ranks through ``ep_pack.run_distributed``).  The
              construction checks the layout and gathers a config
              fingerprint from every rank (a mismatch raises ValueError on
              each).  Each rank packs and moves only its own cells
              (:meth:`_mh_stream`: without reuse the windows of
              ``PackedLoader.plan_windows``, the serial iteration's, each
              rank packing its own; with reuse the host-global cache; EP
              the whole group, its local cells moved), stages only its
              cells' columns of a device epoch and takes its slice of the
              global seed draw; the steps sum [SSE, gradients] over every
              rank in one collective and validation sums the SSE, so every
              rank steps (or skips) alike.  Only the primary writes a
              checkpoint (then a barrier) and prints the new best model.
              W ranks give the single-process run with the same
              ``n_dp``/``n_ep``: bit for bit where a sum has two operands.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..data.batch import (PackedGraphBatch, PackSpec, device_tensor,
                          empty_batch, to_device)
from ..data.dataset import ChemDataset
from ..data.loader import PackedLoader, background
from ..models.cgr_mpnn import (CGRMPNNConfig, fused_train_value_and_grad,
                               init_params, sse_loss, supports_fused_train)
from ..ops._launch import stage_rates
from ..parallel import multihost
from ..parallel.data_parallel import (groups_of, make_dp_eval_step,
                                      make_dp_train_step, stack_batches)
from ..parallel.ep_loader import EPPackLoader
from ..parallel.ep_pack import (EPPackedBatch, ep_shards,
                                make_ep_pack_eval_step,
                                make_ep_pack_train_step)
from ..utils.device import resolve_device
from .checkpoint import (SEED_STREAM, load_checkpoint,
                         restore_training_state, save_checkpoint)
from .metrics import MetricsLogger
from .profiler import StepTimer

__all__ = ["RxnGraphTrainer", "set_epoch_lr", "sse_loss"]

_M32 = 0xFFFFFFFF


def set_epoch_lr(optimizer: torch.optim.Optimizer, lr: float, gamma: float,
                 epoch: int) -> None:
    """learning rate = lr * gamma**epoch (ExponentialLR stepped per epoch)."""
    for group in optimizer.param_groups:
        group["lr"] = lr * (gamma ** epoch)


def _copy_all(dst: list, src: list) -> None:
    """dst[i] <- src[i], one foreach copy per device (Adam's ``step``
    stays on the host beside state on the card)."""
    for dev in {t.device for t in src}:
        pairs = [(d, t) for d, t in zip(dst, src) if t.device == dev]
        torch._foreach_copy_([d for d, _ in pairs], [t for _, t in pairs])


@dataclass
class RxnGraphTrainer:
    """Orchestrates train/val epochs on one device (every data-parallel
    group and edge-partition shard in this process), or on one rank's
    cells of a multi-process run."""
    name: str
    cfg: CGRMPNNConfig
    train_data: ChemDataset
    val_data: ChemDataset
    spec: PackSpec
    lr: float = 1e-3
    weight_decay: float = 0.0
    gamma: float = 1.0
    num_epochs: int = 30
    batch_size: int = 32
    val_frequency: int = 5
    model_save_dir: str = "saved_models"
    seed: int = 0
    logger: MetricsLogger | None = None
    resume_from: str | None = None
    log_param_norms: bool = False
    # per-epoch histograms of the params and of the eval-mode gradients of
    # the epoch's first batch (on the card through the VJP kernel)
    log_histograms: bool = False
    max_bad_steps: int = 3
    # save {name}.latest.npz every N successful steps inside an epoch
    ckpt_every_steps: int = 0
    device: str | torch.device = "cuda"
    # data parallelism: groups per step, each of ceil(batch_size / n_dp)
    # graphs
    n_dp: int = 1
    # edge partitioning: shards per step, and the EP packer's tile
    n_ep: int = 1
    ep_te: int = 128
    ep_tn: int = 72
    # the loaders' packing threads and cross-epoch pack reuse
    loader_workers: int = 1
    reuse_packs: bool = False
    # train steps per host read of the losses (single device): see
    # "chunks" in the module doc
    steps_per_call: int = 1
    # whole epochs on the device over the staged pack cache: see "device
    # epoch" in the module doc
    device_epoch: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.n_dp = max(1, self.n_dp)
        self.n_ep = max(1, self.n_ep)
        self.steps_per_call = max(1, self.steps_per_call)
        self._lay = multihost.layout(self.n_dp, self.n_ep,
                                     ep_rdma=self.cfg.ep_rdma_exchange)
        self._check_modes()
        if self._lay.world > 1:
            self._check_fingerprint()
        # layout (b): this rank's EP group (made here, on every rank)
        self._comm = (multihost.ep_comm(self._lay)
                      if self._lay.kind == "shards" else None)
        modes = dict(reuse_packs=self.reuse_packs,
                     workers=self.loader_workers)
        # each group's batch (JAX trainer.py:299)
        per_dp = -(-self.batch_size // self.n_dp)
        if self.n_ep > 1:
            self.train_loader = EPPackLoader(self.train_data, self.n_ep,
                                             batch_size=per_dp,
                                             n_dp=self.n_dp, shuffle=True,
                                             seed=self.seed, te=self.ep_te,
                                             tn=self.ep_tn, **modes)
            self.val_loader = EPPackLoader(self.val_data, self.n_ep,
                                           batch_size=per_dp, n_dp=self.n_dp,
                                           shuffle=False, te=self.ep_te,
                                           tn=self.ep_tn, **modes)
        else:
            self.train_loader = PackedLoader(self.train_data, self.spec,
                                             batch_size=per_dp,
                                             shuffle=True, seed=self.seed,
                                             **modes)
            self.val_loader = PackedLoader(self.val_data, self.spec,
                                           batch_size=per_dp, **modes)
        # the EP steps, keyed by ("t" | "e", the loader's spec)
        self._ep_steps: dict = {}
        self.model = init_params(self.cfg,
                                 torch.Generator().manual_seed(self.seed),
                                 self.device)
        if self.n_dp > 1 and self.n_ep == 1:
            self._dp_train = make_dp_train_step(self.model,
                                                self.train_loader.spec)
            self._dp_eval = make_dp_eval_step(self.model,
                                              self.val_loader.spec)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=self.lr,
            weight_decay=self.weight_decay, amsgrad=True)
        self.step = 0                       # successful optimizer steps
        # the dropout seed stream: step seeds come from a generator seeded
        # with (stream seed, draws so far)
        self._stream = [self.seed & _M32, 0]
        self._gen = torch.Generator()
        self.best_val_loss = float("inf")
        self.start_epoch = 0
        self._skip_steps = 0
        self._epoch_done = -1
        self._timer = StepTimer()
        self._staged = None          # the device epoch's staged cache
        self._snap: list = []        # the rollback snapshot's buffers
        if self.resume_from:
            self._resume(self.resume_from)
            if self.device_epoch and self._skip_steps:
                raise ValueError(
                    "--device_epoch cannot fast-forward into a MID-epoch "
                    "checkpoint (a staged epoch has no host-visible steps, "
                    "and the checkpoint's batch order came from a "
                    "host-looped run); resume this checkpoint without "
                    "--device_epoch, or resume an epoch-boundary checkpoint")

    def _check_fingerprint(self) -> None:
        """Every rank must walk the same batch sequence and enter the same
        collectives: one gather of the config fingerprint (JAX
        ``trainer.py:253-279``); a mismatch raises on every rank."""
        probe = np.asarray(
            [self.seed, len(self.train_data), len(self.val_data),
             self.batch_size, self.n_dp, self.n_ep, self.num_epochs,
             int(self.reuse_packs), int(self.device_epoch), self.spec.te,
             self.spec.tn, self.spec.tb, self.val_frequency,
             self.ckpt_every_steps, int(bool(self.resume_from)),
             self.steps_per_call, self.max_bad_steps, self.lr,
             self.weight_decay, self.gamma], np.float64)
        gathered = multihost.all_gather_rows(probe)
        if not (gathered == gathered[0:1]).all():
            raise ValueError(
                "multi-process config mismatch: every process must run the "
                "identical trainer config (seed, dataset sizes, batch size, "
                "mesh, epochs, pack spec) -- fingerprints (a row a rank):\n"
                f"{gathered}")

    def _check_modes(self) -> None:
        """Refuse what the JAX trainer refuses (``trainer.py:278-298``)."""
        if self.n_dp * self.n_ep > 1 and self.steps_per_call > 1:
            raise ValueError("steps_per_call > 1 is single-device only")
        if not self.device_epoch:
            return
        if not self.reuse_packs:
            raise ValueError("--device_epoch requires --reuse_packs (the "
                             "epoch cache is what gets staged on the device)")
        if self.ckpt_every_steps:
            raise ValueError("--device_epoch has no host-visible steps; "
                             "--ckpt_every_steps cannot fire inside a staged "
                             "epoch")
        if self.steps_per_call > 1:
            raise ValueError("--device_epoch runs the whole epoch with one "
                             "host read; --steps_per_call would be silently "
                             "ignored -- drop one of the two")

    # -- checkpointing ----------------------------------------------------
    def _ckpt_meta(self) -> dict:
        return {
            "name": self.name,
            "model": {
                "num_node_features": self.cfg.num_node_features,
                "num_edge_features": self.cfg.num_edge_features,
                "depth": self.cfg.depth,
                "hidden_sizes": list(self.cfg.hidden_sizes),
                "dropout_ps": list(self.cfg.dropout_ps),
                "activation": self.cfg.activation,
                "aggr": self.cfg.aggr,
                "pooling": self.cfg.pooling,
                "use_learnable_skip": self.cfg.use_learnable_skip,
            },
            "best_val_loss": self.best_val_loss,
            "epoch": self._epoch_done,
        }

    def save(self, path: str | Path, mid_epoch: tuple | None = None) -> Path:
        meta = self._ckpt_meta()
        if mid_epoch is not None:
            # (epoch in progress, successful steps completed within it)
            meta["mid_epoch"] = {"epoch": mid_epoch[0],
                                 "steps_done": mid_epoch[1]}
        # every rank holds the same state: the primary writes, and the
        # barrier keeps every rank until the file is whole
        if multihost.is_primary():
            save_checkpoint(path, self.model, meta, self.optimizer,
                            self.step, self._stream)
        multihost.sync_global_devices("ckpt")
        return Path(path)

    def _resume(self, path: str) -> None:
        leaves, meta = load_checkpoint(path)
        self.step, rng = restore_training_state(self.model, self.optimizer,
                                                leaves)
        if meta.get("seed_stream") == SEED_STREAM:
            self._stream = [int(rng[0]), int(rng[1])]
        self.best_val_loss = float(meta.get("best_val_loss", np.inf))
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        mid = meta.get("mid_epoch")
        if mid:
            # re-enter the interrupted epoch past its completed steps
            self.start_epoch = int(mid["epoch"])
            self._skip_steps = int(mid["steps_done"])

    # -- steps ------------------------------------------------------------
    def _seeds_at(self, draw: int) -> torch.Tensor:
        """The dropout seeds of the step at ``draw`` in the stream: one per
        conv layer (``models.kernel_seeds``' draw), [n_dp, depth] under DP
        and [n_dp, n_ep, depth] under EP (one per group, shard and layer,
        in that order; group 0's are the single-device draw's).  A rank of
        a multi-process run takes its cells' rows of that global draw."""
        self._gen.manual_seed((self._stream[0] << 32) | draw)
        lead = ((self.n_dp, self.n_ep) if self.n_ep > 1
                else (self.n_dp,) if self.n_dp > 1 else ())
        seeds = torch.randint(0, 2**31 - 1, lead + (self.cfg.depth,),
                              generator=self._gen,
                              dtype=torch.int64).to(torch.int32)
        return self._local(seeds)

    def _next_seeds(self, n: int) -> torch.Tensor:
        """The seeds of the next ``n`` steps, [n, ...], the rows the host
        loop would draw, on the trainer's device in one copy (on the card,
        the drop tables' rate rows go over once, here, and not in a step
        loop)."""
        seeds = torch.stack([self._seeds_at(self._stream[1] + i)
                             for i in range(n)]).to(self.device)
        if seeds.device.type == "cuda":
            stage_rates(self.cfg.dropout_ps, seeds.device)
        return seeds

    def _ep_step(self, kind: str, spec):
        """The EP train ("t") or eval ("e") step of ``spec``."""
        if (kind, spec) not in self._ep_steps:
            make = (make_ep_pack_train_step if kind == "t"
                    else make_ep_pack_eval_step)
            self._ep_steps[(kind, spec)] = make(self.model, spec, self._comm)
        return self._ep_steps[(kind, spec)]

    def _dp_groups(self, items, spec: PackSpec):
        """Loader batches ``n_dp`` at a time, stacked [n_dp, ...]; a short
        last group is padded with all-masked empty batches (JAX
        ``trainer.py:525-540``)."""
        group = []
        for b in items:
            group.append(b)
            if len(group) == self.n_dp:
                yield stack_batches(group)
                group = []
        if group:
            filler = empty_batch(spec, self.train_data.num_node_features,
                                 self.train_data.num_edge_features)
            yield stack_batches(group + [filler] * (self.n_dp - len(group)))

    def _local(self, stacked):
        """This rank's cells of a stacked array or item: leaves [n_dp, ...]
        (DP) or [n_dp, n_ep, ...] (EP) cut to its groups (and shards);
        in a single process all of it."""
        if self._lay.kind == "one":
            return stacked
        g = slice(self._lay.groups.start, self._lay.groups.stop)
        k = slice(self._lay.shards.start, self._lay.shards.stop)
        if torch.is_tensor(stacked):
            return stacked[g, k] if self.n_ep > 1 else stacked[g]
        return type(stacked)(*(a[g, k] if self.n_ep > 1 else a[g]
                               for a in stacked))

    def _mh_stream(self, loader):
        """A rank's items of a multi-process run (JAX ``_mh_stream``): the
        single-process items cut to this rank's cells, of which only its
        own are packed where the packing is per group.

        * DP without reuse: every rank computes the serial iteration's
          window and carry plan with the placement probe
          (``PackedLoader.plan_windows``) and packs only the windows of its
          groups (on a background thread); a packer that disagrees with the
          plan raises.
        * DP with ``reuse_packs``: the per-epoch batch-order shuffle moves
          cached batches between groups, so the cache is host-global and
          each step's local groups are cut from it.
        * EP: the edge partition is a decision over the whole group, so
          every rank builds the whole item and keeps its cells."""
        if self.n_ep > 1:
            for spec, stacked in loader.prefetch():
                yield spec, self._local(stacked)
            return
        if loader.reuse_packs:
            for stacked in self._dp_groups(loader.prefetch(), loader.spec):
                yield self._local(stacked)
            return
        yield from background(self._own_windows(loader))

    def _own_windows(self, loader):
        """This rank's groups of each step, packed from the plan of the
        serial iteration (filler batches past its end)."""
        plan = loader.plan_windows(loader._order())
        filler = None
        for first in range(0, len(plan), self.n_dp):
            group = []
            for g in self._lay.groups:
                if first + g < len(plan):
                    rows = plan[first + g]
                    b, used = loader._pack_window(rows)
                    if used != len(rows):
                        # a short pack on one rank would drop rows and
                        # part the ranks' data
                        raise RuntimeError(
                            f"window plan disagrees with the packer "
                            f"(planned {len(rows)} rows, packed {used})")
                else:
                    if filler is None:
                        filler = empty_batch(
                            loader.spec, loader.dataset.num_node_features,
                            loader.dataset.num_edge_features)
                    b = filler
                group.append(b)
            yield stack_batches(group)

    def _items(self, loader):
        """The loader's items, one a step: its batches (packed ahead on a
        background thread), under DP in stacked groups; over several ranks
        this rank's cells of them (:meth:`_mh_stream`)."""
        if self._lay.world > 1:
            return self._mh_stream(loader)
        items = loader.prefetch()
        if self.n_dp > 1 and self.n_ep == 1:
            return self._dp_groups(items, loader.spec)
        return items

    def _to_device(self, item):
        """A loader item on the trainer's device: a packed batch (DP: the
        step's groups stacked, [n_dp, ...]), or under EP (spec, the
        [n_dp][n_ep] shards of its groups)."""
        if self.n_ep == 1:
            return to_device(item, self.device)
        spec, stacked = item
        return spec, [ep_shards(EPPackedBatch(*(a[g] for a in stacked)),
                                self.device)
                      for g in range(len(self._lay.groups))]

    def _stack_on_device(self, host: list):
        """Loader items stacked on the trainer's device, one transfer a
        field: a packed batch of [n, ...] tensors (DP: [n, n_dp, ...]), or
        under EP (their one spec, the [n, n_dp, n_ep, ...] shards of each
        item's groups).  :meth:`_staged_row` reads item i back as views."""
        if self.n_ep == 1:
            return to_device(PackedGraphBatch(*map(np.stack, zip(*host))),
                             self.device)
        spec = host[0][0]
        if any(sp != spec for sp, _ in host):
            raise RuntimeError("the reused EP packs must share one spec to "
                               "be staged")
        return spec, EPPackedBatch(*(
            device_tensor(np.stack([b[f] for _, b in host]), self.device)
            for f in range(len(EPPackedBatch._fields))))

    def _device_batches(self, host: list) -> list:
        """Loader batches on the device: one alone as it is, several
        stacked in one transfer and taken row by row (views)."""
        if len(host) == 1:
            return [self._to_device(host[0])]
        stacked = self._stack_on_device(host)
        return [self._staged_row(stacked, j) for j in range(len(host))]

    def _grads(self, batch, seeds) -> torch.Tensor:
        """The step's loss (0-dim, on the device) with the gradients of
        every parameter in ``.grad``; no optimizer step."""
        spec = self.train_loader.spec
        if self.n_ep > 1:
            spec, groups = batch
            return self._ep_step("t", spec)(groups, seeds)
        if self.n_dp > 1:
            return self._dp_train(batch, seeds)
        if supports_fused_train(self.cfg):
            return fused_train_value_and_grad(self.model, batch, spec, seeds)
        self.optimizer.zero_grad()
        sse = sse_loss(self.model, batch, spec, train=True, seeds=seeds)
        sse.backward()
        return sse.detach()

    def _train_step(self, batch) -> float:
        """One step on a device batch: the loss; the update is applied only
        when the loss is finite."""
        loss = float(self._grads(batch, self._seeds_at(self._stream[1])))
        if math.isfinite(loss):
            self.optimizer.step()
            self.step += 1
            self._stream[1] += 1
        return loss

    def _run_steps(self, batches, seeds: torch.Tensor) -> torch.Tensor:
        """One step on each device batch in turn, step i with ``seeds[i]``
        (on the trainer's device), the optimizer stepping always: the [n]
        losses, left on the device.  Nothing here copies to the device or
        reads from it."""
        losses = []
        for i, batch in enumerate(batches):
            losses.append(self._grads(batch, seeds[i]))
            self.optimizer.step()
        return torch.stack(losses)

    def _train_chunk(self, batches: list) -> list[float]:
        """``steps_per_call`` steps with one host read: their losses.  A
        non-finite one rolls the whole chunk back (the state, seeds
        included, as before it)."""
        snap = self._snapshot()
        losses = self._run_steps(batches, self._next_seeds(len(batches)))
        losses = losses.tolist()
        if all(math.isfinite(v) for v in losses):
            self.step += len(batches)
            self._stream[1] += len(batches)
        else:
            self._restore(snap)
        return losses

    def _state_tensors(self, layout: list) -> list:
        """The live training tensors: the parameters, then the Adam state
        of each (``layout``: its state's keys, or none before its first
        step)."""
        params = list(self.model.parameters())
        return [p.detach() for p in params] + [
            self.optimizer.state[p][k] for p, keys in zip(params, layout)
            for k in keys]

    def _snapshot(self) -> tuple:
        """The training state as device-side copies (``optimizer
        .state_dict()`` would give references) in buffers made once and
        refilled, with ``step`` and the seed stream."""
        layout = [tuple(sorted(self.optimizer.state.get(p, {})))
                  for p in self.model.parameters()]
        live = self._state_tensors(layout)
        with torch.no_grad():
            if [t.shape for t in self._snap] != [t.shape for t in live]:
                self._snap = [t.clone() for t in live]
            else:
                _copy_all(self._snap, live)
        return layout, self.step, list(self._stream)

    def _restore(self, snap: tuple) -> None:
        """Put back the state of :meth:`_snapshot`, bit for bit (Adam's
        state of a parameter dropped where it had none then)."""
        layout, self.step, stream = snap
        self._stream = list(stream)
        for p, keys in zip(self.model.parameters(), layout):
            if not keys:
                self.optimizer.state.pop(p, None)
        with torch.no_grad():
            _copy_all(self._state_tensors(layout), self._snap)

    def _grad_norm(self) -> float:
        return float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                    for p in self.model.parameters())))

    def _param_norm(self) -> float:
        return float(torch.sqrt(sum((p.detach().double() ** 2).sum()
                                    for p in self.model.parameters())))

    # -- epochs -----------------------------------------------------------
    def _chunks(self):
        """The loader's batches in lists of ``steps_per_call``, the
        remainder one at a time (JAX ``trainer.py:749-770``)."""
        K, pend = self.steps_per_call, []
        for b in self._items(self.train_loader):
            pend.append(b)
            if len(pend) == K:
                yield pend
                pend = []
        for b in pend:
            yield [b]

    def _train_epoch(self, epoch_idx: int) -> float:
        if self.device_epoch:
            return self._train_epoch_device(epoch_idx)
        total = 0.0
        self.train_loader.set_epoch(epoch_idx)
        self._timer.reset_epoch()
        bad = 0
        skip = self._skip_steps if epoch_idx == self.start_epoch else 0
        if skip:
            msg = {"event": "resume_mid_epoch", "epoch": epoch_idx,
                   "skipping_steps": skip}
            (self.logger.log(msg) if self.logger else print(msg))
        steps_done = 0
        hist_sample = None
        for host in self._chunks():
            n = len(host)
            if steps_done + n <= skip:
                # fast-forward the deterministic loader past steps already
                # trained before the mid-epoch checkpoint
                steps_done += n
                continue
            batches = self._device_batches(host)
            if (self.log_histograms and hist_sample is None
                    and self.n_ep == 1):
                hist_sample = self._first_batch(batches[0])
            losses = ([self._train_step(batches[0])] if n == 1
                      else self._train_chunk(batches))
            if not all(math.isfinite(v) for v in losses):
                # NaN/inf guard: the update was not applied, or the chunk
                # was rolled back (the state and the seed stream stay at
                # the last good step)
                bad += 1
                msg = {"event": "non_finite_loss", "epoch": epoch_idx,
                       "consecutive": bad}
                (self.logger.log(msg) if self.logger else print(msg))
                if bad >= self.max_bad_steps:
                    raise FloatingPointError(
                        f"{bad} consecutive non-finite losses at epoch "
                        f"{epoch_idx}; aborting (last checkpoint is intact)")
                continue
            bad = 0
            for v in losses:
                total += v
            self._timer.tick(n)
            steps_done += n
            every = self.ckpt_every_steps
            if every and steps_done // every > (steps_done - n) // every:
                self.save(Path(self.model_save_dir)
                          / f"{self.name}.latest.npz",
                          mid_epoch=(epoch_idx, steps_done))
        self._skip_steps = 0
        return self._end_epoch(epoch_idx, total, hist_sample,
                               steps_done > skip)

    def _stage_epoch(self) -> tuple:
        """(the staged cache, its S steps): the loader's reused pack cache
        on the trainer's device, [S, ...] (DP: [S, n_dp, ...]; EP: the spec
        and [S, n_dp, n_ep, ...]), made once.  Single device: in cache
        order, read past the loader's shuffle, so that each epoch's order
        is the loader's own and not composed with the staging order (JAX
        ``trainer.py:621-638``).  DP and EP: the epoch-0 iteration's steps
        (the host loop's epoch-0 groups; EP: every item under one spec)."""
        if self._staged is not None:
            return self._staged
        if self.n_dp == 1 and self.n_ep == 1:
            items = self.train_loader.cached_batches()
        else:
            self.train_loader.set_epoch(0)
            items = list(self._items(self.train_loader))
        staged = self._stack_on_device(items)
        tensors = staged if self.n_ep == 1 else staged[1]
        self._staged = (staged, len(items))
        mb = sum(t.numel() * t.element_size() for t in tensors) / 2**20
        msg = {"device_epoch_staged_mb": mb}
        print(json.dumps(msg))
        if self.logger:
            self.logger.log(msg)
        return self._staged

    def _staged_row(self, staged, i: int):
        """Step ``i`` of the staged cache as views: a packed batch (DP: its
        stacked groups), or under EP (spec, its [n_dp][n_ep] shards)."""
        if self.n_ep == 1:
            return PackedGraphBatch(*(t[i] for t in staged))
        spec, b = staged
        return spec, [[EPPackedBatch(*(t[i, g, k] for t in b))
                       for k in range(len(self._lay.shards))]
                      for g in range(len(self._lay.groups))]

    def _first_batch(self, item):
        """The first packed batch of a device item: the histograms' sample
        (DP: group 0's)."""
        return item if self.n_dp == 1 else groups_of(item)[0]

    def _train_epoch_device(self, epoch_idx: int) -> float:
        """One staged epoch: its seeds copied over once, its steps run with
        no host read, its losses read once at the end."""
        staged, S = self._stage_epoch()
        # the loader's order over the cache (shuffled from seed + epoch);
        # DP and EP staged the epoch-0 iteration, so their epoch 0 is the
        # identity and later epochs shuffle whole steps (JAX :690-697)
        order = np.arange(S)
        if self.train_loader.shuffle and not (
                epoch_idx == 0 and self.n_dp * self.n_ep > 1):
            np.random.default_rng(self.train_loader.seed
                                  + epoch_idx).shuffle(order)
        seeds = self._next_seeds(S)
        snap = self._snapshot()
        self._timer.reset_epoch()
        self._timer.tick()
        losses = self._run_steps((self._staged_row(staged, i) for i in order),
                                 seeds).tolist()
        self._timer.tick(S)
        if not all(math.isfinite(v) for v in losses):
            # epoch-granular NaN guard: the whole epoch rolls back, and a
            # rerun would repeat it (the same batches, seeds and order)
            self._restore(snap)
            msg = {"event": "non_finite_loss", "epoch": epoch_idx,
                   "scope": "device_epoch (epoch rolled back)"}
            (self.logger.log(msg) if self.logger else print(msg))
            raise FloatingPointError(
                f"non-finite loss inside staged epoch {epoch_idx}; state "
                f"rolled back to epoch start (checkpoint intact)")
        self.step += S
        self._stream[1] += S
        sample = (self._first_batch(self._staged_row(staged, 0))
                  if self.log_histograms and self.n_ep == 1 else None)
        # summed in step order, as the host loop sums
        return self._end_epoch(epoch_idx, sum(losses), sample, True)

    def _end_epoch(self, epoch_idx: int, total: float, hist_sample,
                   stepped: bool) -> float:
        """The epoch's RMSE, logged with its step times (and norms), and its
        histograms; ``stepped``: a step ran, so ``.grad`` holds the last
        step's gradients."""
        rmse = float(np.sqrt(total / len(self.train_data)))
        if self.logger:
            rec = {"train_loss": rmse, "epoch": epoch_idx,
                   **self._timer.stats()}
            if self.log_param_norms:
                rec["param_norm"] = self._param_norm()
                if stepped:
                    rec["grad_norm"] = self._grad_norm()
            self.logger.log(rec)
        else:
            print(f"\n______epoch {epoch_idx}\nTrain loss, RMSE: {rmse:.4f}")
        if self.log_histograms and self.logger:
            self._emit_histograms(epoch_idx, hist_sample)
        return rmse

    def _emit_histograms(self, epoch_idx: int, sample_batch) -> None:
        """Per-parameter histograms of the params every epoch, and of the
        eval-mode gradients of one sampled batch (dropout off: the
        histogram shows the loss surface, not one mask draw)."""
        named = dict(self.model.named_parameters())
        self.logger.log_histograms("params", named, epoch_idx)
        if sample_batch is not None:
            with torch.enable_grad():
                loss = sse_loss(self.model, sample_batch,
                                self.train_loader.spec)
                grads = torch.autograd.grad(loss, list(named.values()))
            self.logger.log_histograms("grads", dict(zip(named, grads)),
                                       epoch_idx)

    def _val_epoch(self, epoch_idx: int) -> float:
        total = 0.0
        with torch.no_grad():
            for host_batch in self._items(self.val_loader):
                batch = self._to_device(host_batch)
                if self.n_ep > 1:
                    spec, groups = batch
                    total += float(self._ep_step("e", spec)(groups)[0])
                elif self.n_dp > 1:
                    total += float(self._dp_eval(batch))
                else:
                    total += float(sse_loss(self.model, batch,
                                            self.val_loader.spec))
        rmse = float(np.sqrt(total / len(self.val_data)))
        if self.logger:
            self.logger.log({"val_loss": rmse, "epoch": epoch_idx})
        else:
            print(f"Val loss, RMSE: {rmse:.4f}\n")
        return rmse

    def train(self) -> dict:
        """Full loop; returns {'train_losses': [...], 'val_losses': [...],
        'train_time_s', 'steps'}."""
        out = {"train_losses": [], "val_losses": []}
        save_dir = Path(self.model_save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        self._epoch_done = self.start_epoch - 1
        t0 = time.time()
        for epoch in range(self.start_epoch, self.num_epochs):
            set_epoch_lr(self.optimizer, self.lr, self.gamma, epoch)
            out["train_losses"].append(self._train_epoch(epoch))
            self._epoch_done = epoch
            if epoch % self.val_frequency == 0 or epoch == self.num_epochs - 1:
                val = self._val_epoch(epoch)
                out["val_losses"].append(val)
                if val < self.best_val_loss:
                    self.best_val_loss = val
                    path = self.save(save_dir / f"{self.name}.npz")
                    if multihost.is_primary():
                        print(f"New best model with validation loss RMSE: "
                              f"{self.best_val_loss:.4f} located at {path}")
            # latest state for resume
            self.save(save_dir / f"{self.name}.latest.npz")
        out["train_time_s"] = time.time() - t0
        out["steps"] = self.step
        if self.logger:
            self.logger.finish()
        return out
