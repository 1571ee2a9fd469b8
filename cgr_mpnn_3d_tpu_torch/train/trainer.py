"""Training loop on one device: the counterpart of the single-device path of
``cgr_mpnn_3d_tpu/train/trainer.py::RxnGraphTrainer``.

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
* EP          with ``n_ep > 1`` (JAX ``trainer.py:299-313``, :355-386) the
              batches come from ``parallel.EPPackLoader`` (``ep_te`` /
              ``ep_tn`` tiles) as (spec, batch), and every shard of a step
              runs in this process: the step and the validation step are
              ``parallel.ep_pack``'s, keyed by the loader's spec (rebuilt
              when the pins grow), with one dropout seed per shard and
              layer, at either ``compute_dtype`` and with the config's
              ``ep_overlap`` and ``ep_rdma_exchange``; the gradient
              histograms are skipped there, as in JAX.

* loaders     ``reuse_packs`` packs each loader's epoch once and reuses
              its batches in later epochs (batch order shuffled from seed
              + epoch); ``loader_workers`` is accepted and packing stays
              serial (``data/loader.py``); both reach the EP loader too, as
              in JAX (``trainer.py:300-326``).

Left out: data parallelism, multi-host, device-resident epochs and several
steps per call (ROADMAP.md).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..data.batch import PackSpec, to_device
from ..data.dataset import ChemDataset
from ..data.loader import PackedLoader
from ..models.cgr_mpnn import (CGRMPNNConfig, apply,
                               fused_train_value_and_grad, init_params,
                               kernel_seeds, supports_fused_train)
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


def sse_loss(model, batch, spec: PackSpec, train: bool = False,
             seeds=None) -> torch.Tensor:
    """Masked sum of squared errors of ``apply`` on ``batch``."""
    preds = apply(model, batch, spec, train=train, seeds=seeds)
    err = (preds - batch.labels) * batch.graph_mask
    return (err * err).sum()


@dataclass
class RxnGraphTrainer:
    """Orchestrates train/val epochs on one device."""
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
    # edge partitioning: shards per step, and the EP packer's tile
    n_ep: int = 1
    ep_te: int = 128
    ep_tn: int = 72
    # the loaders' packing threads and cross-epoch pack reuse
    loader_workers: int = 1
    reuse_packs: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.n_ep = max(1, self.n_ep)
        modes = dict(reuse_packs=self.reuse_packs,
                     workers=self.loader_workers)
        if self.n_ep > 1:
            self.train_loader = EPPackLoader(self.train_data, self.n_ep,
                                             batch_size=self.batch_size,
                                             shuffle=True, seed=self.seed,
                                             te=self.ep_te, tn=self.ep_tn,
                                             **modes)
            self.val_loader = EPPackLoader(self.val_data, self.n_ep,
                                           batch_size=self.batch_size,
                                           shuffle=False, te=self.ep_te,
                                           tn=self.ep_tn, **modes)
        else:
            self.train_loader = PackedLoader(self.train_data, self.spec,
                                             batch_size=self.batch_size,
                                             shuffle=True, seed=self.seed,
                                             **modes)
            self.val_loader = PackedLoader(self.val_data, self.spec,
                                           batch_size=self.batch_size,
                                           **modes)
        # the EP steps, keyed by ("t" | "e", the loader's spec)
        self._ep_steps: dict = {}
        self.model = init_params(self.cfg,
                                 torch.Generator().manual_seed(self.seed),
                                 self.device)
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
        if self.resume_from:
            self._resume(self.resume_from)

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
        return save_checkpoint(path, self.model, meta, self.optimizer,
                               self.step, self._stream)

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
    def _step_seeds(self) -> torch.Tensor:
        """The step's dropout seeds: one per conv layer, or [n_ep, depth]
        (one per shard and layer, in shard order) under EP."""
        self._gen.manual_seed((self._stream[0] << 32) | self._stream[1])
        if self.n_ep > 1:
            return torch.randint(0, 2**31 - 1, (self.n_ep, self.cfg.depth),
                                 generator=self._gen,
                                 dtype=torch.int64).to(torch.int32)
        return kernel_seeds(self.cfg, self._gen)

    def _ep_step(self, kind: str, spec):
        """The EP train ("t") or eval ("e") step of ``spec``."""
        if (kind, spec) not in self._ep_steps:
            make = (make_ep_pack_train_step if kind == "t"
                    else make_ep_pack_eval_step)
            self._ep_steps[(kind, spec)] = make(self.model, spec)
        return self._ep_steps[(kind, spec)]

    def _to_device(self, item):
        """A loader item on the trainer's device: a packed batch, or under
        EP (spec, the shards of its one data-parallel group)."""
        if self.n_ep == 1:
            return to_device(item, self.device)
        spec, stacked = item
        return spec, ep_shards(EPPackedBatch(*(a[0] for a in stacked)),
                               self.device)

    def _train_step(self, batch) -> float:
        """One step on a device batch: the loss; the update is applied only
        when the loss is finite."""
        spec, seeds = self.train_loader.spec, self._step_seeds()
        if self.n_ep > 1:
            spec, shards = batch
            sse = self._ep_step("t", spec)(shards, seeds)
        elif supports_fused_train(self.cfg):
            sse = fused_train_value_and_grad(self.model, batch, spec, seeds)
        else:
            self.optimizer.zero_grad()
            sse = sse_loss(self.model, batch, spec, train=True, seeds=seeds)
            sse.backward()
        loss = float(sse.detach())
        if math.isfinite(loss):
            self.optimizer.step()
            self.step += 1
            self._stream[1] += 1
        return loss

    def _grad_norm(self) -> float:
        return float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                    for p in self.model.parameters())))

    def _param_norm(self) -> float:
        return float(torch.sqrt(sum((p.detach().double() ** 2).sum()
                                    for p in self.model.parameters())))

    # -- epochs -----------------------------------------------------------
    def _train_epoch(self, epoch_idx: int) -> float:
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
        for host_batch in self.train_loader.prefetch():
            if steps_done < skip:
                # fast-forward the deterministic loader past steps already
                # trained before the mid-epoch checkpoint
                steps_done += 1
                continue
            batch = self._to_device(host_batch)
            if (self.log_histograms and hist_sample is None
                    and self.n_ep == 1):
                hist_sample = batch
            loss = self._train_step(batch)
            if not math.isfinite(loss):
                # NaN/inf guard: the update was not applied (the state and
                # the seed stream stay at the last good step)
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
            total += loss
            self._timer.tick()
            steps_done += 1
            if (self.ckpt_every_steps
                    and steps_done % self.ckpt_every_steps == 0):
                self.save(Path(self.model_save_dir)
                          / f"{self.name}.latest.npz",
                          mid_epoch=(epoch_idx, steps_done))
        self._skip_steps = 0
        rmse = float(np.sqrt(total / len(self.train_data)))
        if self.logger:
            rec = {"train_loss": rmse, "epoch": epoch_idx,
                   **self._timer.stats()}
            if self.log_param_norms:
                rec["param_norm"] = self._param_norm()
                if steps_done > skip:
                    # the gradients of the epoch's last step
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
            for host_batch in self.val_loader.prefetch():
                batch = self._to_device(host_batch)
                if self.n_ep > 1:
                    spec, shards = batch
                    total += float(self._ep_step("e", spec)(shards)[0])
                    continue
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
                    print(f"New best model with validation loss RMSE: "
                          f"{self.best_val_loss:.4f} located at {path}")
            # latest state for resume
            self.save(save_dir / f"{self.name}.latest.npz")
        out["train_time_s"] = time.time() - t0
        out["steps"] = self.step
        if self.logger:
            self.logger.finish()
        return out
