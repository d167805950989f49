"""Halo-sharded whole-mesh training over several parts.

Counterpart of geobignn_tpu/train/halo_trainer.py: `Config.halo_parts > 1`
routes `train()` here.  Each training sample is ONE whole mesh,
node-partitioned over `halo_parts` parts with a boundary exchange per conv
(parallel/halo_model.py); the optimizer trajectory is that of single-device
full-batch training on the same hierarchies.  This module adds the epoch
loop, the node-weighted eval pass, the learning-rate policies (the plateau
included), best/last checkpoints in the JAX file format and resume — the
surface of train/trainer.Trainer.

The parts run on `devices` (one per part; one device may be named several
times), on the CPU with device="cpu", else on the first `halo_parts`
visible cards.  With every part on one card, each step and each
evaluation forward replays one CUDA graph of its mesh's shapes
(parallel/halo_train.py), all in one memory pool; parts on several cards,
the CPU and testing.eager_steps() run eagerly.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from geobignn_tpu_torch import capture
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.models import losses
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.parallel import halo_train as ht
from geobignn_tpu_torch.parallel.api import make_mesh
from geobignn_tpu_torch.train import checkpoint as ckpt
from geobignn_tpu_torch.train import optim
from geobignn_tpu_torch.train.logging import MetricLogger
from geobignn_tpu_torch.utils import resolve_device


def part_devices(n_parts: int, device=None, devices=None) -> list[torch.device]:
    """The devices of n_parts parts: `devices` as given, every part on the
    CPU with device="cpu", else the first n_parts visible cards (raises with
    fewer, as JAX's make_mesh)."""
    if devices is not None:
        if len(devices) != n_parts:
            raise ValueError(f"{n_parts} parts, {len(devices)} devices")
        return [torch.device(d) for d in devices]
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n_parts
    return make_mesh(1, n_parts)[0]


class HaloTrainer:
    """Epoch-driven trainer over halo-sharded mesh pairs.

    mesh_pairs / eval_pairs: [(TriMesh noisy, TriMesh original)]."""

    # surface-to-volume knee: below about this many faces per part, splitting
    # a mesh trades more compute for boundary exchange than it saves
    KNEE_FACES_PER_PART = 2560

    def __init__(self, cfg: Config, mesh_pairs, eval_pairs=None, run_dir: str | None = None,
                 device=None, devices=None):
        if cfg.halo_parts < 2:
            raise ValueError("HaloTrainer needs cfg.halo_parts >= 2")
        cfg.validate()
        self.cfg = cfg
        self.run_dir = run_dir
        self.n_parts = cfg.halo_parts
        self.devices = part_devices(self.n_parts, device, devices)
        self.device = self.devices[0]  # the parameters and optimizer live here

        # halo builds order each part's slots themselves; a whole-mesh RCM
        # order would be redone anyway
        bc = dataclasses.replace(cfg.build_config(), reorder=False)

        def build(m_n, m_o):
            return ht.build_halo_train_sample(
                m_n, m_o, bc, self.n_parts, seed=cfg.preprocess_seed,
                granularity=cfg.granularity, banded=cfg.halo_banded, devices=self.devices)

        if not mesh_pairs:
            raise ValueError("HaloTrainer needs at least one training pair: mesh_pairs "
                             "is empty")
        min_fpp = min(m_n.n_faces for m_n, _ in mesh_pairs) // self.n_parts
        if min_fpp < self.KNEE_FACES_PER_PART:
            # a warning, not a failure: the run is still right, only slower
            print(
                f"WARNING: halo_parts={self.n_parts} leaves only {min_fpp} "
                f"faces/partition on the smallest mesh — below the "
                f"surface-to-volume knee (~{self.KNEE_FACES_PER_PART} faces/part); "
                "use fewer partitions or larger meshes")

        self.samples = [build(m_n, m_o) for m_n, m_o in mesh_pairs]
        self.eval_samples = [build(m_n, m_o) for m_n, m_o in (eval_pairs or [])]
        self._compute_dtype = torch.bfloat16 if cfg.precision == "bfloat16" else None
        self.model = DualGNN(force_depth=cfg.force_depth, pool_type=cfg.pool_type,
                             heads=cfg.heads, device=self.device, seed=cfg.seed or 0)
        self.optimizer = optim.make_optimizer(cfg, self.model.parameters())
        self.epoch = 0
        self.best_error = float("inf")
        self._restored_plateau = None
        self._steps: dict = {}  # exchange schedule -> step
        self._fwds: dict = {}
        # one stream replays the steps' and the evaluation's graphs one at a
        # time: they share one memory pool, as the meshes' graphs would
        # otherwise each keep a step's memory
        self._pool = capture.Pool()

    # ------------------------------------------------------------------
    def _step_for(self, sample):
        key = repr(sample.static)
        if key not in self._steps:
            cfg = self.cfg
            self._steps[key] = ht.make_halo_train_step(
                self.model, self.optimizer, static_d=sample.static, loss_cfg=cfg.loss_cfg(),
                pool_type=cfg.pool_type, augment=cfg.augment, n_steps=1,
                compute_dtype=self._compute_dtype)
            self._steps[key].program.pool = self._pool
        return self._steps[key]

    def _fwd_for(self, sample):
        key = repr(sample.static)
        if key not in self._fwds:
            self._fwds[key] = ht.make_halo_forward(
                self.model, static_d=sample.static, pool_type=self.cfg.pool_type,
                compute_dtype=self._compute_dtype)
            self._fwds[key].program.pool = self._pool
        return self._fwds[key]

    # ------------------------------------------------------------------
    def run_epoch(self, rng: np.random.Generator, logger: MetricLogger | None = None):
        """One step per mesh, in the order `rng` permutes them; each step's
        rotation seed is the next integer `rng` draws.  Metrics sync once."""
        order = rng.permutation(len(self.samples))
        self.model.train()
        sums, msgs_done = {}, 0
        t0 = time.time()
        for i in order:
            s = self.samples[int(i)]
            seed = int(rng.integers(1 << 31))
            metrics = self._step_for(s)(s.arrays, seed)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0) + v.detach()
            msgs_done += int(s.meta.get("messages", 0))
        keys = list(sums)
        vals = torch.stack([sums[k] for k in keys]).cpu().tolist() if keys else []
        dt = max(time.time() - t0, 1e-9)
        agg = {k: v / max(len(order), 1) for k, v in zip(keys, vals)}
        agg["samples_per_s"] = len(order) / dt
        if msgs_done:  # real (unpadded) conv messages -> edges/s
            agg["edges_per_s"] = msgs_done / dt
            agg["edges_per_s_chip"] = msgs_done / dt / self.n_parts
        if logger:
            logger.log("train", self.epoch, **agg)
        return agg

    def evaluate(self, logger: MetricLogger | None = None):
        """Node-weighted eval over the eval meshes: the sharded forward,
        unsharded on the host, the reference metrics on the whole graphs."""
        if not self.eval_samples:
            return None
        self.model.eval()
        cfg = self.cfg
        sums = dict(loss_v=0.0, loss_f=0.0, error_v=0.0, error_f=0.0, n_v=0.0, n_f=0.0)
        for s in self.eval_samples:
            v_loc, n_loc = self._fwd_for(s)(s.arrays)
            vp, nf = ht.unshard_predictions(s, v_loc, n_loc)
            yv, ynf = ht.unshard_predictions(s, [a["yv"] for a in s.arrays],
                                             [a["yf"] for a in s.arrays])
            dv, dn = vp - yv, nf - ynf
            # the loss family the step optimizes, through the single-device
            # losses on the unsharded predictions
            t = torch.from_numpy
            if cfg.loss_v == "CD":
                ones_v = torch.ones(vp.shape[0])
                sums["loss_v"] += float(losses.loss_v(t(vp), t(yv), ones_v, "CD")) * vp.shape[0]
            else:
                sums["loss_v"] += float((np.abs(dv) if cfg.loss_v == "L1" else dv ** 2).sum())
            if cfg.loss_n == "sided":
                fv = s.meta["fv_indices"]
                ones_f = torch.ones(nf.shape[0])
                sums["loss_f"] += float(losses.loss_n(
                    t(nf), t(ynf), ones_f, "sided", t(vp[fv].mean(axis=1)),
                    t(yv[fv].mean(axis=1)))) * nf.shape[0]
            else:
                sums["loss_f"] += float((np.abs(dn) if cfg.loss_n == "L1" else dn ** 2).sum())
            sums["error_v"] += float(np.sqrt((dv ** 2).sum(1)).sum())
            en = np.degrees(np.arccos(np.clip(1.0 - (dn ** 2).sum(1) / 2.0, -1, 1)))
            sums["error_f"] += float(en.sum())
            sums["n_v"] += s.n_v
            sums["n_f"] += s.n_f
        cv, cf = max(sums["n_v"], 1.0), max(sums["n_f"], 1.0)
        out = dict(loss_v=sums["loss_v"] / cv, error_v=sums["error_v"] / cv,
                   loss_f=sums["loss_f"] / cf, error_f=sums["error_f"] / cf)
        if logger:
            logger.log("test", self.epoch, **out)
        return out

    # ------------------------------------------------------------------
    def fit(self, logger: MetricLogger | None = None, on_epoch=None) -> float:
        cfg = self.cfg
        plateau = (optim.PlateauState(cfg.lr, cfg.lr_decay, cfg.lr_step[0])
                   if cfg.lr_sch == "auto" else None)
        if plateau is not None and self._restored_plateau:
            for k, v in self._restored_plateau.items():
                setattr(plateau, k, v)
        last_lr = plateau.lr if plateau is not None else cfg.lr
        for self.epoch in range(self.epoch, cfg.max_epoch):
            if plateau is None:
                last_lr = optim.lr_at_epoch(cfg, self.epoch)
            optim.set_lr(self.optimizer, last_lr)
            # epoch-keyed rng: a resumed run replays the shuffle and rotations
            rng = np.random.default_rng((cfg.seed or 0) * 100003 + self.epoch)
            train_m = self.run_epoch(rng, logger)
            eval_m = self.evaluate(logger)
            key_err = (eval_m or train_m)["error_f"]
            if plateau is not None:
                last_lr = plateau.step(key_err)
            if key_err < self.best_error:
                self.best_error = key_err
                if self.run_dir:
                    ckpt.save_checkpoint(os.path.join(self.run_dir, "ckpt_best.pkl"),
                                         self.model.state_dict(), epoch=self.epoch,
                                         best_error=self.best_error)
            if self.run_dir:
                ckpt.save_checkpoint(
                    os.path.join(self.run_dir, "ckpt_last.pkl"),
                    self.model.state_dict(), self.optimizer.state_dict(),
                    epoch=self.epoch, best_error=self.best_error,
                    plateau=None if plateau is None else dataclasses.asdict(plateau))
            if on_epoch:
                on_epoch(self, train_m, eval_m)
        return self.best_error

    def restore(self, path: str, with_opt: bool = True):
        """Weights, epoch, best error, plateau state and, with_opt, the
        optimizer state of a checkpoint."""
        state, opt_state, scalars = ckpt.load_checkpoint(path, with_opt=with_opt)
        self.model.load_state_dict(state)
        if with_opt and opt_state is not None:
            optim.load_state(self.optimizer, opt_state)
            self._steps.clear()  # their graphs hold the replaced state tensors
        self.epoch = int(scalars.get("epoch", -1)) + 1
        self.best_error = float(scalars.get("best_error", float("inf")))
        self._restored_plateau = scalars.get("plateau")

