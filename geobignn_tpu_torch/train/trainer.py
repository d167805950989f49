"""Single-device training loop: steps, accumulation, eval, schedules.

Counterpart of geobignn_tpu/train/trainer.py:35-427 (`_metrics_of`,
`Trainer.__init__`, `run_epoch`, `evaluate`, `fit`; reference
code/train_dual.py): per-sample forward with an on-device random rotation,
the dual L1 loss, gradient accumulation over `batch_size` samples, a full
node-weighted eval pass each epoch, and per-epoch learning-rate policies
(the plateau keyed on the eval normal error, or on the train one when there
is no eval set).

The JAX trainer saves TPU dispatches with a fused step and a whole epoch in
one `lax.scan`; here each step is one Python iteration with the same
results.  Metrics accumulate on the device and sync once per epoch.  Every
epoch draws `np.random.default_rng(seed * 100003 + epoch)`: the permutation
first (so the shuffle equals the JAX trainer's), then one integer per step
that seeds the rotation's torch.Generator.

Not ported yet, and refused with NotImplementedError rather than taking
another path: checkpoints (`run_dir`, `restore`, `auto_resume`), dynamic
pooling, multi-device meshes, `precision="bfloat16"`, size bucketing and
streaming with prefetch (`preload=False`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import augment
from geobignn_tpu_torch.models import losses
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.train import optim
from geobignn_tpu_torch.train.logging import MetricLogger
from geobignn_tpu_torch.utils import not_ported, resolve_device

METRIC_KEYS = ("loss", "loss_v", "loss_f", "error_v", "error_f", "n_v", "n_f")


def _metrics_of(vert_p, norm_p, sample, cfg: Config):
    mask_v = sample.v.levels[0].node_mask
    mask_f = sample.f.levels[0].node_mask
    lv = losses.loss_v(vert_p, sample.v.y, mask_v, cfg.loss_v)
    fc_p = fc = None
    if cfg.loss_n == "sided":  # nearest-face matching needs face centroids
        fc_p = vert_p[sample.fv_indices].mean(dim=1)
        fc = sample.v.y[sample.fv_indices].mean(dim=1)
    ln = losses.loss_n(norm_p, sample.f.y, mask_f, cfg.loss_n, fc_p, fc)
    loss = losses.dual_loss(lv, ln, cfg.loss_v_scale, cfg.loss_n_scale)
    return loss, dict(
        loss=loss,
        loss_v=lv,
        loss_f=ln,
        error_v=losses.error_v(vert_p, sample.v.y, mask_v),
        error_f=losses.error_n(norm_p, sample.f.y, mask_f),
        n_v=mask_v.sum(),
        n_f=mask_f.sum(),
    )


class Trainer:
    """Single-device trainer.  Runs on CUDA unless device="cpu"; the model
    is initialised from `cfg.seed` (load other weights into `self.model`
    before `fit`)."""

    def __init__(self, cfg: Config, train_ds, eval_ds=None, run_dir: str | None = None,
                 device=None):
        cfg.validate()
        if run_dir is not None or cfg.restore or cfg.auto_resume:
            not_ported("trainer checkpoints (run_dir, restore, auto_resume; "
                       "the msgpack framing of train/checkpoint.py)",
                       "modules to port, item 3, checkpoints, Predictor.from_run and the CLI")
        if cfg.dynamic_pool or cfg.edge_weight_type in (3, 4, 5):
            not_ported("dynamic pooling (edge_weight_type 3-5, dynamic_pool)",
                       "modules to port, item 7, dynamic pooling")
        if cfg.dcn * cfg.dp * cfg.gp > 1:
            not_ported("multi-device training (dp * gp * dcn > 1)",
                       "modules to port, item 6, halo and multi-chip paths")
        if cfg.precision == "bfloat16":
            not_ported("precision='bfloat16'",
                       "modules to port, item 5, the precision='bfloat16' mode")
        if cfg.buckets_growth > 1.0:
            not_ported("size bucketing (buckets_growth > 1)",
                       "modules to port, item 8, the rest of the package: bucketing")
        if not cfg.preload:
            not_ported("streaming with prefetch (preload=False, data/prefetch.py)",
                       "modules to port, item 8, the rest of the package: data/prefetch.py")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_ds = train_ds
        self.eval_ds = eval_ds
        self.plan = train_ds.plan
        if eval_ds is not None and eval_ds.plan is not None:
            self.plan = self.plan.merge(eval_ds.plan)
        self.model = DualGNN(
            force_depth=cfg.force_depth, pool_type=cfg.pool_type, heads=cfg.heads,
            fusion=cfg.fusion_features,
            fc_dtype=torch.bfloat16 if cfg.fc_precision == "bfloat16" else None,
            device=self.device, seed=cfg.seed or 0,
        )
        self.optimizer = optim.make_optimizer(cfg, self.model.parameters())
        # real (unpadded) conv messages per sample, for edges/s each epoch
        self._msgs = (train_ds.messages_per_sample()
                      if hasattr(train_ds, "messages_per_sample") else None)
        self.epoch = 0
        self.best_error = float("inf")
        self._cache: dict = {}

    # ------------------------------------------------------------------
    def _get(self, ds, tag: str, idx: int):
        """Padded sample on the device, cached (cfg.preload)."""
        key = (tag, idx)
        if key not in self._cache:
            self._cache[key] = ds.get(idx, self.plan).to(self.device)
        return self._cache[key]

    def _step(self, sample, seed: int):
        """Forward and backward of one sample; gradients add into .grad."""
        if self.cfg.augment:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            sample = augment.random_rotate(sample, gen)
        vert_p, norm_p = self.model(sample)
        loss, metrics = _metrics_of(vert_p, norm_p, sample, self.cfg)
        loss.backward()
        return metrics

    def _apply(self, n_acc: int):
        """Mean of the accumulated gradients, one optimizer step."""
        if n_acc > 1:
            for prm in self.model.parameters():
                prm.grad.div_(float(n_acc))
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def run_epoch(self, rng: np.random.Generator, logger: MetricLogger | None = None):
        cfg = self.cfg
        order = rng.permutation(len(self.train_ds))
        m_acc = {k: torch.zeros((), device=self.device) for k in METRIC_KEYS}
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        t0 = time.time()
        n_acc = 0
        for step, idx in enumerate(order):
            metrics = self._step(self._get(self.train_ds, "t", int(idx)),
                                 int(rng.integers(1 << 31)))
            n_acc += 1
            if n_acc == cfg.batch_size or step == len(order) - 1:
                self._apply(n_acc)
                n_acc = 0
            for k in METRIC_KEYS:
                m_acc[k] += metrics[k].detach()
        sums = torch.stack([m_acc[k] for k in METRIC_KEYS]).cpu().tolist()  # one sync
        dt = max(time.time() - t0, 1e-9)
        n_steps = len(order)
        agg = {k: v / max(n_steps, 1) for k, v in zip(METRIC_KEYS, sums)}
        agg["samples_per_s"] = n_steps / dt
        if self._msgs is not None:
            agg["edges_per_s"] = float(self._msgs[order].sum()) / dt
        if logger:
            logger.log("train", self.epoch, **agg)
        return agg

    @torch.no_grad()
    def evaluate(self, logger: MetricLogger | None = None):
        """Node-count-weighted eval means (reference train_dual.py:233-263)."""
        if self.eval_ds is None or len(self.eval_ds) == 0:
            return None
        self.model.eval()
        keys = ("loss_v", "loss_f", "error_v", "error_f", "n_v", "n_f")
        sums = {k: torch.zeros((), device=self.device) for k in keys}
        for i in range(len(self.eval_ds)):
            sample = self._get(self.eval_ds, "e", i)
            m = _metrics_of(*self.model(sample), sample, self.cfg)[1]
            for k, n in (("loss_v", "n_v"), ("error_v", "n_v"),
                         ("loss_f", "n_f"), ("error_f", "n_f")):
                sums[k] += m[k] * m[n]
            sums["n_v"] += m["n_v"]
            sums["n_f"] += m["n_f"]
        s = dict(zip(keys, torch.stack([sums[k] for k in keys]).cpu().tolist()))
        # an all-padded eval set has no valid nodes: report zeros, never inf
        if s["n_v"] == 0.0 or s["n_f"] == 0.0:
            print("WARNING: eval pass saw zero valid nodes; metrics are zeros")
        cv, cf = max(s["n_v"], 1.0), max(s["n_f"], 1.0)
        out = dict(loss_v=s["loss_v"] / cv, error_v=s["error_v"] / cv,
                   loss_f=s["loss_f"] / cf, error_f=s["error_f"] / cf)
        if logger:
            logger.log("test", self.epoch, **out)
        return out

    # ------------------------------------------------------------------
    def fit(self, logger: MetricLogger | None = None, on_epoch=None) -> float:
        cfg = self.cfg
        plateau = (optim.PlateauState(cfg.lr, cfg.lr_decay, cfg.lr_step[0])
                   if cfg.lr_sch == "auto" else None)
        last_lr = plateau.lr if plateau is not None else cfg.lr
        for self.epoch in range(self.epoch, cfg.max_epoch):
            if plateau is None:
                last_lr = optim.lr_at_epoch(cfg, self.epoch)
            optim.set_lr(self.optimizer, last_lr)
            # epoch-keyed rng: the shuffle and rotation stream of an epoch
            # depend on (seed, epoch) only
            rng = np.random.default_rng((cfg.seed or 0) * 100003 + self.epoch)
            train_m = self.run_epoch(rng, logger)
            eval_m = self.evaluate(logger)
            key_err = (eval_m or train_m)["error_f"]
            if plateau is not None:
                last_lr = plateau.step(key_err)
            self.best_error = min(self.best_error, key_err)
            if on_epoch:
                on_epoch(self, train_m, eval_m)
        return self.best_error
