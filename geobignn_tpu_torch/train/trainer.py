"""Single-device training: steps, accumulation, eval, schedules, run dirs.

Counterpart of geobignn_tpu/train/trainer.py (`_metrics_of`, `Trainer`,
`make_run_dir`, `find_resumable_run`, `train`; reference
code/train_dual.py): per-sample forward with an on-device random rotation,
the dual L1 loss, gradient accumulation over `batch_size` samples, a full
node-weighted eval pass each epoch, per-epoch learning-rate policies (the
plateau keyed on the eval normal error, or on the train one when there is
no eval set), the best checkpoint on the eval normal error and a resume
checkpoint every epoch, and the run directory's artefacts: `params.json`,
the code snapshot `code_bak/`, `metrics.jsonl`, `training_info.txt`.

The JAX trainer runs a step in one dispatch (`fused_step`; a whole epoch
in one `lax.scan`) when each optimizer step takes one sample.  Here, on the
card, with `batch_size == 1` and Adam, `fused_step` replays one CUDA graph
of the step — rotation, forward, loss, backward, the Adam update and the
metric sums — per padded shape (capture.py); a run's samples share one
plan, so one graph.  The first step of a shape runs eagerly, as the
capture's warm-up.  `batch_size > 1` keeps the eager
gradient/accumulate/apply loop, as the JAX trainer keeps three dispatches
there; the CPU, SGD and RMSprop are eager; `testing.eager_steps()` makes
the card eager too, for comparisons.  The two paths run the same
operations on the same tensors.  The eval pass is the JAX `self._eval`:
on the card one replay of a CUDA graph of a sample's forward and metrics
per padded shape (one for a preloaded run, one per bucket plan when
streamed), in the step's memory pool; eager where `capture.one_card`
says so, as the step.  Metrics accumulate on the device and sync once per
epoch and once per eval pass.  Every
epoch draws `np.random.default_rng(seed * 100003 + epoch)`: the permutation
first (so the shuffle equals the JAX trainer's), then one integer per step
that seeds the rotation's torch.Generator.  With that, and the optimizer's
moments and step counts and the plateau state in `ckpt_last.pkl`, a run
restored from it continues on the trajectory of an uninterrupted one.

The modes of the JAX trainer, routed as there: `precision="bfloat16"`
(bf16 activations through the U-Nets), `fusion_features` (DualGNN's fusion
layer), dynamic pooling (`dynamic_pool` or `edge_weight_type` 3-5:
pool/dynamic.DualGNNDynamic; the pooling parameters the loss does not
reach get zero gradients, as jax.grad gives them), and streaming
(`preload=False`): each epoch's samples are padded and copied by a worker
thread `prefetch_depth` steps ahead (data/prefetch.py), into one SizePlan
per size bucket with `buckets_growth > 1` (one CUDA graph per bucket plan).

Several devices: with `dcn * dp * gp > 1` each epoch runs the step of
parallel/api.py over a (dcn, dp, gp) grid of devices (`devices`, or every
entry on the CPU with device="cpu", else the first visible cards) on
global batches of dcn * dp * batch_size samples, a short last batch filled
by wrapping around the epoch's order, as the JAX trainer does.  With the
whole grid on one card in one process (dcn included) and Adam, a step is
one replay of a CUDA graph per batch shape (api.make_sharded_train_step);
a grid over several cards, the CPU, SGD and RMSprop run eagerly.  In a
process group of dcn processes (api.distributed_init) each process holds
its (dp, gp) grid and the step, eager, adds the gradients over the
group.  `halo_parts > 1` routes `train()` to train/halo_trainer.py.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import random
import shutil
import sys
import time

import numpy as np
import torch

from geobignn_tpu_torch import capture, native
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import augment, prefetch
from geobignn_tpu_torch.models import losses
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.parallel import api
from geobignn_tpu_torch.pool.dynamic import DualGNNDynamic, fill_missing_grads
from geobignn_tpu_torch.train import checkpoint as ckpt
from geobignn_tpu_torch.train import optim
from geobignn_tpu_torch.train.logging import MetricLogger, Tee
from geobignn_tpu_torch.utils import resolve_device

METRIC_KEYS = ("loss", "loss_v", "loss_f", "error_v", "error_f", "n_v", "n_f")
EVAL_KEYS = ("loss_v", "loss_f", "error_v", "error_f", "n_v", "n_f")


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
    before `fit`, or `restore` a checkpoint).  With `run_dir`, `fit` writes
    `ckpt_best.pkl` and `ckpt_last.pkl` there."""

    def __init__(self, cfg: Config, train_ds, eval_ds=None, run_dir: str | None = None,
                 device=None, devices=None):
        cfg.validate()
        self.cfg = cfg
        self.n_chips = cfg.dcn * cfg.dp * cfg.gp
        self._mesh = None
        if self.n_chips > 1:
            if devices is None and resolve_device(device).type == "cpu":
                devices = [torch.device("cpu")] * self.n_chips
            self._mesh = api.make_mesh(cfg.dp, cfg.gp, devices, cfg.dcn)
            device = api.replica_rows(self._mesh)[0][0]
        self.device = resolve_device(device)
        self.train_ds = train_ds
        self.eval_ds = eval_ds
        self.run_dir = run_dir
        self.plan = train_ds.plan
        if eval_ds is not None and eval_ds.plan is not None:
            self.plan = self.plan.merge(eval_ds.plan)
        # bucketed streaming: per-bucket plans instead of one merged plan
        # (each dataset buckets on its own; get(idx, None) pads to the
        # entry's bucket plan)
        self.bucketed = cfg.buckets_growth > 1.0 and not cfg.preload
        if self.bucketed:
            n_b = train_ds.bucketize(cfg.buckets_growth)
            if eval_ds is not None and len(eval_ds):
                eval_ds.bucketize(cfg.buckets_growth)
            print(f"bucketed SizePlans: {n_b} train buckets (growth {cfg.buckets_growth})")
        if cfg.dynamic_pool or cfg.edge_weight_type in (3, 4, 5):
            self.model = DualGNNDynamic(
                force_depth=cfg.force_depth, pool_type=cfg.pool_type, heads=cfg.heads,
                edge_weight_type=cfg.edge_weight_type, wei_param=cfg.wei_param,
                device=self.device, seed=cfg.seed or 0)
        else:
            self.model = DualGNN(
                force_depth=cfg.force_depth, pool_type=cfg.pool_type, heads=cfg.heads,
                fusion=cfg.fusion_features,
                compute_dtype=torch.bfloat16 if cfg.precision == "bfloat16" else torch.float32,
                fc_dtype=torch.bfloat16 if cfg.fc_precision == "bfloat16" else None,
                device=self.device, seed=cfg.seed or 0,
            )
        self.optimizer = optim.make_optimizer(cfg, self.model.parameters())
        # real (unpadded) conv messages per sample, for edges/s each epoch
        self._msgs = (train_ds.messages_per_sample()
                      if hasattr(train_ds, "messages_per_sample") else None)
        self.epoch = 0
        self.best_error = float("inf")
        self._restored_plateau = None
        self._cache: dict = {}
        # fused_step: one CUDA graph of the step per padded shape; the
        # gradients a capture leaves point into the graph's memory, so
        # outside it the parameters hold none, as after an eager step.  The
        # eval pass replays one graph of a sample's forward and metrics per
        # padded shape (the JAX `self._eval`); one stream replays the steps'
        # and the evaluation's graphs one at a time, so they share a pool
        pool = capture.Pool()
        self._program = capture.Program(
            self._captured_step, settle=lambda: self.optimizer.zero_grad(set_to_none=True),
            pool=pool)
        self._eval_program = capture.Program(self._eval_into, pool=pool)
        # the epoch's metric sums and the eval pass's node-weighted sums on
        # the device (a captured step or eval forward adds into them)
        self._sums = {k: torch.zeros((), device=self.device) for k in METRIC_KEYS}
        self._eval_sums = {k: torch.zeros((), device=self.device) for k in EVAL_KEYS}
        self._sharded_step = None
        if self._mesh is not None:
            dynamic = isinstance(self.model, DualGNNDynamic)
            self._global_batch = cfg.dcn * cfg.dp * cfg.batch_size
            self._sharded_step = api.make_sharded_train_step(
                self.model, self.optimizer, self._mesh, cfg.loss_cfg(),
                augment=cfg.augment, gp_shard=not dynamic)

    # ------------------------------------------------------------------
    def _get(self, ds, tag: str, idx: int):
        """Padded sample on the device, cached (the preloaded path)."""
        plan = None if self.bucketed else self.plan
        key = (tag, idx)
        if key not in self._cache:
            self._cache[key] = ds.get(idx, plan).to(self.device)
        return self._cache[key]

    def _samples(self, ds, tag: str, order):
        """Samples in `order`; streaming pads and copies `prefetch_depth`
        samples ahead on a worker thread (data/prefetch.py)."""
        if self.cfg.preload:
            return (self._get(ds, tag, int(i)) for i in order)
        plan = None if self.bucketed else self.plan
        return prefetch.device_iter(order, lambda i: ds.get(int(i), plan), self.device,
                                    self.cfg.prefetch_depth)

    def _rotation(self, seed: int):
        """The step's random rotation, drawn on the device from its seed
        (None without augmentation)."""
        if not self.cfg.augment:
            return None
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return augment.random_rotation_matrix(gen)

    def _backward(self, sample, rot):
        """Forward and backward of one sample under rotation rot; gradients
        add into .grad."""
        if rot is not None:
            sample = augment.rotate_sample(sample, rot)
        vert_p, norm_p = self.model(sample)
        loss, metrics = _metrics_of(vert_p, norm_p, sample, self.cfg)
        loss.backward()
        fill_missing_grads(self.model)
        return metrics

    def _step(self, sample, seed: int):
        """Forward and backward of one sample; gradients add into .grad."""
        return self._backward(sample, self._rotation(seed))

    def _apply(self, n_acc: int):
        """Mean of the accumulated gradients, one optimizer step."""
        if n_acc > 1:
            for prm in self.model.parameters():
                prm.grad.div_(float(n_acc))
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def _add_metrics(self, metrics) -> None:
        for k in METRIC_KEYS:
            self._sums[k] += metrics[k].detach()

    def _captured_step(self, sample, rot) -> None:
        """What the graph of a step holds: forward, backward (into .grad,
        set to None first, so that the capture makes it and each replay
        writes it anew), Adam and the metric sums."""
        self.optimizer.zero_grad(set_to_none=True)
        self._add_metrics(self._backward(sample, rot))
        self.optimizer.step()

    def one_dispatch(self) -> bool:
        """Whether a step runs as one CUDA graph: on the card, one sample
        per optimizer step, Adam (capturable there), and not under
        testing.eager_steps()."""
        return (self.cfg.batch_size == 1 and capture.one_card([self.device])
                and capture.capturable(self.optimizer))

    def fused_step(self, sample, seed: int) -> None:
        """One optimizer step on one sample as a replay of its shape's CUDA
        graph (the JAX `fused_step`); its metrics add into the epoch's sums.
        The rotation is drawn outside the graph from the step's seed, as the
        eager step draws it, and copied in.  The first step of a shape runs
        eagerly on a side stream — the capture's warm-up — and then
        captures the graph; a failed capture raises."""
        self._program(sample, self._rotation(seed))

    def _run_epoch_sharded(self, rng: np.random.Generator, logger=None):
        """One epoch on the (dcn, dp, gp) grid: global batches of dcn * dp *
        batch_size samples; the short last one is filled by wrapping around
        the order."""
        order = rng.permutation(len(self.train_ds)).tolist()
        b = self._global_batch
        self.model.train()
        sums, n_steps, msgs_done = {}, 0, 0
        t0 = time.time()
        for beg in range(0, len(order), b):
            chunk = order[beg : beg + b]
            while len(chunk) < b:  # wrap-around fill
                chunk.append(order[(beg + len(chunk)) % len(order)])
            if self._msgs is not None:
                msgs_done += int(self._msgs[chunk].sum())
            batch = api.stack_samples([self.train_ds.get(int(i), self.plan) for i in chunk])
            metrics = self._sharded_step(batch, int(rng.integers(1 << 31)))
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0) + v.detach()
            n_steps += 1
        keys = list(sums)
        vals = torch.stack([sums[k] for k in keys]).cpu().tolist()  # one sync
        agg = {k: v / max(n_steps, 1) for k, v in zip(keys, vals)}
        dt = max(time.time() - t0, 1e-9)
        agg["samples_per_s"] = n_steps * b / dt
        if self._msgs is not None:
            agg["edges_per_s"] = msgs_done / dt
            agg["edges_per_s_chip"] = msgs_done / dt / self.n_chips
        if logger:
            logger.log("train", self.epoch, **agg)
        return agg

    def run_epoch(self, rng: np.random.Generator, logger: MetricLogger | None = None):
        if self._sharded_step is not None:
            return self._run_epoch_sharded(rng, logger)
        cfg = self.cfg
        order = rng.permutation(len(self.train_ds))
        for v in self._sums.values():
            v.zero_()
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        fused = self.one_dispatch()
        t0 = time.time()
        n_acc = 0
        for step, sample in enumerate(self._samples(self.train_ds, "t", order)):
            seed = int(rng.integers(1 << 31))
            if fused:
                self.fused_step(sample, seed)
                continue
            metrics = self._step(sample, seed)
            n_acc += 1
            if n_acc == cfg.batch_size or step == len(order) - 1:
                self._apply(n_acc)
                n_acc = 0
            self._add_metrics(metrics)
        sums = torch.stack([self._sums[k] for k in METRIC_KEYS]).cpu().tolist()  # one sync
        dt = max(time.time() - t0, 1e-9)
        n_steps = len(order)
        agg = {k: v / max(n_steps, 1) for k, v in zip(METRIC_KEYS, sums)}
        agg["samples_per_s"] = n_steps / dt
        if self._msgs is not None:
            agg["edges_per_s"] = float(self._msgs[order].sum()) / dt
        if logger:
            logger.log("train", self.epoch, **agg)
        return agg

    def _eval_into(self, sample) -> None:
        """What the graph of an eval sample holds: the forward, the metrics
        and their node-weighted sums added into the pass's sums."""
        m = _metrics_of(*self.model(sample), sample, self.cfg)[1]
        for k, n in (("loss_v", "n_v"), ("error_v", "n_v"),
                     ("loss_f", "n_f"), ("error_f", "n_f")):
            self._eval_sums[k] += m[k] * m[n]
        self._eval_sums["n_v"] += m["n_v"]
        self._eval_sums["n_f"] += m["n_f"]

    @torch.no_grad()
    def evaluate(self, logger: MetricLogger | None = None):
        """Node-count-weighted eval means (reference train_dual.py:233-263).
        On the card each sample is one replay of its shape's CUDA graph
        (the first of a shape runs eagerly and captures, as a step does);
        the CPU and testing.eager_steps() run it eagerly.  One sync."""
        if self.eval_ds is None or len(self.eval_ds) == 0:
            return None
        self.model.eval()
        for v in self._eval_sums.values():
            v.zero_()
        run = self._eval_program if capture.one_card([self.device]) else self._eval_into
        for sample in self._samples(self.eval_ds, "e", range(len(self.eval_ds))):
            run(sample)
        s = dict(zip(EVAL_KEYS, torch.stack(
            [self._eval_sums[k] for k in EVAL_KEYS]).cpu().tolist()))
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
        if plateau is not None and self._restored_plateau:
            for k, v in self._restored_plateau.items():
                setattr(plateau, k, v)
        last_lr = plateau.lr if plateau is not None else cfg.lr
        for self.epoch in range(self.epoch, cfg.max_epoch):
            if plateau is None:
                last_lr = optim.lr_at_epoch(cfg, self.epoch)
            optim.set_lr(self.optimizer, last_lr)
            # epoch-keyed rng: the shuffle and rotation stream of an epoch
            # depend on (seed, epoch) only, so a resumed run replays them
            rng = np.random.default_rng((cfg.seed or 0) * 100003 + self.epoch)
            train_m = self.run_epoch(rng, logger)
            eval_m = self.evaluate(logger)
            key_err = (eval_m or train_m)["error_f"]
            if plateau is not None:
                last_lr = plateau.step(key_err)
            if key_err < self.best_error:
                self.best_error = key_err
                if self.run_dir:
                    ckpt.save_checkpoint(
                        os.path.join(self.run_dir, "ckpt_best.pkl"),
                        self.model.state_dict(),
                        epoch=self.epoch, best_error=self.best_error)
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
        """Continue from a checkpoint: weights, epoch, best error, plateau
        state and, with_opt, the optimizer's state (which only this package's
        checkpoints carry in a form torch can load)."""
        state, opt_state, scalars = ckpt.load_checkpoint(path, with_opt=with_opt)
        self.model.load_state_dict(state)
        if with_opt and opt_state is not None:
            optim.load_state(self.optimizer, opt_state)
            # they hold the replaced state tensors; the eval graphs go with
            # them: a restored trainer captures afresh, as a new one
            self._program.graphs.clear()
            self._eval_program.graphs.clear()
            if self._sharded_step is not None:
                self._sharded_step.program.graphs.clear()
        self.epoch = int(scalars.get("epoch", -1)) + 1
        self.best_error = float(scalars.get("best_error", float("inf")))
        self._restored_plateau = scalars.get("plateau")


def make_run_dir(cfg: Config) -> str:
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    run_dir = os.path.join(
        cfg.log_dir, f"GeoBi-GNN_{cfg.data_type}_{cfg.flag}", stamp
    )
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


def find_resumable_run(cfg: Config) -> str | None:
    """Latest run dir of this data_type/flag that has a ckpt_last.pkl
    (restart after a failure: rerun the same command, training continues)."""
    base = os.path.join(cfg.log_dir, f"GeoBi-GNN_{cfg.data_type}_{cfg.flag}")
    if not os.path.isdir(base):
        return None
    runs = sorted(
        d for d in os.listdir(base)
        if os.path.exists(os.path.join(base, d, "ckpt_last.pkl"))
    )
    return os.path.join(base, runs[-1]) if runs else None


def snapshot_code(run_dir: str) -> str:
    """Copy this package (with csrc/) to `run_dir/code_bak/geobignn_tpu_torch`
    and the native mesh library's sources to `run_dir/code_bak/native`, so
    that version-pinned inference runs the training-time code end to end:
    the snapshot builds its own kernels and its own native library, and
    never takes another host code path than training took."""
    bak = os.path.join(run_dir, "code_bak")
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(
        pkg_dir, os.path.join(bak, os.path.basename(pkg_dir)),
        ignore=shutil.ignore_patterns("__pycache__", "*.pyc"),
        dirs_exist_ok=True,
    )
    os.makedirs(os.path.join(bak, "native"), exist_ok=True)
    for name in native.SOURCE_FILES:
        shutil.copy2(os.path.join(native.NATIVE_DIR, name),
                     os.path.join(bak, "native", name))
    return bak


def _train_halo(cfg: Config, dataset_root: str | None, device, devices) -> str:
    """Halo-mode training: whole meshes (no submesh split), each
    node-partitioned over cfg.halo_parts parts; the run directory, logging,
    resume and restore of the standard path."""
    from geobignn_tpu_torch.data.dataset import discover_mesh_pairs
    from geobignn_tpu_torch.meshio import read_obj
    from geobignn_tpu_torch.train.halo_trainer import HaloTrainer

    resume_dir = find_resumable_run(cfg) if cfg.auto_resume else None
    run_dir = resume_dir or make_run_dir(cfg)
    stdout = sys.stdout
    tee = sys.stdout = Tee(os.path.join(run_dir, "training_info.txt"))
    try:
        print(f"Halo training ({cfg.halo_parts} parts) flag: {cfg.flag} "
              f"seed: {cfg.seed}\nrun_dir: {run_dir}")
        cfg.to_json(os.path.join(run_dir, "params.json"))
        snapshot_code(run_dir)
        root = dataset_root or cfg.dataset_dir
        pairs, eval_pairs = (
            [(read_obj(n), read_obj(o))
             for n, o in discover_mesh_pairs(root, cfg.data_type, split, f"{split}_list.txt")]
            for split in ("train", "test"))
        print(f"Training meshes: {len(pairs)}; eval: {len(eval_pairs)}")
        trainer = HaloTrainer(cfg, pairs, eval_pairs, run_dir, device=device, devices=devices)
        _fit_and_report(trainer, cfg, resume_dir, run_dir)
    finally:
        sys.stdout = stdout
        tee.log.close()
    return run_dir


def _fit_and_report(trainer, cfg: Config, resume_dir: str | None, run_dir: str) -> None:
    """Resume or restore, then fit with the metric stream and the epoch
    report of both training paths."""
    if resume_dir is not None:
        trainer.restore(os.path.join(resume_dir, "ckpt_last.pkl"))
        print(f"auto-resume: continuing {resume_dir} at epoch {trainer.epoch}")
    elif cfg.restore and cfg.model_path:
        trainer.restore(cfg.model_path)
    logger = MetricLogger(os.path.join(run_dir, "metrics.jsonl"))

    def report(tr, train_m, eval_m):
        m = eval_m or train_m  # eval split may be empty
        if tr.epoch % 10 == 0 or m["error_f"] <= tr.best_error:
            print(
                f"Epoch {tr.epoch:>3}: loss {m['loss_v']:.4f} "
                f"{m['loss_f']:.4f} | error {m['error_v']:.4f} "
                f"{m['error_f']:.4f}"
            )

    best = trainer.fit(logger, report)
    print(f"best error: {best}")
    logger.close()


def train(cfg: Config, dataset_root: str | None = None, device=None, devices=None) -> str:
    """Full training entry: datasets from disk, run-dir artefacts, fit.
    Returns the run directory.  While it runs, stdout is teed into
    `training_info.txt`; it is put back before the function returns.
    `devices` places the parts (halo_parts) or the (dp, gp) grid."""
    from geobignn_tpu_torch.data.dataset import DualDataset

    device = resolve_device(device)
    if cfg.seed is None:
        cfg.seed = random.randint(1, 10000)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    cfg.validate()
    if cfg.halo_parts and cfg.halo_parts > 1:
        return _train_halo(cfg, dataset_root, device, devices)

    resume_dir = find_resumable_run(cfg) if cfg.auto_resume else None
    run_dir = resume_dir or make_run_dir(cfg)
    stdout = sys.stdout
    tee = sys.stdout = Tee(os.path.join(run_dir, "training_info.txt"))
    try:
        print(f"Training flag: {cfg.flag}  seed: {cfg.seed}\nrun_dir: {run_dir}")
        cfg.to_json(os.path.join(run_dir, "params.json"))
        snapshot_code(run_dir)

        root = dataset_root or cfg.dataset_dir
        bc = cfg.build_config()
        train_ds = DualDataset(
            root, cfg.data_type, "train", "train_list.txt",
            cfg.filter_patch_count, cfg.sub_size, bc,
        )
        eval_ds = DualDataset(
            root, cfg.data_type, "test", "test_list.txt", 0, cfg.sub_size, bc
        )
        print(f"Training set: {len(train_ds)} samples; eval: {len(eval_ds)}")

        trainer = Trainer(cfg, train_ds, eval_ds, run_dir, device=device, devices=devices)
        _fit_and_report(trainer, cfg, resume_dir, run_dir)
    finally:
        sys.stdout = stdout
        tee.log.close()
    return run_dir
