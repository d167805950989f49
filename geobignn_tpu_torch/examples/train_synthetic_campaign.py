"""Reference-protocol accuracy campaign on a synthetic corpus, on the card.

Counterpart of the JAX package's examples/train_synthetic_campaign.py, with
its own copy of the corpus and the protocol (the reference's
code/train_dual.py:187-278 on generated shapes):

  * 22 train base shapes x 3 noise levels (sigma 0.1 / 0.2 / 0.3 x mean
    edge length) = 66 training samples; 8 held-out base shapes x 3 = 24
    eval samples; four classes: smooth, torus (genus 1), sharp (cubes and
    cuboids), mixed (cylinders);
  * Config(seed=11, max_epoch=500, lmd decay 0.98 every 20 epochs, SO(3)
    augmentation, preload, granularity 128, auto_resume): a full eval pass
    each epoch, the best checkpoint on the eval normal error;
  * the final per-shape evaluation with the best checkpoint: angle1 (the
    predicted normals), angle2 (after 60 position updates) and the
    Hausdorff-style distance (the largest nearest distance from the
    denoised vertices to the clean ones, over the clean mesh's mean edge
    length).

Run:  python -m geobignn_tpu_torch.examples.train_synthetic_campaign --epochs 500
      (on the CPU at a small size: --device cpu --short --epochs 1)
Outputs: <log_dir>/GeoBi-GNN_SynthCampaign_<flag>/<stamp>/{metrics.jsonl,
         ckpt_best.pkl, ckpt_last.pkl, campaign_results.json}
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from geobignn_tpu_torch import geometry
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import synth
from geobignn_tpu_torch.data.dataset import InMemoryDataset
from geobignn_tpu_torch.infer.predict import Predictor, _angular_error
from geobignn_tpu_torch.models.losses import nearest_distance
from geobignn_tpu_torch.train import checkpoint as ckpt
from geobignn_tpu_torch.train.logging import MetricLogger
from geobignn_tpu_torch.train.trainer import Trainer, find_resumable_run, make_run_dir

NOISE_LEVELS = (0.1, 0.2, 0.3)


def train_shapes():
    """22 base shapes, grouped by class (all ~4k-20k faces so one merged
    SizePlan stays tight)."""
    s = []
    # smooth: spheres / ellipsoids / bumpy organics
    s.append(("sphere4", "smooth", synth.icosphere(4)))
    s.append(("sphere5", "smooth", synth.icosphere(5)))
    s.append(("ellip_a", "smooth", synth.ellipsoid(4, (1.0, 0.7, 0.85))))
    s.append(("ellip_b", "smooth", synth.ellipsoid(5, (1.4, 1.0, 0.6))))
    s.append(("bumpy_a", "smooth", synth.bumpy_sphere(4, 10, 0.12, seed=1)))
    s.append(("bumpy_b", "smooth", synth.bumpy_sphere(5, 14, 0.18, seed=2)))
    s.append(("bumpy_c", "smooth", synth.bumpy_sphere(4, 20, 0.10, seed=3)))
    # genus-1
    s.append(("torus_a", "torus", synth.torus(72, 36)))
    s.append(("torus_b", "torus", synth.torus(96, 48, 1.0, 0.25)))
    s.append(("torus_c", "torus", synth.torus(120, 40, 1.0, 0.45)))
    s.append(("torus_d", "torus", synth.torus(64, 64, 1.0, 0.5)))
    # sharp CAD-like
    s.append(("cube_a", "sharp", synth.cube(20)))
    s.append(("cube_b", "sharp", synth.cube(28)))
    s.append(("cube_c", "sharp", synth.cube(36)))
    s.append(("cuboid_a", "sharp", synth.cuboid(24, (1.0, 0.6, 1.4))))
    s.append(("cuboid_b", "sharp", synth.cuboid(32, (0.5, 1.0, 1.0))))
    s.append(("cuboid_c", "sharp", synth.cuboid(20, (1.2, 1.2, 0.4))))
    # mixed smooth/sharp
    s.append(("cyl_a", "mixed", synth.cylinder(72, 36)))
    s.append(("cyl_b", "mixed", synth.cylinder(96, 48, 0.35, 2.4)))
    s.append(("cyl_c", "mixed", synth.cylinder(64, 64, 0.7, 1.2)))
    s.append(("cyl_d", "mixed", synth.cylinder(120, 30, 0.5, 3.0)))
    s.append(("cyl_e", "mixed", synth.cylinder(48, 72, 0.25, 2.0)))
    return s


def eval_shapes():
    """8 held-out base shapes — same classes, different parameters/seeds."""
    s = []
    s.append(("SphereT", "smooth", synth.icosphere(4, radius=1.2)))
    s.append(("EllipT", "smooth", synth.ellipsoid(4, (0.8, 1.1, 0.65))))
    s.append(("BumpyT", "smooth", synth.bumpy_sphere(4, 16, 0.15, seed=77)))
    s.append(("TorusT", "torus", synth.torus(84, 42, 1.0, 0.3)))
    s.append(("CubeT", "sharp", synth.cube(24)))
    s.append(("CuboidT", "sharp", synth.cuboid(28, (1.3, 0.5, 1.0))))
    s.append(("CylT", "mixed", synth.cylinder(80, 40, 0.45, 1.8)))
    s.append(("CylT2", "mixed", synth.cylinder(56, 56, 0.6, 2.6)))
    return s


def make_pairs(shapes, seed0: int):
    """(noisy, clean) pairs of every shape at each noise level, and their
    (name, class); the noise seed of shape i at level j is seed0 + 17 i + j."""
    pairs, names = [], []
    for i, (name, klass, m_o) in enumerate(shapes):
        for j, sig in enumerate(NOISE_LEVELS):
            m_n = synth.add_noise(m_o, sig, seed=seed0 + 17 * i + j)
            pairs.append((m_n, m_o))
            names.append((f"{name}_n{j + 1}", klass))
    return pairs, names


def corpus(short: bool = False):
    """((train pairs, names), (eval pairs, names)) of the campaign: 66 and
    24 samples.  `short`: the samples of the first two train shapes of each
    class and of the first two held-out shapes, 24 and 6, each as in the
    whole corpus."""
    train, evals = train_shapes(), eval_shapes()
    sets = (make_pairs(train, seed0=1000), make_pairs(evals, seed0=9000))
    if not short:
        return sets
    by_class: dict = {}
    for name, klass, _ in train:
        by_class.setdefault(klass, []).append(name)
    keep = {n for names in by_class.values() for n in names[:2]} | {n for n, _, _ in evals[:2]}

    def kept(pairs, names):
        pick = [i for i, (n, _) in enumerate(names) if n.rsplit("_n", 1)[0] in keep]
        return [pairs[i] for i in pick], [names[i] for i in pick]

    return tuple(kept(*s) for s in sets)


def campaign_config(epochs: int = 500, seed: int = 11, lr: float = 1e-3,
                    flag: str = "campaign", log_dir: str = "log") -> Config:
    """The campaign's Config, as the JAX script sets it."""
    return Config(
        data_type="SynthCampaign", flag=flag, seed=seed, max_epoch=epochs, lr=lr,
        lr_sch="lmd", lr_decay=0.98, lr_step=(20,), augment=True, preload=True,
        granularity=128, auto_resume=True, log_dir=log_dir,
    )


def final_eval(cfg, params, eval_pairs, eval_names, device=None):
    """Per-shape angle_noisy / angle1 / angle2 / Hausdorff of the weights
    `params` (rounded as the JAX script rounds them), printed one line a
    shape.  The distances run on the predictor's device (on the card, the
    nearest-distance kernel)."""
    pred = Predictor(cfg, params, device=device)
    rows = []
    for (m_n, m_o), (name, klass) in zip(eval_pairs, eval_names):
        gt_n = geometry.face_normals_np(m_o.points, m_o.fv_indices)
        noisy_n = geometry.face_normals_np(m_n.points, m_n.fv_indices)
        _, np_pred = pred.predict_mesh(m_n)
        angle1 = _angular_error(np_pred, gt_n)
        v_final, _ = pred.denoise(m_n, n_update_iters=60)
        n_final = geometry.face_normals_np(v_final, m_n.fv_indices)
        angle2 = _angular_error(n_final, gt_n)
        mel = geometry.mean_edge_length_np(m_o.points, m_o.ev_indices)
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(pred.device)
        haus = float(nearest_distance(to_dev(v_final), to_dev(m_o.points)).max()) / mel
        rows.append(dict(
            name=name, klass=klass, faces=int(m_n.n_faces),
            angle_noisy=round(_angular_error(noisy_n, gt_n), 3),
            angle1=round(angle1, 3), angle2=round(angle2, 3),
            hausdorff=round(haus, 4),
        ))
        print(f"  {name:>12} [{klass:6}] noisy {rows[-1]['angle_noisy']:6.2f} "
              f"-> angle1 {angle1:6.2f}  angle2 {angle2:6.2f}  "
              f"H {haus:.3f}", flush=True)
    return rows


def summarize(rows):
    """(per-class means, corpus means) of final_eval's rows, weighted by
    faces and rounded as the JAX script rounds them."""
    agg: dict = {}
    for r in rows:
        a = agg.setdefault(r["klass"], dict(n=0, f=0, a0=0.0, a1=0.0, a2=0.0, h=0.0))
        a["n"] += 1
        a["f"] += r["faces"]
        a["a0"] += r["angle_noisy"] * r["faces"]
        a["a1"] += r["angle1"] * r["faces"]
        a["a2"] += r["angle2"] * r["faces"]
        a["h"] += r["hausdorff"] * r["faces"]
    per_class = {
        k: dict(
            n=v["n"], angle_noisy=round(v["a0"] / v["f"], 3),
            angle1=round(v["a1"] / v["f"], 3),
            angle2=round(v["a2"] / v["f"], 3),
            hausdorff=round(v["h"] / v["f"], 4),
        )
        for k, v in agg.items()
    }
    tot_f = sum(r["faces"] for r in rows)
    corpus = dict(
        angle_noisy=round(sum(r["angle_noisy"] * r["faces"] for r in rows) / tot_f, 3),
        angle1=round(sum(r["angle1"] * r["faces"] for r in rows) / tot_f, 3),
        angle2=round(sum(r["angle2"] * r["faces"] for r in rows) / tot_f, 3),
        hausdorff=round(sum(r["hausdorff"] * r["faces"] for r in rows) / tot_f, 4),
    )
    return per_class, corpus


def datasets(cfg: Config, train_pairs, eval_pairs):
    """The preloaded train and eval datasets of the pairs (the host build)."""
    bc = cfg.build_config()
    train_ds = InMemoryDataset(train_pairs, bc)
    eval_ds = InMemoryDataset(eval_pairs, bc)
    print(f"plans merged: v n1={train_ds.plan.v.n1} f n1={train_ds.plan.f.n1}",
          flush=True)
    return train_ds, eval_ds


def train(cfg: Config, train_ds, eval_ds, device=None, on_epoch=None):
    """The campaign's training: resume the latest run of cfg's flag under
    cfg.log_dir or make a new run directory, fit with the metric stream and
    the JAX script's report (every 5 epochs and at each new best), then
    `on_epoch(trainer, train_m, eval_m)` if given.  Returns (trainer,
    run_dir, best eval error_f)."""
    resume = find_resumable_run(cfg) if cfg.auto_resume else None
    run_dir = resume or make_run_dir(cfg)
    cfg.to_json(os.path.join(run_dir, "params.json"))
    print("run_dir:", run_dir, flush=True)

    trainer = Trainer(cfg, train_ds, eval_ds, run_dir, device=device)
    if resume:
        trainer.restore(os.path.join(resume, "ckpt_last.pkl"))
        print(f"resumed at epoch {trainer.epoch}", flush=True)
    logger = MetricLogger(os.path.join(run_dir, "metrics.jsonl"))

    def report(tr, train_m, eval_m):
        m = eval_m or train_m
        if tr.epoch % 5 == 0 or m["error_f"] <= tr.best_error:
            print(
                f"epoch {tr.epoch:>4}  train loss {train_m['loss']:.4f} "
                f"({train_m['samples_per_s']:.1f} samp/s)  eval error_v "
                f"{m['error_v']:.4f} error_f {m['error_f']:.3f} deg  "
                f"best {min(tr.best_error, m['error_f']):.3f}",
                flush=True,
            )
        if on_epoch is not None:
            on_epoch(tr, train_m, eval_m)

    try:
        best = trainer.fit(logger, report)
    finally:
        logger.close()
    print(f"training done; best eval error_f {best:.3f} deg", flush=True)
    return trainer, run_dir, best


def evaluate_best(cfg: Config, run_dir: str, epochs: int, best: float, n_train: int,
                  eval_pairs, eval_names, device=None) -> dict:
    """final_eval with the run's best checkpoint; writes and returns
    campaign_results.json's contents."""
    best_params, _, _ = ckpt.load_checkpoint(os.path.join(run_dir, "ckpt_best.pkl"))
    print("final per-shape evaluation (best ckpt):", flush=True)
    rows = final_eval(cfg, best_params, eval_pairs, eval_names, device=device)
    per_class, corpus = summarize(rows)
    out = dict(
        epochs=epochs, best_eval_error_f=best,
        n_train=n_train, n_eval=len(eval_pairs),
        corpus=corpus, per_class=per_class, per_shape=rows,
    )
    with open(os.path.join(run_dir, "campaign_results.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(dict(corpus=corpus, per_class=per_class), indent=2))
    print("results ->", os.path.join(run_dir, "campaign_results.json"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--flag", default="campaign")
    ap.add_argument("--log_dir", default="log")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--short", action="store_true",
                    help="the short corpus: 24 train and 6 eval samples")
    args = ap.parse_args(argv)

    cfg = campaign_config(args.epochs, args.seed, args.lr, args.flag, args.log_dir)
    print("building corpus ...", flush=True)
    (train_pairs, _), (eval_pairs, eval_names) = corpus(short=args.short)
    print(f"train {len(train_pairs)} samples, eval {len(eval_pairs)}", flush=True)
    train_ds, eval_ds = datasets(cfg, train_pairs, eval_pairs)
    trainer, run_dir, best = train(cfg, train_ds, eval_ds, device=args.device)
    return evaluate_best(cfg, run_dir, trainer.epoch + 1, best, len(train_pairs),
                         eval_pairs, eval_names, device=args.device)


if __name__ == "__main__":
    main()
