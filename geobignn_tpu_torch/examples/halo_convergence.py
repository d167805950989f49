"""Halo-mode convergence: single-device against 8-part halo training.

Counterpart of the JAX package's examples/halo_convergence.py, with its own
copy of the corpus and the protocol.  Halo pooling is partition
constrained (matchings never cross a part's boundary; each part builds its
own hierarchy, reorder=False), so the halo model is another member of the
same family, not the single-device model bit for bit: the same small
corpus is trained (a) on one device and (b) with halo_parts=8, same seed
and protocol, and the eval error_f curves and their final means compared.

On the card all 8 parts sit on the one device given (every halo step and
eval forward one CUDA graph); on the CPU, device="cpu".

Run:  python -m geobignn_tpu_torch.examples.halo_convergence --out_dir DIR
      (on the CPU at a small size: --device cpu --epochs 1; from the JAX
      trainers' initial weights at seed s: --seed s --init <jax_init(s)>)
Outputs: DIR/{single,halo}_curve.jsonl, DIR/run_{single,halo}/ and
         DIR/summary.json.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from geobignn_tpu_torch import params
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import synth
from geobignn_tpu_torch.train.logging import MetricLogger

HALO_PARTS = 8
# the JAX package's Trainer and HaloTrainer initial weights for run_config's
# seeds (one tree for both at each seed), in the port's names
# (params.save_npz); regenerated by `python tests/test_torch_faults.py
# write-init 7 8 9 10 11`
JAX_INIT_SEEDS = (7, 8, 9, 10, 11)


def jax_init(seed: int) -> str:
    """The path of the JAX trainers' initial weights at `seed` (seed 7's
    file keeps the name it was first committed under)."""
    name = "halo_conv_jax_init.npz" if seed == 7 else f"halo_conv_jax_init_s{seed}.npz"
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", name)


def gate(own: dict, jax: dict, bound: float) -> tuple[bool, str]:
    """Whether halo convergence from the port's own initial weights meets
    the rel_gap bound, given compare()'s rel_gap of the pairs run from the
    port's weights (`own`) and from the JAX trainers' (`jax`), each
    {seed: rel_gap} over the same seeds.  Returns (met, the rule as read).

    If every JAX-weights pair meets `bound`, JAX's trainer meets it at every
    seed, and the port's pair at the first seed is held to it.  If one
    misses it, the one-seed bound is no property of a correct trainer, and
    the median of the port's pairs is held to the larger of `bound` and the
    JAX pairs' median."""
    if not own or sorted(own) != sorted(jax):
        raise ValueError(f"own and jax need the same seeds: {sorted(own)}, {sorted(jax)}")
    if all(g <= bound for g in jax.values()):
        first = min(own)
        return own[first] <= bound, (
            f"every JAX-weights pair meets {bound}: the own pair at seed {first}, "
            f"{own[first]}, held to {bound}")
    limit = max(bound, float(np.median(list(jax.values()))))
    mid = float(np.median(list(own.values())))
    return mid <= limit, (
        f"a JAX-weights pair misses {bound}: the own pairs' median, {mid}, held to "
        f"max({bound}, the JAX pairs' median) = {limit}")


def corpus():
    """4 shapes x 2 noise levels to train on, one noisy copy of each to
    evaluate."""
    shapes = [
        ("sphere", synth.icosphere(4)),
        ("torus", synth.torus(48, 24)),
        ("cube", synth.cube(14)),
        ("cyl", synth.cylinder(48, 24)),
    ]
    train, evals = [], []
    for i, (name, m_o) in enumerate(shapes):
        for j, sig in enumerate((0.15, 0.3)):
            train.append((synth.add_noise(m_o, sig, seed=100 + 7 * i + j), m_o))
        evals.append((synth.add_noise(m_o, 0.2, seed=900 + i), m_o))
    return train, evals


def run_config(mode: str, epochs: int, seed: int) -> Config:
    return Config(
        data_type="HaloConv", flag=mode, seed=seed, max_epoch=epochs,
        lr=1e-3, lr_sch="lmd", lr_decay=0.98, lr_step=(20,),
        augment=False, preload=True, granularity=128, batch_size=1,
        halo_parts=HALO_PARTS if mode == "halo" else 0,
    )


def run(mode: str, epochs: int, seed: int, out_dir: str, device="cuda", init=None):
    """Train `mode` ("single" or "halo") on corpus(); the eval curve goes to
    out_dir/{mode}_curve.jsonl.  `init`, the path of a weights .npz
    (params.save_npz; jax_init(seed) holds the JAX trainers'), replaces the
    seeded initial weights.  Returns the best eval error_f."""
    import torch

    train_pairs, eval_pairs = corpus()
    os.makedirs(out_dir, exist_ok=True)
    curve_path = os.path.join(out_dir, f"{mode}_curve.jsonl")
    cfg = run_config(mode, epochs, seed)

    run_dir = os.path.join(out_dir, f"run_{mode}")
    os.makedirs(run_dir, exist_ok=True)
    logger = MetricLogger(os.path.join(run_dir, "metrics.jsonl"), tensorboard=False)

    if mode == "halo":
        from geobignn_tpu_torch.train.halo_trainer import HaloTrainer

        trainer = HaloTrainer(cfg, train_pairs, eval_pairs, run_dir,
                              devices=[torch.device(device)] * HALO_PARTS)
    else:
        from geobignn_tpu_torch.data.dataset import InMemoryDataset
        from geobignn_tpu_torch.train.trainer import Trainer

        bc = cfg.build_config()
        trainer = Trainer(
            cfg, InMemoryDataset(train_pairs, bc),
            InMemoryDataset(eval_pairs, bc), run_dir, device=device,
        )

    if init is not None:
        trainer.model.load_state_dict(params.load_npz(init))

    def report(tr, train_m, eval_m):
        if eval_m and tr.epoch % 5 == 0:
            print(f"{mode} epoch {tr.epoch:>3} eval error_f "
                  f"{eval_m['error_f']:.3f}", flush=True)

    try:
        best = trainer.fit(logger, report)
    finally:
        logger.close()

    rows = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r.get("split") == "test":
                rows.append(dict(epoch=r["epoch"], error_f=r["error_f"],
                                 error_v=r.get("error_v")))
    with open(curve_path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"{mode}: best eval error_f {best:.4f}; curve -> {curve_path}")
    return best


def compare(out_dir: str) -> dict:
    """The two curves of out_dir side by side, and the means of their last
    10 epochs (a third of the epochs if fewer), written to
    out_dir/summary.json and returned."""
    def load(mode):
        with open(os.path.join(out_dir, f"{mode}_curve.jsonl")) as f:
            return [json.loads(ln) for ln in f]

    s, h = load("single"), load("halo")
    sd = {r["epoch"]: r["error_f"] for r in s}
    hd = {r["epoch"]: r["error_f"] for r in h}
    marks = sorted(set(sd) & set(hd))
    print("| epoch | single-chip error_f | halo(8) error_f |")
    print("|---|---|---|")
    for m in marks[:: max(1, len(marks) // 12)] + [marks[-1]]:
        print(f"| {m} | {sd[m]:.3f} | {hd[m]:.3f} |")
    tail = min(10, len(marks) // 3)
    s_tail = np.mean([sd[m] for m in marks[-tail:]])
    h_tail = np.mean([hd[m] for m in marks[-tail:]])
    summary = dict(
        single_final_mean=round(float(s_tail), 4),
        halo_final_mean=round(float(h_tail), 4),
        rel_gap=round(float(abs(s_tail - h_tail) / s_tail), 4),
        epochs=marks[-1] + 1,
    )
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("phase", choices=["single", "halo", "compare", "all"],
                    nargs="?", default="all")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out_dir", default=os.path.join("log", "halo_conv"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init", default=None,
                    help="initial weights (.npz, params.save_npz) in place of the "
                         "seeded ones; the JAX trainers' at seed s: jax_init(s), "
                         f"e.g. {jax_init(7)}")
    args = ap.parse_args(argv)
    if args.phase in ("single", "all"):
        run("single", args.epochs, args.seed, args.out_dir, args.device, args.init)
    if args.phase in ("halo", "all"):
        run("halo", args.epochs, args.seed, args.out_dir, args.device, args.init)
    if args.phase in ("compare", "all"):
        return compare(args.out_dir)
    return None


if __name__ == "__main__":
    main()
