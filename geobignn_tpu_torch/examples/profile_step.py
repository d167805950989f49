"""The union-batch training step split into forward, backward, the
optimizer, each branch's U-Net and each level's conv stack.

Counterpart of the JAX repo's examples/profile_step.py, on its sample: a
union batch of `--batch` (8) copies of the whole add_noise(icosphere(
subdiv), 0.2, seed=0) mesh (subdiv 5: 20,480 faces each), the shape of the
JAX repo's bench.py.  It times the whole step (graphed, Trainer.fused_step,
and eager), forward and loss, forward and backward, Adam alone, each
branch's U-Net forward and backward, and each branch's conv stack at each
level (profile_large.Parts), each part but the eager step as one CUDA
graph replayed (CUDA events, the median of `--steps`; on the CPU the host
clock, eagerly); then each part's share of the graphed step.

Run:  python -m geobignn_tpu_torch.examples.profile_step [--subdiv 5 --batch 8]
      (on the CPU at a small size: --device cpu --subdiv 2 --batch 2)
"""

from __future__ import annotations

from geobignn_tpu_torch.examples import _probe
from geobignn_tpu_torch.examples.profile_large import Parts


def main(argv=None) -> dict:
    ap = _probe.parser(__doc__)
    ap.add_argument("--subdiv", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = _probe.device_of(args.device)
    parts = Parts(args.subdiv, args.batch, dev, args.steps, "profile-step")
    h = parts.host
    print(f"[profile-step] {_probe.card(dev)}; union batch of {args.batch} x "
          f"{h['noisy'].n_faces} faces: rows vertex {h['sample'].v.x.shape[0]}, facet "
          f"{h['sample'].f.x.shape[0]}; host build {h['host_s']:.2f} s")
    whole = parts.whole()
    parts.fwd_bwd()
    parts.adam()
    for side in ("v", "f"):
        parts.unet(side)
    for side in ("v", "f"):
        for level in range(3):
            parts.conv_stack(side, level)
    full = whole.get("graphed", whole["eager"])
    for r in parts.rows:
        _probe.row("profile-step-share", part=r["part"], of_step=r["median_ms"] / full)
    return dict(whole=whole, parts=parts.rows)


if __name__ == "__main__":
    main()
