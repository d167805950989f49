"""The dynamic-pooling step against the static one on the same sample.

Counterpart of the JAX repo's examples/bench_dynamic.py: one training step
(forward, backward, Adam; bf16 fc heads) of the DualGNNDynamic model
(Config(dynamic_pool=True): in-forward matchings and coalesces, COO convs
at the padded level-1 size) against the static-hierarchy DualGNN, on the
same whole add_noise(icosphere(subdiv), 0.2, seed=0) sample (subdiv 5:
20,480 faces, batch 1), each step its shape's CUDA graph on the card
(Trainer.fused_step; eager on the CPU), timed with CUDA events (the median
of `--steps`); edges/s over the sample's real edge messages, and the
dynamic step's multiple of the static one.

Run:  python -m geobignn_tpu_torch.examples.bench_dynamic [--subdiv 5]
      (on the CPU at a small size: --device cpu --subdiv 2)
"""

from __future__ import annotations

import itertools
import json

from geobignn_tpu_torch.examples import _probe, _sample


def main(argv=None) -> dict:
    ap = _probe.parser(__doc__)
    ap.add_argument("--subdiv", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = _probe.device_of(args.device)
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.train.trainer import Trainer

    host = _sample.whole_sample(args.subdiv)
    msgs = host["msgs"]
    print(f"[bench-dynamic] {_probe.card(dev)}; {host['noisy'].n_faces} faces, {msgs} edge "
          f"messages a step")
    sample = host["sample"].to(dev)
    out = {}
    for name, dynamic in (("static", False), ("dynamic", True)):
        cfg = Config(seed=0, granularity=256, dynamic_pool=dynamic)
        tr = Trainer(cfg, _sample.stand_in(cfg), None, device=dev)
        step, it = _sample.train_step(tr, sample), itertools.count()
        t = _probe.timed(lambda: step(next(it)), dev, steps=args.steps)
        out[name] = _probe.row("bench-dynamic", model=name, graphed=tr.one_dispatch(),
                               **_probe.spread(t), edges_per_s=msgs / (t["median_ms"] / 1e3))
    out["overhead_x"] = out["dynamic"]["median_ms"] / out["static"]["median_ms"]
    print("[bench-dynamic] " + json.dumps({"overhead_x": out["overhead_x"]}))
    return out


if __name__ == "__main__":
    main()
