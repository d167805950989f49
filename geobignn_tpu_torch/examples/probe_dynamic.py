"""The pieces of the dynamic-pooling forward, apart.

Counterpart of the JAX repo's examples/probe_dynamic.py: on the facet
level 1 of the whole add_noise(icosphere(subdiv), 0.2, seed=0) sample
(subdiv 5: 20,480 faces, batch 1), the biggest workload of
DualGNNDynamic, it times one application of each piece the dynamic
forward runs in place of the static hierarchy (plain PyTorch, no custom
kernel): the parallel matching at 8, 4 and 2 rounds (ops/matching), the
coalesce of the relabelled edges (ops/coalesce), the pooling onto the
representatives, and one coarse conv (32 -> 64) over the coalesced edges
at the padded level-1 size, the COO conv (ops/feastconv.feast_conv),
forward and backward — each captured as one CUDA graph on the card and
its replays timed (CUDA events, the median of `--steps`), eagerly on the
CPU's host clock.

Run:  python -m geobignn_tpu_torch.examples.probe_dynamic [--subdiv 5]
      (on the CPU at a small size: --device cpu --subdiv 2)
"""

from __future__ import annotations

import torch

from geobignn_tpu_torch.examples import _probe, _sample


def main(argv=None) -> list:
    ap = _probe.parser(__doc__)
    ap.add_argument("--subdiv", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = _probe.device_of(args.device)
    from geobignn_tpu_torch.ops import feastconv, matching, segment
    from geobignn_tpu_torch.ops.coalesce import coalesce_edges

    lvl = _sample.whole_sample(args.subdiv)["sample"].f.levels[0]
    ei = torch.as_tensor(lvl.edge_index, dtype=torch.int64, device=dev)
    w = torch.as_tensor(lvl.edge_weight, device=dev).abs() + 0.1
    n_pad = int(lvl.node_mask.shape[0])
    gen = torch.Generator(device=dev).manual_seed(0)
    x32 = torch.randn((n_pad, 32), device=dev, generator=gen)
    print(f"[probe-dynamic] {_probe.card(dev)}; facet level 1: n_pad={n_pad} "
          f"e={ei.shape[1]}")
    rows = []

    def timeit(name, fn):
        t = _probe.timed(fn, dev, steps=args.steps, graph=True)
        rows.append(_probe.row("probe-dynamic", part=name, **_probe.spread(t)))

    for rounds in (8, 4, 2):
        timeit(f"parallel_matching ({rounds} rounds)",
               lambda r=rounds: matching.parallel_matching(ei, w, n_pad, r))
    rep = matching.parallel_matching(ei, w, n_pad, 8)
    rei = rep[ei]
    timeit("coalesce_edges (one application)", lambda: coalesce_edges(rei, w, n_pad))
    timeit("pool_with_rep (segment_max)", lambda: matching.pool_with_rep(x32, rep, "max"))

    cei, _ = coalesce_edges(rei, w, n_pad)
    real = cei[0] != cei[1]
    deg = segment.segment_count(torch.where(real, cei[0], n_pad - 1), n_pad)
    bound = (6.0 / (32 + 64)) ** 0.5
    prm = {"u": (torch.randn((32, 9), device=dev, generator=gen) * 0.1).requires_grad_(True),
           "c": torch.zeros(9, device=dev, requires_grad=True),
           "w": ((torch.rand((9, 32, 64), device=dev, generator=gen) * 2 - 1) * bound
                 ).requires_grad_(True),
           "b": torch.zeros(64, device=dev, requires_grad=True)}

    def conv_fwd_bwd():
        feastconv.feast_conv(prm, x32, cei, deg=deg).sum().backward()
        for v in prm.values():
            v.grad = None

    timeit("coarse conv 32->64 COO at n_pad fwd+bwd", conv_fwd_bwd)
    return rows


if __name__ == "__main__":
    main()
