"""Three chained banded convs against three independent ones.

Counterpart of the JAX repo's examples/probe_serial.py: a per-level conv
stack timed as independent convs (each on the same input) misses what the
U-Net pays when each conv waits for the one before (x2 = f(x1)).  On
seeded random inputs at one banded level (N rows, C channels in and out,
H heads, a mask whose slots are set with probability deg / 3T), it times

    indep3   three convs of the same x, forward (+ backward)
    chain3   x -> conv -> conv -> conv, forward (+ backward)

each conv the factorized softmax (ops/banded.factorized_softmax, c = 0)
and the banded aggregate (ops/banded_cuda.banded_aggregate: csrc/
banded_fwd.cu, csrc/banded_bwd.cu), each captured as one CUDA graph and
its replays timed (CUDA events, the median of `--steps`; on the CPU the
host clock, eagerly).  The JAX probe's default tile, 768,
is above the port's MAX_BAND_TILE (ops/banded.py), so the tile here is 384
(164,352 = 428 x 384); the JAX probe's "xpose" row times a layout change
of its TPU kernel that the CUDA kernels do not make.

Run:  python -m geobignn_tpu_torch.examples.probe_serial [--n 164352
      --tile 384 --c 64 --heads 9 --deg 6]
      (on the CPU at a small size: --device cpu --n 1536 --tile 128)
"""

from __future__ import annotations

import torch

from geobignn_tpu_torch.examples import _probe
from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.ops.banded import factorized_softmax


def main(argv=None) -> list:
    ap = _probe.parser(__doc__)
    ap.add_argument("--n", type=int, default=164_352)
    ap.add_argument("--tile", type=int, default=384)
    ap.add_argument("--c", type=int, default=64)
    ap.add_argument("--heads", type=int, default=9)
    ap.add_argument("--deg", type=int, default=6)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = _probe.device_of(args.device)
    n, tile, c, heads = args.n, args.tile, args.c, args.heads
    if n % tile:
        raise ValueError(f"N {n} is not a multiple of the tile {tile}")
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(device=dev, generator=gen)
    m = (torch.rand((n // tile, tile, 3 * tile), **kw) < args.deg / (3 * tile)).to(torch.int8)
    x = torch.randn((n, c), **kw)
    ws = [torch.randn((heads, c, c), **kw) * 0.1 for _ in range(3)]
    us = [torch.randn((c, heads), **kw) * 0.1 for _ in range(3)]
    c0 = torch.zeros(heads, device=dev)
    print(f"[probe-serial] {_probe.card(dev)}; N={n} tile={tile} C {c}->{c} H{heads}, "
          f"{int(m.count_nonzero())} set mask slots")

    def conv(x_, u, w):
        p, r = factorized_softmax(x_, u, c0)
        return banded_cuda.banded_aggregate(r, p, x_, w, m)

    def indep3(x_):
        return sum(conv(x_, u, w).sum() for u, w in zip(us, ws))

    def chain3(x_):
        y = x_
        for u, w in zip(us, ws):
            y = conv(y, u, w)
        return y.sum()

    xg = x.clone().requires_grad_(True)

    def fwd(f):
        def run():
            with torch.no_grad():
                f(x)
        return run

    def fwd_bwd(f):
        def run():
            f(xg).backward()
            xg.grad = None
        return run

    rows = []
    for name, f in (("indep3", indep3), ("chain3", chain3)):
        for part, make in (("fwd", fwd), ("fwd+bwd", fwd_bwd)):
            t = _probe.timed(make(f), dev, steps=args.steps, graph=True)
            rows.append(_probe.row("probe-serial", probe=name, part=part, **_probe.spread(t)))
    return rows


if __name__ == "__main__":
    main()
