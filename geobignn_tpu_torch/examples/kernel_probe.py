"""One aggregate kernel, forward and forward+backward, at a shape given on
the command line.

Counterpart of the JAX repo's examples/kernel_probe.py: the production
banded aggregate (ops/banded_cuda.banded_aggregate: csrc/banded_fwd.cu,
csrc/banded_bwd.cu), or with `--blocksparse K` the block-sparse one over K
column blocks a row block (ops/blocksparse.bs_aggregate:
csrc/blocksparse_fwd.cu, csrc/blocksparse_bwd.cu), on seeded random
inputs: r, p, x (N, C_in), w (H, C_in, C_out) and an int8 mask whose slots
are set with probability deg / window.  Banded, the window is 3T; block-
sparse it is K T, the K column blocks of row block b being b - K//2 ..
b + K - 1 - K//2 modulo the row blocks.  Each measurement prints the
milliseconds (median, min, max; on the card the replays of one CUDA graph
of the call between CUDA events, on the CPU the host clock), its bytes
and operations, its bound and the bound's share of
the time.  The bytes and operations of the forward are
train/roofline.aggregate_work's, of the backward aggregate_work_bwd's, of
this call's r, p, x, w, mask (and block list):

    forward bytes = 4 (|r| + |p| + |x| + |w| + N C_out) + |mask| (+ 8 |blk_idx|)
    forward ops   = 2 S (H + K) + N K + (tf: 2 N H C_out C_in + N K;
                                          not: N K + 2 N K C_out)

with S the set mask slots, K = H C_out if the kernel transforms first
(C_out < C_in) else H C_in; the forward+backward row adds the two.  A
bound is bytes / 3.35 TB/s or operations / 989 TF/s (bf16 tensor cores),
whichever is longer (train/roofline.bound_ms).

Run:  python -m geobignn_tpu_torch.examples.kernel_probe [--n 165888
      --tile 384 --c-in 64 --c-out 32 --heads 9 --deg 12 --blocksparse K]
      (on the CPU at a small size: --device cpu --n 1536 --tile 128)
"""

from __future__ import annotations

import torch

from geobignn_tpu_torch.examples import _probe
from geobignn_tpu_torch.ops import banded_cuda, blocksparse
from geobignn_tpu_torch.train import roofline


def inputs(n: int, tile: int, c_in: int, c_out: int, heads: int, deg: int, k_blocks: int,
           device, seed: int = 0) -> dict:
    """The seeded operands of one call (r, p, x, w, m and, block-sparse,
    blk_idx), made on `device`."""
    if n % tile:
        raise ValueError(f"N {n} is not a multiple of the tile {tile}")
    gen = torch.Generator(device=device).manual_seed(seed)
    n_blk = n // tile
    win = (k_blocks or 3) * tile
    kw = dict(device=device, generator=gen)
    ops = dict(r=torch.rand((n, heads), **kw), p=torch.rand((n, heads), **kw),
               x=torch.randn((n, c_in), **kw), w=torch.randn((heads, c_in, c_out), **kw) * 0.1,
               m=(torch.rand((n_blk, tile, win), **kw) < deg / win).to(torch.int8))
    if k_blocks:
        b = torch.arange(n_blk, device=device)[:, None]
        ops["blk_idx"] = (b + torch.arange(k_blocks, device=device) - k_blocks // 2) % n_blk
    return ops


def work(ops: dict) -> dict:
    """Bytes and operations of the forward and of the backward (the
    module docstring's formula) and their bounds."""
    tf = banded_cuda.use_transform_first(ops["x"].shape[1], ops["w"].shape[2])
    args = [ops[k] for k in ("r", "p", "x", "w", "m")]
    out = {}
    for tag, fn in (("fwd", roofline.aggregate_work), ("bwd", roofline.aggregate_work_bwd)):
        byts, n_ops, _ = fn(*args, tf, ops.get("blk_idx"))
        out[tag] = dict(bytes=byts, ops=n_ops)
    return out


def main(argv=None) -> list:
    ap = _probe.parser(__doc__)
    ap.add_argument("--n", type=int, default=165_888)
    ap.add_argument("--tile", type=int, default=384)
    ap.add_argument("--c-in", type=int, default=64)
    ap.add_argument("--c-out", type=int, default=32)
    ap.add_argument("--heads", type=int, default=9)
    ap.add_argument("--deg", type=int, default=12)
    ap.add_argument("--blocksparse", type=int, default=0, metavar="K",
                    help="the block-sparse kernels over K column blocks a row block")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = _probe.device_of(args.device)
    ops = inputs(args.n, args.tile, args.c_in, args.c_out, args.heads, args.deg,
                 args.blocksparse, dev)
    tf = banded_cuda.use_transform_first(args.c_in, args.c_out)
    bs = "blk_idx" in ops
    kernel = "bs_aggregate" if bs else "banded_aggregate"
    print(f"[kernel-probe] {_probe.card(dev)}; {kernel}, "
          f"{'transform' if tf else 'aggregate'}-first: N={args.n} tile={args.tile} "
          f"window={ops['m'].shape[2]} C {args.c_in}->{args.c_out} H{args.heads}, "
          f"{int(ops['m'].count_nonzero())} set mask slots")
    leaves = [ops[k] for k in ("r", "p", "x", "w")]
    rest = [ops["m"]] + ([ops["blk_idx"]] if bs else [])
    fn = blocksparse.bs_aggregate if bs else banded_cuda.banded_aggregate
    grads = [t.clone().requires_grad_(True) for t in leaves]
    gout = torch.randn((args.n, args.c_out), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))

    def fwd():
        with torch.no_grad():
            return fn(*leaves, *rest)

    def fwd_bwd():
        out = fn(*grads, *rest)
        torch.autograd.backward(out, gout)
        for g in grads:
            g.grad = None

    w = work(ops)
    rows = []
    for tag, step, parts in (("fwd", fwd, ("fwd",)), ("fwd+bwd", fwd_bwd, ("fwd", "bwd"))):
        t = _probe.timed(step, dev, steps=args.steps, graph=True)
        byts = sum(w[p]["bytes"] for p in parts)
        n_ops = sum(w[p]["ops"] for p in parts)
        bound, by = roofline.bound_ms(byts, n_ops)
        rows.append(_probe.row(
            "kernel-probe", kernel=kernel, part=tag, n=args.n, tile=args.tile,
            window=int(ops["m"].shape[2]), c_in=args.c_in, c_out=args.c_out, heads=args.heads,
            transform_first=tf, set_slots=int(ops["m"].count_nonzero()), **_probe.spread(t),
            bytes=byts, ops=n_ops, bound_ms=bound, bound_by=by,
            bound_share=bound / t["median_ms"]))
    return rows


if __name__ == "__main__":
    main()
