"""The facet level-1 conv at 327,680 faces under its formulations.

Counterpart of the JAX repo's examples/probe_f1_327k.py: the facet graph
of add_noise(icosphere(subdiv), 0.2, seed=0) (subdiv 7: 327,680 faces),
and one FeaStConv on it (C_in 64 -> C_out 32, 9 heads, seeded weights,
bf16 aggregate operands), forward and forward+backward (with respect to x),
under

    bs256        the global RCM order, block-sparse windows at T 256
                 (ops/blocksparse: csrc/blocksparse_fwd.cu, _bwd.cu)
    hyb384/256   the slab-RCM order (ops/banded.order_for_band), the band at
                 T 384 or 256 plus the boundary table's correction
                 (ops/banded_cuda.feast_conv_hybrid: csrc/banded_fwd.cu,
                 _bwd.cu, and plain torch for the table)
    hyb*_nb      the same band with the boundary correction left out: the
                 band's cost apart from the table's

each captured as one CUDA graph and its replays timed (CUDA events, the
median of `--steps`; on the CPU the host clock, eagerly).  The host build
of the three structures is timed and printed; the JAX probe caches it on
disk, this one makes it anew each run.

Run:  python -m geobignn_tpu_torch.examples.probe_f1_327k [--subdiv 7
      --configs bs256,hyb384,hyb256]
      (on the CPU at a small size: --device cpu --subdiv 3)
"""

from __future__ import annotations

import time

import numpy as np
import torch

from geobignn_tpu_torch.examples import _probe

C_IN, C_OUT, HEADS = 64, 32, 9


def structures(subdiv: int, names) -> dict:
    """The host structures of each configuration named."""
    from geobignn_tpu_torch import graphs
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.ops import banded, blocksparse
    from geobignn_tpu_torch.structs import round_up

    mesh = synth.add_noise(synth.icosphere(subdiv), 0.2, seed=0)
    ei = graphs.build_facet_graph(mesh.fv_indices, mesh.vf_indices)
    n = mesh.n_faces
    out = {}

    def relabel(perm):
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        return inv[ei.astype(np.int64)].astype(np.int32)

    def degree(e, n_pad):
        deg = np.zeros(n_pad, np.float32)
        np.add.at(deg, e[0], 1.0)
        return deg

    if "bs256" in names:
        ei_g = relabel(banded.rcm_order(ei.astype(np.int64), n))
        n_pad = round_up(n + 1, 256)
        blk_idx, mask, k = blocksparse.block_sparse_np(ei_g, n_pad, 256)
        out["bs256"] = dict(kind="bs", m=mask, blk_idx=blk_idx.astype(np.int64),
                            deg=degree(ei_g, n_pad), n_pad=n_pad, note=f"K={k}")
    hybs = [int(name[3:]) for name in names if name.startswith("hyb")]
    if hybs:
        perm_s, bw_i = banded.order_for_band(ei, n)
        ei_s = relabel(perm_s)
        for tile in hybs:
            n_pad = round_up(n + 1, tile)
            widths = [banded.hybrid_widths(ei_s, nn, tile=tile)[1:] for nn in (n, n_pad)]
            mb, kb, rb, sb = (max(a, b) for a, b in zip(*widths))
            arrs = banded.hybrid_arrays_np(ei_s, n_pad, tile, mb, kb, rb, sb)
            out[f"hyb{tile}"] = dict(kind="hyb", deg=degree(ei_s, n_pad), n_pad=n_pad,
                                     note=f"intra_bw={bw_i} mb={mb} kb={kb}", **arrs)
    return out


def conv_of(s: dict, dev, skip_boundary: bool):
    """conv(params, x) of one configuration, its arrays on `dev`."""
    from geobignn_tpu_torch.ops import banded_cuda, blocksparse

    t = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in s.items()
         if isinstance(v, np.ndarray)}
    if s["kind"] == "bs":
        return lambda prm, x: blocksparse.feast_conv_blocksparse(
            prm, x, t["m"], t["blk_idx"], t["deg"])
    if skip_boundary:
        return lambda prm, x: banded_cuda.feast_conv_banded_kernel(prm, x, t["m"], t["deg"])
    b = [t[k].long() if k != "kmask_b" else t[k]
         for k in ("rows_b", "nbr_b", "kmask_b", "src_b", "rev_b")]
    return lambda prm, x: banded_cuda.feast_conv_hybrid(prm, x, t["m"], *b, t["deg"])


def main(argv=None) -> list:
    ap = _probe.parser(__doc__)
    ap.add_argument("--subdiv", type=int, default=7)
    ap.add_argument("--configs", default="bs256,hyb384,hyb256")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = _probe.device_of(args.device)
    names = args.configs.split(",")
    t0 = time.perf_counter()
    structs = structures(args.subdiv, names)
    print(f"[probe-f1] {_probe.card(dev)}; facet graph of icosphere({args.subdiv}); host "
          f"build of {names} {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(0)
    bound = (6.0 / (C_IN + C_OUT)) ** 0.5  # Glorot-uniform w, as the model's
    prm = dict(u=torch.randn((C_IN, HEADS), device=dev, generator=gen) * 0.1,
               c=torch.zeros(HEADS, device=dev),
               w=(torch.rand((HEADS, C_IN, C_OUT), device=dev, generator=gen) * 2 - 1) * bound,
               b=torch.zeros(C_OUT, device=dev))
    rows = []
    for name in names:
        s = structs[name]
        x0 = torch.randn((s["n_pad"], C_IN), device=dev, generator=gen) * 0.1
        xg = x0.clone().requires_grad_(True)
        for skip in ((False, True) if s["kind"] == "hyb" else (False,)):
            conv = conv_of(s, dev, skip)

            def fwd():
                with torch.no_grad():
                    conv(prm, x0)

            def fwd_bwd():
                (conv(prm, xg) ** 2).sum().backward()
                xg.grad = None

            t_f = _probe.timed(fwd, dev, steps=args.steps, graph=True)
            t_fb = _probe.timed(fwd_bwd, dev, steps=args.steps, graph=True)
            rows.append(_probe.row(
                "probe-f1", config=name + ("_nb" if skip else ""), n_pad=s["n_pad"],
                note=s["note"], fwd_ms=t_f["median_ms"], fwd_min_ms=t_f["min_ms"],
                fwd_bwd_ms=t_fb["median_ms"], fwd_bwd_min_ms=t_fb["min_ms"]))
    return rows


if __name__ == "__main__":
    main()
