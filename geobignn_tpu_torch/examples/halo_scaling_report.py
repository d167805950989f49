"""The halo exchange's bytes and rounds a training step over a range of part
counts, and the efficiency bounds they give beside the single card's step.

Counterpart of the JAX repo's examples/halo_scaling_report.py: for each
cell (subdivisions, part counts) it builds the halo-sharded sample of
add_noise(icosphere(subdiv), 0.2, seed=0) under BuildConfig(granularity=256,
reorder=False) (parallel/halo_train.build_halo_train_sample, on the host),
and reads the exchange's real volume, a host-side fact (the send buffers
are precomputed index tables), through parallel/accounting.halo_comm_report:
the padded payload, the real cut and the dense all-to-all a step, and its
rounds.  The efficiency bounds divide the single card's step by P against
the exchange's time at a link rate and a launch latency per exchange; the
rates are planning figures, not measurements (the grid shows how far the
conclusion is from tipping).  The single card's step is measured here: one
graphed training step (Trainer.fused_step, CUDA events, the median of 10)
of the whole mesh on the card, unless `--step-ms` gives it.

Run:  python -m geobignn_tpu_torch.examples.halo_scaling_report
      [--cells 5:4,8,16 7:8,16,32] [--step-ms MS] [--out log/halo_scaling.json]
      (the host half only: --step-ms MS; on the CPU: --device cpu)
"""

from __future__ import annotations

import json
import os

from geobignn_tpu_torch.examples import _probe, _sample

LINKS_GBPS = (10, 40, 100, 450)  # 450: one H100's NVLink, a direction
LATENCIES_US = (1, 5, 25)


def single_step_ms(subdiv: int, device, steps: int = 10) -> float:
    """The median ms of one graphed training step of the whole mesh
    (Config(seed=0, granularity=256), bf16 heads) on `device`."""
    import itertools

    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.train.trainer import Trainer

    cfg = Config(seed=0, granularity=256)
    host = _sample.whole_sample(subdiv)
    tr = Trainer(cfg, _sample.stand_in(cfg), None, device=device)
    sample = host["sample"].to(device)
    step, it = _sample.train_step(tr, sample), itertools.count()
    return _probe.timed(lambda: step(next(it)), device, steps=steps)["median_ms"]


def report(subdiv: int, parts: int, step_ms: float) -> dict:
    """halo_comm_report of the P-part halo sample of the subdiv mesh, with
    the sensitivity grid over LINKS_GBPS x LATENCIES_US."""
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.data.builder import BuildConfig
    from geobignn_tpu_torch.parallel import accounting
    from geobignn_tpu_torch.parallel.halo_train import build_halo_train_sample

    m_o = synth.icosphere(subdiv)
    m_n = synth.add_noise(m_o, 0.2, seed=0)
    hs = build_halo_train_sample(m_n, m_o, BuildConfig(granularity=256, reorder=False),
                                 n_parts=parts, seed=0)
    rep = accounting.halo_comm_report(hs.structure, step_ms_single_chip=step_ms)
    rep.update(faces=m_n.n_faces, subdiv=subdiv, step_ms_single=step_ms)
    del rep["per_conv"]
    rep["sensitivity"] = {
        f"{g}GBps_{lat}us": accounting.halo_comm_report(
            hs.structure, step_ms_single_chip=step_ms, ici_gbps=g,
            round_latency_us=lat)["efficiency_no_overlap"]
        for g in LINKS_GBPS for lat in LATENCIES_US}
    return rep


def main(argv=None) -> list:
    ap = _probe.parser(__doc__)
    ap.add_argument("--cells", nargs="+", default=["5:4,8,16", "7:8,16,32"],
                    help="subdiv:P,P,... per cell")
    ap.add_argument("--step-ms", type=float, default=None,
                    help="the single card's step ms for every cell (else measured)")
    ap.add_argument("--out", default=os.path.join("log", "halo_scaling.json"))
    args = ap.parse_args(argv)
    cells = [(int(s), [int(p) for p in ps.split(",")])
             for s, ps in (c.split(":") for c in args.cells)]
    dev = None if args.step_ms is not None else _probe.device_of(args.device)
    print(f"[halo-scaling] {_probe.card(dev) if dev is not None else 'host only'}; "
          f"the single step {'given' if dev is None else 'measured on ' + str(dev)}")
    rows = []
    for subdiv, parts_list in cells:
        step_ms = args.step_ms if dev is None else single_step_ms(subdiv, dev)
        for p in parts_list:
            rep = report(subdiv, p, step_ms)
            rows.append(rep)
            _probe.row("halo-scaling", **{k: rep[k] for k in (
                "faces", "n_parts", "step_payload_mb", "step_real_mb", "step_dense_mb",
                "n_rounds_step", "t_comm_ms", "t_compute_ms", "efficiency_no_overlap",
                "efficiency_real_cut", "efficiency_dense_a2a", "step_ms_single")})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    print(f"[halo-scaling] -> {args.out}")
    return rows


if __name__ == "__main__":
    main()
