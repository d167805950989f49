"""Communication accounting of the halo-sharded training step.

Counterpart of geobignn_tpu/parallel/accounting.py.  The step's exchange
volume is a host fact of the built sharding (the send tables are
precomputed, parallel/partition.py), equal to the JAX package's; the time
model weighs it against a per-part compute time:

    eff_no_overlap = T_compute / (T_compute + T_comm)
    eff_overlap    = T_compute / max(T_compute, T_comm)

per conv and per step.  Every conv exchanges its halo rounds in the forward
and their transpose in the backward — 2x the payload per conv per step (1x
for the first vertex conv, whose raw-data input gets no gradient;
ConvComm.factor).  Each round is padded to its own largest pair cut; the
dense all-to-all (every pair padded to the global largest cut) is kept as a
comparison column.

The link rate is a parameter.  Its default is the NVLink figure of the
NVIDIA H100 SXM (NVLink 4: 18 links, 900 GB/s per card in both directions
together, 450 GB/s each way); the single-device step time has no default:
measure it on the card the model is for.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from geobignn_tpu_torch.models.dual_gnn import CONV_SCHEDULE as _MODEL_SCHEDULE

# H100 SXM NVLink 4, one direction per card (public specification): the
# rate a part's sends leave its card at
DEFAULT_LINK_GBPS = 450.0

_CONV_SCHEDULE = [(lvl, c_in, c_out) for _, lvl, c_in, c_out in _MODEL_SCHEDULE]


@dataclasses.dataclass
class ConvComm:
    name: str
    level: int
    c_in: int
    payload_mb: float  # sparse per-round exchange payload per part (fwd)
    real_mb: float  # real (non-trash) boundary rows only
    dense_mb: float  # what a dense max-pair all-to-all would move
    factor: int = 2  # exchanges per step: forward + backward; 1 for the
    # FIRST vertex conv, whose exchanged input is the raw data xv


def _level_halo(sh) -> tuple[int, int, int]:
    """(sparse padded rows, real rows, dense all-to-all rows) per exchange,
    each the largest over the parts (the slowest part paces the step).
    Sparse counts a part's round participation: a part with no partner in a
    round moves nothing in it."""
    trash = sh.n_loc - 1
    real = (sh.send_idx != trash).sum(axis=1)
    part = np.zeros(sh.n_parts, np.int64)
    for perm, h_c in sh.rounds:
        for chip in {s for s, _ in perm}:  # perm holds both directions
            part[chip] += h_c
    dense = (sh.n_parts - 1) * max((h for _, h in sh.rounds), default=0)
    return int(part.max()), int(real.max()), dense


def halo_comm_report(
    hd,
    step_ms_single_chip: float,
    c0_v: int = 6,
    c0_f: int = 12,
    ici_gbps: float = DEFAULT_LINK_GBPS,
    round_latency_us: float = 5.0,
) -> dict:
    """Per-conv and per-step exchange volume and efficiency bounds.

    hd: parallel.halo_model.HaloDual (host-built).
    step_ms_single_chip: the MEASURED single-device training-step time of
      this mesh on the target card (required: the per-part compute under a
      perfect P-way split is step_ms / P).
    ici_gbps: the link rate per part, GB/s (the name kept from JAX).
    round_latency_us: a planning figure for one exchange's launch, not a
      measurement."""
    p = hd.v.levels[0].send_idx.shape[0]
    convs: list[ConvComm] = []
    conv_rounds: list[int] = []
    for branch, tag, c0 in ((hd.v, "v", c0_v), (hd.f, "f", c0_f)):
        for i, (lvl, c_in, _) in enumerate(_CONV_SCHEDULE):
            ci = c0 if c_in is None else c_in
            padded, real, dense = _level_halo(branch.levels[lvl])
            conv_rounds.append(len(branch.levels[lvl].rounds))
            convs.append(ConvComm(
                name=f"{tag}_conv{i + 1}", level=lvl + 1, c_in=ci,
                payload_mb=padded * ci * 4 / 1e6, real_mb=real * ci * 4 / 1e6,
                dense_mb=dense * ci * 4 / 1e6,
                factor=1 if (tag == "v" and i == 0) else 2,
            ))
    # the cross-domain corner gather: 3-coordinate positions
    fv_part = np.zeros(p, np.int64)
    for perm, h_c in hd.fv_rounds:
        for chip in {s for s, _ in perm}:
            fv_part[chip] += h_c
    fv_real = (hd.send_fv != hd.v.levels[0].n_loc - 1).sum(axis=1)
    fv_dense = (p - 1) * max((h for _, h in hd.fv_rounds), default=0)
    convs.append(ConvComm("fv_gather", 1, 3, int(fv_part.max()) * 3 * 4 / 1e6,
                          int(fv_real.max()) * 3 * 4 / 1e6, fv_dense * 3 * 4 / 1e6))
    conv_rounds.append(len(hd.fv_rounds))

    n_rounds_step = sum(c.factor * r for c, r in zip(convs, conv_rounds))
    n_exchanges = sum(c.factor for c in convs)
    step_payload_mb = sum(c.factor * c.payload_mb for c in convs)
    step_real_mb = sum(c.factor * c.real_mb for c in convs)
    step_dense_mb = sum(c.factor * c.dense_mb for c in convs)

    # latency once per exchange: every round's send rows come from one
    # gather, so the copies issue back to back; bytes add up
    t_latency_ms = n_exchanges * round_latency_us / 1e3
    t_comm_ms = step_payload_mb / 1e3 / ici_gbps * 1e3 + t_latency_ms
    t_comm_real_ms = step_real_mb / 1e3 / ici_gbps * 1e3 + t_latency_ms
    t_comm_dense_ms = step_dense_mb / 1e3 / ici_gbps * 1e3 + t_latency_ms
    t_comp_ms = step_ms_single_chip / p
    return dict(
        n_parts=p,
        per_conv=[dataclasses.asdict(c) for c in convs],
        step_payload_mb=round(step_payload_mb, 3),
        step_real_mb=round(step_real_mb, 3),
        step_dense_mb=round(step_dense_mb, 3),
        padding_overhead=round(step_payload_mb / max(step_real_mb, 1e-9), 2),
        n_rounds_step=n_rounds_step,
        t_latency_ms=round(t_latency_ms, 3),
        ici_gbps=ici_gbps,
        t_comm_ms=round(t_comm_ms, 3),
        t_comm_real_ms=round(t_comm_real_ms, 3),
        t_comm_dense_ms=round(t_comm_dense_ms, 3),
        t_compute_ms=round(t_comp_ms, 3),
        efficiency_no_overlap=round(t_comp_ms / (t_comp_ms + t_comm_ms), 4),
        efficiency_overlapped=round(t_comp_ms / max(t_comp_ms, t_comm_ms), 4),
        efficiency_real_cut=round(t_comp_ms / (t_comp_ms + t_comm_real_ms), 4),
        efficiency_dense_a2a=round(t_comp_ms / (t_comp_ms + t_comm_dense_ms), 4),
    )
