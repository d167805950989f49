"""Analytic FLOP accounting and MFU/roofline figures of the DualGNN step.

Counterpart of geobignn_tpu/train/roofline.py, with the peaks of the
NVIDIA card in place of the TPU table.  From a sample's attached
structures it counts

  * executed flops — the matmul FLOPs of the step as the JAX package's
    formulations run them: the banded and block-sparse windows dense
    (masked slots included), the padded table slots, the padded COO edges;
  * useful flops — the least work of the same math: real-edge messages,
    per-node head transforms and the fc heads,

and reports, for a measured step time,

    mfu_pct          executed / (step time * peak)
    useful_flops_pct useful / executed
    useful_mfu_pct   their product

with the keys of the JAX module.  A training step counts as 3x the forward
(`bwd_multiplier`).  The port's window kernels walk the set mask slots
instead of the dense window, so on the card the executed count is the JAX
formulation's work, not the kernels': `useful_mfu_pct` is the figure that
compares across the two.

`peak_flops` is the dense bf16 tensor-core rate of the card, found from
`torch.cuda.get_device_name` in `PEAKS` (the card's float32 and memory
rates beside it); on the CPU, or on a card the table does not list, the
caller passes the peak.
"""

from __future__ import annotations

import numpy as np
import torch

# (dense bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores,
# memory bytes/s) by device name, matched by substring, longest first
PEAKS = {
    "H100 80GB HBM3": (989e12, 67e12, 3.35e12),  # SXM5, 700 W
    "H100 SXM": (989e12, 67e12, 3.35e12),
    "H100 PCIe": (756e12, 51e12, 2.0e12),
}


def device_peaks(device=None) -> tuple[float, float, float]:
    """(bf16 FLOP/s, float32 FLOP/s, bytes/s) of a CUDA device, by its name."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass the peak (peak_flops=...)")
    name = torch.cuda.get_device_name(device)
    for key in sorted(PEAKS, key=len, reverse=True):
        if key in name:
            return PEAKS[key]
    raise RuntimeError(f"no peaks known for {name!r}: pass the peak (peak_flops=...)")


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _conv_schedule(c0: int):
    """(level index, C_in, C_out) of the 8 convs of one GNNModule branch;
    c0 = the branch input width (6 vertex / 12 facet)."""
    return [
        (0, c0, 32), (1, 32, 64), (2, 64, 128), (2, 128, 128),
        (1, 128, 64), (1, 128, 64), (0, 64, 32), (0, 64, 32),
    ]


def _conv_flops(level, c_in: int, c_out: int, heads: int) -> tuple[int, int]:
    """(executed, useful) forward FLOPs of ONE FeaStConv on `level`."""
    mask = _np(level.node_mask)
    n_pad = int(mask.shape[0])
    n_valid = int(mask.sum())
    e_real = int(_np(level.deg).sum())

    # useful: per real edge one H-score dot + one H-weighted feature sum;
    # per valid node the head-transform matmul + self term
    useful = 4 * e_real * heads * c_in + 2 * n_valid * heads * c_in * c_out
    useful += 2 * n_valid * c_in * c_out  # self-loop term

    if level.band is not None:
        n_blk, tile, win = level.band.shape
        n_rows = n_blk * tile
        # D matmul + numerator z matmul + xpw broadcast + head transform
        exe = n_rows * (
            2 * win * heads * (c_in + 1)
            + win * heads * c_in
            + 2 * heads * c_in * c_out
        )
        exe += 2 * n_pad * c_in * c_out
    elif level.nbr is not None:
        k = int(level.nbr.shape[1])
        exe = n_pad * (4 * k * heads * c_in + 2 * heads * c_in * c_out)
        exe += 2 * n_pad * c_in * c_out
    else:
        e_pad = int(level.edge_index.shape[1])
        exe = 4 * e_pad * heads * c_in + 2 * n_pad * heads * c_in * c_out
        exe += 2 * n_pad * c_in * c_out
    return exe, useful


def dual_gnn_flops(sample, heads: int = 9, fc_hidden: int = 1024) -> dict:
    """Forward executed/useful FLOPs of one DualGNN application."""
    exe = useful = 0
    for branch, c0 in ((sample.v, 6), (sample.f, 12)):
        for lvl_i, c_in, c_out in _conv_schedule(c0):
            e, u = _conv_flops(branch.levels[lvl_i], c_in, c_out, heads)
            exe += e
            useful += u
        n_pad = int(branch.x.shape[0])
        n_valid = int(_np(branch.levels[0].node_mask).sum())
        out_dim = 3
        fc = 2 * (32 * fc_hidden + fc_hidden * out_dim)
        exe += n_pad * fc
        useful += n_valid * fc
    return dict(fwd_executed=exe, fwd_useful=useful)


def roofline(sample, step_seconds: float, heads: int = 9,
             bwd_multiplier: float = 3.0, peak_flops: float | None = None,
             device=None) -> dict:
    """MFU metrics of one measured training step on `sample`; the peak is
    the card's dense bf16 rate unless given."""
    f = dual_gnn_flops(sample, heads)
    peak = peak_flops if peak_flops is not None else device_peaks(device)[0]
    exe = f["fwd_executed"] * bwd_multiplier
    useful = f["fwd_useful"] * bwd_multiplier
    mfu = exe / (step_seconds * peak)
    useful_frac = useful / exe
    return dict(
        mfu_pct=round(100 * mfu, 2),
        useful_flops_pct=round(100 * useful_frac, 2),
        useful_mfu_pct=round(100 * mfu * useful_frac, 3),
        step_tflops=round(exe / step_seconds / 1e12, 2),
        peak_tflops=round(peak / 1e12, 1),
    )


# --------------------------------------------------------------------------
# one call of a banded / block-sparse aggregate (csrc/banded_*.cu,
# csrc/blocksparse_*.cu): the work its data needs, for its bound
# --------------------------------------------------------------------------

def aggregate_work(r, p, x, w, m, tf: bool, blk_idx=None) -> tuple[int, int, int]:
    """(bytes, operations this call's data needs, operations counted
    densely over the window as the TPU wrapper's cost estimate does) of one
    forward aggregate.  With N rows, H heads, C_in -> C_out, a window of W
    slots, S set mask slots and K = H * (C_out if tf else C_in):

        bytes = 4 (|r| + |p| + |x| + |w| + N C_out) + |m| (+ |blk_idx| x its item size)
        ops   = 2 S (H + K) + N K,  plus
                tf:  2 N H C_out C_in + N K      (x W first; the head sum)
                not: N K + 2 N K C_out           (p x; the W contraction)
        dense = 2 N W (H (C_out + 1) + H C_in / 3)   tf
                2 N W (H (C_in + 1) + H C_out / 3)   not tf

    r, p, x, w in float32 (the wrapper's operands), m int8."""
    n, c_in = x.shape
    heads, c_out = r.shape[1], w.shape[2]
    win = m.shape[2]
    k = heads * (c_out if tf else c_in)
    nnz = int(m.count_nonzero())
    byts = 4 * (r.numel() + p.numel() + x.numel() + w.numel() + n * c_out) + m.numel()
    if blk_idx is not None:
        byts += blk_idx.numel() * blk_idx.element_size()
    ops = 2 * nnz * (heads + k) + n * k  # D and A·V over the set slots; r scale
    if tf:
        ops += 2 * n * heads * c_out * c_in + n * k  # W2 x; head sum
    else:
        ops += n * k + 2 * n * k * c_out  # p x; W contraction
    if tf:
        dense = 2 * n * win * (heads * (c_out + 1) + heads * c_in / 3)
    else:
        dense = 2 * n * win * (heads * (c_in + 1) + heads * c_out / 3)
    return byts, ops, int(dense)


def aggregate_work_bwd(r, p, x, w, m, tf: bool, blk_idx=None) -> tuple[int, int, int]:
    """(bytes, operations this call's data needs, dense operations) of one
    backward aggregate.  Inputs r, p, x, w, m, gout (and blk_idx) and
    outputs r̄, p̄, x̄ and the per-block W̄ partials, each moved once; per set
    mask slot D, the window products z, K and a and the r̄ / p̄ denominator
    parts, plus the per-node products; densely, the five window products of
    the TPU kernel over the whole window and the two C_out (or C_in)
    products.  With B row blocks, Cv = C_out if tf else C_in, KK = H Cv,
    Cr = C_in if tf else C_out:

        bytes = 4 (|r| + |p| + |x| + |w| + N C_out) + |m|
                + 4 (2 N H + N C_in + B KK Cr) (+ |blk_idx| x its item size)
        ops   = S (6 KK + 6 H) + (tf:  N (4 KK C_in + 8 KK) + 2 N KK C_in
                                  not: N (9 KK + 2 KK C_out) + 2 N KK C_out)"""
    n, c_in = x.shape
    heads, c_out = r.shape[1], w.shape[2]
    n_blk, _, win = m.shape
    cv = c_out if tf else c_in
    kk = heads * cv
    cr = c_in if tf else c_out
    nnz = int(m.count_nonzero())
    byts = (4 * (r.numel() + p.numel() + x.numel() + w.numel() + n * c_out)
            + m.numel() + 4 * (2 * n * heads + n * c_in + n_blk * kk * cr))
    if blk_idx is not None:
        byts += blk_idx.numel() * blk_idx.element_size()
    ops = nnz * (6 * kk + 6 * heads)
    if tf:  # Y, V, G, gz*z, y*a, yb, x̄ = yb W2, W̄ = yb^T x
        ops += n * (2 * kk * c_in + 8 * kk + 2 * kk * c_in) + 2 * n * kk * c_in
        dense = 2 * n * win * (3 * kk + 3 * heads) + 3 * 2 * 3 * n * kk * c_in
    else:  # V, gy, G, zr, gy*z, x̄, p̄ direct, W̄ = zr^T gout
        ops += n * (9 * kk + 2 * kk * c_out) + 2 * n * kk * c_out
        dense = 2 * n * win * (3 * kk + 3 * heads) + 4 * n * kk * c_out
    return byts, ops, int(dense)


def bound_ms(byts: float, ops: float, peaks=PEAKS["H100 80GB HBM3"]) -> tuple[float, str]:
    """(the least milliseconds for `byts` bytes and `ops` bf16 tensor-core
    operations at the card's rates, which of the two bounds it)."""
    t_b, t_o = byts / peaks[2], ops / peaks[0]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")
