"""The work a DualGNN step needs: useful FLOPs and the aggregates' bounds.

Frozen copies of the port's `train/roofline.py` arithmetic, fed from the
graphs' real sizes so that they read the same work whatever implements it:

  * `step_useful_flops` is `dual_gnn_flops`'s useful count (real-edge
    messages, valid-node head transforms and self terms, the fc heads),
    from the unpadded node and edge counts of each level; a training step
    counts three times the forward.  The executed count (dense windows,
    padded slots) is not kept: it moves with every tile and padding.
  * `aggregate_work` / `aggregate_work_bwd` are the counts of one call of
    the banded / block-sparse aggregate (#1-#6).  With the tensors'
    float32 sizes and the window mask's bytes they equal the port's; the
    harness gives them the level's real rows and edges, the operands at
    the configuration's dtype and the edges as CSR indices (4 bytes an
    edge and a row), one W-gradient written once.
  * `bound_s` is the larger of bytes over the memory rate and operations
    over the dense bf16 tensor-core rate.

The peaks are NVIDIA's data sheet figures for one H100 SXM at 700 W.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def conv_useful_flops(n: int, e: int, c_in: int, c_out: int, heads: int) -> int:
    """Forward FLOPs of one FeaStConv over n real nodes and e real edges."""
    return 4 * e * heads * c_in + 2 * n * heads * c_in * c_out + 2 * n * c_in * c_out


def branch_useful_flops(sizes, c0: int, widths: dict) -> int:
    """sizes: ((n, e) of levels 0, 1, 2) of one branch; c0 its input width."""
    h, hid = widths["heads"], widths["fc_hidden"]
    total = 0
    for _, lvl, ci, co in widths["convs"]:
        n, e = sizes[lvl]
        total += conv_useful_flops(n, e, c0 if ci is None else ci, co, h)
    last = widths["convs"][-1][3]
    return total + sizes[0][0] * 2 * (last * hid + hid * 3)


def step_useful_flops(sizes_v, sizes_f, widths: dict, train: bool) -> int:
    """Useful FLOPs of one sample's forward, times 3 for a training step."""
    fwd = (branch_useful_flops(sizes_v, widths["in_v"], widths)
           + branch_useful_flops(sizes_f, widths["in_f"], widths))
    return 3 * fwd if train else fwd


def aggregate_work(n, c_in, c_out, heads, nnz, tf, index_bytes, in_bytes=4, out_bytes=4):
    """(bytes, operations) of one forward aggregate: r, p (n, H), x (n, C_in),
    w (H, C_in, C_out) read at in_bytes, the (n, C_out) output written at
    out_bytes, the connectivity's index_bytes; nnz set slots (edges)."""
    k = heads * (c_out if tf else c_in)
    byts = in_bytes * (2 * n * heads + n * c_in + heads * c_in * c_out) \
        + out_bytes * n * c_out + index_bytes
    ops = 2 * nnz * (heads + k) + n * k
    if tf:
        ops += 2 * n * heads * c_out * c_in + n * k
    else:
        ops += n * k + 2 * n * k * c_out
    return byts, ops


def aggregate_work_bwd(n, c_in, c_out, heads, nnz, tf, index_bytes, partials=1,
                       in_bytes=4, out_bytes=4):
    """(bytes, operations) of one backward aggregate: the forward's inputs
    and the output gradient read, r̄, p̄, x̄ and `partials` W-gradients
    written."""
    cv = c_out if tf else c_in
    kk = heads * cv
    cr = c_in if tf else c_out
    byts = (in_bytes * (2 * n * heads + n * c_in + heads * c_in * c_out + n * c_out)
            + index_bytes + out_bytes * (2 * n * heads + n * c_in + partials * kk * cr))
    ops = nnz * (6 * kk + 6 * heads)
    if tf:
        ops += n * (2 * kk * c_in + 8 * kk + 2 * kk * c_in) + 2 * n * kk * c_in
    else:
        ops += n * (9 * kk + 2 * kk * c_out) + 2 * n * kk * c_out
    return byts, ops


def bound_s(byts: float, ops: float) -> float:
    return max(byts / PEAK_BYTES, ops / PEAK_BF16_FLOPS)


def transform_first(c_in: int, c_out: int) -> bool:
    """Which aggregate a conv runs: transform-first when it narrows."""
    return c_out < c_in


def step_aggregate_bound_s(sizes_v, sizes_f, routed_v, routed_f, widths: dict,
                           train: bool, operand_bytes: int) -> float:
    """The least seconds of one sample's #1-#6 calls: every conv at a level
    the program routes through the aggregates (routed_*[level] true), its
    forward and, training, its backward, each call bounded on its own."""
    total = 0.0
    for sizes, routed, c0 in ((sizes_v, routed_v, widths["in_v"]),
                              (sizes_f, routed_f, widths["in_f"])):
        for _, lvl, ci, co in widths["convs"]:
            if not routed[lvl]:
                continue
            n, e = sizes[lvl]
            ci = c0 if ci is None else ci
            idx = 4 * (e + n + 1)
            tf = transform_first(ci, co)
            total += bound_s(*aggregate_work(n, ci, co, widths["heads"], e, tf, idx,
                                             in_bytes=operand_bytes))
            if train:
                total += bound_s(*aggregate_work_bwd(n, ci, co, widths["heads"], e, tf, idx,
                                                     in_bytes=operand_bytes))
    return total
