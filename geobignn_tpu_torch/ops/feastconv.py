"""FeaStConv over COO edges and over dense neighbour tables, in plain torch.

Counterpart of geobignn_tpu/ops/feastconv.py: the conv paths that hold no
kernel.  Every level takes `feast_conv_table` under Config(reorder=False),
and `feast_conv` when a sample carries no tables at all.

    q_h(i,j) = softmax_h( u_h . (x_j - x_i) + c_h )
    out_i    = ( sum_edges sum_h q_h W_h x_j + sum_h s_h W_h x_i ) / (deg_i + 1) + b
    with s = softmax(c), the implicit self-loop (edge lists store none).

`params` is the dict the banded convs take: u (C_in, H), c (H,),
w (H, C_in, C_out), b (C_out,).  Gradients are autograd's, through the
sorted-sum backwards of `segment.take_rows` in the COO conv.

Both convs take `x_src`, a gather source other than x: the halo-sharded
case (parallel/partition.py), where x is one part's local rows and x_src
its extended [local | halo] table.  The COO conv's edge-partition mode
(graph parallel, the JAX function's `psum_axis`) is `shard_devices`: the
edge list is cut into one contiguous slice per device (trash padding makes
any slice valid), each device aggregates its slice, and the partial
aggregates and degrees are summed on x's device, as the JAX psum does.
"""

from __future__ import annotations

import torch

from geobignn_tpu_torch.ops import segment
from geobignn_tpu_torch.ops import table as tbl
from geobignn_tpu_torch.ops.banded import self_loop_epilogue


# E * H * C_in, the elements of the fused-heads outer product, above which
# the COO conv sums the heads one at a time (the JAX function's gate)
FUSED_HEADS_MAX = 1 << 29


def _partial_aggregate(params: dict, x, x_src, row, col, n: int, count: bool):
    """(sum over the edges of q_h W_h x_j per row (N, C_out), the rows' edge
    counts (N,) or None without `count`) of one edge list.  The edges are
    first put in row order by a stable argsort (the identity on the
    row-sorted lists of host-built levels and compacted coalesce outputs; a
    reordered level's lists are not sorted), so the sums are sorted segment
    sums and the gathers' backwards are too: no atomics, and no serial run
    over the trash padding (ops/segment.py).  Up to FUSED_HEADS_MAX
    elements, one segment sum of the (E, H*C_in) outer product, as the JAX
    function's fused-heads branch; above it one (E, C_in) weighted gather
    a head, summed into the output head by head, as its scan over the
    heads: one such intermediate is live at a time."""
    c_in = x.shape[1]
    heads = params["c"].shape[0]
    order = torch.argsort(row, stable=True)
    row, col = row[order], col[order]
    x_j, x_i = segment.take_rows(x_src, col), segment.take_rows(x, row, sorted=True)
    q = torch.softmax((x_j - x_i) @ params["u"] + params["c"], dim=-1)  # (E, H)
    e = row.shape[0]
    if e * heads * c_in <= FUSED_HEADS_MAX:
        big = (q[:, :, None] * x_j[:, None, :]).reshape(e, heads * c_in)
        z = segment.segment_sum(big, row, n, sorted=True).reshape(n, heads, c_in)
        num = torch.einsum("nhc,hco->no", z, params["w"])
    else:
        num = sum(segment.segment_sum(q[:, h, None] * x_j, row, n, sorted=True)
                  @ params["w"][h] for h in range(heads))
    cnt = segment.segment_count(row, n, dtype=x.dtype, sorted=True) if count else None
    return num, cnt


def feast_conv(params: dict, x: torch.Tensor, edge_index: torch.Tensor, *,
               deg: torch.Tensor | None = None, x_src: torch.Tensor | None = None,
               shard_devices: list | None = None) -> torch.Tensor:
    """x: (N, C_in) with a zero trash row; edge_index: (2, E) [dst, src], no
    self-loops, columns into x_src (default x); deg: (N,) real-edge
    in-degree, counted if None.  Returns (N, C_out).

    With `shard_devices` (graph parallel) the edges are split into one
    contiguous slice per device; each slice is aggregated on its device with
    x and the parameters copied there, and the partial aggregates and edge
    counts are summed on x's device.  deg is then the summed count, as the
    JAX psum mode counts it."""
    n = x.shape[0]
    x_src = x if x_src is None else x_src
    if shard_devices is None:
        num, cnt = _partial_aggregate(params, x, x_src, edge_index[0], edge_index[1], n,
                                      deg is None)
    else:
        num = cnt = 0
        for ei, dev in zip(edge_index.chunk(len(shard_devices), dim=1), shard_devices):
            prm = {k: v.to(dev) for k, v in params.items()}
            ei = ei.to(dev)
            part, c = _partial_aggregate(prm, x.to(dev), x_src.to(dev), ei[0], ei[1], n,
                                         True)
            num = num + part.to(x.device)
            cnt = cnt + c.to(x.device)
        deg = None
    return self_loop_epilogue(num, x, params, cnt if deg is None else deg)


def feast_conv_table(params: dict, x: torch.Tensor, nbr: torch.Tensor,
                     kmask: torch.Tensor, rev: torch.Tensor | None = None, *,
                     deg: torch.Tensor | None = None,
                     x_src: torch.Tensor | None = None) -> torch.Tensor:
    """FeaStConv over a dense neighbour table: nbr (N, K) into x_src
    (default x), kmask (N, K) f32, rev the reverse table of nbr over x_src's
    rows.  Same math as `feast_conv`; the neighbour sum is a contraction
    over K."""
    if deg is None:
        deg = kmask.sum(dim=1)
    xn = tbl.table_gather(x if x_src is None else x_src, nbr, rev)  # (N, K, C_in)
    s = torch.einsum("nkc,ch->nkh", xn - x[:, None, :], params["u"]) + params["c"]
    q = torch.softmax(s, dim=-1) * kmask[..., None]  # (N, K, H)
    z = torch.einsum("nkh,nkc->nhc", q, xn)
    num = torch.einsum("nhc,hco->no", z, params["w"])
    return self_loop_epilogue(num, x, params, deg)


def feast_conv_dense_reference(params: dict, x: torch.Tensor,
                               edge_index: torch.Tensor) -> torch.Tensor:
    """Brute-force reference with explicit self-loops (for unit tests)."""
    n = x.shape[0]
    loops = torch.arange(n, dtype=edge_index.dtype, device=edge_index.device)
    row = torch.cat([edge_index[0], loops])
    col = torch.cat([edge_index[1], loops])
    q = torch.softmax((x[col] - x[row]) @ params["u"] + params["c"], dim=-1)
    msg = torch.einsum("eh,ec,hco->eo", q, x[col], params["w"])
    out = segment.segment_sum(msg, row, n)
    cnt = segment.segment_count(row, n, dtype=x.dtype)
    return out / torch.clamp(cnt, min=1.0)[:, None] + params["b"]
