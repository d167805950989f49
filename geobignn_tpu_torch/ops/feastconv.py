"""FeaStConv over COO edges and over dense neighbour tables, in plain torch.

Counterpart of geobignn_tpu/ops/feastconv.py: the conv paths that hold no
kernel.  Every level takes `feast_conv_table` under Config(reorder=False),
and `feast_conv` when a sample carries no tables at all.

    q_h(i,j) = softmax_h( u_h . (x_j - x_i) + c_h )
    out_i    = ( sum_edges sum_h q_h W_h x_j + sum_h s_h W_h x_i ) / (deg_i + 1) + b
    with s = softmax(c), the implicit self-loop (edge lists store none).

`params` is the dict the banded convs take: u (C_in, H), c (H,),
w (H, C_in, C_out), b (C_out,).  Gradients are autograd's, through the
sorted-sum backwards of `segment.take_rows` in the COO conv.  The JAX
function's edge-partition mode (`psum_axis`, graph parallel) is not ported.
"""

from __future__ import annotations

import torch

from geobignn_tpu_torch.ops import segment
from geobignn_tpu_torch.ops import table as tbl
from geobignn_tpu_torch.ops.banded import self_loop_epilogue


def feast_conv(params: dict, x: torch.Tensor, edge_index: torch.Tensor, *,
               deg: torch.Tensor | None = None) -> torch.Tensor:
    """x: (N, C_in) with a zero trash row; edge_index: (2, E) [dst, src], no
    self-loops; deg: (N,) real-edge in-degree, counted if None.  Returns
    (N, C_out).  One segment sum of the (E, H*C_in) outer product, as the
    JAX function's fused-heads branch.  The edges are first put in row order
    by a stable argsort (the identity on the row-sorted lists of host-built
    levels and compacted coalesce outputs; a reordered level's lists are
    not sorted), so the sums are sorted segment sums and the gathers'
    backwards are too: no atomics, and no serial run over the trash padding
    (ops/segment.py)."""
    n, c_in = x.shape
    heads = params["c"].shape[0]
    order = torch.argsort(edge_index[0], stable=True)
    row, col = edge_index[0][order], edge_index[1][order]
    x_j, x_i = segment.take_rows(x, col), segment.take_rows(x, row, sorted=True)
    q = torch.softmax((x_j - x_i) @ params["u"] + params["c"], dim=-1)  # (E, H)
    if deg is None:
        deg = segment.segment_count(row, n, dtype=x.dtype, sorted=True)
    big = (q[:, :, None] * x_j[:, None, :]).reshape(row.shape[0], heads * c_in)
    z = segment.segment_sum(big, row, n, sorted=True).reshape(n, heads, c_in)
    num = torch.einsum("nhc,hco->no", z, params["w"])
    return self_loop_epilogue(num, x, params, deg)


def feast_conv_table(params: dict, x: torch.Tensor, nbr: torch.Tensor,
                     kmask: torch.Tensor, rev: torch.Tensor | None = None, *,
                     deg: torch.Tensor | None = None) -> torch.Tensor:
    """FeaStConv over a dense neighbour table: nbr (N, K), kmask (N, K) f32.
    Same math as `feast_conv`; the neighbour sum is a contraction over K."""
    if deg is None:
        deg = kmask.sum(dim=1)
    xn = tbl.table_gather(x, nbr, rev)  # (N, K, C_in)
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
