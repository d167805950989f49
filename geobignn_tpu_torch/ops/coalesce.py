"""Static-shape edge coalescing: sort, drop duplicates, mean their weights.

Counterpart of geobignn_tpu/ops/coalesce.py (the in-graph torch_sparse
coalesce, reference code/net_util.py:294): duplicate edges made by
relabelling clusters become trash padding in place (shapes never change),
and duplicate weights are mean-reduced onto the surviving edge.  Sorts,
cumsums and segment reductions only, with no host sync, so a CUDA graph can
hold it.  torch has no `lexsort`: stable argsorts are chained from the least
significant key up, which orders exactly as the stable lexsort does.
"""

from __future__ import annotations

import torch

from geobignn_tpu_torch.ops import segment


def lexsort(keys) -> torch.Tensor:
    """Indices sorting by keys[-1], then keys[-2], ... (numpy's lexsort
    order: the last key is the primary one), stable."""
    order = None
    for k in keys:
        k = k if order is None else k[order]
        step = torch.argsort(k, stable=True)
        order = step if order is None else order[step]
    return order


def coalesce_edges(edge_index: torch.Tensor, edge_weight: torch.Tensor | None,
                   n_pad: int, compact: bool = False):
    """edge_index (2, E) int64, trash-padded (row == col == n_pad - 1);
    edge_weight (E,) or None.  Returns (edge_index, edge_weight) of the same
    shapes with duplicates and self-loops turned into trash padding; the
    surviving edges keep sorted (row, col) order and carry the mean of
    their duplicates' weights.

    compact=True moves the trashed slots to the end (one more stable
    sort), so the rows come out non-decreasing, as the scan matching and
    the next level's convs take them."""
    e = edge_index.shape[1]
    trash = n_pad - 1
    row, col = edge_index[0], edge_index[1]

    # self-loops (trash padding included) sort last by a loop flag
    is_loop = row == col
    order = lexsort((col, row, is_loop.to(torch.int8)))
    row_s0, col_s0, loop_s = row[order], col[order], is_loop[order]
    same = torch.cat([
        torch.zeros_like(loop_s[:1]),
        (row_s0[1:] == row_s0[:-1]) & (col_s0[1:] == col_s0[:-1])])
    first = ~same & ~loop_s
    # group id per sorted edge (first occurrences open groups); loops and
    # padding fall into the junk group e - 1
    gid = torch.cumsum(first.to(torch.int64), 0) - 1
    gid = torch.where(~loop_s, gid, torch.full_like(gid, e - 1))

    row_s = torch.where(first, row_s0, torch.full_like(row_s0, trash))
    col_s = torch.where(first, col_s0, torch.full_like(col_s0, trash))
    out_ei = torch.stack([row_s, col_s])

    out_w = None
    if edge_weight is not None:
        w_s = edge_weight[order]
        kept = torch.where(~loop_s, w_s, torch.zeros_like(w_s))
        # gid is non-decreasing: the sorted sum, the same bits every run
        mean_w = segment.segment_mean(kept[:, None], gid, e, sorted=True)[:, 0]
        out_w = torch.where(first, mean_w[gid], torch.zeros_like(w_s))
    if compact:
        # stable: surviving edges keep their (row, col) sorted order
        order2 = torch.argsort((~first).to(torch.int8), stable=True)
        out_ei = out_ei[:, order2]
        if out_w is not None:
            out_w = out_w[order2]
    return out_ei, out_w
