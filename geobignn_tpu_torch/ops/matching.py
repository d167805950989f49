"""On-device parallel heavy-edge matching (the graph-capturable Graclus).

Counterpart of geobignn_tpu/ops/matching.py.  The reference's graclus is a
sequential randomized greedy matching run on the host inside every forward
(code/net_util.py:127); this is the JAX package's deterministic handshake:

  repeat R rounds:
    every unmatched node points at its heaviest unmatched neighbour
    (ties broken toward the smaller node id);
    mutual proposals (i -> j and j -> i) become matched pairs.

The result is a representative map rep[i] = min(i, partner(i)) in the
original slot space: dynamic pooling keeps the padded node count at every
level, so pooled features live at representative slots.  `rep` is int64,
as every index tensor of the port.  The rounds are a static loop of
sorts, gathers and scans with no host sync, so a CUDA graph holds them.
"""

from __future__ import annotations

import torch

from geobignn_tpu_torch.ops import segment
from geobignn_tpu_torch.ops.coalesce import coalesce_edges, lexsort


def parallel_matching(edge_index: torch.Tensor, edge_weight: torch.Tensor | None,
                      n_pad: int, rounds: int = 8) -> torch.Tensor:
    """rep (n_pad,) int64: each node's representative slot.

    One sort by (row, weight ascending, col descending): then a node's
    heaviest free edge (weight ties toward the smaller col) is the free
    edge with the largest sorted position in the node's run, which a
    cummax over positions and a gather at each run's end find.  (The JAX
    function's `rows_sorted` only cheapens its sort; the result is the same
    either way, so the flag has no counterpart here.)"""
    row, col = edge_index[0], edge_index[1]
    e = row.shape[0]
    w = (torch.ones(e, dtype=torch.float32, device=row.device)
         if edge_weight is None else edge_weight)
    order = lexsort((-col, w, row))
    row, col = row[order], col[order]
    real = row != col  # self-loops and trash padding excluded

    iota = torch.arange(n_pad, device=row.device)
    pos1 = torch.arange(1, e + 1, device=row.device)
    # last sorted index of each node's run (validity is checked below)
    row_end = (torch.searchsorted(row, iota, right=True) - 1).clamp(0, e - 1)

    matched = torch.zeros(n_pad, dtype=torch.bool, device=row.device)
    partner = iota.clone()
    for _ in range(rounds):
        free_edge = real & ~matched[row] & ~matched[col]
        # best free edge per node: the largest sorted position among its
        # free edges; the cummax carries across runs, so a run without a
        # free edge inherits an earlier position, caught by its row
        key = torch.where(free_edge, pos1, torch.zeros_like(pos1))
        best = torch.cummax(key, dim=0).values[row_end] - 1
        best_c = best.clamp(0, e - 1)
        has = (best >= 0) & (row[best_c] == iota)
        prop = torch.where(has, col[best_c], torch.full_like(iota, n_pad - 1))
        prop = prop.clamp(0, n_pad - 1)
        mutual = has & (prop[prop] == iota) & ~matched
        partner = torch.where(mutual, prop, partner)
        matched = matched | mutual
    return torch.minimum(iota, partner)


def _parallel_matching_scatter(edge_index: torch.Tensor, edge_weight: torch.Tensor | None,
                               n_pad: int, rounds: int = 8) -> torch.Tensor:
    """The segment-scatter formulation: the oracle of the scan version."""
    row, col = edge_index[0], edge_index[1]
    e = row.shape[0]
    w = (torch.ones(e, dtype=torch.float32, device=row.device)
         if edge_weight is None else edge_weight)
    real = row != col
    iota = torch.arange(n_pad, device=row.device)
    matched = torch.zeros(n_pad, dtype=torch.bool, device=row.device)
    partner = iota.clone()
    for _ in range(rounds):
        free_edge = real & ~matched[row] & ~matched[col]
        wv = torch.where(free_edge, w, torch.full_like(w, -torch.inf))
        m = wv.new_full((n_pad,), -torch.inf).scatter_reduce(0, row, wv, "amax")
        is_best = free_edge & (wv >= m[row])
        cand = torch.where(is_best, col, torch.full_like(col, n_pad))
        prop = torch.full_like(iota, n_pad).scatter_reduce(0, row, cand, "amin")
        has = prop < n_pad
        prop_c = prop.clamp(0, n_pad - 1)
        mutual = has & (prop_c[prop_c] == iota) & ~matched
        partner = torch.where(mutual, prop_c, partner)
        matched = matched | mutual
    return torch.minimum(iota, partner)


def pool_with_rep(x: torch.Tensor, rep: torch.Tensor, pool_type: str = "max") -> torch.Tensor:
    """Node features reduced onto their representative slots (same size)."""
    n = x.shape[0]
    if pool_type == "max":
        return segment.segment_max(x, rep, n)
    return segment.segment_mean(x, rep, n)


def pool_edges_with_rep(edge_index: torch.Tensor, edge_weight: torch.Tensor | None,
                        rep: torch.Tensor, n_pad: int):
    """Edges relabelled through rep, self-collapsed ones trashed, coalesced
    with compact=True, so the rows come back sorted."""
    return coalesce_edges(rep[edge_index], edge_weight, n_pad, compact=True)
