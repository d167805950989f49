"""GCN convolution — symmetric-normalized adjacency aggregation.

Counterpart of geobignn_tpu/ops/gcn.py (torch_geometric GCNConv as the
legacy FacetAttentionGNN uses it, reference code/network.py:34-36,63-64):

    out = D^{-1/2} (A + I) D^{-1/2} X W + b,   deg counts the self-loop.

Edge lists carry no self-loops (the identity term is added explicitly);
padded edges point at the zero trash row and count in its degree.  Plain
torch: the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from geobignn_tpu_torch.ops import segment


def gcn_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
             edge_index: torch.Tensor) -> torch.Tensor:
    """w (C_in, C_out), b (C_out,), x (N, C_in), edge_index (2, E)."""
    n = x.shape[0]
    row, col = edge_index[0], edge_index[1]
    deg = segment.segment_count(row, n, dtype=x.dtype) + 1.0  # + self-loop
    dinv = torch.rsqrt(deg)
    h = x @ w
    msg = (dinv[col] * dinv[row])[:, None] * h[col]
    out = segment.segment_sum(msg, row, n)
    out = out + dinv[:, None] * dinv[:, None] * h  # identity term
    return out + b
