"""GAT convolution — per-edge attention with a segment softmax.

Counterpart of geobignn_tpu/ops/gat.py (torch_geometric GATConv as the
legacy GATGNN uses it, reference code/network.py:108-124).  Per head h:

    e_ij   = LeakyReLU(a_l . W_h x_i + a_r . W_h x_j, 0.2)
    alpha  = softmax over j in N(i) ∪ {i}
    out_i  = concat_h sum_j alpha_ij W_h x_j

One loop edge is appended for every one of the n rows, the trash row
included; padded edges attend into the trash row only.  Plain torch: the
JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from geobignn_tpu_torch.ops import segment


def segment_softmax(scores: torch.Tensor, seg_ids: torch.Tensor, num_segments: int):
    """Softmax of `scores` (E, ...) grouped by seg_ids.  The shift (each
    segment's max, 0 for an empty one) carries no gradient: the softmax
    does not depend on it."""
    m = segment.segment_max(scores.detach(), seg_ids, num_segments)
    e = torch.exp(scores - m[seg_ids])
    denom = segment.segment_sum(e, seg_ids, num_segments)
    return e / torch.clamp(denom[seg_ids], min=1e-16)


def gat_conv(w: torch.Tensor, a_l: torch.Tensor, a_r: torch.Tensor, b: torch.Tensor,
             x: torch.Tensor, edge_index: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """w (C_in, H, C_out), a_l / a_r (H, C_out), b (H * C_out,)."""
    n = x.shape[0]
    heads, c_out = a_l.shape
    loops = torch.arange(n, dtype=edge_index.dtype, device=edge_index.device)
    row = torch.cat([edge_index[0], loops])
    col = torch.cat([edge_index[1], loops])
    h = torch.einsum("nc,cho->nho", x, w)  # (N, H, C_out)
    al = (h * a_l).sum(-1)  # (N, H)
    ar = (h * a_r).sum(-1)
    alpha = segment_softmax(F.leaky_relu(al[row] + ar[col], slope), row, n)
    out = segment.segment_sum(alpha[:, :, None] * h[col], row, n)  # (N, H, C_out)
    return out.reshape(n, heads * c_out) + b
