"""Losses and error metrics, mask-aware for padded graphs.

Counterpart of geobignn_tpu/models/losses.py (reference code/network.py:
347-413):
  loss_v      — L1 / L2 / Chamfer vertex-position loss
  loss_n      — L1 / L2 / sided normal loss
  dual_loss   — v_scale * loss_v + n_scale * loss_n (optional alpha blend)
  laplacian   — uniform graph-Laplacian L1 (optional normal projection)
  error_v     — mean Euclidean vertex distance
  error_n     — mean angular error acos(1 - ||dn||^2 / 2) in degrees

All reductions are means over VALID nodes only (node_mask).  The nearest-
point searches run over row blocks of 1024 queries, so the (Na, Nb)
distance matrix never exists whole (the JAX package tiles with lax.map for
the same reason).
"""

from __future__ import annotations

import math

import torch

from geobignn_tpu_torch.ops import nn_cuda

NEAREST_BLOCK = 1024


def masked_mean(per_node: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (per_node * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_v(vp, v, mask, dis: str = "L1", apply_icp: bool = False):
    if apply_icp:  # rigid prealignment before the distance (reference
        # network.py:364-367, pytorch3d ICP)
        from geobignn_tpu_torch.utils import icp_align

        vp, _, _ = icp_align(vp, v, mask, mask)
    if dis == "L1":
        per = (vp - v).abs().sum(dim=1)
    elif dis == "L2":
        per = ((vp - v) ** 2).sum(dim=1)
    elif dis == "CD":
        return chamfer_distance(vp, v, mask, mask)
    else:
        raise ValueError(f"unknown vertex loss '{dis}'")
    return masked_mean(per, mask)


def loss_n(np_, n, mask, norm: str = "L1", fc_p=None, fc=None):
    if norm == "L1":
        per = (np_ - n).abs().sum(dim=1)
    elif norm == "L2":
        per = ((np_ - n) ** 2).sum(dim=1)
    elif norm == "sided":
        # each predicted face (by centroid) against its nearest GT face
        # (reference network.py:385-388, kaolin sided_distance)
        idx = nearest_index(fc_p, fc, mask)
        per = (np_ - n[idx]).abs().sum(dim=1)
    else:
        raise ValueError(f"unknown normal loss '{norm}'")
    return masked_mean(per, mask)


def nearest_index(a, b, mask_b=None, block: int = NEAREST_BLOCK):
    """Per-point index of the nearest valid point of b."""
    if mask_b is None:
        mask_b = torch.ones(b.shape[0], dtype=a.dtype, device=a.device)
    return _tiled_nearest(a, b, mask_b, block)[1]


def dual_loss(lv, ln, v_scale=1.0, n_scale=1.0, alpha=None):
    if alpha is None:
        return lv * v_scale + ln * n_scale
    return alpha * lv * v_scale + (1.0 - alpha) * ln * n_scale


def error_v(vp, v, mask):
    return masked_mean(torch.sqrt(((vp - v) ** 2).sum(dim=1)), mask)


def error_n(np_, n, mask):
    err = ((np_ - n) ** 2).sum(dim=1)
    val = torch.clamp(1.0 - err / 2.0, -1.0, 1.0)
    return masked_mean(torch.arccos(val) * (180.0 / math.pi), mask)


def _graph_laplacian(v, edge_index, n, normal=None):
    row, col = edge_index[0], edge_index[1]
    s = v.new_zeros((n, v.shape[1])).index_add_(0, row, v[row] - v[col])
    cnt = v.new_zeros(n).index_add_(0, row, v.new_ones(row.shape[0]))
    lap = s / torch.clamp(cnt, min=1.0)[:, None]
    if normal is not None:
        lap = normal * (lap * normal).sum(dim=1, keepdim=True)
    return lap


def laplacian_loss(vp, v, edge_index, mask, normal=None):
    """Edge lists are self-loop-free already (storage convention), so no
    stripping is needed (the reference strips, code/network.py:357)."""
    n = vp.shape[0]
    lap_p = _graph_laplacian(vp, edge_index, n, normal)
    lap = _graph_laplacian(v, edge_index, n, normal)
    return masked_mean((lap_p - lap).abs().sum(dim=1), mask)


def chamfer_distance(a, b, mask_a, mask_b, block: int = NEAREST_BLOCK):
    """Masked symmetric Chamfer (mean squared nearest distance both ways)."""
    d_ab = _tiled_nearest(a, b, mask_b, block)[0]
    d_ba = _tiled_nearest(b, a, mask_a, block)[0]
    return masked_mean(d_ab, mask_a) + masked_mean(d_ba, mask_b)


def _tiled_nearest(a, b, mask_b, block: int):
    """Per point of `a`, the (squared distance, index) of the nearest VALID
    point of b, over row blocks of `a`."""
    nb2 = (b ** 2).sum(dim=1)
    penal = torch.where(mask_b > 0, 0.0, 1e30).to(a.dtype)
    d2, idx = [], []
    for s in range(0, a.shape[0], block):
        blk = a[s:s + block]
        d = (blk ** 2).sum(dim=1, keepdim=True) - 2.0 * blk @ b.T + nb2[None, :]
        m, i = (d + penal[None, :]).min(dim=1)
        d2.append(m)
        idx.append(i)
    return torch.clamp(torch.cat(d2), min=0.0), torch.cat(idx)


def nearest_distance(a, b, block: int = NEAREST_BLOCK, metric: str = "euclidean"):
    """Nearest-neighbour distances a->b over row blocks (the evaluation
    metric; reference my_hausdorff.py:17-49 over the `hausdorff` package's
    euclidean / manhattan / chebyshev / cosine metrics).  The euclidean
    metric on CUDA tensors is the hand-written kernel of ops/nn_cuda.py."""
    if metric == "euclidean":
        if a.is_cuda:
            return nn_cuda.nearest_distance(a, b)
        mask_b = torch.ones(b.shape[0], dtype=a.dtype, device=a.device)
        return torch.sqrt(_tiled_nearest(a, b, mask_b, block)[0])
    if metric == "manhattan":
        pair = lambda blk: (blk[:, None, :] - b[None, :, :]).abs().sum(-1)
    elif metric == "chebyshev":
        pair = lambda blk: (blk[:, None, :] - b[None, :, :]).abs().amax(-1)
    elif metric == "cosine":
        bn = b / torch.clamp(torch.linalg.norm(b, dim=1, keepdim=True), min=1e-12)

        def pair(blk):
            an = blk / torch.clamp(torch.linalg.norm(blk, dim=1, keepdim=True), min=1e-12)
            return 1.0 - an @ bn.T
    else:
        raise ValueError(f"unknown metric '{metric}'")
    return torch.cat([pair(a[s:s + block]).amin(dim=1)
                      for s in range(0, a.shape[0], block)])
