"""Mesh geometry operators — host (numpy) and device (torch) variants.

Counterpart of geobignn_tpu/geometry.py.  The `*_np` host functions are
copied from it unchanged (their outputs feed the bit-equal host builders);
the device variants are torch functions over padded arrays, where padded
faces index a zero "trash" vertex row so their cross products vanish.
"""

from __future__ import annotations

import numpy as np
import torch

EPS_NORMALIZE = 1e-12


# --------------------------------------------------------------------------
# device (torch)
# --------------------------------------------------------------------------

def safe_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / max(||x||, eps), written via the clamped squared norm (as the JAX
    package does) so a zero row stays zero and has a zero gradient."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=EPS_NORMALIZE**2))


# --------------------------------------------------------------------------
# host (numpy) — preprocessing-time
# --------------------------------------------------------------------------

def face_normals_np(points: np.ndarray, fv_indices: np.ndarray) -> np.ndarray:
    fv = points[fv_indices]
    n = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    d = np.maximum(np.linalg.norm(n, axis=1, keepdims=True), EPS_NORMALIZE)
    return (n / d).astype(np.float32)


def vertex_normals_np(
    points: np.ndarray,
    fv_indices: np.ndarray,
    n_vertices: int | None = None,
    weighting: str = "uniform",
) -> np.ndarray:
    """Unit vertex normals: normalize(weighted sum of incident face normals).

    weighting="uniform" (default) sums UNIT face normals — exactly OpenMesh's
    `update_vertex_normals` (code/dataset.py:199), whose default
    `calc_vertex_normal` delegates to `calc_vertex_normal_fast`:
    `for vf_it: n += normal(*vf_it)` over unit face normals
    (OpenMesh PolyMeshT_impl.hh).  So the reference's vertex-branch inputs
    use uniform weighting, not angle/area weighting.

    weighting="area" sums UNNORMALIZED cross products (magnitude = 2x face
    area), provided for robustness experiments on meshes with skewed
    triangle sizes."""
    if n_vertices is None:
        n_vertices = points.shape[0]
    if weighting == "uniform":
        fn = face_normals_np(points, fv_indices)
    elif weighting == "area":
        fv = points[fv_indices]
        fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    else:
        raise ValueError(f"unknown weighting '{weighting}'")
    acc = np.zeros((n_vertices, 3), dtype=np.float64)
    for c in range(3):
        np.add.at(acc, fv_indices[:, c], fn)
    d = np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), EPS_NORMALIZE)
    return (acc / d).astype(np.float32)


def mean_edge_length_np(points: np.ndarray, ev_indices: np.ndarray) -> float:
    e = points[ev_indices.astype(np.int64)]
    return float(np.linalg.norm(e[:, 0] - e[:, 1], axis=1).mean())


def center_and_scale_np(
    points: np.ndarray, ev_indices: np.ndarray, s_type: int = 0
) -> tuple[np.ndarray, np.ndarray, float]:
    """Translate to centroid and scale; returns (scaled_points, centroid, scale).

    `scale` is the multiplicative factor (1/size measure), exactly the
    quantity the reference stores and later divides by at inference
    (code/test_dual.py:63).  Four size measures, matching s_type 0..3."""
    points = np.asarray(points, dtype=np.float32)
    centroid = points.mean(axis=0, keepdims=True)
    centered = points - centroid
    if s_type == 0:  # mean edge length
        size = mean_edge_length_np(centered, ev_indices)
    elif s_type == 1:  # bounding-box diagonal
        size = float(np.linalg.norm(centered.max(0) - centered.min(0)))
    elif s_type == 2:  # max abs coordinate
        size = float(np.abs(centered).max())
    elif s_type == 3:  # furthest distance from centroid
        size = float(np.sqrt((centered**2).sum(1).max()))
    else:
        raise ValueError(f"unknown s_type {s_type}")
    scale = 1.0 / size
    return centered * scale, centroid.astype(np.float32), scale


def bilateral_edge_weights_np(
    node_pos: np.ndarray, node_normal: np.ndarray, edge_index: np.ndarray
) -> np.ndarray:
    """Per-edge bilateral affinity:
        w = clamp(n_i . n_j, min=1e-3) * exp(-||p_i - p_j||^2 / (2*mean_len))

    where mean_len is the mean edge length over *this* edge list.  When the
    list includes self-loops their zero lengths participate in the mean,
    reproducing the reference's convention (code/data_util.py:389-398:
    weights are computed after self-loop insertion).
    edge_index: (2, E)."""
    eps = 0.001
    p = node_pos[edge_index]  # (2, E, 3)
    sq_len = ((p[0] - p[1]) ** 2).sum(axis=1)
    mean_len = np.sqrt(sq_len).mean()
    n = node_normal[edge_index]
    dn = (n[0] * n[1]).sum(axis=1)
    dp = np.exp(sq_len / (-2.0 * mean_len + 1e-12))
    return (np.maximum(dn, eps) * dp).astype(np.float32)
