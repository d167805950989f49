"""Edge-weight strategies for graph-coarsening affinity (host, numpy).

Counterpart of the numpy branch of geobignn_tpu/pool/edge_weight.py: the
11 `edge_weight_type` strategies (-1..10) evaluated at data-prep time when
building the precomputed pooling hierarchies.  Types that depend on layer
activations use the input features as proxy; the learned-attention types
(3, 4, 5) degrade to the stored weight, as in the JAX host path.  The shipped
model uses type 10: stored bilateral weight + exp(-||x_i - x_j||^2 / 2).
"""

from __future__ import annotations

import numpy as np


def _minmax(w, eps=1e-12):
    return (w - w.min()) / (w.max() - w.min() + eps)


def _feat_gauss(x, edge_index, param):
    d = x[edge_index[0]] - x[edge_index[1]]
    return np.exp((d * d).sum(-1) / (-param))


def compute_edge_weight(
    weight_type: int,
    edge_index: np.ndarray,
    stored_weight: np.ndarray | None,
    x: np.ndarray | None = None,
    wei_param: float = 2.0,
):
    """Evaluate one strategy on numpy arrays.

    edge_index: (2, E) with NO self-loops (the reference strips them before
    weighting, code/net_util.py:163)."""
    t = weight_type
    if t == -1:
        return None  # random matching
    if t == 0:
        return stored_weight
    if t == 1:
        return _feat_gauss(x, edge_index, wei_param)
    if t == 2:
        return stored_weight * _feat_gauss(x, edge_index, wei_param)
    if t in (3, 4, 5):  # learned types: host fallback to the stored weight
        return stored_weight
    if t == 6:
        return _minmax(stored_weight)
    if t == 7:
        d = x[edge_index[0]] - x[edge_index[1]]
        return _minmax(-(d * d).sum(-1))
    if t == 8:
        return _minmax(_feat_gauss(x, edge_index, 2.0))
    if t == 9:
        return _minmax(stored_weight) + _minmax(_feat_gauss(x, edge_index, 2.0))
    if t == 10:  # shipped default
        return stored_weight + _feat_gauss(x, edge_index, 2.0)
    raise ValueError(f"unknown edge_weight_type {t}")
