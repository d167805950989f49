"""Edge-weight strategies for graph-coarsening affinity.

Counterpart of geobignn_tpu/pool/edge_weight.py: the 11 `edge_weight_type`
strategies (-1..10) of the reference's PoolingLayer
(code/net_util.py:160-240).  The shipped model uses type 10: stored
bilateral weight + exp(-||x_i - x_j||^2 / 2).  Two call sites, as there:

  * the host (numpy arrays), when the precomputed pooling hierarchies are
    built: types that depend on layer activations use the input features
    as proxy, and the learned types (3, 4, 5) degrade to the stored weight;
  * the device (torch tensors), for dynamic pooling (pool/dynamic.py),
    where every type is exact, the learned ones with `att_l`, `att_r` and
    `lin`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _exp(v):
    return torch.exp(v) if torch.is_tensor(v) else np.exp(v)


def _minmax(w, eps=1e-12):
    return (w - w.min()) / (w.max() - w.min() + eps)


def _feat_gauss(x, edge_index, param):
    d = x[edge_index[0]] - x[edge_index[1]]
    return _exp((d * d).sum(-1) / (-param))


def _gat_scores(x, edge_index, att_l, att_r):
    """Symmetrized GAT-style attention logit -> sigmoid."""
    al = (x * att_l).sum(-1)
    ar = (x * att_r).sum(-1)
    row, col = edge_index[0], edge_index[1]
    alpha = (al[row] + ar[col]) + (al[col] + ar[row])
    return 1.0 / (1.0 + _exp(-alpha))


def compute_edge_weight(
    weight_type: int,
    edge_index,
    stored_weight,
    x=None,
    wei_param: float = 2.0,
    att_l=None,
    att_r=None,
    lin=None,
):
    """Evaluate one strategy on numpy arrays or torch tensors.

    edge_index: (2, E) with NO self-loops (the reference strips them before
    weighting, code/net_util.py:163).  The learned types take att_l, att_r
    (1, C) and, for 4 and 5, `lin` (a callable: the Dense layer); without
    att_l they return the stored weight (the host's fallback)."""
    t = weight_type
    if t == -1:
        return None  # random matching
    if t == 0:
        return stored_weight
    if t == 1:
        return _feat_gauss(x, edge_index, wei_param)
    if t == 2:
        return stored_weight * _feat_gauss(x, edge_index, wei_param)
    if t in (3, 4, 5):
        if att_l is None:  # host fallback for learned types
            return stored_weight
        xx = x
        if t in (4, 5) and lin is not None:
            xx = F.leaky_relu(lin(x), 0.2)
        w = _gat_scores(xx, edge_index, att_l, att_r)
        return (w + stored_weight) / 2.0 if t == 5 else w
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
