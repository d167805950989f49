"""Dynamic (in-forward) pooling: exact parity for the activation-dependent
edge-weight strategies, the learned types 3-5 among them.

Counterpart of geobignn_tpu/pool/dynamic.py (reference PoolingLayer,
code/net_util.py:56-245): every forward weighs the edges from the layer's
activations by one of the 11 strategies (pool/edge_weight.py), coarsens by
`pool_step` rounds of the parallel matching (ops/matching.py) and coalesces
the relabelled edges (ops/coalesce.py).  Parameter names follow the flax
tree (gnn_v.pooling1.att_l, gnn_v.pooling1.lin.kernel, ...).

Every level keeps the padded level-1 node count, so the convs of levels 2
and 3 run the COO `feast_conv` over n_pad rows (several times the static
model's work there).  Level 1 takes the sample's precomputed GraphLevel, so
its convs run the banded or block-sparse aggregates.

The edge weights reach the loss only through sort keys: `att_l`, `att_r`
and `lin` get a zero gradient in JAX.  Autograd leaves their `.grad` at
None; `fill_missing_grads` gives them zeros, so that Adam's moments and
weight decay move them as optax does.
"""

from __future__ import annotations

import torch
from torch import nn

from geobignn_tpu_torch import geometry, params as params_mod
from geobignn_tpu_torch.models.dual_gnn import CONV_SCHEDULE, Dense, FeaStConv, _act
from geobignn_tpu_torch.ops import matching, segment
from geobignn_tpu_torch.ops import table as tbl
from geobignn_tpu_torch.pool import edge_weight as ew
from geobignn_tpu_torch.structs import DualSample, GraphLevel
from geobignn_tpu_torch.utils import resolve_device


def fill_missing_grads(model: nn.Module) -> None:
    """Zero gradients for the parameters the loss did not reach (jax.grad
    gives them zeros; autograd leaves None)."""
    for prm in model.parameters():
        if prm.grad is None:
            prm.grad = torch.zeros_like(prm)


def coarse_level(edge_index: torch.Tensor, n_pad: int) -> GraphLevel:
    """The GraphLevel of a coalesced edge list at n_pad slots: real in-degree
    (trash padding counted into the trash row) and an all-ones node mask,
    as the JAX module's `lvl`."""
    real = edge_index[0] != edge_index[1]
    rows = torch.where(real, edge_index[0], torch.full_like(edge_index[0], n_pad - 1))
    deg = segment.segment_count(rows, n_pad)
    return GraphLevel(
        edge_index=edge_index,
        edge_weight=edge_index.new_zeros(edge_index.shape[1], dtype=torch.float32),
        deg=deg, node_mask=deg.new_ones(n_pad))


class DynamicPooling(nn.Module):
    """One PoolingLayer application: weight strategy + pool_step matchings.
    forward returns (x_pooled, edge_index, edge_weight, unpool_map); every
    tensor keeps its padded size, nodes live at representative slots."""

    def __init__(self, in_channel: int, pool_type: str = "max", pool_step: int = 2,
                 edge_weight_type: int = 10, wei_param: float = 2.0, rounds: int = 8,
                 device=None):
        super().__init__()
        self.pool_type = pool_type
        self.pool_step = pool_step
        self.edge_weight_type = edge_weight_type
        self.wei_param = wei_param
        self.rounds = rounds
        kw = dict(dtype=torch.float32, device=device)
        if edge_weight_type in (3, 4, 5):
            self.att_l = nn.Parameter(torch.empty(1, in_channel, **kw))
            self.att_r = nn.Parameter(torch.empty(1, in_channel, **kw))
        if edge_weight_type in (4, 5):
            self.lin = Dense(in_channel, in_channel, device=device)

    def forward(self, x, edge_index, edge_weight):
        n_pad = x.shape[0]
        learned = self.edge_weight_type in (3, 4, 5)
        w = ew.compute_edge_weight(
            self.edge_weight_type, edge_index, edge_weight, x, self.wei_param,
            self.att_l if learned else None, self.att_r if learned else None,
            self.lin if self.edge_weight_type in (4, 5) else None)
        unpool = torch.arange(n_pad, device=x.device)
        for _ in range(self.pool_step):
            rep = matching.parallel_matching(edge_index, w, n_pad, self.rounds)
            x = matching.pool_with_rep(x, rep, self.pool_type)
            edge_index, w = matching.pool_edges_with_rep(edge_index, w, rep, n_pad)
            unpool = rep[unpool]
        return x, edge_index, w, unpool


class GNNModuleDynamic(nn.Module):
    """The graph U-Net with in-forward pooling.  Consumes the level-1
    GraphLevel only."""

    def __init__(self, c_in: int, pool_type: str = "max", heads: int = 9,
                 edge_weight_type: int = 10, wei_param: float = 2.0, device=None):
        super().__init__()
        for name, _, ci, co in CONV_SCHEDULE:
            setattr(self, name, FeaStConv(c_in if ci is None else ci, co, heads, device))
        self.pooling1 = DynamicPooling(32, pool_type, 2, edge_weight_type, wei_param,
                                       device=device)
        self.pooling2 = DynamicPooling(64, pool_type, 2, edge_weight_type, wei_param,
                                       device=device)

    def forward(self, x: torch.Tensor, level1: GraphLevel) -> torch.Tensor:
        n_pad = x.shape[0]
        x1 = _act(self.l_conv1(x, level1))
        x2, ei2, w2, un1 = self.pooling1(x1, level1.edge_index, level1.edge_weight)
        l2 = coarse_level(ei2, n_pad)
        x2 = _act(self.l_conv2(x2, l2))
        x3, ei3, _, un2 = self.pooling2(x2, ei2, w2)
        l3 = coarse_level(ei3, n_pad)
        x3 = _act(self.l_conv3(x3, l3))
        x3 = _act(self.l_conv4(x3, l3))

        u2 = self.r_conv1(x3[un2], l2)
        x2 = torch.cat([x2, u2], dim=1)
        x2 = _act(self.r_conv2(x2, l2))

        u1 = self.r_conv3(x2[un1], level1)
        x1 = torch.cat([x1, u1], dim=1)
        return _act(self.r_conv4(x1, level1))


class DualGNNDynamic(nn.Module):
    """DualGNN with dynamic pooling in both branches (any edge_weight_type,
    the learned 3-5 included).  Consumes a DualSample's level-1 graphs only.
    The fc heads run in float32, as the JAX module's (it takes no fc dtype).
    Parameters are created on `device` (CUDA unless device="cpu") and
    initialised from `seed` by params.init_."""

    def __init__(self, force_depth: bool = False, pool_type: str = "max", heads: int = 9,
                 edge_weight_type: int = 10, wei_param: float = 2.0, device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.force_depth = force_depth
        self.gnn_v = GNNModuleDynamic(6, pool_type, heads, edge_weight_type, wei_param, dev)
        self.gnn_f = GNNModuleDynamic(12, pool_type, heads, edge_weight_type, wei_param, dev)
        self.fc_v1 = Dense(32, 1024, device=dev)
        self.fc_v2 = Dense(1024, 1 if force_depth else 3, device=dev)
        self.fc_f1 = Dense(32, 1024, device=dev)
        self.fc_f2 = Dense(1024, 3, device=dev)
        params_mod.init_(self, seed)

    def forward(self, sample: DualSample):
        xyz = sample.v.x[:, :3]
        feat_v = self.gnn_v(sample.v.x, sample.v.levels[0])
        d = self.fc_v2(_act(self.fc_v1(feat_v)))
        if self.force_depth:
            d = d * sample.v.depth_direction
        vert_p = d + xyz

        corners = tbl.table_gather(vert_p, sample.fv_indices, sample.fv_rev)
        face_cent = corners.mean(dim=1)
        face_norm = geometry.safe_normalize(torch.linalg.cross(
            corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0], dim=-1))
        x_f = torch.cat([sample.f.x, face_cent, face_norm], dim=1)

        feat_f = self.gnn_f(x_f, sample.f.levels[0])
        n = self.fc_f2(_act(self.fc_f1(feat_f)))
        return vert_p, geometry.safe_normalize(n)
