"""DualFusionLayer: symmetric cross-domain feature exchange.

Counterpart of geobignn_tpu/models/fusion.py (reference
code/net_util.py:248-278, preserved there as the opt-in
`Config.fusion_features`).  Each side averages the other domain's features
over the vertex<->facet incidence pairs (`sample.edge_dual_v` /
`edge_dual_f`), concatenates, and mixes through two flax-layout Dense layers
with LeakyReLU 0.2 (parameters fusion.lin_{v,f}{1,2}.{kernel,bias}).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from geobignn_tpu_torch.ops import segment
from geobignn_tpu_torch.structs import DualSample


def _mean_by(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """segment_mean over ids in any order, summed after a stable sort by id,
    so without atomics: the same bits on every run, eager or graphed."""
    order = torch.argsort(ids, stable=True)
    return segment.segment_mean(data[order], ids[order], n, sorted=True)


class DualFusionLayer(nn.Module):
    def __init__(self, c_v: int, c_f: int, features: int, device=None):
        super().__init__()
        from geobignn_tpu_torch.models.dual_gnn import Dense

        self.lin_v1 = Dense(c_v + c_f, features, device=device)
        self.lin_v2 = Dense(features, features, device=device)
        self.lin_f1 = Dense(c_f + c_v, features, device=device)
        self.lin_f2 = Dense(features, features, device=device)

    def forward(self, x_v: torch.Tensor, x_f: torch.Tensor, sample: DualSample):
        n_v, n_f = x_v.shape[0], x_f.shape[0]
        ev, ef = sample.edge_dual_v, sample.edge_dual_f
        from_f = _mean_by(x_f[ef], ev, n_v)  # incident faces' mean
        from_v = _mean_by(x_v[ev], ef, n_f)  # corner vertices' mean

        def act(v):
            return F.leaky_relu(v, 0.2)

        h_v = act(self.lin_v2(act(self.lin_v1(torch.cat([x_v, from_f], dim=1)))))
        h_f = act(self.lin_f2(act(self.lin_f1(torch.cat([x_f, from_v], dim=1)))))
        return h_v, h_f
