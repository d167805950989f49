"""Legacy model family (reference code/network.py:30-250).

Counterpart of geobignn_tpu/models/legacy.py, as torch modules whose
parameter names follow the flax tree (gcn1.w, g1.kernel, l_conv1.u,
fc1.kernel, ...), so params.py moves weights across by renaming keys:
FacetAttentionGNN (GCN + global-max-pool channel attention, facet only),
GATGNN (GAT U-Net), FGCNet (FeaStConv U-Net, 9 heads, slope 0.1) and
FeaStGNNPrePool (the same at 6 heads).  All consume a BranchGraph and its
input features; the FeaStConv U-Nets run the port's FeaStConv, so a banded
level launches the banded kernels (#1-#4) and a block-sparse one #5/#6, at
these models' widths.  Their fc heads are plain float32 Dense layers, run
whole (no bf16, no row chunks, no rematerialization), as the JAX models'.

Parameters are created on `device` (CUDA by default; raises without a GPU
unless device="cpu") and initialised from `seed` as params.init_ does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from geobignn_tpu_torch import geometry, params as params_mod
from geobignn_tpu_torch.models.dual_gnn import CONV_SCHEDULE, Dense, FeaStConv, pool_features
from geobignn_tpu_torch.ops.gat import gat_conv
from geobignn_tpu_torch.ops.gcn import gcn_conv
from geobignn_tpu_torch.structs import BranchGraph
from geobignn_tpu_torch.utils import resolve_device

LEGACY_SLOPE = 0.1  # the legacy U-Nets' LeakyReLU (the shipped DualGNN's is 0.2)


def _leaky(v):
    """The legacy U-Nets' LeakyReLU, looked up at each call (as ReLU below:
    testing.same_branches holds their branches)."""
    return F.leaky_relu(v, LEGACY_SLOPE)


def _relu(v):
    return F.relu(v)


class GCNLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.w = nn.Parameter(torch.empty(c_in, c_out, **kw))
        self.b = nn.Parameter(torch.empty(c_out, **kw))

    def forward(self, x, level):
        return gcn_conv(self.w, self.b, x, level.edge_index)


class GATLayer(nn.Module):
    """Output width heads * c_out."""

    def __init__(self, c_in: int, c_out: int, heads: int = 2, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.w = nn.Parameter(torch.empty(c_in, heads, c_out, **kw))
        self.a_l = nn.Parameter(torch.empty(heads, c_out, **kw))
        self.a_r = nn.Parameter(torch.empty(heads, c_out, **kw))
        self.b = nn.Parameter(torch.empty(heads * c_out, **kw))

    def forward(self, x, level):
        return gat_conv(self.w, self.a_l, self.a_r, self.b, x, level.edge_index)


class FacetAttentionGNN(nn.Module):
    """GCN encoder + global-feature channel attention; predicts normals."""

    def __init__(self, c_in: int = 3, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.gcn1 = GCNLayer(c_in, 16, dev)
        self.gcn3 = GCNLayer(16, 32, dev)
        for name, ci, co in (("g1", 32, 64), ("g2", 64, 128), ("f1", 160, 128),
                             ("f2", 128, 32), ("d1", 32, 32), ("d2", 32, 32),
                             ("a1", 2, 32), ("a2", 32, 1)):
            setattr(self, name, Dense(ci, co, device=dev))
        self.gcn5 = GCNLayer(32, 32, dev)
        self.gcn6 = GCNLayer(32, 128, dev)
        self.fc1 = Dense(128, 32, device=dev)
        self.fc2 = Dense(32, 3, device=dev)
        params_mod.init_(self, seed)

    def forward(self, branch: BranchGraph, x: torch.Tensor) -> torch.Tensor:
        l1 = branch.levels[0]
        feat = _relu(self.gcn1(x, l1))
        feat = _relu(self.gcn3(feat, l1))
        g = _relu(self.g2(_relu(self.g1(feat))))
        # masked global max pool, broadcast back (amax splits a tie's
        # gradient among its members, as JAX's reduce_max)
        g_max = torch.where(l1.node_mask[:, None] > 0, g, g.new_full((), -torch.inf)).amax(dim=0)
        aug = torch.cat([feat, g_max.expand_as(g)], dim=1)
        aug = _relu(self.f2(_relu(self.f1(aug))))
        diff = _relu(self.d2(_relu(self.d1(feat - aug))))
        chan = torch.stack([diff.amax(dim=1), diff.mean(dim=1)], dim=1)
        aug = aug * torch.sigmoid(self.a2(_relu(self.a1(chan))))
        aug = self.gcn6(self.gcn5(aug, l1), l1)
        return geometry.safe_normalize(self.fc2(self.fc1(aug)))


class _UNetBase(nn.Module):
    """The legacy U-Net skeleton over CONV_SCHEDULE's names and levels;
    `make_conv(c_in, c_out, device)` gives a conv and `width(c_out)` its
    output width.  Unpooling is plain indexing, as the JAX models do it."""

    def __init__(self, c_in: int, device):
        super().__init__()
        for name, _, ci, co in CONV_SCHEDULE:  # widths scale by width(): 2x for GAT
            setattr(self, name, self.make_conv(c_in if ci is None else self.width(ci), co,
                                               device))
        self.out_width = self.width(CONV_SCHEDULE[-1][3])

    def width(self, c_out: int) -> int:
        return c_out

    def unet(self, branch: BranchGraph, x: torch.Tensor) -> torch.Tensor:
        l1, l2, l3 = branch.levels
        x1 = _leaky(self.l_conv1(x, l1))
        x2 = pool_features(x1, branch.steps[0:2], "max")
        x2 = _leaky(self.l_conv2(x2, l2))
        x3 = pool_features(x2, branch.steps[2:4], "max")
        x3 = _leaky(self.l_conv3(x3, l3))
        x3 = _leaky(self.l_conv4(x3, l3))
        u2 = self.r_conv1(x3[branch.unpool2], l2)
        x2 = _leaky(self.r_conv2(torch.cat([x2, u2], dim=1), l2))
        u1 = self.r_conv3(x2[branch.unpool1], l1)
        return _leaky(self.r_conv4(torch.cat([x1, u1], dim=1), l1))


class FGCNet(_UNetBase):
    """FeaStConv U-Net (9 heads, slope 0.1) -> unit normals."""

    heads = 9
    hidden = 1024

    def __init__(self, c_in: int = 6, device=None, seed: int = 0):
        dev = resolve_device(device)
        super().__init__(c_in, dev)
        self.fc1 = Dense(self.out_width, self.hidden, device=dev)
        self.fc2 = Dense(self.hidden, 3, device=dev)
        params_mod.init_(self, seed)

    def make_conv(self, c_in, c_out, device):
        return FeaStConv(c_in, c_out, self.heads, device)

    def forward(self, branch: BranchGraph, x: torch.Tensor) -> torch.Tensor:
        h = _leaky(self.fc1(self.unet(branch, x)))
        return geometry.safe_normalize(self.fc2(h))


class FeaStGNNPrePool(FGCNet):
    """6-head FeaStConv U-Net over the precomputed hierarchy."""

    heads = 6
    hidden = 512


class GATGNN(_UNetBase):
    """GAT U-Net (2 heads) -> tanh -> unit normals."""

    def __init__(self, c_in: int = 6, device=None, seed: int = 0):
        dev = resolve_device(device)
        super().__init__(c_in, dev)
        self.fc1 = Dense(self.out_width, 512, device=dev)
        self.fc2 = Dense(512, 128, device=dev)
        self.fc3 = Dense(128, 3, device=dev)
        params_mod.init_(self, seed)

    def make_conv(self, c_in, c_out, device):
        return GATLayer(c_in, c_out, 2, device)

    def width(self, c_out: int) -> int:
        return 2 * c_out

    def forward(self, branch: BranchGraph, x: torch.Tensor) -> torch.Tensor:
        h = _relu(self.fc1(self.unet(branch, x)))
        h = _relu(self.fc2(h))
        return geometry.safe_normalize(torch.tanh(self.fc3(h)))
