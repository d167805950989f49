"""The shipped model: graph U-Net branches + bi-domain cascade (forward).

Counterpart of geobignn_tpu/models/dual_gnn.py, as torch modules whose
parameter names follow the flax tree (gnn_v.l_conv1.u, fc_v1.kernel, ...),
so params.py moves weights across by renaming keys only.

  * GNNModule — FeaStConv encoder/decoder with 2 pooling layers, copy-back
    unpooling and skip concats;
  * DualGNN — the vertex branch regresses residual positions; facet
    features are rebuilt from the denoised vertices (centroids and
    cross-product normals); the facet branch regresses unit normals, with
    the `force_depth` head (out = scalar * depth_direction).

Every conv of the default configuration runs the banded aggregate
(ops/banded_cuda.py).  The dispatch branches this port does not have yet
raise NotImplementedError naming the ROADMAP item; they never quietly take
another path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from geobignn_tpu_torch import geometry, params as params_mod
from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.ops import table as tbl
from geobignn_tpu_torch.structs import BranchGraph, DualSample, GraphLevel
from geobignn_tpu_torch.utils import resolve_device

LEAKY_SLOPE = 0.2  # reference uses F.leaky_relu(x, 0.2) throughout

# (param name, level index 0/1/2, c_in, c_out) of one branch, in call order;
# c_in None = the branch input width (6 vertex, 12 facet)
CONV_SCHEDULE = (
    ("l_conv1", 0, None, 32),
    ("l_conv2", 1, 32, 64),
    ("l_conv3", 2, 64, 128),
    ("l_conv4", 2, 128, 128),
    ("r_conv1", 1, 128, 64),
    ("r_conv2", 1, 128, 64),
    ("r_conv3", 0, 64, 32),
    ("r_conv4", 0, 64, 32),
)


def _act(v):
    return F.leaky_relu(v, LEAKY_SLOPE)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to geobignn_tpu_torch yet (ROADMAP: {item})"
    )


class FeaStConv(nn.Module):
    """FeaStConv with per-head weights; dispatches on the level's structures
    like the JAX module (dual_gnn.py:80-139)."""

    def __init__(self, c_in: int, c_out: int, heads: int = 9, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.u = nn.Parameter(torch.empty(c_in, heads, **kw))
        self.c = nn.Parameter(torch.empty(heads, **kw))
        self.w = nn.Parameter(torch.empty(heads, c_in, c_out, **kw))
        self.b = nn.Parameter(torch.empty(c_out, **kw))

    def forward(self, x: torch.Tensor, level: GraphLevel) -> torch.Tensor:
        if level.band is None:
            if level.nbr is not None:
                _not_ported("the dense-table FeaStConv (feast_conv_table)",
                            "modules to port, non-band conv paths")
            _not_ported("the COO FeaStConv (feast_conv)",
                        "modules to port, non-band conv paths")
        if level.blk_idx is not None:
            _not_ported("the block-sparse FeaStConv (TPU kernels #5/#6)",
                        "TPU kernels to port, kernels #5/#6")
        if level.jnodes is None and level.nbr_b is not None:
            _not_ported("the boundary-table hybrid conv (feast_conv_hybrid)",
                        "modules to port, non-band conv paths")
        dt = x.dtype
        params = {"u": self.u.to(dt), "c": self.c.to(dt), "w": self.w.to(dt),
                  "b": self.b.to(dt)}
        n1 = x.shape[0]
        n_band = level.band.shape[0] * level.band.shape[1]
        xp = F.pad(x, (0, 0, 0, n_band - n1))
        dp = F.pad(level.deg.to(torch.float32), (0, n_band - n1))
        if level.jnodes is not None:
            out = banded_cuda.feast_conv_hybrid_band(
                params, xp, level.band, level.jnodes, level.jband, level.jpos, dp)
        else:
            out = banded_cuda.feast_conv_banded_kernel(params, xp, level.band, dp)
        out = out[:n1].to(dt)
        # restore the zero-trash invariant (bias/self terms make padded rows
        # nonzero; the trash row would otherwise grow every conv)
        return out * level.node_mask.to(out.dtype)[:, None]


def pool_features(x: torch.Tensor, steps, pool_type: str = "max") -> torch.Tensor:
    """Apply coarsening rounds as gathers over the member tables."""
    for st in steps:
        if st.members is None:
            _not_ported("segment pooling without member tables",
                        "modules to port, non-band conv paths")
        if pool_type == "max":
            x = tbl.gather_pool_max(x, st.members, st.rev, st.mmask)
        elif pool_type == "mean":
            x = tbl.gather_pool_mean(x, st.members, st.rev, st.mmask)
        else:
            raise ValueError(pool_type)
    return x


class GNNModule(nn.Module):
    """FeaStConv U-Net: 32 -> (pool) 64 -> (pool) 128 -> 128, then unpool
    with skip concatenation back to 32 output channels."""

    def __init__(self, c_in: int, pool_type: str = "max", heads: int = 9,
                 compute_dtype=torch.float32, device=None):
        super().__init__()
        self.pool_type = pool_type
        self.compute_dtype = compute_dtype
        for name, _, ci, co in CONV_SCHEDULE:
            setattr(self, name, FeaStConv(c_in if ci is None else ci, co, heads, device))

    def forward(self, branch: BranchGraph, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        l1, l2, l3 = branch.levels
        x1 = _act(self.l_conv1(x, l1))
        x2 = pool_features(x1, branch.steps[0:2], self.pool_type)
        x2 = _act(self.l_conv2(x2, l2))
        x3 = pool_features(x2, branch.steps[2:4], self.pool_type)
        x3 = _act(self.l_conv3(x3, l3))
        x3 = _act(self.l_conv4(x3, l3))

        u2 = tbl.gather_unpool(x3, branch.unpool2, branch.unpool2_rev)
        u2 = self.r_conv1(u2, l2)
        x2 = torch.cat([x2, u2], dim=1)
        x2 = _act(self.r_conv2(x2, l2))

        u1 = tbl.gather_unpool(x2, branch.unpool1, branch.unpool1_rev)
        u1 = self.r_conv3(u1, l1)
        x1 = torch.cat([x1, u1], dim=1)
        return _act(self.r_conv4(x1, l1))


class Dense(nn.Module):
    """flax `nn.Dense` layout (kernel (in, out)); with a dtype, both the
    input and the parameters are cast to it and the output stays in it."""

    def __init__(self, c_in: int, c_out: int, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.kernel = nn.Parameter(torch.empty(c_in, c_out, **kw))
        self.bias = nn.Parameter(torch.empty(c_out, **kw))
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or x.dtype
        return torch.matmul(x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)


class DualGNN(nn.Module):
    """Bi-domain cascade; forward returns (vertex_positions, face_normals).

    Parameters are created on `device` (CUDA by default; raises without a
    GPU unless device="cpu") and initialised from `seed` as params.init_
    does; load trained weights with `load_state_dict`."""

    def __init__(self, force_depth: bool = False, pool_type: str = "max",
                 heads: int = 9, fusion: int = 0, compute_dtype=torch.float32,
                 fc_dtype=None, device=None, seed: int = 0):
        super().__init__()
        if fusion:
            _not_ported("the DualFusionLayer (fusion > 0, models/fusion.py)",
                        "modules to port, the rest of the package")
        dev = resolve_device(device)
        self.force_depth = force_depth
        fdt = fc_dtype or compute_dtype
        self.gnn_v = GNNModule(6, pool_type, heads, compute_dtype, dev)
        self.gnn_f = GNNModule(12, pool_type, heads, compute_dtype, dev)
        self.fc_v1 = Dense(32, 1024, fdt, dev)
        self.fc_v2 = Dense(1024, 1 if force_depth else 3, fdt, dev)
        self.fc_f1 = Dense(32, 1024, fdt, dev)
        self.fc_f2 = Dense(1024, 3, fdt, dev)
        params_mod.init_(self, seed)

    def forward(self, sample: DualSample):
        # the fc heads run on all rows at once: rows are independent, so the
        # JAX module's row chunking above 2^18 rows changes nothing here
        xyz = sample.v.x[:, :3]
        feat_v = self.gnn_v(sample.v, sample.v.x)
        d = self.fc_v2(_act(self.fc_v1(feat_v))).to(torch.float32)
        if self.force_depth:
            d = d * sample.v.depth_direction
        vert_p = d + xyz

        # rebuild facet features from the denoised vertices (f32)
        face_cent = tbl.table_gather(vert_p, sample.fv_indices, sample.fv_rev).mean(dim=1)
        face_norm = geometry.face_normals(vert_p, sample.fv_indices)
        x_f = torch.cat([sample.f.x, face_cent, face_norm], dim=1)

        feat_f = self.gnn_f(sample.f, x_f)
        n = self.fc_f2(_act(self.fc_f1(feat_f))).to(torch.float32)
        return vert_p, geometry.safe_normalize(n)
