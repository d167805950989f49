"""The shipped model: graph U-Net branches + bi-domain cascade.

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
(ops/banded_cuda.py) or, at a level that carries `blk_idx`, the block-sparse
one (ops/blocksparse.py); levels without a band run the table or COO conv
(ops/feastconv.py, plain torch).  Called with `gp_devices` (the dp / gp
step of parallel/api.py), every conv is the COO conv over its edge list cut
across those devices, as the JAX model with `gp_axis` set.  With `fusion > 0` a DualFusionLayer
(models/fusion.py) exchanges features over the vertex<->facet incidence and
its outputs are concatenated onto both branch inputs; `compute_dtype`
bfloat16 runs the U-Nets' activations in bf16 (Config(precision=
"bfloat16")), with float32 parameters, geometry and losses.

Rematerialization, as the JAX module has it: the convs of levels without a
band (their (E, C) gathered residuals dominate device memory on big meshes)
and the fc heads (their (N, 1024) hidden) run under `_remat`, which keeps
only their inputs for the backward and recomputes the rest there; above
`fc_chunk_rows` rows a head also runs in row chunks (`head_chunks`).  The
banded and block-sparse aggregates are left out: their autograd Functions
already recompute their window intermediates in the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from geobignn_tpu_torch import geometry, params as params_mod
from geobignn_tpu_torch.ops import banded_cuda, blocksparse, feastconv, segment
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


def _remat(fn, *args):
    """fn(*args), keeping for the backward only what the call was given and
    recomputing the rest there (the JAX module's `jax.checkpoint` /
    `nn.remat`).  Without autograd recording (serving) it is a plain call.
    The model's one rematerialization switch: replace this function with a
    plain call to keep every intermediate instead."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def head_chunks(n: int, fc_chunk_rows: int) -> int:
    """Row chunks of an fc head over n rows, by the JAX module's rule
    (`run_head`): double while a chunk exceeds fc_chunk_rows rows, n stays
    divisible and there are fewer than 32 chunks."""
    n_chunks = 1
    while n // n_chunks > fc_chunk_rows and n % (2 * n_chunks) == 0 and n_chunks < 32:
        n_chunks *= 2
    return n_chunks


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

    def _params(self, dt) -> dict:
        return {"u": self.u.to(dt), "c": self.c.to(dt), "w": self.w.to(dt),
                "b": self.b.to(dt)}

    def _unbanded(self, x: torch.Tensor, level: GraphLevel) -> torch.Tensor:
        """The table conv (Config(reorder=False)) or the COO conv."""
        dt = x.dtype
        params = self._params(dt)
        if level.nbr is not None:
            out = feastconv.feast_conv_table(
                params, x, level.nbr, level.kmask, level.rev, deg=level.deg.to(dt))
        else:
            out = feastconv.feast_conv(params, x, level.edge_index, deg=level.deg.to(dt))
        return out * level.node_mask.to(dt)[:, None]

    def _edge_sharded(self, x: torch.Tensor, level: GraphLevel, devices) -> torch.Tensor:
        """The COO conv with the edge list cut over `devices` (graph parallel)."""
        dt = x.dtype
        out = feastconv.feast_conv(self._params(dt), x, level.edge_index,
                                   shard_devices=devices)
        return out * level.node_mask.to(dt)[:, None]

    def forward(self, x: torch.Tensor, level: GraphLevel, gp_devices=None) -> torch.Tensor:
        if gp_devices is not None:  # the sharded model: COO convs only, as JAX's
            return _remat(self._edge_sharded, x, level, gp_devices)
        if level.band is None:
            return _remat(self._unbanded, x, level)
        dt = x.dtype
        # u stays float32: ops/banded.factorized_softmax forms x @ u in it
        params = dict(self._params(dt), u=self.u.to(torch.promote_types(dt, torch.float32)))
        mask = level.node_mask.to(dt)[:, None]
        n1 = x.shape[0]
        n_band = level.band.shape[0] * level.band.shape[1]
        xp = F.pad(x, (0, 0, 0, n_band - n1))
        dp = F.pad(level.deg.to(torch.float32), (0, n_band - n1))
        if level.blk_idx is not None:
            out = blocksparse.feast_conv_blocksparse(
                params, xp, level.band, level.blk_idx, dp)
        elif level.jnodes is not None:
            out = banded_cuda.feast_conv_hybrid_band(
                params, xp, level.band, level.jnodes, level.jband, level.jpos, dp)
        elif level.nbr_b is not None:
            out = banded_cuda.feast_conv_hybrid(
                params, xp, level.band, level.rows_b, level.nbr_b, level.kmask_b,
                level.src_b, level.rev_b, dp)
        else:
            out = banded_cuda.feast_conv_banded_kernel(params, xp, level.band, dp)
        # restore the zero-trash invariant (bias/self terms make padded rows
        # nonzero; the trash row would otherwise grow every conv)
        return out[:n1].to(dt) * mask


def pool_features(x: torch.Tensor, steps, pool_type: str = "max") -> torch.Tensor:
    """Apply coarsening rounds as gathers over the member tables, or, when
    a step carries none, as segment reductions over its cluster map."""
    if pool_type not in ("max", "mean"):
        raise ValueError(pool_type)
    for st in steps:
        if st.members is not None:
            pool = tbl.gather_pool_max if pool_type == "max" else tbl.gather_pool_mean
            x = pool(x, st.members, st.rev, st.mmask)
        elif pool_type == "max":
            x = segment.segment_max(x, st.cluster, st.n_out)
        else:
            x = segment.segment_mean(x, st.cluster, st.n_out)
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

    def forward(self, branch: BranchGraph, x: torch.Tensor, gp_devices=None) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        l1, l2, l3 = branch.levels
        g = gp_devices
        x1 = _act(self.l_conv1(x, l1, g))
        x2 = pool_features(x1, branch.steps[0:2], self.pool_type)
        x2 = _act(self.l_conv2(x2, l2, g))
        x3 = pool_features(x2, branch.steps[2:4], self.pool_type)
        x3 = _act(self.l_conv3(x3, l3, g))
        x3 = _act(self.l_conv4(x3, l3, g))

        u2 = tbl.gather_unpool(x3, branch.unpool2, branch.unpool2_rev)
        u2 = self.r_conv1(u2, l2, g)
        x2 = torch.cat([x2, u2], dim=1)
        x2 = _act(self.r_conv2(x2, l2, g))

        u1 = tbl.gather_unpool(x2, branch.unpool1, branch.unpool1_rev)
        u1 = self.r_conv3(u1, l1, g)
        x1 = torch.cat([x1, u1], dim=1)
        return _act(self.r_conv4(x1, l1, g))


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
    does; load trained weights with `load_state_dict`.  Above
    `fc_chunk_rows` rows the fc heads run in row chunks (`head_chunks`)."""

    def __init__(self, force_depth: bool = False, pool_type: str = "max",
                 heads: int = 9, fusion: int = 0, compute_dtype=torch.float32,
                 fc_dtype=None, device=None, seed: int = 0,
                 fc_chunk_rows: int = 1 << 18):
        super().__init__()
        dev = resolve_device(device)
        self.force_depth = force_depth
        self.fc_chunk_rows = fc_chunk_rows
        fdt = fc_dtype or compute_dtype
        if fusion:
            from geobignn_tpu_torch.models.fusion import DualFusionLayer

            self.fusion = DualFusionLayer(6, 6, fusion, dev)
        self.gnn_v = GNNModule(6 + fusion, pool_type, heads, compute_dtype, dev)
        self.gnn_f = GNNModule(12 + fusion, pool_type, heads, compute_dtype, dev)
        self.fc_v1 = Dense(32, 1024, fdt, dev)
        self.fc_v2 = Dense(1024, 1 if force_depth else 3, fdt, dev)
        self.fc_f1 = Dense(32, 1024, fdt, dev)
        self.fc_f2 = Dense(1024, 3, fdt, dev)
        params_mod.init_(self, seed)

    def _run_head(self, fc1: Dense, fc2: Dense, feat: torch.Tensor) -> torch.Tensor:
        """fc2(act(fc1(feat))), rematerialized and, above fc_chunk_rows rows,
        chunk by chunk, so that the (rows, 1024) hidden exists for one chunk
        at a time; the output in float32 (float64 stays float64)."""
        def head(f):
            return fc2(_act(fc1(f)))

        n_chunks = head_chunks(feat.shape[0], self.fc_chunk_rows)
        out = torch.cat([_remat(head, f) for f in feat.chunk(n_chunks)])
        return out.to(torch.promote_types(out.dtype, torch.float32))

    def forward(self, sample: DualSample, gp_devices=None):
        """`gp_devices`: the sharded model (parallel/api.py), every conv the
        COO conv over its edge list cut across these devices."""
        xyz = sample.v.x[:, :3]
        x_v, h_f = sample.v.x, None
        if hasattr(self, "fusion"):
            h_v, h_f = self.fusion(sample.v.x, sample.f.x, sample)
            x_v = torch.cat([x_v, h_v], dim=1)
        feat_v = self.gnn_v(sample.v, x_v, gp_devices)
        d = self._run_head(self.fc_v1, self.fc_v2, feat_v)
        if self.force_depth:
            d = d * sample.v.depth_direction
        vert_p = d + xyz

        # rebuild facet features from the denoised vertices (f32), both from
        # the corners of one gather
        corners = tbl.table_gather(vert_p, sample.fv_indices, sample.fv_rev)
        face_cent = corners.mean(dim=1)
        face_norm = geometry.safe_normalize(torch.linalg.cross(
            corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0], dim=-1))
        parts_f = [sample.f.x, face_cent, face_norm] + ([h_f] if h_f is not None else [])
        x_f = torch.cat(parts_f, dim=1)

        feat_f = self.gnn_f(sample.f, x_f, gp_devices)
        n = self._run_head(self.fc_f1, self.fc_f2, feat_f)
        return vert_p, geometry.safe_normalize(n)
