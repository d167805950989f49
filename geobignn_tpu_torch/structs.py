"""Graph containers with static padded shapes: numpy on the host, torch on
the device.

Counterpart of geobignn_tpu/structs.py.  The host builders fill these
dataclasses with numpy arrays laid out exactly as the JAX package's pytrees
(same trash-slot padding convention: padded edges carry row == col == trash,
padded cluster/unpool entries point at the coarse trash slot, padded faces
index the trash vertex).  `.to(device)` returns a copy whose arrays are torch
tensors on `device`: index arrays become int64, the int8 band masks stay
int8, everything else keeps its dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BranchSizes:
    """Padded sizes for one branch (vertex or facet) of the dual graph.

    n1/e1: finest level nodes/edges; m1: after pooling-layer-1 step 1;
    n2/e2: level 2; m2: after pooling-layer-2 step 1; n3/e3: level 3."""

    n1: int
    e1: int
    m1: int
    n2: int
    e2: int
    m2: int
    n3: int
    e3: int

    @staticmethod
    def plan(counts: dict, granularity: int = 128) -> "BranchSizes":
        g = granularity
        return BranchSizes(
            **{k: round_up(int(v) + 1, g) for k, v in counts.items()}
        )

    def merge(self, other: "BranchSizes") -> "BranchSizes":
        return BranchSizes(
            *[max(a, b) for a, b in zip(dataclasses.astuple(self), dataclasses.astuple(other))]
        )


@dataclasses.dataclass(frozen=True)
class SizePlan:
    v: BranchSizes
    f: BranchSizes

    def merge(self, other: "SizePlan") -> "SizePlan":
        return SizePlan(self.v.merge(other.v), self.f.merge(other.f))


def _to(value, device):
    if isinstance(value, _Struct):
        return value.to(device)
    if isinstance(value, tuple):
        return tuple(_to(v, device) for v in value)
    if isinstance(value, np.ndarray) or isinstance(value, np.generic):
        arr = np.asarray(value)
        if arr.dtype.kind in "iu" and arr.dtype != np.int8:
            arr = arr.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return value  # static ints and None


class _Struct:
    """Shared behaviour of the containers: functional update and transfer."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device):
        return dataclasses.replace(
            self,
            **{f.name: _to(getattr(self, f.name), device)
               for f in dataclasses.fields(self)},
        )


@dataclasses.dataclass(frozen=True)
class GraphLevel(_Struct):
    """One resolution level of a graph: trash-padded COO edges + per-node
    metadata.  N_pad == node_mask.shape[0]; trash slot == N_pad - 1.
    Field meanings as in geobignn_tpu/structs.GraphLevel."""

    edge_index: np.ndarray  # (2, E_pad) int32
    edge_weight: np.ndarray  # (E_pad,) f32, 0 on padding
    deg: np.ndarray  # (N_pad,) f32 — real-edge in-degree
    node_mask: np.ndarray  # (N_pad,) f32 — 1.0 on valid nodes
    nbr: np.ndarray | None = None  # (N_pad, K) neighbor table
    kmask: np.ndarray | None = None  # (N_pad, K) f32
    rev: np.ndarray | None = None  # (N_pad, R) reverse table
    band: np.ndarray | None = None  # (B, T, W) int8 window mask
    blk_idx: np.ndarray | None = None  # (B, K) block-sparse column blocks
    rows_b: np.ndarray | None = None  # boundary-table hybrid (M_b,)
    nbr_b: np.ndarray | None = None  # (M_b, K_b)
    kmask_b: np.ndarray | None = None  # (M_b, K_b) f32
    src_b: np.ndarray | None = None  # (S_b,)
    rev_b: np.ndarray | None = None  # (S_b, R_b)
    jnodes: np.ndarray | None = None  # (S,) boundary nodes, sub-RCM order
    jband: np.ndarray | None = None  # (Bs, Ts, 3Ts) int8 sub-band mask
    jpos: np.ndarray | None = None  # (n_band,) inverse of jnodes (sentinel S)


@dataclasses.dataclass(frozen=True)
class PoolStep(_Struct):
    """One coarsening round: fine-slot -> coarse-slot map, plus the optional
    member tables that make the reduction a gather."""

    cluster: np.ndarray  # (N_in_pad,); padding -> coarse trash
    n_out: int  # coarse padded size (static)
    members: np.ndarray | None = None  # (n_out, m_pad) fine slots
    mmask: np.ndarray | None = None  # (n_out, m_pad) f32
    rev: np.ndarray | None = None  # (N_in_pad, 1) position in members


@dataclasses.dataclass(frozen=True)
class BranchGraph(_Struct):
    """One full branch: features, 3 levels, 4 pooling steps, 2 unpool maps."""

    x: np.ndarray  # (N1_pad, C)
    y: np.ndarray | None  # (N1_pad, 3) target (positions / normals)
    levels: tuple
    steps: tuple
    unpool1: np.ndarray  # (N1_pad,) -> level-2 slot
    unpool2: np.ndarray  # (N2_pad,) -> level-3 slot
    depth_direction: np.ndarray | None = None  # (N1_pad, 3) Kinect depth rays
    unpool1_rev: np.ndarray | None = None  # (N2_pad, R)
    unpool2_rev: np.ndarray | None = None  # (N3_pad, R)


@dataclasses.dataclass(frozen=True)
class DualSample(_Struct):
    """A vertex-branch + facet-branch pair with the cross-domain coupling."""

    v: BranchGraph
    f: BranchGraph
    fv_indices: np.ndarray  # (Nf_pad, 3) into padded vertex slots
    edge_dual_v: np.ndarray  # (3Ff_pad,) vertex side of incidence pairs
    edge_dual_f: np.ndarray  # (3Ff_pad,) face side of incidence pairs
    centroid: np.ndarray  # (1, 3)
    scale: np.ndarray  # () f32
    fv_rev: np.ndarray | None = None  # (Nv_pad, R)


# --------------------------------------------------------------------------
# host-side padding helpers (numpy in, numpy out)
# --------------------------------------------------------------------------

def pad_rows(arr: np.ndarray, size: int, fill=0):
    out = np.full((size,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def pad_edges(edge_index: np.ndarray, e_pad: int, trash: int) -> np.ndarray:
    out = np.full((2, e_pad), trash, dtype=np.int32)
    out[:, : edge_index.shape[1]] = edge_index
    return out


def make_level(
    edge_index: np.ndarray,
    edge_weight: np.ndarray | None,
    n_valid: int,
    n_pad: int,
    e_pad: int,
) -> GraphLevel:
    assert n_valid < n_pad, f"no trash slot: {n_valid} >= {n_pad}"
    assert edge_index.shape[1] <= e_pad, "edge overflow"
    trash = n_pad - 1
    deg = np.zeros(n_pad, dtype=np.float32)
    np.add.at(deg, edge_index[0].astype(np.int64), 1.0)
    mask = np.zeros(n_pad, dtype=np.float32)
    mask[:n_valid] = 1.0
    w = np.zeros(edge_index.shape[1], np.float32) if edge_weight is None else edge_weight
    return GraphLevel(
        edge_index=pad_edges(edge_index, e_pad, trash),
        edge_weight=pad_rows(w.astype(np.float32), e_pad),
        deg=deg,
        node_mask=mask,
    )


def make_pool_step(cluster: np.ndarray, n_in_pad: int, n_out_pad: int) -> PoolStep:
    c = np.full(n_in_pad, n_out_pad - 1, dtype=np.int32)
    c[: cluster.shape[0]] = cluster
    return PoolStep(cluster=c, n_out=n_out_pad)


def make_index_map(idx: np.ndarray, n_in_pad: int, n_out_pad: int) -> np.ndarray:
    out = np.full(n_in_pad, n_out_pad - 1, dtype=np.int32)
    out[: idx.shape[0]] = idx
    return out
