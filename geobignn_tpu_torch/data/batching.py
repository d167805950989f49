"""Disjoint-union graph batching, on the host.

Counterpart of geobignn_tpu/data/batching.py (numpy in, numpy out; the
arrays are bit-equal to the JAX package's): B padded samples of one
SizePlan merge into ONE sample whose node arrays are concatenations and
whose index arrays are offset by their sample's slot base — a single graph
with B connected components, which the model runs unchanged at B times the
size.  Each component keeps its own trash slot; `batch_ids` names the
owning sample of every node slot.  The union carries no tables or bands:
`builder.attach_tables` / `attach_band` add them afterwards, over the union.
"""

from __future__ import annotations

import numpy as np

from geobignn_tpu_torch.structs import BranchGraph, DualSample, GraphLevel, PoolStep


def _cat(arrs):
    return np.concatenate([np.asarray(a) for a in arrs], axis=0)


def _offset(arrs, step: int, axis: int = -1) -> np.ndarray:
    """The index arrays of the samples, each shifted by its sample's base,
    concatenated along axis (edge lists (2, E) along their edges)."""
    return np.concatenate(
        [np.asarray(a) + k * step for k, a in enumerate(arrs)], axis=axis).astype(np.int32)


def _union_levels(levels: list[GraphLevel]) -> GraphLevel:
    n_pad = np.asarray(levels[0].node_mask).shape[0]
    return GraphLevel(
        edge_index=_offset([lvl.edge_index for lvl in levels], n_pad),
        edge_weight=_cat([lvl.edge_weight for lvl in levels]),
        deg=_cat([lvl.deg for lvl in levels]),
        node_mask=_cat([lvl.node_mask for lvl in levels]),
    )


def _union_steps(steps: list[PoolStep]) -> PoolStep:
    n_out = steps[0].n_out
    return PoolStep(cluster=_offset([s.cluster for s in steps], n_out),
                    n_out=n_out * len(steps))


def _union_branch(branches: list[BranchGraph]) -> BranchGraph:
    b0 = branches[0]
    n2 = np.asarray(b0.levels[1].node_mask).shape[0]
    n3 = np.asarray(b0.levels[2].node_mask).shape[0]
    return BranchGraph(
        x=_cat([b.x for b in branches]),
        y=None if b0.y is None else _cat([b.y for b in branches]),
        levels=tuple(_union_levels([b.levels[i] for b in branches]) for i in range(3)),
        steps=tuple(_union_steps([b.steps[i] for b in branches]) for i in range(4)),
        unpool1=_offset([b.unpool1 for b in branches], n2),
        unpool2=_offset([b.unpool2 for b in branches], n3),
        depth_direction=(None if b0.depth_direction is None
                         else _cat([b.depth_direction for b in branches])),
    )


def union_batch(samples: list[DualSample]) -> DualSample:
    """Merge same-SizePlan samples (numpy, as the builders make them) into
    one disjoint-union DualSample."""
    s0 = samples[0]
    nv = np.asarray(s0.v.x).shape[0]
    nf = np.asarray(s0.f.x).shape[0]
    return DualSample(
        v=_union_branch([s.v for s in samples]),
        f=_union_branch([s.f for s in samples]),
        fv_indices=_offset([s.fv_indices for s in samples], nv, axis=0),
        edge_dual_v=_offset([s.edge_dual_v for s in samples], nv),
        edge_dual_f=_offset([s.edge_dual_f for s in samples], nf),
        centroid=np.stack([np.asarray(s.centroid).reshape(3) for s in samples]),
        scale=np.stack([np.asarray(s.scale) for s in samples]),
    )


def batch_ids(n_samples: int, n_pad: int) -> np.ndarray:
    """(n_samples * n_pad,) owning-sample id per node slot."""
    return np.repeat(np.arange(n_samples, dtype=np.int32), n_pad)
