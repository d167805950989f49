"""Precomputed graph-coarsening hierarchies (host, numpy).

Counterpart of geobignn_tpu/pool/hierarchy.py, copied unchanged so that the
port builds bit-identical pooling hierarchies from the same mesh: a seeded
deterministic greedy heavy-edge matching (the Graclus family) run once at
preprocessing time, shipped to the device as static index arrays.  One
`PoolLevelSpec` is one PoolingLayer application (`pool_step` greedy rounds);
`build_hierarchy` produces the two specs each GNNModule branch needs."""

from __future__ import annotations

import dataclasses

import numpy as np

from geobignn_tpu_torch.pool import edge_weight as ew


def _csr(edge_index: np.ndarray, n: int):
    """Sort (row, col, w) by row; return row_ptr plus sorted cols."""
    order = np.lexsort((edge_index[1], edge_index[0]))
    row = edge_index[0][order]
    col = edge_index[1][order]
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=ptr[1:])
    return ptr, col.astype(np.int64), order


def greedy_matching(
    edge_index: np.ndarray,
    weight: np.ndarray | None,
    n_nodes: int,
    seed: int = 0,
    visit_order: np.ndarray | None = None,
) -> np.ndarray:
    """Seeded greedy heavy-edge matching -> consecutive cluster ids (n,).

    Visits nodes in a seeded random order; an unmatched node merges with its
    heaviest unmatched neighbour (random neighbour when weight is None),
    else stays a singleton.  Same policy as graclus but deterministic under
    the seed.  Cluster ids are relabelled consecutively in order of first
    appearance by node index (the reference's `consecutive_cluster`).

    Dispatches to the C++ kernel (native/meshkernel.cpp) when built (~13x
    faster at 40k nodes).  Given the same `visit_order`, the native and
    python paths are bit-identical; when
    the order is drawn implicitly the two paths use different seeded
    shuffles, so clusterings are deterministic per path but not across
    paths."""
    from geobignn_tpu_torch import native

    ptr, col, perm = _csr(edge_index, n_nodes)
    w = None if weight is None else weight[perm]
    if visit_order is None:
        if native.has_native():
            visit_order = native.permutation(n_nodes, seed)
        else:
            visit_order = np.random.default_rng(seed).permutation(n_nodes)
    if native.has_native() and weight is not None:
        match = native.greedy_matching_csr(ptr, col, w, visit_order)
    else:
        match = _greedy_matching_py(ptr, col, w, visit_order, n_nodes, seed)
    uniq, cluster = np.unique(match, return_inverse=True)
    return cluster.astype(np.int64)


def _greedy_matching_py(ptr, col, w, order, n_nodes, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    match = np.full(n_nodes, -1, dtype=np.int64)
    for i in order:
        if match[i] >= 0:
            continue
        beg, end = ptr[i], ptr[i + 1]
        nbrs = col[beg:end]
        free = match[nbrs] < 0
        cand = nbrs[free & (nbrs != i)]
        if cand.size == 0:
            match[i] = i
            continue
        if w is None:
            j = cand[rng.integers(cand.size)]
        else:
            cw = w[beg:end][free & (nbrs != i)]
            j = cand[np.argmax(cw)]
        match[i] = match[j] = min(i, j)
    return match


def coalesce_edges_np(
    edge_index: np.ndarray, edge_attr: np.ndarray | None, n: int, op: str = "mean"
):
    """Sort + dedup a COO edge list, reducing duplicate attrs (torch_sparse
    `coalesce` semantics, reference code/net_util.py:294)."""
    keys = edge_index[0].astype(np.int64) * max(n, 1) + edge_index[1]
    uniq, inverse = np.unique(keys, return_inverse=True)
    ei = np.stack([uniq // max(n, 1), uniq % max(n, 1)]).astype(np.int32)
    if edge_attr is None:
        return ei, None
    s = np.zeros(uniq.size, dtype=np.float64)
    np.add.at(s, inverse, edge_attr)
    if op == "mean":
        c = np.bincount(inverse, minlength=uniq.size)
        s = s / np.maximum(c, 1)
    return ei, s.astype(np.float32)


def pool_graph_np(
    cluster: np.ndarray, edge_index: np.ndarray, edge_attr: np.ndarray | None
):
    """Relabel edges through the cluster map, drop self-loops, coalesce
    (mean attrs).  Mirrors pool_edge (code/net_util.py:289-295)."""
    n_out = int(cluster.max()) + 1 if cluster.size else 0
    ei = cluster[edge_index.astype(np.int64)]
    keep = ei[0] != ei[1]
    ei = ei[:, keep]
    attr = None if edge_attr is None else edge_attr[keep]
    return (*coalesce_edges_np(ei, attr, n_out), n_out)


@dataclasses.dataclass
class PoolLevelSpec:
    """One pooling layer = `pool_step` matching rounds.

    step_clusters[k] maps nodes of intermediate level k to level k+1;
    `unpool` is their composition (coarse id per finest-level node);
    (edge_index, edge_weight) describe the coarsened graph the next conv
    runs on; step_sizes[k] = node count after step k."""

    step_clusters: list[np.ndarray]
    step_sizes: list[int]
    unpool: np.ndarray
    edge_index: np.ndarray
    edge_weight: np.ndarray | None
    n_out: int
    owner_out: np.ndarray | None = None  # per-coarse-node chip id when
    # matching was partition-constrained


def build_pool_level(
    edge_index: np.ndarray,
    stored_weight: np.ndarray | None,
    x: np.ndarray | None,
    n_nodes: int,
    *,
    pool_step: int = 2,
    weight_type: int = 10,
    wei_param: float = 2.0,
    pool_type: str = "max",
    seed: int = 0,
    owner: np.ndarray | None = None,
    reorder: bool = False,
) -> PoolLevelSpec:
    """Run `pool_step` matching rounds from one graph level to the next.

    reorder=True RCM-permutes the OUTPUT node space so the coarsened graph
    is band-limited too (banded convs at every U-Net level; the finest
    level is reordered at mesh build time, data/builder.py).

    The affinity is evaluated once before the rounds (as in the reference,
    code/net_util.py:80) and carried through coalescing between rounds.

    `owner` (chip id per node) constrains matching to stay WITHIN a
    partition — coarse nodes then inherit a unique owner, which keeps the
    whole hierarchy local under halo-sharded execution (cross-partition
    edges still survive into the coarse graphs; only merges are local)."""
    w = ew.compute_edge_weight(weight_type, edge_index, stored_weight, x, wei_param)
    ei = edge_index
    clusters, sizes = [], []
    n = n_nodes
    own = owner
    for k in range(pool_step):
        if own is not None:
            keep = own[ei[0]] == own[ei[1]]
            cluster = greedy_matching(
                ei[:, keep], None if w is None else w[keep], n, seed=seed + k
            )
        else:
            cluster = greedy_matching(ei, w, n, seed=seed + k)
        clusters.append(cluster)
        if own is not None:  # representative inherits the (unique) owner
            new_own = np.zeros(int(cluster.max()) + 1, dtype=own.dtype)
            new_own[cluster] = own
            own = new_own
        ei, w, n = pool_graph_np(cluster, ei, w)
        sizes.append(n)
        if ei.shape[1] == 0:
            break
    # edgeless early exit: pad to `pool_step` rounds with identity clusters
    # so downstream consumers (builder/_pad_branch, cache serialization) see
    # a uniform step count (tiny meshes coarsen to singletons quickly)
    while len(clusters) < pool_step:
        clusters.append(np.arange(n, dtype=np.int64))
        sizes.append(n)
    if reorder and ei.shape[1] > 0:
        from geobignn_tpu_torch.ops import banded

        # slab-RCM fallback when plain RCM is over-wide (hybrid conv)
        perm, _ = banded.order_for_band(ei, n)  # new -> old
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        clusters[-1] = inv[clusters[-1]]
        ei = inv[ei.astype(np.int64)].astype(np.int32)
        if own is not None:
            own = own[perm]
    unpool = clusters[0]
    for c in clusters[1:]:
        unpool = c[unpool]
    return PoolLevelSpec(
        step_clusters=clusters,
        step_sizes=sizes,
        unpool=unpool.astype(np.int64),
        edge_index=ei.astype(np.int32),
        edge_weight=w,
        n_out=n,
        owner_out=own,
    )


def _pool_features_np(x, cluster, n_out, pool_type):
    out = np.full((n_out, x.shape[1]), -np.inf if pool_type == "max" else 0.0)
    if pool_type == "max":
        np.maximum.at(out, cluster, x)
        out[np.isneginf(out)] = 0.0
    else:
        np.add.at(out, cluster, x)
        cnt = np.bincount(cluster, minlength=n_out)
        out /= np.maximum(cnt, 1)[:, None]
    return out.astype(x.dtype)


def build_hierarchy(
    edge_index: np.ndarray,
    stored_weight: np.ndarray | None,
    x: np.ndarray | None,
    n_nodes: int,
    *,
    n_levels: int = 2,
    pool_step: int = 2,
    weight_type: int = 10,
    wei_param: float = 2.0,
    pool_type: str = "max",
    seed: int = 0,
    owner: np.ndarray | None = None,
    reorder: bool = False,
) -> list[PoolLevelSpec]:
    """The full per-branch hierarchy: `n_levels` PoolLevelSpecs (the two
    PoolingLayers of a GNNModule).  Activation-dependent weight types use
    the input features `x`, pooled along the way, as proxy (module doc).
    `owner` constrains every level's matching within partitions."""
    specs = []
    ei, w, n, xs = edge_index, stored_weight, n_nodes, x
    for lvl in range(n_levels):
        spec = build_pool_level(
            ei, w, xs, n,
            pool_step=pool_step, weight_type=weight_type, wei_param=wei_param,
            pool_type=pool_type, seed=seed + 1000 * lvl, owner=owner,
            reorder=reorder,
        )
        owner = spec.owner_out
        specs.append(spec)
        ei, w, n = spec.edge_index, spec.edge_weight, spec.n_out
        if xs is not None:
            for c, sz in zip(spec.step_clusters, spec.step_sizes):
                xs = _pool_features_np(xs, c, sz, pool_type)
    return specs
