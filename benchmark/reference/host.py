"""The plain host build: graphs, edge weights, pooling hierarchies, RCM order.

A frozen copy, in numpy and Python, of what the port's set-up derives from
a mesh (`geobignn_tpu_torch/data/builder.build_raw`, `graphs`,
`geometry`, `pool/hierarchy`, `pool/edge_weight`, the RCM and slab orders
of `ops/banded.order_for_band`, and the splitmix64 permutation and greedy
matching of `native/meshkernel.cpp`), so that the reference works every
structure out again from the raw mesh and the program's are judged against
it.  The matching runs as a Python loop over the native library's visit
order and tie rule (the first heaviest free neighbour in CSR order, weights
compared in float32), so it gives the native path's clusters without
loading the program's library.  Patches are not split here: the
benchmark's meshes fit their configuration's `sub_size` whole.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from yardstick.meshes import Mesh, mean_edge_length

EPS_NORMALIZE = 1e-12
MAX_BAND_TILE = 384
_MASK64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def face_normals(points, fv):
    p = points[fv]
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    d = np.maximum(np.linalg.norm(n, axis=1, keepdims=True), EPS_NORMALIZE)
    return (n / d).astype(np.float32)


def vertex_normals(points, fv):
    fn = face_normals(points, fv)
    acc = np.zeros((points.shape[0], 3), dtype=np.float64)
    for c in range(3):
        np.add.at(acc, fv[:, c], fn)
    d = np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), EPS_NORMALIZE)
    return (acc / d).astype(np.float32)


def center_and_scale(points, ev):
    """(centroid (1, 3) float32, scale = 1 / mean edge length)."""
    points = np.asarray(points, dtype=np.float32)
    centroid = points.mean(axis=0, keepdims=True)
    size = mean_edge_length(points - centroid, ev)
    return centroid.astype(np.float32), 1.0 / size


def bilateral_weights(pos, normal, edge_index):
    p = pos[edge_index]
    sq_len = ((p[0] - p[1]) ** 2).sum(axis=1)
    mean_len = np.sqrt(sq_len).mean()
    n = normal[edge_index]
    dn = (n[0] * n[1]).sum(axis=1)
    dp = np.exp(sq_len / (-2.0 * mean_len + 1e-12))
    return (np.maximum(dn, 0.001) * dp).astype(np.float32)


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------

def _dedup(row, col, n):
    keys = row.astype(np.int64) * max(n, 1) + col.astype(np.int64)
    uniq = np.unique(keys)
    return np.stack([uniq // max(n, 1), uniq % max(n, 1)]).astype(np.int32)


def vertex_graph(ev, n):
    ev = np.asarray(ev, dtype=np.int64)
    return _dedup(np.concatenate([ev[:, 0], ev[:, 1]]),
                  np.concatenate([ev[:, 1], ev[:, 0]]), n)


def facet_graph(fv, vf):
    f = np.asarray(fv, dtype=np.int64)
    n = f.shape[0]
    nbr = vf[f].reshape(n, -1).astype(np.int64)
    row = np.repeat(np.arange(n, dtype=np.int64), nbr.shape[1])
    col = nbr.reshape(-1)
    valid = col >= 0
    ei = _dedup(row[valid], col[valid], n)
    return np.ascontiguousarray(ei[:, ei[0] != ei[1]])


def weighted(edge_index, n, pos, normal):
    """Bilateral weights evaluated with one self-loop per node appended (the
    reference's mean edge length), the loops' weights then dropped."""
    loops = np.arange(n, dtype=np.int32)
    ei_sl = np.concatenate([edge_index, np.stack([loops, loops])], axis=1)
    return bilateral_weights(pos, normal, ei_sl)[: edge_index.shape[1]]


# ---------------------------------------------------------------------------
# orders
# ---------------------------------------------------------------------------

def rcm_order(edge_index, n):
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    row, col = edge_index[0], edge_index[1]
    real = row != col
    g = coo_matrix((np.ones(real.sum(), np.int8), (row[real], col[real])),
                   shape=(n, n)).tocsr()
    return np.asarray(reverse_cuthill_mckee(g, symmetric_mode=True), np.int64)


def order_for_band(edge_index, n, max_tile=MAX_BAND_TILE, target_tile=256):
    """Plain RCM where its bandwidth fits max_tile, else slabs of the RCM
    order, each re-ordered by RCM and turned to face its neighbours."""
    target_tile = min(target_tile, max_tile)
    perm = rcm_order(edge_index.astype(np.int64), n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    row = inv[edge_index[0].astype(np.int64)]
    col = inv[edge_index[1].astype(np.int64)]
    real = row != col
    bw = int(np.abs(row[real] - col[real]).max()) if real.any() else 0
    if bw <= max_tile:
        return perm
    for q in (2, 4, 8, 16, 32, 64):
        cap = -(-n // q)
        owner = np.minimum(inv // cap, q - 1)
        new_perm = np.empty(n, np.int64)
        bw_intra = 0
        base = 0
        o_row, o_col = owner[edge_index[0]], owner[edge_index[1]]
        for p in range(q):
            nodes = perm[p * cap: (p + 1) * cap]
            m = nodes.size
            idx_of = np.full(n, -1, np.int64)
            idx_of[nodes] = np.arange(m)
            sel = (o_row == p) & (o_col == p) & (edge_index[0] != edge_index[1])
            sub = np.stack([idx_of[edge_index[0][sel]], idx_of[edge_index[1][sel]]])
            r = rcm_order(sub, m)
            if sub.shape[1]:
                rank = np.empty(m, np.int64)
                rank[r] = np.arange(m)
                vote = 0.0
                prev_n = idx_of[np.concatenate([
                    edge_index[0][(o_row == p) & (o_col == p - 1)],
                    edge_index[1][(o_col == p) & (o_row == p - 1)],
                ])] if p > 0 else np.empty(0, np.int64)
                next_n = idx_of[np.concatenate([
                    edge_index[0][(o_row == p) & (o_col == p + 1)],
                    edge_index[1][(o_col == p) & (o_row == p + 1)],
                ])] if p < q - 1 else np.empty(0, np.int64)
                if prev_n.size:
                    vote += rank[prev_n].mean() - (m - 1) / 2.0
                if next_n.size:
                    vote += (m - 1) / 2.0 - rank[next_n].mean()
                if vote > 0:
                    r = r[::-1]
                    rank = (m - 1) - rank
                bw_intra = max(bw_intra, int(np.abs(rank[sub[0]] - rank[sub[1]]).max()))
            new_perm[base: base + m] = nodes[r]
            base += m
        if bw_intra <= target_tile or q == 64:
            return new_perm
    return perm


# ---------------------------------------------------------------------------
# pooling hierarchy
# ---------------------------------------------------------------------------

def splitmix_permutation(n: int, seed: int) -> np.ndarray:
    """Fisher-Yates permutation of [0, n) drawn with splitmix64."""
    out = list(range(n))
    s = seed & _MASK64
    for i in range(n - 1, 0, -1):
        s = (s + 0x9E3779B97F4A7C15) & _MASK64
        z = s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
        j = z % (i + 1)
        out[i], out[j] = out[j], out[i]
    return np.asarray(out, dtype=np.int64)


def greedy_matching(edge_index, weight, n, seed):
    """Greedy heavy-edge matching in a seeded visit order -> consecutive
    cluster ids in order of each cluster's smallest member."""
    order = np.lexsort((edge_index[1], edge_index[0]))
    row = edge_index[0][order]
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=ptr[1:])
    col = edge_index[1][order].astype(np.int64).tolist()
    w = np.asarray(weight[order], dtype=np.float32).tolist()
    ptr = ptr.tolist()
    match = [-1] * n
    for i in splitmix_permutation(n, seed).tolist():
        if match[i] >= 0:
            continue
        best, best_w = -1, -1.0
        for p in range(ptr[i], ptr[i + 1]):
            j = col[p]
            if j == i or match[j] >= 0:
                continue
            if w[p] > best_w:
                best_w, best = w[p], j
        if best < 0:
            match[i] = i
            continue
        rep = min(i, best)
        match[i] = match[best] = rep
    _, cluster = np.unique(np.asarray(match, dtype=np.int64), return_inverse=True)
    return cluster.astype(np.int64)


def _coalesce_mean(edge_index, attr, n):
    keys = edge_index[0].astype(np.int64) * max(n, 1) + edge_index[1]
    uniq, inverse = np.unique(keys, return_inverse=True)
    ei = np.stack([uniq // max(n, 1), uniq % max(n, 1)]).astype(np.int32)
    s = np.zeros(uniq.size, dtype=np.float64)
    np.add.at(s, inverse, attr)
    c = np.bincount(inverse, minlength=uniq.size)
    return ei, (s / np.maximum(c, 1)).astype(np.float32)


def pool_graph(cluster, edge_index, attr):
    n_out = int(cluster.max()) + 1 if cluster.size else 0
    ei = cluster[edge_index.astype(np.int64)]
    keep = ei[0] != ei[1]
    ei, w = _coalesce_mean(ei[:, keep], attr[keep], n_out)
    return ei, w, n_out


def edge_weight(weight_type, edge_index, stored, x, wei_param):
    """The host's affinity of the shipped types (0, 1, 2, 10).  The learned
    types (3, 4, 5) score live activations inside the forward; on the host
    they take the stored weight, as the port's host build does."""
    def gauss(param):
        d = x[edge_index[0]] - x[edge_index[1]]
        return np.exp((d * d).sum(-1) / (-param))

    if weight_type in (0, 3, 4, 5):
        return stored
    if weight_type == 1:
        return gauss(wei_param)
    if weight_type == 2:
        return stored * gauss(wei_param)
    if weight_type == 10:
        return stored + gauss(2.0)
    raise ValueError(f"edge_weight_type {weight_type} has no plain host build here")


@dataclasses.dataclass
class PoolLevel:
    step_clusters: list  # fine id -> coarse id, one map per matching round
    step_sizes: list
    unpool: np.ndarray  # finest id -> coarse id of the level
    edge_index: np.ndarray  # the coarse graph
    edge_weight: np.ndarray
    n_out: int


def pool_level(edge_index, stored, x, n, *, pool_step, weight_type, wei_param,
               seed, reorder):
    w = edge_weight(weight_type, edge_index, stored, x, wei_param)
    ei, clusters, sizes = edge_index, [], []
    for k in range(pool_step):
        cluster = greedy_matching(ei, w, n, seed + k)
        clusters.append(cluster)
        ei, w, n = pool_graph(cluster, ei, w)
        sizes.append(n)
        if ei.shape[1] == 0:
            break
    while len(clusters) < pool_step:
        clusters.append(np.arange(n, dtype=np.int64))
        sizes.append(n)
    if reorder and ei.shape[1] > 0:
        perm = order_for_band(ei, n)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        clusters[-1] = inv[clusters[-1]]
        ei = inv[ei.astype(np.int64)].astype(np.int32)
    unpool = clusters[0]
    for c in clusters[1:]:
        unpool = c[unpool]
    return PoolLevel(clusters, sizes, unpool.astype(np.int64), ei.astype(np.int32), w, n)


def _pool_features(x, cluster, n_out):
    out = np.full((n_out, x.shape[1]), -np.inf)
    np.maximum.at(out, cluster, x)
    out[np.isneginf(out)] = 0.0
    return out.astype(x.dtype)


def hierarchy(edge_index, stored, x, n, bc: dict, seed: int):
    levels = []
    ei, w, xs = edge_index, stored, x
    for lvl in range(bc["n_levels"]):
        spec = pool_level(ei, w, xs, n, pool_step=bc["pool_step"],
                          weight_type=bc["edge_weight_type"], wei_param=bc["wei_param"],
                          seed=seed + 1000 * lvl, reorder=bc["reorder"])
        levels.append(spec)
        ei, w, n = spec.edge_index, spec.edge_weight, spec.n_out
        for c, sz in zip(spec.step_clusters, spec.step_sizes):
            xs = _pool_features(xs, c, sz)
    return levels


# ---------------------------------------------------------------------------
# one sample
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Branch:
    x: np.ndarray  # (n, 6) inputs: scaled positions and normals
    y: np.ndarray  # (n, 3) targets
    edge_index: np.ndarray  # (2, E), no self-loops
    edge_weight: np.ndarray
    levels: list  # two PoolLevel
    n: int


@dataclasses.dataclass
class Sample:
    v: Branch
    f: Branch
    fv: np.ndarray  # (F, 3) faces in the reordered vertex ids
    perm_v: np.ndarray | None  # new slot -> input vertex id
    perm_f: np.ndarray | None


def build(noisy: Mesh, clean: Mesh, bc: dict) -> Sample:
    """A (noisy, clean) pair's sample as the port's set-up derives it: the
    whole mesh's frame, then the RCM order, graphs and hierarchies.  `bc`
    holds the configuration's build fields (edge_weight_type, wei_param,
    pool_step, n_levels, preprocess_seed, reorder)."""
    centroid, scale = center_and_scale(noisy.points, noisy.ev_indices)
    perm_v = perm_f = None
    if bc["reorder"]:
        perm_v = order_for_band(vertex_graph(noisy.ev_indices, noisy.n_vertices),
                                noisy.n_vertices)
        inv_v = np.empty(noisy.n_vertices, np.int64)
        inv_v[perm_v] = np.arange(noisy.n_vertices)
        perm_f = order_for_band(facet_graph(noisy.fv_indices, noisy.vf_indices),
                                noisy.n_faces)
        fv_new = inv_v[noisy.fv_indices[perm_f]].astype(np.int32)
        noisy = Mesh(noisy.points[perm_v], fv_new)
        clean = Mesh(clean.points[perm_v], fv_new.copy())
    pts, fv = noisy.points, noisy.fv_indices
    vn = vertex_normals(pts, fv)
    fn = face_normals(pts, fv)
    fc = pts[fv].mean(1)

    ei_v = vertex_graph(noisy.ev_indices, noisy.n_vertices)
    w_v = weighted(ei_v, noisy.n_vertices, pts, vn)
    x_v = np.concatenate([(pts - centroid) * scale, vn], axis=1).astype(np.float32)
    y_v = ((clean.points - centroid) * scale).astype(np.float32)
    seed = bc["preprocess_seed"]
    bv = Branch(x_v, y_v, ei_v, w_v, hierarchy(ei_v, w_v, x_v, noisy.n_vertices, bc, seed),
                noisy.n_vertices)

    ei_f = facet_graph(fv, noisy.vf_indices)
    w_f = weighted(ei_f, noisy.n_faces, fc, fn)
    x_f = np.concatenate([(fc - centroid) * scale, fn], axis=1).astype(np.float32)
    y_f = face_normals(clean.points, clean.fv_indices)
    bf = Branch(x_f, y_f, ei_f, w_f, hierarchy(ei_f, w_f, x_f, noisy.n_faces, bc, seed + 7),
                noisy.n_faces)
    return Sample(bv, bf, fv, perm_v, perm_f)
