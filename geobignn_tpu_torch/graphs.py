"""Host-side graph construction for the bi-domain (vertex + facet) mesh graphs.

Capability parity targets in the reference:
  * vertex graph (1-ring, undirected)      — code/dataset.py:211-213
  * vertex graph (2-ring variant)          — code/data_util.py:407-433
  * facet graph (faces sharing a vertex)   — code/data_util.py:436-456
  * vertex<->facet incidence pair lists    — code/data_util.py:459-489
  * BFS submesh patch growth               — code/data_util.py:55-84
  * submesh vertex re-indexing             — code/data_util.py:318-336

Storage convention (deliberate deviation, documented): edge lists are kept
WITHOUT self-loops — the convolution adds the self contribution implicitly
(the reference's FeaStConv strips then re-adds exactly one self-loop per
node, so the effective graph is identical).  Bilateral edge weights are
computed on the *with-self-loop* list first so the mean-edge-length
normalizer matches the reference bit-for-bit, then self-loop rows are
dropped.

All outputs are int32 / float32 numpy arrays with deterministic ordering
(lexicographic (row, col)).
"""

from __future__ import annotations

import numpy as np

from geobignn_tpu_torch import geometry


def _dedup_directed(row: np.ndarray, col: np.ndarray, n: int) -> np.ndarray:
    """Unique (row, col) pairs, lex-sorted by (row, col); returns (2, E)."""
    keys = row.astype(np.int64) * max(n, 1) + col.astype(np.int64)
    uniq = np.unique(keys)
    return np.stack([uniq // max(n, 1), uniq % max(n, 1)]).astype(np.int32)


def with_self_loops(edge_index: np.ndarray, n: int) -> np.ndarray:
    """Append one self-loop per node to a (2, E) edge list."""
    loops = np.arange(n, dtype=np.int32)
    return np.concatenate([edge_index, np.stack([loops, loops])], axis=1)


def strip_self_loops(
    edge_index: np.ndarray, edge_attr: np.ndarray | None = None
):
    keep = edge_index[0] != edge_index[1]
    ei = np.ascontiguousarray(edge_index[:, keep])
    return ei if edge_attr is None else (ei, edge_attr[keep])


def build_vertex_graph_1ring(ev_indices: np.ndarray, n_vertices: int) -> np.ndarray:
    """Shipped vertex graph: undirected 1-ring, no self-loops, (2, 2E)."""
    ev = np.asarray(ev_indices, dtype=np.int64)
    row = np.concatenate([ev[:, 0], ev[:, 1]])
    col = np.concatenate([ev[:, 1], ev[:, 0]])
    return _dedup_directed(row, col, n_vertices)


def build_vertex_graph_2ring(
    ev_indices: np.ndarray, vv_indices: np.ndarray
) -> np.ndarray:
    """2-ring vertex graph: neighbours-of-neighbours of the undirected
    1-ring (includes self-loops in the raw product; stripped here)."""
    n = vv_indices.shape[0]
    ev = np.asarray(ev_indices, dtype=np.int64)
    row1 = np.concatenate([ev[:, 0], ev[:, 1]])
    col1 = np.concatenate([ev[:, 1], ev[:, 0]])
    deg = vv_indices.shape[1]
    row = np.repeat(row1, deg)
    col = vv_indices[col1].reshape(-1).astype(np.int64)
    valid = col >= 0
    ei = _dedup_directed(row[valid], col[valid], n)
    return strip_self_loops(ei)


def build_facet_graph(fv_indices: np.ndarray, vf_indices: np.ndarray) -> np.ndarray:
    """Facet graph: faces sharing >=1 vertex, undirected, no self-loops."""
    f = np.asarray(fv_indices, dtype=np.int64)
    n_faces = f.shape[0]
    nbr = vf_indices[f].reshape(n_faces, -1).astype(np.int64)  # (F, 3*max_vf)
    row = np.repeat(np.arange(n_faces, dtype=np.int64), nbr.shape[1])
    col = nbr.reshape(-1)
    valid = col >= 0
    ei = _dedup_directed(row[valid], col[valid], n_faces)
    return strip_self_loops(ei)


def build_edge_fv(fv_indices: np.ndarray) -> np.ndarray:
    """(2, 3F) face->vertex incidence pairs (face_i, vertex_j) per corner."""
    f = np.asarray(fv_indices, dtype=np.int32)
    rows = np.repeat(np.arange(f.shape[0], dtype=np.int32), 3)
    return np.stack([rows, f.reshape(-1)])


def build_edge_vf(vf_indices: np.ndarray) -> np.ndarray:
    """(2, K) vertex->face incidence pairs (vertex_i, face_j), -1s dropped."""
    vf = np.asarray(vf_indices, dtype=np.int32)
    rows = np.repeat(np.arange(vf.shape[0], dtype=np.int32), vf.shape[1])
    cols = vf.reshape(-1)
    valid = cols >= 0
    return np.stack([rows[valid], cols[valid]])


def weighted_graph(
    edge_index: np.ndarray,
    n_nodes: int,
    node_pos: np.ndarray,
    node_normal: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Attach bilateral weights to a self-loop-free edge list.

    Weights are evaluated on the with-self-loop list (reference convention —
    the zero-length loop edges bias the mean edge length) and the loop rows
    are then dropped; see module docstring."""
    ei_sl = with_self_loops(edge_index, n_nodes)
    w = geometry.bilateral_edge_weights_np(node_pos, node_normal, ei_sl)
    e = edge_index.shape[1]
    return edge_index, w[:e]


# --------------------------------------------------------------------------
# submesh partitioning (the reference's big-mesh scaling seam)
# --------------------------------------------------------------------------

def grow_patch(
    fv_indices: np.ndarray,
    vf_indices: np.ndarray,
    seed_face: int,
    max_faces: int | None = None,
    max_rings: int | None = None,
) -> np.ndarray:
    """BFS ring-growth of a face patch from a seed face.

    Ring-synchronous frontier expansion over the faces-sharing-a-vertex
    adjacency; stops when `max_faces` is reached (possibly mid-ring) or the
    frontier empties or `max_rings` rings were grown.  Vectorized per ring
    (the reference walks scalar Python loops).  Returns face ids in
    visit order."""
    assert max_faces is not None or max_rings is not None
    from geobignn_tpu_torch import native

    if native.has_native():
        return native.grow_patch(
            fv_indices, vf_indices, int(seed_face), max_faces, max_rings
        )
    n_faces = fv_indices.shape[0]
    cap = n_faces if max_faces is None else min(max_faces, n_faces)
    rings = np.inf if max_rings is None else max_rings

    visited = np.zeros(n_faces, dtype=bool)
    visited[seed_face] = True
    selected = [np.array([seed_face], dtype=np.int64)]
    count = 1
    frontier = selected[0]
    ring = 0
    while count < cap and frontier.size and ring < rings:
        nbr = vf_indices[fv_indices[frontier].reshape(-1)].reshape(-1).astype(np.int64)
        nbr = nbr[nbr >= 0]
        # first-occurrence order within the ring, then drop already-visited
        first = np.sort(np.unique(nbr, return_index=True)[1])
        nbr = nbr[first]
        nbr = nbr[~visited[nbr]]
        if nbr.size > cap - count:
            nbr = nbr[: cap - count]
        visited[nbr] = True
        selected.append(nbr)
        count += nbr.size
        frontier = nbr
        ring += 1
    return np.concatenate(selected).astype(np.int64)


def extract_submesh(
    fv_indices: np.ndarray, select_faces: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Re-index a face subset into a standalone mesh.

    Returns (V_idx, F): V_idx maps new vertex id -> original vertex id (in
    first-occurrence order over the selected faces' corners — the map used
    for overlap scatter-back at inference), F is the re-labelled (S, 3)
    face array."""
    corners = np.asarray(fv_indices, dtype=np.int64)[select_faces].reshape(-1)
    _, first_idx, inverse = np.unique(corners, return_index=True, return_inverse=True)
    # re-rank unique ids by first occurrence so V_idx is in visit order
    order = np.argsort(np.argsort(first_idx))
    new_ids = order[inverse]
    v_idx = corners[np.sort(first_idx)]
    return v_idx.astype(np.int64), new_ids.reshape(-1, 3).astype(np.int32)
