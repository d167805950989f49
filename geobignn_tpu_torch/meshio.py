"""Host-side triangle-mesh IO and incidence-structure builders.

Counterpart of geobignn_tpu/meshio.py, copied unchanged (the port imports
nothing of the JAX package): a dependency-free .obj reader/writer plus
vectorized numpy builders for every incidence array (`fv_indices`,
`vf_indices`, `ev_indices`, `vv_indices`).  The native C++ parser
(native/meshkernel.cpp, bound in native.py) is used when built.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TriMesh:
    """A triangle mesh: float32 vertex positions and int32 face-vertex ids.

    Incidence arrays are built lazily and cached; all are int32 with -1
    padding for ragged rows (matching the reference's OpenMesh conventions,
    e.g. code/data_util.py:34 checks `fvf < 0`).
    """

    points: np.ndarray  # (V, 3) float32
    fv_indices: np.ndarray  # (F, 3) int32

    def __post_init__(self):
        self.points = np.ascontiguousarray(self.points, dtype=np.float32)
        self.fv_indices = np.ascontiguousarray(self.fv_indices, dtype=np.int32)
        self._ev = None
        self._vf = None
        self._vv = None

    @property
    def n_vertices(self) -> int:
        return int(self.points.shape[0])

    @property
    def n_faces(self) -> int:
        return int(self.fv_indices.shape[0])

    @property
    def ev_indices(self) -> np.ndarray:
        """(E, 2) unique undirected edges, each row sorted, rows lex-sorted."""
        if self._ev is None:
            self._ev = build_edges(self.fv_indices)
        return self._ev

    @property
    def vf_indices(self) -> np.ndarray:
        """(V, max_vf) faces incident to each vertex, -1 padded."""
        if self._vf is None:
            self._vf = build_vertex_face_incidence(self.fv_indices, self.n_vertices)
        return self._vf

    @property
    def vv_indices(self) -> np.ndarray:
        """(V, max_vv) 1-ring vertex neighbours of each vertex, -1 padded."""
        if self._vv is None:
            self._vv = build_vertex_vertex_incidence(self.ev_indices, self.n_vertices)
        return self._vv


def read_obj(path: str) -> TriMesh:
    """Parse a Wavefront .obj triangle mesh (v / f records only).

    Handles `f i j k`, `f i/t j/t k/t`, `f i/t/n ...` and negative (relative)
    indices.  Faces with >3 corners are fan-triangulated.  Uses the native
    C parser (native/meshkernel.cpp) when built; this Python path is the
    semantic reference and fallback.
    """
    from geobignn_tpu_torch import native

    if native.has_native():
        arrays = native.read_obj_arrays(path)
        if arrays is not None:
            return TriMesh(*arrays)
    verts: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for line in fh:
            if not line:
                continue
            c = line[0]
            if c == "v" and line[1] in " \t":
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif c == "f":
                parts = line.split()[1:]
                idx = []
                for p in parts:
                    s = p.split("/", 1)[0]
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
    points = np.asarray(verts, dtype=np.float32).reshape(-1, 3)
    fv = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    return TriMesh(points, fv)


def write_obj(path: str, points: np.ndarray, fv_indices: np.ndarray) -> None:
    """Write a triangle mesh as .obj (counterpart of om.write_mesh,
    reference: code/test_dual.py:73)."""
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    fv = np.asarray(fv_indices, dtype=np.int64).reshape(-1, 3) + 1
    with open(path, "w", encoding="utf-8") as fh:
        lines = [f"v {p[0]:.8g} {p[1]:.8g} {p[2]:.8g}" for p in points]
        lines += [f"f {f[0]} {f[1]} {f[2]}" for f in fv]
        fh.write("\n".join(lines))
        fh.write("\n")


def build_edges(fv_indices: np.ndarray) -> np.ndarray:
    """Unique undirected edge list (E, 2) from faces; rows sorted (i<j).

    Equivalent information to OpenMesh's `ev_indices()`
    (reference: code/dataset.py:201)."""
    fv = np.asarray(fv_indices, dtype=np.int64)
    halves = np.concatenate([fv[:, [0, 1]], fv[:, [1, 2]], fv[:, [2, 0]]], axis=0)
    lo = np.minimum(halves[:, 0], halves[:, 1])
    hi = np.maximum(halves[:, 0], halves[:, 1])
    keys = lo * (fv.max() + 1 if fv.size else 1) + hi
    _, first = np.unique(keys, return_index=True)
    edges = np.stack([lo[first], hi[first]], axis=1)
    return np.ascontiguousarray(edges, dtype=np.int32)


def _ragged_from_pairs(row: np.ndarray, col: np.ndarray, n_rows: int) -> np.ndarray:
    """Pack (row, col) pairs into a -1-padded (n_rows, max_deg) table.

    Column order within a row follows ascending `col` (stable sort by row)."""
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    counts = np.bincount(row, minlength=n_rows)
    max_deg = int(counts.max()) if counts.size else 0
    out = np.full((n_rows, max(max_deg, 1)), -1, dtype=np.int32)
    # position of each pair within its row
    offsets = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    pos = np.arange(row.size) - offsets[row]
    out[row, pos] = col
    return out


def build_vertex_face_incidence(fv_indices: np.ndarray, n_vertices: int) -> np.ndarray:
    """(V, max_deg) faces adjacent to each vertex, -1 padded (vf_indices)."""
    fv = np.asarray(fv_indices, dtype=np.int64)
    face_ids = np.repeat(np.arange(fv.shape[0], dtype=np.int64), 3)
    return _ragged_from_pairs(fv.reshape(-1), face_ids, n_vertices)


def build_vertex_vertex_incidence(ev_indices: np.ndarray, n_vertices: int) -> np.ndarray:
    """(V, max_deg) 1-ring neighbour vertices of each vertex, -1 padded."""
    ev = np.asarray(ev_indices, dtype=np.int64)
    row = np.concatenate([ev[:, 0], ev[:, 1]])
    col = np.concatenate([ev[:, 1], ev[:, 0]])
    return _ragged_from_pairs(row, col, n_vertices)
