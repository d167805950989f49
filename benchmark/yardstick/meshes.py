"""Triangle meshes and the corpus generator of the benchmark's traffic.

A frozen copy of the synthetic shapes and the noise model that the port's
accuracy campaign trains on (`geobignn_tpu_torch/data/synth.py`, the
incidence builders of `geobignn_tpu_torch/meshio.py`), kept here so that a
change to the program cannot change the benchmark's inputs.  `Mesh` is the
plain container both sides start from: the program gets its own mesh type
built from the same two arrays, the reference uses this one.

`corpus(traffic, seed)` is the one generator every traffic file feeds: the
file lists base shapes (a generator name below and its keyword arguments)
and noise levels; sample (i, j) is shape i under Gaussian vertex noise of
level j, drawn from a seed made of (seed, i, j).  The seed changes the
noise only, never the shapes, so every seed gives the same face counts.
A file that fixes `noise_seed` draws sample (i, j) from noise_seed + 17 i
+ j whatever the run's seed: a corpus of one mesh, whose noise decides its
pooling hierarchy and so the step's work, stays the same mesh, and the
run's seed moves only the weights and the rotations.
"""

from __future__ import annotations

import numpy as np


class Mesh:
    """float32 points (V, 3), int32 faces (F, 3); incidence arrays built on
    first use, as the port's TriMesh builds them."""

    def __init__(self, points, fv_indices):
        self.points = np.ascontiguousarray(points, dtype=np.float32)
        self.fv_indices = np.ascontiguousarray(fv_indices, dtype=np.int32)
        self._ev = None
        self._vf = None

    @property
    def n_vertices(self) -> int:
        return int(self.points.shape[0])

    @property
    def n_faces(self) -> int:
        return int(self.fv_indices.shape[0])

    @property
    def ev_indices(self) -> np.ndarray:
        if self._ev is None:
            self._ev = build_edges(self.fv_indices)
        return self._ev

    @property
    def vf_indices(self) -> np.ndarray:
        if self._vf is None:
            fv = np.asarray(self.fv_indices, dtype=np.int64)
            face_ids = np.repeat(np.arange(fv.shape[0], dtype=np.int64), 3)
            self._vf = _ragged_from_pairs(fv.reshape(-1), face_ids, self.n_vertices)
        return self._vf


def build_edges(fv_indices: np.ndarray) -> np.ndarray:
    """(E, 2) unique undirected edges, each row sorted, rows lex-sorted."""
    fv = np.asarray(fv_indices, dtype=np.int64)
    halves = np.concatenate([fv[:, [0, 1]], fv[:, [1, 2]], fv[:, [2, 0]]], axis=0)
    lo = np.minimum(halves[:, 0], halves[:, 1])
    hi = np.maximum(halves[:, 0], halves[:, 1])
    keys = lo * (fv.max() + 1 if fv.size else 1) + hi
    _, first = np.unique(keys, return_index=True)
    edges = np.stack([lo[first], hi[first]], axis=1)
    return np.ascontiguousarray(edges, dtype=np.int32)


def _ragged_from_pairs(row, col, n_rows: int) -> np.ndarray:
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    counts = np.bincount(row, minlength=n_rows)
    max_deg = int(counts.max()) if counts.size else 0
    out = np.full((n_rows, max(max_deg, 1)), -1, dtype=np.int32)
    offsets = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    pos = np.arange(row.size) - offsets[row]
    out[row, pos] = col
    return out


def mean_edge_length(points: np.ndarray, ev_indices: np.ndarray) -> float:
    e = points[ev_indices.astype(np.int64)]
    return float(np.linalg.norm(e[:, 0] - e[:, 1], axis=1).mean())


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def icosahedron() -> Mesh:
    t = (1.0 + 5**0.5) / 2.0
    pts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
        dtype=np.float64,
    )
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    fv = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        dtype=np.int32,
    )
    return Mesh(pts.astype(np.float32), fv)


def icosphere(subdivisions: int = 3, radius: float = 1.0) -> Mesh:
    """Subdivided icosahedron on the sphere: 20 * 4^subdivisions faces."""
    mesh = icosahedron()
    pts = mesh.points.astype(np.float64)
    fv = mesh.fv_indices.astype(np.int64)
    for _ in range(subdivisions):
        e0, e1, e2 = fv[:, [0, 1]], fv[:, [1, 2]], fv[:, [2, 0]]
        edges = np.concatenate([e0, e1, e2], axis=0)
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        key = lo * pts.shape[0] + hi
        uniq, inv = np.unique(key, return_inverse=True)
        mid = pts[uniq // pts.shape[0]] + pts[uniq % pts.shape[0]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        mid_ids = pts.shape[0] + np.arange(uniq.shape[0])
        pts = np.concatenate([pts, mid], axis=0)
        m01, m12, m20 = np.split(mid_ids[inv], 3)
        fv = np.concatenate(
            [np.stack([fv[:, 0], m01, m20], 1),
             np.stack([fv[:, 1], m12, m01], 1),
             np.stack([fv[:, 2], m20, m12], 1),
             np.stack([m01, m12, m20], 1)],
            axis=0,
        )
    return Mesh((pts * radius).astype(np.float32), fv.astype(np.int32))


def torus(n_major: int = 48, n_minor: int = 24, r_major: float = 1.0,
          r_minor: float = 0.35) -> Mesh:
    i, j = np.meshgrid(np.arange(n_major), np.arange(n_minor), indexing="ij")
    u = 2 * np.pi * i / n_major
    v = 2 * np.pi * j / n_minor
    x = (r_major + r_minor * np.cos(v)) * np.cos(u)
    y = (r_major + r_minor * np.cos(v)) * np.sin(u)
    z = r_minor * np.sin(v)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    faces = []
    for a in range(n_major):
        for b in range(n_minor):
            p00 = a * n_minor + b
            p10 = ((a + 1) % n_major) * n_minor + b
            p01 = a * n_minor + (b + 1) % n_minor
            p11 = ((a + 1) % n_major) * n_minor + (b + 1) % n_minor
            faces += [[p00, p10, p11], [p00, p11, p01]]
    return Mesh(pts.astype(np.float32), np.asarray(faces, np.int32))


def cube(n: int = 12) -> Mesh:
    verts: dict = {}
    pts: list = []

    def vid(p):
        key = tuple(np.round(p, 9))
        if key not in verts:
            verts[key] = len(pts)
            pts.append(key)
        return verts[key]

    faces = []
    g = np.linspace(-1.0, 1.0, n + 1)
    for axis in range(3):
        for sign in (-1.0, 1.0):
            for i in range(n):
                for j in range(n):
                    quad = []
                    for (di, dj) in ((0, 0), (1, 0), (1, 1), (0, 1)):
                        p = [0.0, 0.0, 0.0]
                        p[axis] = sign
                        p[(axis + 1) % 3] = g[i + di]
                        p[(axis + 2) % 3] = g[j + dj]
                        quad.append(vid(p))
                    if sign > 0:
                        faces += [[quad[0], quad[1], quad[2]], [quad[0], quad[2], quad[3]]]
                    else:
                        faces += [[quad[0], quad[2], quad[1]], [quad[0], quad[3], quad[2]]]
    return Mesh(np.asarray(pts, np.float32), np.asarray(faces, np.int32))


def cylinder(n_seg: int = 48, n_height: int = 24, radius: float = 0.5,
             height: float = 2.0) -> Mesh:
    pts = []
    for k in range(n_height + 1):
        z = height * (k / n_height - 0.5)
        for s in range(n_seg):
            a = 2 * np.pi * s / n_seg
            pts.append((radius * np.cos(a), radius * np.sin(a), z))
    top = len(pts)
    pts.append((0.0, 0.0, height / 2))
    bot = len(pts)
    pts.append((0.0, 0.0, -height / 2))
    faces = []
    for k in range(n_height):
        for s in range(n_seg):
            p00 = k * n_seg + s
            p01 = k * n_seg + (s + 1) % n_seg
            p10 = (k + 1) * n_seg + s
            p11 = (k + 1) * n_seg + (s + 1) % n_seg
            faces += [[p00, p01, p11], [p00, p11, p10]]
    for s in range(n_seg):
        faces.append([top, n_height * n_seg + s, n_height * n_seg + (s + 1) % n_seg])
        faces.append([bot, (s + 1) % n_seg, s])
    return Mesh(np.asarray(pts, np.float32), np.asarray(faces, np.int32))


def ellipsoid(subdivisions: int = 4, radii=(1.0, 0.7, 0.85)) -> Mesh:
    m = icosphere(subdivisions)
    return Mesh((m.points * np.asarray(radii, np.float32)).astype(np.float32),
                m.fv_indices.copy())


def bumpy_sphere(subdivisions: int = 4, n_bumps: int = 12, amp: float = 0.15,
                 seed: int = 0) -> Mesh:
    m = icosphere(subdivisions)
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n_bumps, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    widths = rng.uniform(0.15, 0.45, n_bumps)
    signs = rng.choice([-1.0, 1.0], n_bumps)
    p = m.points / np.linalg.norm(m.points, axis=1, keepdims=True)
    r = np.ones(len(p))
    for d, w, s in zip(dirs, widths, signs):
        ang = np.arccos(np.clip(p @ d, -1, 1))
        r += s * amp * np.exp(-((ang / w) ** 2))
    return Mesh((p * r[:, None]).astype(np.float32), m.fv_indices.copy())


def cuboid(n: int = 24, dims=(1.0, 0.6, 1.4)) -> Mesh:
    m = cube(n)
    return Mesh((m.points * np.asarray(dims, np.float32)).astype(np.float32),
                m.fv_indices.copy())


def add_noise(mesh: Mesh, sigma_ratio: float, seed: int) -> Mesh:
    """Gaussian vertex noise, sigma = sigma_ratio x mean edge length."""
    rng = np.random.default_rng(seed)
    mel = mean_edge_length(mesh.points, mesh.ev_indices)
    noisy = mesh.points + rng.normal(
        0.0, sigma_ratio * mel, size=mesh.points.shape).astype(np.float32)
    return Mesh(noisy.astype(np.float32), mesh.fv_indices.copy())


SHAPES = {f.__name__: f for f in (icosphere, torus, cube, cylinder, ellipsoid,
                                    bumpy_sphere, cuboid)}


def noise_seed(seed: int, i: int, j: int) -> int:
    """The noise seed of shape i at level j under the run's seed."""
    return int(np.random.SeedSequence([int(seed), i, j]).generate_state(1, np.uint64)[0])


def corpus(traffic: dict, seed: int):
    """[(noisy Mesh, clean Mesh, name)] of a traffic file's shapes x noise
    levels, shape-major."""
    out = []
    for i, spec in enumerate(traffic["shapes"]):
        clean = SHAPES[spec["make"]](**spec.get("args", {}))
        for j, sigma in enumerate(traffic["noise_levels"]):
            ns = (traffic["noise_seed"] + 17 * i + j if "noise_seed" in traffic
                  else noise_seed(seed, i, j))
            noisy = add_noise(clean, sigma, ns)
            out.append((noisy, clean, f"{spec['name']}_n{j + 1}"))
    return out
