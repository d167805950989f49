"""Synthetic analytic meshes — test fixtures and benchmark inputs.

The reference ships only dataset file lists (dataset/*/train_list.txt); the
actual CNR/Kinect meshes are external downloads.  These generators provide
meshes with analytically known normals/curvature for golden-value tests
(octahedron, icosphere) and arbitrarily large inputs for throughput
benchmarks, plus the Gaussian noise model used by the benchmark corpora
(sigma expressed as a fraction of mean edge length).
"""

from __future__ import annotations

import numpy as np

from geobignn_tpu_torch import geometry
from geobignn_tpu_torch.meshio import TriMesh


def octahedron() -> TriMesh:
    pts = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        dtype=np.float32,
    )
    fv = np.array(
        [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
         [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]],
        dtype=np.int32,
    )
    return TriMesh(pts, fv)


def icosahedron() -> TriMesh:
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
    return TriMesh(pts.astype(np.float32), fv)


def icosphere(subdivisions: int = 3, radius: float = 1.0) -> TriMesh:
    """Subdivided icosahedron projected to the sphere.
    F = 20 * 4^subdivisions (sub=5 -> 20480 faces, the reference's submesh
    scale; sub=7 -> 327680 faces for large-mesh benchmarks)."""
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
    return TriMesh((pts * radius).astype(np.float32), fv.astype(np.int32))


def grid_patch(nx: int = 16, ny: int = 16) -> TriMesh:
    """Open planar triangle grid (tests boundary/ragged incidence)."""
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    pts = np.stack([xs, ys, np.zeros_like(xs)], axis=-1).reshape(-1, 3)
    quads = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            b = (i + 1) * ny + j
            quads += [[a, b, a + 1], [b, b + 1, a + 1]]
    return TriMesh(pts.astype(np.float32), np.asarray(quads, dtype=np.int32))


def torus(n_major: int = 48, n_minor: int = 24, r_major: float = 1.0, r_minor: float = 0.35) -> TriMesh:
    """Torus — smooth genus-1 benchmark surface."""
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
    return TriMesh(pts.astype(np.float32), np.asarray(faces, np.int32))


def cube(n: int = 12) -> TriMesh:
    """Axis-aligned cube with n x n grid per side — sharp-feature (CAD-like)
    benchmark in the spirit of the CNR Synthetic corpus' Cube/Block."""
    verts: dict[tuple, int] = {}
    pts: list[tuple] = []

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
    return TriMesh(np.asarray(pts, np.float32), np.asarray(faces, np.int32))


def cylinder(n_seg: int = 48, n_height: int = 24, radius: float = 0.5, height: float = 2.0) -> TriMesh:
    """Closed cylinder — mixed smooth/sharp benchmark surface."""
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
    return TriMesh(np.asarray(pts, np.float32), np.asarray(faces, np.int32))


def ellipsoid(subdivisions: int = 4, radii=(1.0, 0.7, 0.85)) -> TriMesh:
    """Anisotropically scaled icosphere — smooth surface with varying
    curvature (campaign corpus: smooth class)."""
    m = icosphere(subdivisions)
    return TriMesh(
        (m.points * np.asarray(radii, np.float32)).astype(np.float32),
        m.fv_indices.copy(),
    )


def bumpy_sphere(
    subdivisions: int = 4, n_bumps: int = 12, amp: float = 0.15, seed: int = 0
) -> TriMesh:
    """Icosphere with a smooth radial field of random spherical Gaussian
    bumps — organic-looking surface with mixed curvature sign (campaign
    corpus: smooth/organic class, analog of the CNR corpus' blobby shapes)."""
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
    return TriMesh((p * r[:, None]).astype(np.float32), m.fv_indices.copy())


def cuboid(n: int = 24, dims=(1.0, 0.6, 1.4)) -> TriMesh:
    """Scaled cube — sharp-feature class with unequal face aspect."""
    m = cube(n)
    return TriMesh(
        (m.points * np.asarray(dims, np.float32)).astype(np.float32),
        m.fv_indices.copy(),
    )


def add_noise(
    mesh: TriMesh, sigma_ratio: float = 0.2, seed: int = 0
) -> TriMesh:
    """Gaussian vertex noise, sigma = sigma_ratio * mean edge length (the
    noise model of the CNR Synthetic corpus's _n1/_n2/_n3 levels)."""
    rng = np.random.default_rng(seed)
    mel = geometry.mean_edge_length_np(mesh.points, mesh.ev_indices)
    noisy = mesh.points + rng.normal(
        0.0, sigma_ratio * mel, size=mesh.points.shape
    ).astype(np.float32)
    return TriMesh(noisy.astype(np.float32), mesh.fv_indices.copy())
