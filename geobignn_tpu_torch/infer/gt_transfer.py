"""Kinect_Fusion ground-truth normal transfer / visualization.

Counterpart of geobignn_tpu/infer/gt_transfer.py (numpy code, kept as its
own copy; the files written are byte-equal to the JAX package's), after
`process_GT_Kinect_Fusion` (reference code/dataset.py:279-336) — for each
(noisy, original, filtered) triple, write three face-colored meshes: noisy
normals, 2-ring-matched GT normals
(the transferred ground truth), and original normals.  Colors encode
(n+1)/2 as RGB; output is .off with face colors (viewable anywhere).

The 2-ring GT match is vectorized: for every face, among its 2-ring
neighbourhood in the ORIGINAL mesh, pick the GT normal closest to the
filtered mesh's normal.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from geobignn_tpu_torch import geometry, graphs, meshio


def _write_normal_colors(path, mesh, normals):
    rgb = (normals + 1.0) / 2.0
    p = np.asarray(mesh.points)
    f = np.asarray(mesh.fv_indices)
    with open(path, "w") as fh:
        fh.write("OFF\n")
        fh.write(f"{len(p)} {len(f)} 0\n")
        for q in p:
            fh.write(f"{q[0]:.8g} {q[1]:.8g} {q[2]:.8g}\n")
        for face, c in zip(f, rgb):
            fh.write(
                f"3 {face[0]} {face[1]} {face[2]} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f} 1.0\n"
            )
    return path


def match_gt_normals_2ring(
    mesh_n: meshio.TriMesh, gt_normals: np.ndarray, filtered_normals: np.ndarray
) -> np.ndarray:
    """For each face, the GT normal from its 2-ring minimizing the squared
    distance to the filtered normal."""
    # 2-ring face adjacency = square of the 1-ring facet graph
    ei = graphs.build_facet_graph(mesh_n.fv_indices, mesh_n.vf_indices)
    n_f = mesh_n.n_faces
    # build ragged 1-ring lists, then expand to 2-ring per face
    order = np.argsort(ei[0], kind="stable")
    rows, cols = ei[0][order].astype(np.int64), ei[1][order].astype(np.int64)
    ptr = np.zeros(n_f + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n_f), out=ptr[1:])

    # vectorized 2-ring argmin: candidate pairs are (i, i), the 1-ring
    # edges (i, j), and their expansion (i, k) for k in N(j) — duplicates
    # are harmless under argmin.  One lexsort replaces the per-face loop
    # (scale-hostile at >100k faces).
    deg = ptr[1:] - ptr[:-1]
    d_c = deg[cols]
    i2 = np.repeat(rows, d_c)
    starts = np.repeat(ptr[cols], d_c)
    offs = np.arange(int(d_c.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(d_c) - d_c, d_c
    )
    k2 = cols[starts + offs]
    self_idx = np.arange(n_f, dtype=np.int64)
    cand_i = np.concatenate([self_idx, rows, i2])
    cand_k = np.concatenate([self_idx, cols, k2])

    dist = ((gt_normals[cand_k] - filtered_normals[cand_i]) ** 2).sum(1)
    order = np.lexsort((dist, cand_i))
    i_sorted = cand_i[order]
    first = np.ones(i_sorted.size, bool)
    first[1:] = i_sorted[1:] != i_sorted[:-1]
    best = filtered_normals.copy()
    best[i_sorted[first]] = gt_normals[cand_k[order][first]]
    return best


def process_gt_transfer(noisy_dir: str, original_dir: str, filtered_dir: str) -> list:
    """Produce the three color-coded .off files per triple, mirroring the
    reference's GT_file outputs (-color_n / -color_f / -color_o)."""
    result_dir = os.path.join(filtered_dir, "GT_file")
    os.makedirs(result_dir, exist_ok=True)
    outputs = []
    for orig in sorted(glob.glob(os.path.join(original_dir, "*.obj"))):
        name = os.path.splitext(os.path.basename(orig))[0]
        noisy_files = sorted(glob.glob(os.path.join(noisy_dir, f"{name}*.obj")))
        filt_files = sorted(glob.glob(os.path.join(filtered_dir, f"{name}*.obj")))
        for noisy, filt in zip(noisy_files, filt_files):
            mesh_n = meshio.read_obj(noisy)
            mesh_o = meshio.read_obj(orig)
            mesh_f = meshio.read_obj(filt)
            n1 = geometry.face_normals_np(mesh_n.points, mesh_n.fv_indices)
            n2 = geometry.face_normals_np(mesh_o.points, mesh_o.fv_indices)
            n3 = geometry.face_normals_np(mesh_f.points, mesh_f.fv_indices)
            base = os.path.splitext(os.path.basename(noisy))[0]
            outputs.append(
                _write_normal_colors(
                    os.path.join(result_dir, f"{base}-color_n.off"), mesh_f, n1
                )
            )
            matched = match_gt_normals_2ring(mesh_n, n2, n3)
            outputs.append(
                _write_normal_colors(
                    os.path.join(result_dir, f"{base}-color_f.off"), mesh_f, matched
                )
            )
            outputs.append(
                _write_normal_colors(
                    os.path.join(result_dir, f"{base}-color_o.off"), mesh_f, n2
                )
            )
    return outputs
