"""Offline evaluation of denoising results over a directory.

Counterpart of geobignn_tpu/infer/evaluate.py (reference
code/data_util.py:559-638 `eval_denoising_result`): for every result mesh
against its ground truth, the face-normal MSE, the angular error and the
nearest-vertex ("Hausdorff-style") distance normalized by the ground
truth's mean edge length; per-mesh rows plus count-weighted corpus totals,
printed and written to `ErrorInfo_h.txt`.

The brute-force O(N*M) nearest distance (numba-parallel in the reference,
my_hausdorff.py:17-49) is `models/losses.nearest_distance`: on the card the
hand-written kernel of ops/nn_cuda.py, one launch per result mesh; with
device="cpu" the tiled plain version.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from geobignn_tpu_torch import geometry, meshio
from geobignn_tpu_torch.models.losses import nearest_distance
from geobignn_tpu_torch.utils import resolve_device


def evaluate_result_pair(mesh_r: meshio.TriMesh, mesh_o: meshio.TriMesh,
                         device=None) -> dict:
    dev = resolve_device(device)
    nr = geometry.face_normals_np(mesh_r.points, mesh_r.fv_indices)
    no = geometry.face_normals_np(mesh_o.points, mesh_o.fv_indices)
    err_face = ((nr - no) ** 2).sum(1)
    ang = np.degrees(np.arccos(np.clip(1.0 - err_face / 2.0, -1.0, 1.0)))
    scale = geometry.mean_edge_length_np(mesh_o.points, mesh_o.ev_indices)
    dist = nearest_distance(
        torch.from_numpy(np.ascontiguousarray(mesh_r.points, np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(mesh_o.points, np.float32)).to(dev),
    ).cpu().numpy()
    return dict(
        n_faces=mesh_r.n_faces,
        n_verts=mesh_r.n_vertices,
        normal_mse=float(err_face.mean()),
        angle=float(ang.mean()),
        vertex_dist=float(dist.mean()),
        vertex_dist_norm=float(dist.mean() / scale),
    )


def eval_denoising_result(dir_result: str, dir_original: str, device=None) -> dict | None:
    """Match `{name}_*.obj` results to `{name}.obj` originals; print + write
    the per-mesh table and count-weighted corpus means."""
    resolve_device(device)
    pairs = []
    for orig in sorted(glob.glob(os.path.join(dir_original, "*.obj"))):
        name = os.path.splitext(os.path.basename(orig))[0]
        for res in sorted(glob.glob(os.path.join(dir_result, f"{name}_*.obj"))):
            pairs.append((res, orig))
    if not pairs:
        print("--- empty data ---")
        return None

    rows = []
    for res, orig in pairs:
        r = evaluate_result_pair(meshio.read_obj(res), meshio.read_obj(orig), device)
        r["name"] = os.path.basename(res)
        rows.append(r)
        print(
            f"{r['name']:<40} {r['n_faces']:>7} {r['normal_mse']:.4f} "
            f"{r['angle']:8.4f} {r['n_verts']:>7} {r['vertex_dist']:8.4f} "
            f"{r['vertex_dist_norm']:.4f}"
        )

    tf = sum(r["n_faces"] for r in rows)
    tv = sum(r["n_verts"] for r in rows)
    corpus = dict(
        n_faces=tf,
        n_verts=tv,
        normal_mse=sum(r["normal_mse"] * r["n_faces"] for r in rows) / tf,
        angle=sum(r["angle"] * r["n_faces"] for r in rows) / tf,
        vertex_dist=sum(r["vertex_dist"] * r["n_verts"] for r in rows) / tv,
        vertex_dist_norm=sum(r["vertex_dist_norm"] * r["n_verts"] for r in rows) / tv,
    )
    print(
        f"{corpus['n_faces']:>8} {corpus['normal_mse']:.4f} "
        f"{corpus['angle']:8.4f} {corpus['n_verts']:>8} "
        f"{corpus['vertex_dist']:8.4f} {corpus['vertex_dist_norm']:.4f}"
    )

    out = os.path.join(dir_result, "ErrorInfo_h.txt")
    with open(out, "w") as f:
        f.write("Error_rst:  num_f   mean   angle_mean   num_v    err_dis \n")
        f.write(
            f"         {corpus['n_faces']:>8}  {corpus['normal_mse']:.4f}  "
            f"{corpus['angle']:9.4f}  {corpus['n_verts']:>8}  "
            f"{corpus['vertex_dist']:9.6f}  {corpus['vertex_dist_norm']:.6f}\n\n"
        )
        for r in rows:
            f.write(
                f"{r['name']:<40} {r['n_faces']:>7}  {r['normal_mse']:.6f}  "
                f"{r['angle']:9.6f}  {r['n_verts']:>7}  "
                f"{r['vertex_dist']:9.6f}  {r['vertex_dist_norm']:.6f}\n"
            )
    print(f"{out} saved.")
    return dict(rows=rows, corpus=corpus)
