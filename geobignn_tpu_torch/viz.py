"""Visualization utilities (headless-friendly).

Counterpart of geobignn_tpu/viz.py (the reference's mayavi/networkx debug
plotting, code/data_util.py:87-177, code/plot_graph.py, and its
colored-error mesh exporters, `normal_error_obj`, code/data_util.py:
682-718): matplotlib (Agg, imported when first used) for graph and mesh
snapshots, plus .off exporters with vertex/face colors.  numpy code, kept
as its own copy; the files written are byte-equal to the JAX package's.
The exporters' default colormap, matplotlib's "jet", is computed here in
numpy as matplotlib computes it (`colormap`), so the .off files need no
matplotlib; another colormap name is matplotlib's.
`hausdorff_heatmap` runs the nearest-distance search on `device` (CUDA
unless device="cpu"): on the card that is the hand-written kernel of
ops/nn_cuda.py.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# matplotlib's "jet" segments (matplotlib/_cm.py) and its lookup size
_JET = {"red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
        "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
                  (1.0, 0, 0)),
        "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0))}
_LUT_N = 256


def _segment_lut(data, n: int = _LUT_N) -> np.ndarray:
    """matplotlib.colors._create_lookup_table(n, data) at gamma 1."""
    a = np.array(data, dtype=float)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _jet(values) -> np.ndarray:
    """matplotlib's cm.jet(values) for float values: (..., 4) RGBA rows of
    its 256-entry lookup, below 0 the first, from 1 the last, NaN (0, 0, 0, 0)."""
    lut = np.ones((_LUT_N, 4))
    for i, c in enumerate(("red", "green", "blue")):
        lut[:, i] = _segment_lut(_JET[c])
    xa = np.array(values, dtype=float) * _LUT_N
    xa[xa == _LUT_N] = _LUT_N - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = np.clip(xa, -1, _LUT_N).astype(int)
    rgba = lut[np.clip(idx, 0, _LUT_N - 1)]
    rgba[bad] = 0.0
    return rgba


def colormap(name: str):
    """The colormap the .off exporters color by: "jet" here, any other name
    matplotlib's."""
    if name == "jet":
        return _jet
    import matplotlib.cm as cm

    return getattr(cm, name) if hasattr(cm, name) else cm.get_cmap(name)


def plot_graph(node_pos, edge_index, edge_values=None, path="graph.png"):
    """3D scatter + line-segment plot of a graph; saves a PNG."""
    plt = _mpl()
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    p = np.asarray(node_pos)
    e = np.asarray(edge_index)
    if e.shape[0] == 2:
        e = e.T
    segs = p[e]  # (E, 2, 3)
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    colors = None
    if edge_values is not None:
        v = np.asarray(edge_values, dtype=float)
        v = (v - v.min()) / max(v.max() - v.min(), 1e-12)
        colors = plt.cm.viridis(v)
    ax.add_collection3d(Line3DCollection(segs, colors=colors, linewidths=0.5))
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=2, c="k")
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_mesh(points, fv_indices, path="mesh.png"):
    plt = _mpl()
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    p = np.asarray(points)
    ax.plot_trisurf(
        p[:, 0], p[:, 1], p[:, 2], triangles=np.asarray(fv_indices),
        linewidth=0.1, edgecolor="gray", alpha=0.9,
    )
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def write_off_face_colors(path, points, fv_indices, face_values, cmap="jet"):
    """Export a mesh with per-face scalar colors as .off (error heatmaps —
    the reference's normal_error_obj capability)."""
    v = np.asarray(face_values, dtype=float)
    v = (v - v.min()) / max(v.max() - v.min(), 1e-12)
    rgba = colormap(cmap)(v)
    p = np.asarray(points)
    f = np.asarray(fv_indices)
    with open(path, "w") as fh:
        fh.write("OFF\n")
        fh.write(f"{len(p)} {len(f)} 0\n")
        for q in p:
            fh.write(f"{q[0]:.8g} {q[1]:.8g} {q[2]:.8g}\n")
        for face, c in zip(f, rgba):
            fh.write(
                f"3 {face[0]} {face[1]} {face[2]} "
                f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f} {c[3]:.4f}\n"
            )
    return path


def write_off_vertex_colors(path, points, fv_indices, vertex_values, cmap="jet",
                            clip_val=None):
    """Export a mesh with per-vertex scalar colors as .off (the reference's
    `point_to_mesh_obj` capability, code/data_util.py:641-679: vertices of
    the result mesh colored by a distance field, jet colormap, values
    clipped to `clip_val` before normalization)."""
    v = np.asarray(vertex_values, dtype=float)
    if clip_val is not None:
        v = np.clip(v, 0.0, clip_val)
        v = v / max(clip_val, 1e-12)
    else:
        v = (v - v.min()) / max(v.max() - v.min(), 1e-12)
    rgba = colormap(cmap)(v)
    p = np.asarray(points)
    f = np.asarray(fv_indices)
    with open(path, "w") as fh:
        fh.write("COFF\n")
        fh.write(f"{len(p)} {len(f)} 0\n")
        for q, c in zip(p, rgba):
            fh.write(
                f"{q[0]:.8g} {q[1]:.8g} {q[2]:.8g} "
                f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f} {c[3]:.4f}\n"
            )
        for face in f:
            fh.write(f"3 {face[0]} {face[1]} {face[2]}\n")
    return path


def hausdorff_heatmap(path, mesh_result, mesh_original, clip_frac=0.8, device=None):
    """Color each vertex of the result mesh by its nearest distance to the
    original mesh's vertices (reference point_to_mesh_obj semantics: jet
    colormap, clip at clip_frac * max distance, code/data_util.py:661-664).
    The distances are computed in float32 on `device`."""
    import torch

    from geobignn_tpu_torch.models.losses import nearest_distance
    from geobignn_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    a, b = (torch.as_tensor(np.asarray(m.points, np.float32), device=dev)
            for m in (mesh_result, mesh_original))
    d = nearest_distance(a, b).cpu().numpy()
    clip_val = float(d.max()) * clip_frac
    return write_off_vertex_colors(
        path, mesh_result.points, mesh_result.fv_indices, d, clip_val=clip_val
    )


def normal_error_heatmap(path, mesh_result, mesh_original):
    """Color each face of the result by its angular normal error (deg)."""
    from geobignn_tpu_torch import geometry

    nr = geometry.face_normals_np(mesh_result.points, mesh_result.fv_indices)
    no = geometry.face_normals_np(mesh_original.points, mesh_original.fv_indices)
    err = ((nr - no) ** 2).sum(1)
    ang = np.degrees(np.arccos(np.clip(1 - err / 2, -1, 1)))
    return write_off_face_colors(path, mesh_result.points, mesh_result.fv_indices, ang)


def plot_pool_levels(pos, edge_index, specs, path_prefix="pool"):
    """Snapshot every pooling level of a hierarchy: level-0 graph plus each
    coarsened graph at segment-mean pooled positions.

    Capability parity: the reference's pooled-graph debug hooks
    (GNNModule.forward(plot_pool=), code/network.py:274-284, and
    PoolingLayer.forward(visual=), code/net_util.py:85-122) which plot or
    dump the coarsened mesh after each graclus round.  Returns the list of
    written paths."""
    paths = [f"{path_prefix}_l0.png"]
    plot_graph(pos, edge_index, path=paths[0])
    cur = np.asarray(pos, np.float64)
    for i, spec in enumerate(specs, start=1):
        nxt = np.zeros((spec.n_out, cur.shape[1]))
        cnt = np.zeros(spec.n_out)
        np.add.at(nxt, spec.unpool, cur)
        np.add.at(cnt, spec.unpool, 1.0)
        cur = nxt / np.maximum(cnt, 1.0)[:, None]
        p = f"{path_prefix}_l{i}.png"
        plot_graph(cur, spec.edge_index, path=p)
        paths.append(p)
    return paths
