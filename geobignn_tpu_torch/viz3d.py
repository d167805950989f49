"""Interactive 3D inspection: self-contained HTML viewer (no dependencies).

Counterpart of geobignn_tpu/viz3d.py (numpy code, kept as its own copy;
the pages written are byte-equal to the JAX package's).

The reference debugs meshes/graphs interactively with mayavi
(code/data_util.py:87-177 plot_graph/plot_mesh/plot_edge) and networkx
demos (code/plot_graph.py).  This environment has no display and no
network egress, so instead of a mayavi port this module EXPORTS a
single-file HTML viewer: vanilla-JS canvas renderer (painter's-algorithm
shaded triangles, wireframe graph overlays, per-element scalar colormaps,
mouse orbit/zoom, layer toggles).  Open the file in any browser — no
three.js, no CDN, no server.

Typical uses:
    write_html_viewer("mesh.html", points, fv_indices,
                      vertex_values=err)          # error heatmap
    write_html_viewer("pool.html", points, fv_indices,
                      graphs=[("L1", pos1, ei1), ("L2", pos2, ei2)])
                                                  # pooled-graph overlay
"""

from __future__ import annotations

import json

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>geobignn viewer</title><style>
 body{margin:0;background:#14161a;color:#ccc;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#1e2126cc;padding:8px 10px;
      border-radius:6px;line-height:1.7}
 #hud label{display:block;cursor:pointer}
 canvas{display:block}
</style></head><body>
<div id="hud"><b>geobignn_tpu viewer</b><br>drag: orbit &middot; wheel: zoom
<div id="layers"></div></div>
<canvas id="c"></canvas>
<script>
const DATA = __DATA__;
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
let W, H; function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
resize(); addEventListener("resize", ()=>{resize(); draw();});
let rx = -0.6, ry = 0.7, zoom = 0.8 * Math.min(innerWidth, innerHeight);
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
onmouseup = () => drag = null;
onmousemove = e => { if(!drag) return;
  ry += (e.clientX - drag[0]) * 0.008; rx += (e.clientY - drag[1]) * 0.008;
  drag = [e.clientX, e.clientY]; draw(); };
cv.onwheel = e => { zoom *= Math.exp(-e.deltaY * 0.001); draw(); e.preventDefault(); };
const show = {};
const layersDiv = document.getElementById("layers");
for (const g of [{name:"mesh"}].concat(DATA.graphs)) {
  show[g.name] = true;
  const l = document.createElement("label");
  const cb = document.createElement("input");
  cb.type = "checkbox"; cb.checked = true;
  cb.onchange = () => { show[g.name] = cb.checked; draw(); };
  l.appendChild(cb); l.appendChild(document.createTextNode(" " + g.name));
  layersDiv.appendChild(l);
}
function proj(p, cr, sr, cy, sy) {
  const x = p[0]*cy + p[2]*sy, z0 = -p[0]*sy + p[2]*cy;
  const y = p[1]*cr - z0*sr,  z = p[1]*sr + z0*cr;
  return [W/2 + x*zoom, H/2 - y*zoom, z];
}
function colormap(t) {  // simple jet-like
  t = Math.max(0, Math.min(1, t));
  const r = Math.min(1, Math.max(0, 1.5 - Math.abs(4*t - 3)));
  const g = Math.min(1, Math.max(0, 1.5 - Math.abs(4*t - 2)));
  const b = Math.min(1, Math.max(0, 1.5 - Math.abs(4*t - 1)));
  return [255*r|0, 255*g|0, 255*b|0];
}
function draw() {
  ctx.fillStyle = "#14161a"; ctx.fillRect(0, 0, W, H);
  const cr = Math.cos(rx), sr = Math.sin(rx), cy = Math.cos(ry), sy = Math.sin(ry);
  const P = DATA.points.map(p => proj(p, cr, sr, cy, sy));
  if (show.mesh && DATA.faces.length) {
    const tris = [];
    for (let i = 0; i < DATA.faces.length; i++) {
      const [a, b, c] = DATA.faces[i];
      const z = (P[a][2] + P[b][2] + P[c][2]) / 3;
      tris.push([z, i, a, b, c]);
    }
    tris.sort((u, v) => u[0] - v[0]);
    for (const [z, i, a, b, c] of tris) {
      const ux = P[b][0]-P[a][0], uy = P[b][1]-P[a][1];
      const vx = P[c][0]-P[a][0], vy = P[c][1]-P[a][1];
      if (ux*vy - uy*vx <= 0) continue;      // backface
      let rgb;
      if (DATA.face_vals) rgb = colormap(DATA.face_vals[i]);
      else if (DATA.vert_vals)
        rgb = colormap((DATA.vert_vals[a]+DATA.vert_vals[b]+DATA.vert_vals[c])/3);
      else { const sh = 0.55 + 0.45 * Math.max(0, Math.min(1, (z/zoom + 1)/2));
             rgb = [90*sh|0, 130*sh|0, 190*sh|0]; }
      ctx.fillStyle = `rgb(${rgb[0]},${rgb[1]},${rgb[2]})`;
      ctx.beginPath(); ctx.moveTo(P[a][0], P[a][1]);
      ctx.lineTo(P[b][0], P[b][1]); ctx.lineTo(P[c][0], P[c][1]);
      ctx.closePath(); ctx.fill();
    }
  }
  for (const g of DATA.graphs) {
    if (!show[g.name]) continue;
    const Q = g.points.map(p => proj(p, cr, sr, cy, sy));
    ctx.strokeStyle = g.color; ctx.lineWidth = 1.2; ctx.beginPath();
    for (const [a, b] of g.edges) {
      ctx.moveTo(Q[a][0], Q[a][1]); ctx.lineTo(Q[b][0], Q[b][1]);
    }
    ctx.stroke();
    ctx.fillStyle = g.color;
    for (const q of Q) ctx.fillRect(q[0]-1.5, q[1]-1.5, 3, 3);
  }
}
draw();
</script></body></html>
"""

_COLORS = ["#ffd166", "#ef6f6c", "#6ce5b1", "#7aa2ff", "#d67aff", "#9aff7a"]


def _norm_points(points: np.ndarray) -> np.ndarray:
    p = np.asarray(points, np.float64)
    c = p.mean(axis=0)
    s = np.abs(p - c).max() or 1.0
    return (p - c) / s


def _norm_vals(vals) -> list | None:
    if vals is None:
        return None
    v = np.asarray(vals, np.float64)
    lo, hi = float(v.min()), float(v.max())
    if hi - lo < 1e-12:
        return [0.5] * v.size
    return np.round((v - lo) / (hi - lo), 4).tolist()


def write_html_viewer(
    path: str,
    points: np.ndarray,
    fv_indices: np.ndarray | None = None,
    vertex_values=None,
    face_values=None,
    graphs: list[tuple] | None = None,
    max_edges: int = 60000,
) -> str:
    """Write a standalone interactive viewer.

    graphs: [(name, node_pos (M,3), edge_index (2,E))], e.g. pooled levels.
    Edge lists above `max_edges` are uniformly subsampled to keep the file
    and the canvas responsive.  Returns `path`."""
    pts = _norm_points(points)
    scale_ref = pts  # graphs are normalized with the SAME frame
    c = np.asarray(points, np.float64).mean(axis=0)
    s = np.abs(np.asarray(points, np.float64) - c).max() or 1.0

    gl = []
    for i, (name, gp, ei) in enumerate(graphs or []):
        ei = np.asarray(ei)
        und = ei[:, ei[0] < ei[1]] if ei.size else ei  # draw each edge once
        if und.shape[1] > max_edges:
            sel = np.linspace(0, und.shape[1] - 1, max_edges).astype(int)
            und = und[:, sel]
        gl.append(dict(
            name=name,
            points=np.round((np.asarray(gp, np.float64) - c) / s, 4).tolist(),
            edges=und.T.tolist(),
            color=_COLORS[i % len(_COLORS)],
        ))
    del scale_ref

    data = dict(
        points=np.round(pts, 4).tolist(),
        faces=[] if fv_indices is None else np.asarray(fv_indices).tolist(),
        vert_vals=_norm_vals(vertex_values),
        face_vals=_norm_vals(face_values),
        graphs=gl,
    )
    with open(path, "w") as f:
        f.write(_PAGE.replace("__DATA__", json.dumps(data)))
    return path


def export_pool_hierarchy(
    path: str,
    points: np.ndarray,
    fv_indices: np.ndarray,
    edge_index: np.ndarray,
    specs,
) -> str:
    """Mesh + every pooled graph level as toggleable overlays (the
    interactive counterpart of viz.plot_pool_levels / the reference's
    pooled-graph debug plots, code/net_util.py:85-122)."""
    graphs = [("graph L1", points, edge_index)]
    pos = np.asarray(points, np.float64)
    for i, sp in enumerate(specs):
        # coarse node position = mean of member fine positions
        nxt = np.zeros((sp.n_out, 3))
        cnt = np.zeros(sp.n_out)
        cl = sp.step_clusters[0]
        mid_n = sp.step_sizes[0]
        mid = np.zeros((mid_n, 3))
        mcnt = np.zeros(mid_n)
        np.add.at(mid, cl, pos)
        np.add.at(mcnt, cl, 1)
        mid /= np.maximum(mcnt, 1)[:, None]
        cl2 = sp.step_clusters[1]
        np.add.at(nxt, cl2, mid)
        np.add.at(cnt, cl2, 1)
        nxt /= np.maximum(cnt, 1)[:, None]
        graphs.append((f"graph L{i + 2}", nxt, sp.edge_index))
        pos = nxt
    return write_html_viewer(path, points, fv_indices, graphs=graphs)
