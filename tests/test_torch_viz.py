"""The host tools — viz.py, infer/gt_transfer.py and viz3d.py — against
the JAX package on the CPU.

Both packages write the same file from the same inputs; the .off and .html
files must be byte-equal, the .png files written (matplotlib's renderings
are not compared).  The cases are those of tests/test_utils.py
(test_gt_transfer, test_plot_pool_levels), tests/test_viz3d.py and
tests/test_review_fixes.py (test_vertex_colored_off_export).  The port's
hausdorff_heatmap runs its nearest-distance search on the CPU here
(device="cpu"); on the card it is kernel #7.  The exporters' "jet" is the
port's numpy copy, held bit-equal to matplotlib's, so the .off files are
written on a machine without matplotlib.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from geobignn_tpu import graphs as jgraphs
from geobignn_tpu import meshio as jmeshio
from geobignn_tpu import native as jnative
from geobignn_tpu import viz as jviz
from geobignn_tpu import viz3d as jviz3d
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.geometry import vertex_normals_np
from geobignn_tpu.infer.gt_transfer import process_gt_transfer as jprocess
from geobignn_tpu.pool.hierarchy import build_hierarchy as jbuild_hierarchy
from geobignn_tpu_torch import graphs, testing, viz, viz3d
from geobignn_tpu_torch.infer.gt_transfer import process_gt_transfer
from geobignn_tpu_torch.pool.hierarchy import build_hierarchy

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    testing.match_reference_native(jnative)


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def test_gt_transfer_files_equal_jax(tmp_path):
    m = jsynth.icosphere(1)
    nd, od, fd = tmp_path / "n", tmp_path / "o", tmp_path / "f"
    for d in (nd, od, fd):
        d.mkdir()
    jmeshio.write_obj(str(od / "M.obj"), m.points, m.fv_indices)
    noisy = jsynth.add_noise(m, 0.1, seed=0)
    jmeshio.write_obj(str(nd / "M_n1.obj"), noisy.points, noisy.fv_indices)
    jmeshio.write_obj(str(fd / "M_n1.obj"), m.points, m.fv_indices)  # "filtered"
    want = {p.rsplit("/", 1)[-1]: open(p, "rb").read() for p in jprocess(str(nd), str(od), str(fd))}
    got = process_gt_transfer(str(nd), str(od), str(fd))
    assert len(got) == 3 and sorted(want) == sorted(p.rsplit("/", 1)[-1] for p in got)
    for p in got:
        assert open(p, "rb").read() == want[p.rsplit("/", 1)[-1]], p


def test_off_exporters_equal_jax(tmp_path):
    """hausdorff_heatmap (vertex colors, nearest distances), and
    normal_error_heatmap / write_off_face_colors (face colors)."""
    m_o = jsynth.icosphere(1)
    m_n = jsynth.add_noise(m_o, 0.05, seed=0)
    for name, fn, jfn in (
            ("h.off", lambda p: viz.hausdorff_heatmap(p, m_n, m_o, device="cpu"),
             lambda p: jviz.hausdorff_heatmap(p, m_n, m_o)),
            ("n.off", lambda p: viz.normal_error_heatmap(p, m_n, m_o),
             lambda p: jviz.normal_error_heatmap(p, m_n, m_o))):
        got, want = fn(str(tmp_path / ("t" + name))), jfn(str(tmp_path / ("j" + name)))
        _same_bytes(got, want)
    lines = open(str(tmp_path / "th.off")).read().splitlines()
    assert lines[0] == "COFF" and len(lines[2].split()) == 7
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            viz.hausdorff_heatmap(str(tmp_path / "x.off"), m_n, m_o)


def test_html_viewers_equal_jax(tmp_path):
    m = jsynth.icosphere(2)
    err = np.linalg.norm(m.points, axis=1)
    _same_bytes(viz3d.write_html_viewer(str(tmp_path / "t.html"), m.points, m.fv_indices,
                                        vertex_values=err),
                jviz3d.write_html_viewer(str(tmp_path / "j.html"), m.points, m.fv_indices,
                                         vertex_values=err))
    m = jsynth.icosphere(3)
    ei = jgraphs.build_vertex_graph_1ring(m.ev_indices, m.n_vertices)
    vn = vertex_normals_np(m.points, m.fv_indices)
    _, w = jgraphs.weighted_graph(ei, m.n_vertices, m.points, vn)
    x = np.concatenate([m.points, vn], axis=1).astype(np.float32)
    _same_bytes(viz3d.export_pool_hierarchy(str(tmp_path / "tp.html"), m.points, m.fv_indices,
                                            ei, build_hierarchy(ei, w, x, m.n_vertices)),
                jviz3d.export_pool_hierarchy(str(tmp_path / "jp.html"), m.points,
                                             m.fv_indices, ei,
                                             jbuild_hierarchy(ei, w, x, m.n_vertices)))


def test_png_plots_written(tmp_path):
    m = jsynth.icosphere(1)
    ei = graphs.build_vertex_graph_1ring(m.ev_indices, m.n_vertices)
    _, w = graphs.weighted_graph(ei, m.n_vertices, m.points, np.ones_like(m.points))
    x = np.concatenate([m.points, np.ones_like(m.points)], axis=1).astype(np.float32)
    specs = build_hierarchy(ei, w, x, m.n_vertices)
    paths = viz.plot_pool_levels(m.points, ei, specs, path_prefix=str(tmp_path / "pool"))
    paths += [viz.plot_mesh(m.points, m.fv_indices, path=str(tmp_path / "mesh.png")),
              viz.plot_graph(m.points, ei, edge_values=w, path=str(tmp_path / "g.png"))]
    assert len(paths) == len(specs) + 3
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_jet_is_matplotlibs(monkeypatch, tmp_path):
    """The exporters' "jet", computed in numpy, equals matplotlib's cm.jet
    bit for bit (on a dense grid, the segment ends, below 0, from 1, NaN),
    and the .off exporters run without matplotlib, as on a machine that
    has none."""
    import matplotlib.cm as cm

    v = np.concatenate([np.linspace(0.0, 1.0, 100_001),
                        [0.35, 0.66, 0.89, 0.125, 0.375, 0.64, 0.91, 0.11, 0.34, 0.65,
                         1.0 - 1e-12, -0.1, 1.2, np.nan]])
    np.testing.assert_array_equal(viz.colormap("jet")(v), cm.jet(v))
    m_o = jsynth.icosphere(1)
    m_n = jsynth.add_noise(m_o, 0.05, seed=0)
    want = [jviz.hausdorff_heatmap(str(tmp_path / "j.off"), m_n, m_o),
            jviz.normal_error_heatmap(str(tmp_path / "jn.off"), m_n, m_o)]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.cm", None)
    got = [viz.hausdorff_heatmap(str(tmp_path / "t.off"), m_n, m_o, device="cpu"),
           viz.normal_error_heatmap(str(tmp_path / "tn.off"), m_n, m_o)]
    for a, b in zip(got, want):
        _same_bytes(a, b)
    with pytest.raises(ImportError):
        viz.colormap("viridis")
