"""The nearest-distance metric of the port on the CPU: the plain version of
the Hopper kernel (ops/nn_cuda.py) against the JAX package's Pallas kernel
in interpret mode and a float64 brute force, and corpus evaluation
(infer/evaluate.py) against the JAX package's.

Bounds.  The expansion |a|^2 - 2 a.b + |b|^2 cancels for near points, so
SQUARED distances are held to 1e-5 * max(|a|^2 + |b|^2) (a few float32 ulps
of the terms that cancel).  The square root magnifies that error for the
closest pairs: a distance d carries at most err(d^2) / d, and never more
than sqrt(err(d^2)); both are checked.  A point of a that is also in b gives
a small residual, not zero: below 3e-3 at unit scale, the JAX package's own
allowance, and never NaN.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from geobignn_tpu.infer import evaluate as jevaluate
from geobignn_tpu.ops.pallas_nn import nearest_distance_pallas
from geobignn_tpu_torch import meshio
from geobignn_tpu_torch.data import synth
from geobignn_tpu_torch.infer import evaluate
from geobignn_tpu_torch.models import losses
from geobignn_tpu_torch.ops import banded_cuda, nn_cuda
from geobignn_tpu import native as jnative
from geobignn_tpu_torch import testing

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


def _case(name):
    rng = np.random.default_rng({"mesh": 0, "coincident": 1, "one": 2, "wide": 3}[name])
    if name == "mesh":
        return rng.normal(size=(700, 3)), rng.normal(size=(1500, 3))
    if name == "coincident":  # 100 points of b against b
        b = rng.normal(size=(1500, 3))
        return b[:100], b
    if name == "one":
        return rng.normal(size=(1, 3)), rng.normal(size=(5, 3))
    return rng.normal(size=(300, 64)), rng.normal(size=(300, 64))


@pytest.mark.parametrize("name", ["mesh", "coincident", "one", "wide"])
def test_plain_matches_pallas_and_brute_force(name):
    a, b = (x.astype(np.float32) for x in _case(name))
    d2_ref = ((a[:, None, :].astype(np.float64) - b[None, :, :]) ** 2).sum(-1).min(axis=1)
    scale = float((a.astype(np.float64) ** 2).sum(1).max()
                  + (b.astype(np.float64) ** 2).sum(1).max())
    bound2 = 1e-5 * scale

    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    d2 = nn_cuda.nearest_distance_plain(ta, tb, block=128, squared=True).numpy()
    d = nn_cuda.nearest_distance_plain(ta, tb, block=128).numpy()
    d_pallas = np.asarray(nearest_distance_pallas(a, b, interpret=True))
    assert d.shape == d_pallas.shape == (a.shape[0],) and d.dtype == np.float32
    assert np.isfinite(d).all() and (d >= 0).all()

    assert np.abs(d2 - d2_ref).max() <= bound2
    assert np.abs(d_pallas.astype(np.float64) ** 2 - d2_ref).max() <= bound2
    assert np.abs(d.astype(np.float64) ** 2 - d_pallas.astype(np.float64) ** 2).max() \
        <= bound2
    # distances: err(d^2) / d away from zero, sqrt(err(d^2)) at most
    d_ref = np.sqrt(d2_ref)
    bound_d = np.minimum(np.sqrt(2 * bound2), 2 * bound2 / np.maximum(d_ref, 1e-30))
    assert (np.abs(d - d_ref) <= bound_d).all()
    assert (np.abs(d - d_pallas) <= 2 * bound_d).all()
    if name == "coincident":
        assert np.abs(d).max() <= 3e-3 and np.abs(d_pallas).max() <= 3e-3
    # the wrapper on CPU tensors is the plain version, whatever the block
    torch.testing.assert_close(nn_cuda.nearest_distance(ta, tb), torch.from_numpy(d),
                               rtol=0, atol=float(bound_d.max()))


def test_wrapper_on_cpu_tensors_converts_checks_and_counts_nothing():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.normal(size=(40, 6)))  # float64
    b = torch.from_numpy(rng.normal(size=(6, 50)).astype(np.float32)).T  # not contiguous
    before = dict(banded_cuda.LAUNCHES)
    got = nn_cuda.nearest_distance(a, b)
    assert got.dtype == torch.float32 and got.shape == (40,)
    want = nn_cuda.nearest_distance_plain(a.float(), b.contiguous())
    assert torch.equal(got, want)
    assert dict(banded_cuda.LAUNCHES) == before and before["nearest"] == 0
    for bad_a, bad_b in ((a, b[:, :5]), (a[0], b), (a, b[:0]), (a[:0], b), (a[:, :0], b[:, :0])):
        with pytest.raises(ValueError, match="nearest_distance needs"):
            nn_cuda.nearest_distance(bad_a, bad_b)
        with pytest.raises(ValueError, match="nearest_distance needs"):
            nn_cuda.nearest_distance_plain(bad_a, bad_b)
    # a NaN-free clamp: coincident points at a large offset give d^2 < 0 somewhere
    far = (torch.from_numpy(rng.normal(size=(200, 3)).astype(np.float32)) + 50.0)
    assert (nn_cuda.nearest_distance_plain(far, far, squared=True) < 0).any()
    assert torch.isfinite(nn_cuda.nearest_distance(far, far)).all()


def test_losses_nearest_distance_on_cpu_is_unchanged():
    """models/losses.nearest_distance(metric="euclidean") on CPU tensors keeps
    its tiled path, which is the plain version's arithmetic."""
    a, b = (torch.from_numpy(x.astype(np.float32)) for x in _case("mesh"))
    got = losses.nearest_distance(a, b, 128, "euclidean")
    assert torch.equal(got, nn_cuda.nearest_distance_plain(a, b, block=128))


def _result_dirs(tmp_path):
    """Two originals and, per original, two 'results' (noisy copies)."""
    od, rd = tmp_path / "original", tmp_path / "result"
    od.mkdir(), rd.mkdir()
    for i, (name, sub) in enumerate((("Ball", 2), ("Globe", 3))):
        m_o = synth.icosphere(sub)
        meshio.write_obj(str(od / f"{name}.obj"), m_o.points, m_o.fv_indices)
        for k in (1, 2):
            m_r = synth.add_noise(m_o, 0.05 * k, seed=7 * i + k)
            meshio.write_obj(str(rd / f"{name}_n{k}-60.obj"), m_r.points, m_r.fv_indices)
    return str(rd), str(od)


def _parse_error_info(path):
    lines = [ln for ln in open(path).read().splitlines() if ln.strip()]
    head, rows = lines[0], lines[1:]
    return head, [[float(t) if re.fullmatch(r"[-+0-9.eE]+", t) else t for t in ln.split()]
                  for ln in rows]


def test_eval_denoising_result_matches_jax(tmp_path, capsys):
    """Both packages on the same two directories: every number of `rows` and
    `corpus` within 1e-5 relative, the vertex distance within 1e-5 of the mean
    edge length (the expansion's cancellation: the two packages sum its terms
    in another order, and distances of a few percent of the unit scale carry
    that as about 1e-5 of themselves); ErrorInfo_h.txt parsed equal to 1e-4."""
    rd, od = _result_dirs(tmp_path)
    want = jevaluate.eval_denoising_result(rd, od)
    j_head, j_rows = _parse_error_info(os.path.join(rd, "ErrorInfo_h.txt"))
    os.remove(os.path.join(rd, "ErrorInfo_h.txt"))
    j_out = capsys.readouterr().out
    got = evaluate.eval_denoising_result(rd, od, device="cpu")
    t_head, t_rows = _parse_error_info(os.path.join(rd, "ErrorInfo_h.txt"))
    t_out = capsys.readouterr().out

    assert len(got["rows"]) == len(want["rows"]) == 4
    for g, w in zip(got["rows"] + [got["corpus"]], want["rows"] + [want["corpus"]]):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, str):
                assert g[k] == v
            elif k.startswith("vertex_dist"):
                mel = w["vertex_dist"] / w["vertex_dist_norm"]
                tol = 1e-5 * (mel if k == "vertex_dist" else 1.0)
                assert abs(g[k] - v) <= tol, (k, g[k], v)
            else:
                assert abs(g[k] - v) <= 1e-5 * abs(v), (k, g[k], v)
    assert t_head == j_head and len(t_rows) == len(j_rows) == 5
    for tr, jr in zip(t_rows, j_rows):
        assert len(tr) == len(jr)
        for x, y in zip(tr, jr):
            assert x == y if isinstance(y, str) else abs(x - y) <= 1e-4, (tr, jr)
    assert len(t_out.splitlines()) == len(j_out.splitlines()) == 6
    assert evaluate.eval_denoising_result(str(tmp_path), od, device="cpu") is None


def test_evaluate_result_pair_of_a_mesh_with_itself(tmp_path):
    m = synth.icosphere(2)
    r = evaluate.evaluate_result_pair(m, m, device="cpu")
    assert r["n_faces"] == 320 and r["n_verts"] == 162
    assert r["normal_mse"] == 0.0 and r["angle"] == 0.0
    assert 0.0 <= r["vertex_dist"] <= 3e-3  # the expansion's residual, not NaN


@pytest.mark.parametrize("n,m,k", [
    (10242, 10242, 3), (40000, 40000, 3), (500000, 500000, 3), (8192, 8192, 64),
    (1, 1, 3), (1, 1_000_000, 3), (31, 129, 5), (10242, 1, 3), (1025, 10242, 130),
    (129, 1025, 17), (700, 1500, 4), (3, 100_000, 2), (2_000_000, 50, 1)])
def test_split_plan_covers_b_once_and_fills_the_card(n, m, k):
    """The host arithmetic of the kernel's launch: every row of b lies in
    exactly one slice, slices are whole row granules, and the grid is two
    waves of the card's SMs wherever N and M allow that many CTAs."""
    slices, rows = nn_cuda.split_plan(n, m, k)
    small = k <= nn_cuda.SMALL_K
    granule = nn_cuda.ROW_GRANULE[small]
    assert rows % granule == 0 and 1 <= slices <= 65535
    assert (slices - 1) * rows < m <= slices * rows  # the last slice is not empty
    starts = np.arange(slices) * rows
    owner = np.searchsorted(starts, np.arange(m), side="right") - 1
    assert (np.bincount(owner, minlength=slices) > 0).all()
    assert (owner == np.minimum(np.arange(m) // rows, slices - 1)).all()
    q_blocks = -(-n // nn_cuda.CTA_QUERIES[small])
    assert q_blocks * slices >= min(2 * nn_cuda.SMS, q_blocks * -(-m // granule))
    assert nn_cuda.split_plan(n, m, k) == (slices, rows)
