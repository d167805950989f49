"""The port's banded aggregate (plain versions of TPU kernels #1 and #2) and
the convs built on it, against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_banded_pallas.py runs them.  Inputs are made with numpy from a
seed and handed to both packages.  Tolerances:
  * compute dtype float32: rtol 1e-5 / atol 1e-6 of the output scale — the
    same float32 math, summed in another order;
  * bfloat16: 1e-2 of max|out| — the casts sit at the same points, but a D
    summed in another order can round an operand to the neighbouring bf16
    value (2^-8 relative) in either package.
The CUDA kernel itself is held against the same plain versions on the card
(chip_smoke.py and tests/test_torch_cuda.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu import graphs
from geobignn_tpu.data import synth
from geobignn_tpu.ops import banded as jbanded
from geobignn_tpu.ops import banded_pallas
from geobignn_tpu.ops.feastconv import FeastParams
from geobignn_tpu_torch.ops import banded as tbanded
from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.structs import round_up
from geobignn_tpu import native as jnative
from geobignn_tpu_torch import testing

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


HEADS = 9


def _band(subdiv=2, tile=64):
    m = synth.icosphere(subdiv)
    ei = graphs.build_vertex_graph_1ring(m.ev_indices, m.n_vertices)
    n = m.n_vertices
    perm = jbanded.rcm_order(ei.astype(np.int64), n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    ei_r = np.stack([inv[ei[0]], inv[ei[1]]])
    n_pad = round_up(n + 1, tile)
    return jbanded.band_mask_np(ei_r, n_pad, tile), ei_r, n


def _inputs(n_pad, n, c_in, c_out, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((n_pad, c_in), np.float32)
    x[:n] = rng.normal(size=(n, c_in))
    a = x @ (rng.normal(size=(c_in, HEADS)) * 0.5).astype(np.float32)
    c = (rng.normal(size=HEADS) * 0.3).astype(np.float32)
    p = np.exp(a - a.max(1, keepdims=True)).astype(np.float32)
    ca = c - a
    r = np.exp(ca - ca.max(1, keepdims=True)).astype(np.float32)
    w = (rng.normal(size=(HEADS, c_in, c_out)) * 0.4).astype(np.float32)
    return r, p, x, w


def _tol(ref, dtype_name):
    scale = float(np.abs(ref).max())
    if dtype_name == "float32":
        return dict(rtol=1e-5, atol=1e-6 * scale)
    return dict(rtol=0, atol=1e-2 * scale)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,c_out", [(6, 8), (16, 5)],
                         ids=["aggregate_first", "transform_first"])
def test_plain_aggregate_matches_jax(c_in, c_out, dtype_name):
    m, _, n = _band()
    _check_plain_aggregate(m, n, c_in, c_out, dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,c_out", [(6, 8), (16, 5)],
                         ids=["aggregate_first", "transform_first"])
def test_plain_aggregate_matches_jax_at_tile_384(c_in, c_out, dtype_name):
    """Tile 384, a 1,152-column window: the tile examples/run_1m.py's 8 halo
    parts band their vertex level at (icosphere(3) in 2 row blocks)."""
    m, _, n = _band(subdiv=3, tile=384)
    assert m.shape == (2, 384, 1152)
    _check_plain_aggregate(m, n, c_in, c_out, dtype_name)


def _check_plain_aggregate(m, n, c_in, c_out, dtype_name):
    r, p, x, w = _inputs(m.shape[0] * m.shape[1], n, c_in, c_out, seed=c_in)
    ref = np.asarray(banded_pallas.banded_aggregate(
        jnp.asarray(r), jnp.asarray(p), jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(m), getattr(jnp, dtype_name)))
    out = banded_cuda.banded_aggregate(
        *(torch.from_numpy(a) for a in (r, p, x, w, m)),
        compute_dtype=getattr(torch, dtype_name)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **_tol(ref, dtype_name))


def test_schedules_agree_in_float32():
    """Both plain schedules compute one function: in float32 they agree
    whichever C_out < C_in says."""
    m, _, n = _band()
    r, p, x, w = _inputs(m.shape[0] * m.shape[1], n, 12, 7, seed=3)
    args = [torch.from_numpy(a) for a in (r, p, x, w, m)]
    a = banded_cuda.aggregate_first_plain(*args, compute_dtype=torch.float32)
    b = banded_cuda.transform_first_plain(*args, compute_dtype=torch.float32)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(a.abs().max()))


def _feast_params(c_in, c_out, seed):
    rng = np.random.default_rng(seed)
    return dict(
        u=(rng.normal(size=(c_in, HEADS)) * 0.5).astype(np.float32),
        c=(rng.normal(size=HEADS) * 0.3).astype(np.float32),
        w=(rng.normal(size=(HEADS, c_in, c_out)) * 0.4).astype(np.float32),
        b=rng.normal(size=c_out).astype(np.float32),
    )


@pytest.mark.parametrize("c_in,c_out", [(6, 8), (16, 5)],
                         ids=["aggregate_first", "transform_first"])
def test_feast_conv_banded_matches_jax(c_in, c_out):
    m, ei_r, n = _band()
    n_pad = m.shape[0] * m.shape[1]
    prm = _feast_params(c_in, c_out, seed=11)
    x = np.zeros((n_pad, c_in), np.float32)
    x[:n] = np.random.default_rng(5).normal(size=(n, c_in))
    deg = np.zeros(n_pad, np.float32)
    np.add.at(deg, ei_r[0], 1.0)
    jp = FeastParams(**{k: jnp.asarray(v) for k, v in prm.items()})
    tp = {k: torch.from_numpy(v) for k, v in prm.items()}
    tx, tm, td = torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(deg)

    ref32 = np.asarray(jbanded.feast_conv_banded(
        jp, jnp.asarray(x), jnp.asarray(m), jnp.asarray(deg)))
    out32 = tbanded.feast_conv_banded(tp, tx, tm, td).numpy()
    np.testing.assert_allclose(out32, ref32, **_tol(ref32, "float32"))

    ref = np.asarray(banded_pallas.feast_conv_banded_pallas(
        jp, jnp.asarray(x), jnp.asarray(m), jnp.asarray(deg)))
    out = banded_cuda.feast_conv_banded_kernel(tp, tx, tm, td).numpy()
    np.testing.assert_allclose(out, ref, **_tol(ref, "bfloat16"))


def test_banded_conv_at_large_coordinates():
    """The banded conv on level-0 features of a whole large mesh, whose
    positions in mean edge lengths run to hundreds: icosphere(2) with its
    positions in its mean edge lengths, then moved 150 of them along each
    axis (the head softmax sees only x_j - x_i), u at the seeded model's
    scale, so that u.x spans over 90 across the heads.  The port's banded
    conv in float32 (the plain aggregate) against the exact COO conv
    (ops/feastconv.feast_conv), on both: within 1e-4 of max|out|.  The JAX
    package's banded conv on the same
    inputs (its halves shifted by their maxima, so that D falls under the
    1e-12 clamp) is off by order 1: the reference's documented deviation,
    which ops/banded.factorized_softmax's middle shift repairs."""
    from geobignn_tpu_torch.ops.feastconv import feast_conv

    mesh = synth.icosphere(2)
    ei = graphs.build_vertex_graph_1ring(mesh.ev_indices, mesh.n_vertices)
    n = mesh.n_vertices
    perm = jbanded.rcm_order(ei.astype(np.int64), n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    ei_r = np.stack([inv[ei[0]], inv[ei[1]]])
    m = jbanded.band_mask_np(ei_r, round_up(n + 1, 64), 64)
    n_pad = m.shape[0] * m.shape[1]
    pts = mesh.points[perm]
    pts = pts / np.linalg.norm(pts[ei_r[0]] - pts[ei_r[1]], axis=1).mean()
    prm = _feast_params(6, 8, seed=11)
    prm["u"] = (np.random.default_rng(3).normal(size=(6, HEADS)) * 0.09).astype(np.float32)
    deg = np.zeros(n_pad, np.float32)
    np.add.at(deg, ei_r[0], 1.0)
    tp = {k: torch.from_numpy(v) for k, v in prm.items()}
    jp = FeastParams(**{k: jnp.asarray(v) for k, v in prm.items()})
    outs = {}
    for shift in (0.0, 150.0):
        x = np.zeros((n_pad, 6), np.float32)
        x[:n, :3] = pts + np.float32(shift)
        x[:n, 3:] = mesh.points[perm]
        a = x[:n] @ prm["u"]
        tx = torch.from_numpy(x)
        exact = feast_conv(tp, tx, torch.from_numpy(ei_r)).numpy()[:n]
        got = tbanded.feast_conv_banded(tp, tx, torch.from_numpy(m),
                                        torch.from_numpy(deg)).numpy()[:n]
        ref = np.asarray(jbanded.feast_conv_banded(jp, jnp.asarray(x), jnp.asarray(m),
                                                   jnp.asarray(deg)))[:n]
        scale = np.abs(exact).max()
        outs[shift] = (float(np.abs(got - exact).max() / scale),
                       float(np.abs(ref - exact).max() / scale), float((a.max(1) - a.min(1)).max()))
    (e0, j0, span0), (e1, j1, span1) = outs[0.0], outs[150.0]
    assert span0 < 27 < 90 < span1 < 170, (span0, span1)
    assert e0 <= 1e-4 and e1 <= 1e-4, (e0, e1)
    assert j0 <= 1e-4 < 0.1 <= j1, (j0, j1)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_hybrid_band_conv_matches_jax(dtype_name):
    """feast_conv_hybrid_band (band + banded boundary sub-graph) against the
    JAX one on a slab-RCM ordered graph with a real boundary."""
    m_mesh = synth.add_noise(synth.icosphere(3), 0.2, seed=0)
    ei = graphs.build_vertex_graph_1ring(m_mesh.ev_indices, m_mesh.n_vertices)
    n = m_mesh.n_vertices
    perm, _ = jbanded.order_for_band(ei, n, max_tile=32, target_tile=32)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    ei_r = inv[ei.astype(np.int64)].astype(np.int32)
    tile = 32
    n_band = round_up(n + 1, tile)
    jarrs = jbanded.boundary_band_np(ei_r, n_band, tile, granularity=32)
    assert jarrs is not None and jarrs["jnodes"].size > 0
    keep = ~jbanded.out_of_window(ei_r, tile)
    m = jbanded.band_mask_np(ei_r[:, keep], n_band, tile, check_bw=False)

    c_in, c_out = 6, 8
    prm = _feast_params(c_in, c_out, seed=2)
    x = np.zeros((n_band, c_in), np.float32)
    x[:n] = np.random.default_rng(9).normal(size=(n, c_in))
    deg = np.zeros(n_band, np.float32)
    np.add.at(deg, ei_r[0], 1.0)

    ref = np.asarray(banded_pallas.feast_conv_hybrid_band(
        FeastParams(**{k: jnp.asarray(v) for k, v in prm.items()}),
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(jarrs["jnodes"]),
        jnp.asarray(jarrs["jband"]), jnp.asarray(jarrs["jpos"]),
        jnp.asarray(deg), compute_dtype=getattr(jnp, dtype_name)))
    t = {k: torch.from_numpy(np.asarray(v, np.int64 if k in ("jnodes", "jpos") else None))
         for k, v in jarrs.items()}
    out = banded_cuda.feast_conv_hybrid_band(
        {k: torch.from_numpy(v) for k, v in prm.items()}, torch.from_numpy(x),
        torch.from_numpy(m), t["jnodes"], t["jband"], t["jpos"],
        torch.from_numpy(deg), compute_dtype=getattr(torch, dtype_name)).numpy()
    np.testing.assert_allclose(out[:n], ref[:n], **_tol(ref[:n], dtype_name))
