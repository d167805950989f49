"""The backward of the port's banded aggregate (plain versions of TPU
kernels #3 and #4) and the gradients of the convs built on it, against the
JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_banded_pallas.py runs them; jax.vjp goes through their custom
VJP.  Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each relative to the largest magnitude of the tensor compared:
  * compute dtype float32: 1e-5 — the same float32 math, summed in another
    order;
  * bfloat16: 2e-2 — the casts sit at the same points, but a value summed in
    another order can round to the neighbouring bf16 value (2^-8 relative)
    in either package, and the cotangents go through two such roundings.
The CUDA kernels are held against the same plain versions on the card
(chip_smoke.py and tests/test_torch_cuda.py).
"""

from __future__ import annotations

import jax
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
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SCHEDULES = pytest.mark.parametrize("c_in,c_out", [(6, 8), (16, 5)],
                                    ids=["aggregate_first", "transform_first"])
DTYPES = pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} > {rel} x {scale:.3e}"


def _band(subdiv=2, tile=64, mesh=None):
    m = synth.icosphere(subdiv) if mesh is None else mesh
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
    gout = rng.normal(size=(n_pad, c_out)).astype(np.float32)
    gout[n:] = 0.0
    return r, p, x, w, gout


@SCHEDULES
@DTYPES
def test_plain_bwd_matches_jax_vjp(c_in, c_out, dtype_name):
    """All four cotangents of the plain backward against jax.vjp of the
    Pallas aggregate (interpret mode)."""
    m, _, n = _band()
    _check_plain_bwd(m, n, c_in, c_out, dtype_name)


@SCHEDULES
@DTYPES
def test_plain_bwd_matches_jax_vjp_at_tile_384(c_in, c_out, dtype_name):
    """The same at tile 384, a 1,152-column window: the tile
    examples/run_1m.py's 8 halo parts band their vertex level at
    (icosphere(3) in 2 row blocks)."""
    m, _, n = _band(subdiv=3, tile=384)
    assert m.shape == (2, 384, 1152)
    _check_plain_bwd(m, n, c_in, c_out, dtype_name)


def _check_plain_bwd(m, n, c_in, c_out, dtype_name):
    r, p, x, w, gout = _inputs(m.shape[0] * m.shape[1], n, c_in, c_out, seed=c_in)
    _, vjp = jax.vjp(
        lambda r_, p_, x_, w_: banded_pallas.banded_aggregate(
            r_, p_, x_, w_, jnp.asarray(m), getattr(jnp, dtype_name)),
        *(jnp.asarray(a) for a in (r, p, x, w)))
    want = vjp(jnp.asarray(gout))
    got = banded_cuda.banded_aggregate_bwd(
        *(torch.from_numpy(a) for a in (r, p, x, w, m, gout)),
        compute_dtype=getattr(torch, dtype_name))
    for name, g, j in zip(("r", "p", "x", "w"), got, want):
        _close(g.numpy(), j, TOL[dtype_name], f"{name} cotangent")


@SCHEDULES
@DTYPES
def test_plain_bwd_with_far_window_mates(c_in, c_out, dtype_name):
    """The aggregate is invariant to scaling each node's r by s_i and its p
    by 1/s_i (ops/banded.factorized_softmax's per-node shifts), and its
    cotangents scale by 1/s_i and s_i.  On a strip, whose band is narrow,
    with s_i = 2^k_i growing along the RCM order, neighbours' k differ by
    at most 12 while two nodes of one window differ by 128 or more: r_i p_j of such a pair passes float32's
    range, as at level 0 of a whole 1,310,720-face mesh, where the middle
    shift keeps each half within exp(span / 2) but two far nodes' halves
    multiply past it (chip_smoke.py --large's boundary sub-band, whose
    gathered rows lie across the mesh).  The plain backward, which forms
    the denominator path densely over the window, must give the scaled
    cotangents of the unscaled inputs (powers of two: exact), not NaN."""
    m, ei_r, n = _band(mesh=synth.grid_patch(3, 40))  # a strip: a narrow band
    n_pad = m.shape[0] * m.shape[1]
    r, p, x, w, gout = _inputs(n_pad, n, c_in, c_out, seed=5)
    k = np.zeros(n_pad, np.int64)
    k[:n] = np.rint(1.5 * (np.arange(n) - n // 2))
    window_pairs = [(i, j) for i in range(n) for j in range(max(i // 64 - 1, 0) * 64, i)]
    assert np.abs(k[ei_r[0]] - k[ei_r[1]]).max() <= 12
    assert max(k[i] - k[j] for i, j in window_pairs) >= 128
    s = np.ldexp(np.float32(1.0), k)[:, None].astype(np.float32)
    cd = getattr(torch, dtype_name)
    args = [torch.from_numpy(a) for a in (x, w, m, gout)]
    plain = banded_cuda.banded_aggregate_bwd_plain(
        *(torch.from_numpy(a) for a in (r, p)), *args, compute_dtype=cd)
    scaled = banded_cuda.banded_aggregate_bwd_plain(
        *(torch.from_numpy(a) for a in (r * s, p / s)), *args, compute_dtype=cd)
    for name, got, want in zip(("r", "p", "x", "w"), scaled,
                               (plain[0] / torch.from_numpy(s), plain[1] * torch.from_numpy(s),
                                *plain[2:])):
        assert torch.isfinite(got).all(), name
        _close(got.numpy(), want.numpy(), 1e-6, f"{name} cotangent")


@SCHEDULES
def test_plain_bwd_matches_autograd_in_float32(c_in, c_out):
    """Independent check: in float32 compute the plain backward is the
    gradient of the plain forward."""
    m, _, n = _band()
    r, p, x, w, gout = _inputs(m.shape[0] * m.shape[1], n, c_in, c_out, seed=7)
    prim = [torch.from_numpy(a).requires_grad_() for a in (r, p, x, w)]
    fwd = (banded_cuda.transform_first_plain if c_out < c_in
           else banded_cuda.aggregate_first_plain)
    out = fwd(*prim, torch.from_numpy(m), compute_dtype=torch.float32)
    want = torch.autograd.grad(out, prim, torch.from_numpy(gout))
    got = banded_cuda.banded_aggregate_bwd_plain(
        *prim, torch.from_numpy(m), torch.from_numpy(gout),
        compute_dtype=torch.float32)
    for name, g, a in zip(("r", "p", "x", "w"), got, want):
        _close(g.detach().numpy(), a.numpy(), 1e-5, f"{name} cotangent")


@SCHEDULES
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64], ids=str)
def test_cotangents_in_primal_dtypes(c_in, c_out, dtype):
    """The autograd Function returns each cotangent in its primal's dtype
    (the kernels and plain versions compute in f32)."""
    m, _, n = _band()
    r, p, x, w, _ = _inputs(m.shape[0] * m.shape[1], n, c_in, c_out, seed=2)
    prim = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (r, p, x, w)]
    out = banded_cuda.banded_aggregate(*prim, torch.from_numpy(m))
    out.sum().backward()
    for t in prim:
        assert t.grad is not None and t.grad.dtype == dtype
        assert torch.isfinite(t.grad).all()


def test_cpu_gradient_is_the_plain_backward():
    """On CPU tensors the aggregate's gradient comes from the plain backward
    through the one autograd Function, not from autograd through the
    forward's bf16 casts (which would round the incoming gradient)."""
    m, _, n = _band()
    r, p, x, w, gout = _inputs(m.shape[0] * m.shape[1], n, 6, 8, seed=4)
    prim = [torch.from_numpy(a).requires_grad_() for a in (r, p, x, w)]
    out = banded_cuda.banded_aggregate(*prim, torch.from_numpy(m))
    assert out.grad_fn.name() == "_BandedAggregateBackward"
    got = torch.autograd.grad(out, prim, torch.from_numpy(gout))
    want = banded_cuda.banded_aggregate_bwd_plain(
        *(t.detach() for t in prim), torch.from_numpy(m), torch.from_numpy(gout))
    for g, a in zip(got, want):
        assert torch.equal(g, a)


def test_factorized_softmax_shift_carries_no_gradient():
    """The per-node max shifts are detached, as the JAX package's
    stop_gradient: gradients of p and r match jax.grad of the same
    expression (without the detach they would not)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    u = (rng.normal(size=(6, HEADS)) * 0.5).astype(np.float32)
    c = (rng.normal(size=HEADS) * 0.3).astype(np.float32)
    g1 = rng.normal(size=(40, HEADS)).astype(np.float32)
    g2 = rng.normal(size=(40, HEADS)).astype(np.float32)

    def jloss(x_, u_, c_):
        a = x_ @ u_
        p = jnp.exp(a - jax.lax.stop_gradient(a.max(axis=1, keepdims=True)))
        ca = c_ - a
        r = jnp.exp(ca - jax.lax.stop_gradient(ca.max(axis=1, keepdims=True)))
        return (p * g1).sum() + (r * g2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, u, c)))
    prim = [torch.from_numpy(a).requires_grad_() for a in (x, u, c)]
    p, r = tbanded.factorized_softmax(*prim)
    loss = (p * torch.from_numpy(g1)).sum() + (r * torch.from_numpy(g2)).sum()
    got = torch.autograd.grad(loss, prim)
    for name, g, j in zip(("x", "u", "c"), got, want):
        _close(g.numpy(), j, 1e-5, f"d/d{name}")


def test_factorized_softmax_wide_span_shift_carries_no_gradient():
    """Where a node's u.x spans more than banded.WIDE_SPAN over the heads,
    every node's halves are shifted by the middle of its span (the JAX
    function's max shifts would put D under its clamp); those shifts are
    detached too: gradients of p and r match jax.grad of the same
    expression, and p and r equal it."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(40, 6)) * 8).astype(np.float32)
    u = (rng.normal(size=(6, HEADS)) * 0.5).astype(np.float32)
    c = (rng.normal(size=HEADS) * 0.3).astype(np.float32)
    g1 = rng.normal(size=(40, HEADS)).astype(np.float32)
    g2 = rng.normal(size=(40, HEADS)).astype(np.float32)
    a = x @ u
    assert tbanded.WIDE_SPAN < (a.max(1) - a.min(1)).max() < 170

    def halves(x_, u_, c_):
        a = x_ @ u_
        s = jax.lax.stop_gradient((a.max(axis=1, keepdims=True)
                                   + a.min(axis=1, keepdims=True)) / 2)
        return jnp.exp(a - s), jnp.exp(c_ - a + s)

    def jloss(x_, u_, c_):
        p, r = halves(x_, u_, c_)
        return (p * g1).sum() + (r * g2).sum()

    jargs = [jnp.asarray(t) for t in (x, u, c)]
    want = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    prim = [torch.from_numpy(t).requires_grad_() for t in (x, u, c)]
    p, r = tbanded.factorized_softmax(*prim)
    for name, got, ref in zip("pr", (p, r), halves(*jargs)):
        _close(got.detach().numpy(), ref, 1e-5, name)
    loss = (p * torch.from_numpy(g1)).sum() + (r * torch.from_numpy(g2)).sum()
    got = torch.autograd.grad(loss, prim)
    for name, g, j in zip(("x", "u", "c"), got, want):
        _close(g.numpy(), j, 1e-5, f"d/d{name}")


def _feast_params(c_in, c_out, seed):
    rng = np.random.default_rng(seed)
    return dict(
        u=(rng.normal(size=(c_in, HEADS)) * 0.5).astype(np.float32),
        c=(rng.normal(size=HEADS) * 0.3).astype(np.float32),
        w=(rng.normal(size=(HEADS, c_in, c_out)) * 0.4).astype(np.float32),
        b=rng.normal(size=c_out).astype(np.float32),
    )


def _conv_grads(jconv, tconv, prm, x, n, seed):
    """Gradients of sum(conv(x) * g) over (u, c, w, b, x) in both packages."""
    keys = ("u", "c", "w", "b")
    g = np.random.default_rng(seed).normal(size=(x.shape[0], prm["w"].shape[2]))
    g = g.astype(np.float32)
    g[n:] = 0.0

    def jloss(u, c, w, b, x_):
        return (jconv(FeastParams(u=u, c=c, w=w, b=b), x_) * g).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(prm[k]) for k in keys), jnp.asarray(x))
    tp = {k: torch.from_numpy(prm[k]).requires_grad_() for k in keys}
    tx = torch.from_numpy(x).requires_grad_()
    loss = (tconv(tp, tx) * torch.from_numpy(g)).sum()
    got = torch.autograd.grad(loss, [tp[k] for k in keys] + [tx])
    return zip(keys + ("x",), got, want)


@SCHEDULES
@DTYPES
def test_feast_conv_banded_grads_match_jax(c_in, c_out, dtype_name):
    m, ei_r, n = _band()
    n_pad = m.shape[0] * m.shape[1]
    prm = _feast_params(c_in, c_out, seed=11)
    x = np.zeros((n_pad, c_in), np.float32)
    x[:n] = np.random.default_rng(5).normal(size=(n, c_in))
    deg = np.zeros(n_pad, np.float32)
    np.add.at(deg, ei_r[0], 1.0)
    jm, jd = jnp.asarray(m), jnp.asarray(deg)
    tm, td = torch.from_numpy(m), torch.from_numpy(deg)
    for name, got, want in _conv_grads(
            lambda p_, x_: banded_pallas.feast_conv_banded_pallas(
                p_, x_, jm, jd, compute_dtype=getattr(jnp, dtype_name)),
            lambda p_, x_: banded_cuda.feast_conv_banded_kernel(
                p_, x_, tm, td, compute_dtype=getattr(torch, dtype_name)),
            prm, x, n, seed=3):
        got = got.numpy()
        want = np.asarray(want)
        if name == "x":
            got, want = got[:n], want[:n]
        _close(got, want, TOL[dtype_name], f"d/d{name}")


@DTYPES
def test_hybrid_band_conv_grads_match_jax(dtype_name):
    """Gradients of feast_conv_hybrid_band (band + banded boundary
    sub-graph, whose gathers autograd differentiates) against the JAX one,
    whose gathers have custom backwards through jpos/jnodes."""
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

    prm = _feast_params(6, 8, seed=2)
    x = np.zeros((n_band, 6), np.float32)
    x[:n] = np.random.default_rng(9).normal(size=(n, 6))
    deg = np.zeros(n_band, np.float32)
    np.add.at(deg, ei_r[0], 1.0)
    j_arr = {k: jnp.asarray(v) for k, v in jarrs.items()}
    t_arr = {k: torch.from_numpy(np.asarray(v, np.int64 if k != "jband" else None))
             for k, v in jarrs.items()}
    jm, jd = jnp.asarray(m), jnp.asarray(deg)
    tm, td = torch.from_numpy(m), torch.from_numpy(deg)
    for name, got, want in _conv_grads(
            lambda p_, x_: banded_pallas.feast_conv_hybrid_band(
                p_, x_, jm, j_arr["jnodes"], j_arr["jband"], j_arr["jpos"], jd,
                compute_dtype=getattr(jnp, dtype_name)),
            lambda p_, x_: banded_cuda.feast_conv_hybrid_band(
                p_, x_, tm, t_arr["jnodes"], t_arr["jband"], t_arr["jpos"], td,
                compute_dtype=getattr(torch, dtype_name)),
            prm, x, n, seed=8):
        got = got.numpy()
        want = np.asarray(want)
        if name == "x":
            got, want = got[:n], want[:n]
        _close(got, want, TOL[dtype_name], f"d/d{name}")
