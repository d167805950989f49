"""The port's conv paths that hold no kernel — segment reductions, the COO
and dense-table FeaStConv, the compact table gather, the boundary-table
hybrid conv, segment pooling — and the DualGNN over levels without a band,
against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  All of
it is float32 math summed in another order: 1e-5 of the largest magnitude
of the tensor compared, gradients included.  The boundary-table hybrid runs
the banded aggregate (Pallas in interpret mode against the port's plain
version), in float32 compute here.  The model runs the Config defaults'
bf16 heads: positions within 2e-2, unit normals within 5e-2, as
tests/test_torch_model.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu import graphs
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import synth
from geobignn_tpu.models import DualGNN as JDualGNN
from geobignn_tpu.models.dual_gnn import pool_features as j_pool_features
from geobignn_tpu.ops import banded as jbanded
from geobignn_tpu.ops import banded_pallas
from geobignn_tpu.ops import feastconv as jfeast
from geobignn_tpu.ops import segment as jsegment
from geobignn_tpu.ops import table as jtable
from geobignn_tpu.structs import PoolStep as JPoolStep
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch.data import builder as tbuilder
from geobignn_tpu_torch.data import synth as tsynth
from geobignn_tpu_torch.models.dual_gnn import DualGNN, pool_features
from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.ops import feastconv as tfeast
from geobignn_tpu_torch.ops import segment as tsegment
from geobignn_tpu_torch.ops import table as ttable
from geobignn_tpu_torch.structs import PoolStep, round_up
from geobignn_tpu import native as jnative
from geobignn_tpu_torch import testing

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


HEADS = 9
KEYS = ("u", "c", "w", "b")


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} > {rel} x {scale:.3e}"


def _graph(subdiv=2, pad=8):
    """Trash-padded vertex graph of an icosphere (host order, rows sorted)."""
    m = synth.icosphere(subdiv)
    ei = graphs.build_vertex_graph_1ring(m.ev_indices, m.n_vertices)
    n = m.n_vertices
    n_pad = round_up(n + 1, 8)
    ei_pad = np.full((2, ei.shape[1] + pad), n_pad - 1, np.int32)
    ei_pad[:, : ei.shape[1]] = ei
    return ei_pad, n, n_pad


def _feast_params(c_in, c_out, seed):
    rng = np.random.default_rng(seed)
    return dict(
        u=(rng.normal(size=(c_in, HEADS)) * 0.5).astype(np.float32),
        c=(rng.normal(size=HEADS) * 0.3).astype(np.float32),
        w=(rng.normal(size=(HEADS, c_in, c_out)) * 0.4).astype(np.float32),
        b=rng.normal(size=c_out).astype(np.float32),
    )


def _both_with_grads(jconv, tconv, prm, x, n, seed):
    """Forward and the gradients of sum(conv(x) * g) over (u, c, w, b, x) in
    both packages: [(name, got, want)], the forward first."""
    g = np.random.default_rng(seed).normal(size=(x.shape[0], prm["w"].shape[2]))
    g = g.astype(np.float32)
    g[n:] = 0.0
    jargs = [jnp.asarray(prm[k]) for k in KEYS] + [jnp.asarray(x)]

    def jrun(u, c, w, b, x_):
        return jconv(jfeast.FeastParams(u=u, c=c, w=w, b=b), x_)

    want = jrun(*jargs)
    want_g = jax.grad(lambda *a: (jrun(*a) * g).sum(), argnums=(0, 1, 2, 3, 4))(*jargs)
    tp = {k: torch.from_numpy(prm[k]).requires_grad_() for k in KEYS}
    tx = torch.from_numpy(x).requires_grad_()
    got = tconv(tp, tx)
    got_g = torch.autograd.grad((got * torch.from_numpy(g)).sum(),
                                [tp[k] for k in KEYS] + [tx])
    out = [("forward", got.detach().numpy()[:n], np.asarray(want)[:n])]
    for name, a, b in zip(KEYS + ("x",), got_g, want_g):
        a, b = a.numpy(), np.asarray(b)
        out.append((f"d/d{name}", a[:n], b[:n]) if name == "x" else (f"d/d{name}", a, b))
    return out


# --------------------------------------------------------------------------
# segment reductions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "mean", "max", "count"])
def test_segment_ops_match_jax(op):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 17, size=200)
    ids[ids == 5] = 6  # segment 5 is empty, 19 segments: 17 and 18 too
    data = rng.normal(size=(200, 4)).astype(np.float32)
    if op == "count":
        want = jsegment.segment_count(jnp.asarray(ids), 19)
        got = tsegment.segment_count(torch.from_numpy(ids), 19)
    else:
        want = getattr(jsegment, f"segment_{op}")(jnp.asarray(data), jnp.asarray(ids), 19)
        got = getattr(tsegment, f"segment_{op}")(
            torch.from_numpy(data), torch.from_numpy(ids), 19)
    assert float(np.abs(np.asarray(want)[5]).max()) == 0.0  # empty segments give 0
    _close(got.numpy(), want, 1e-6, op)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_segment_op_gradients_match_jax(op):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 11, size=60)
    data = rng.normal(size=(60, 3)).astype(np.float32)
    g = rng.normal(size=(11, 3)).astype(np.float32)
    want = jax.grad(lambda d: (getattr(jsegment, f"segment_{op}")(
        d, jnp.asarray(ids), 11) * g).sum())(jnp.asarray(data))
    td = torch.from_numpy(data).requires_grad_()
    out = getattr(tsegment, f"segment_{op}")(td, torch.from_numpy(ids), 11)
    got, = torch.autograd.grad((out * torch.from_numpy(g)).sum(), td)
    _close(got.numpy(), want, 1e-6, op)


@pytest.mark.parametrize("pool_type", ["max", "mean"])
def test_pool_features_segment_branch_matches_jax(pool_type):
    """Pool steps without member tables reduce over their cluster maps."""
    rng = np.random.default_rng(2)
    c1 = np.minimum(np.arange(40) // 3, 15).astype(np.int32)
    c2 = np.minimum(np.arange(16) // 2, 7).astype(np.int32)
    x = rng.normal(size=(40, 5)).astype(np.float32)
    want = j_pool_features(
        jnp.asarray(x), (JPoolStep(cluster=jnp.asarray(c1), n_out=16),
                         JPoolStep(cluster=jnp.asarray(c2), n_out=8)), pool_type)
    steps = (PoolStep(cluster=c1, n_out=16).to("cpu"), PoolStep(cluster=c2, n_out=8).to("cpu"))
    got = pool_features(torch.from_numpy(x), steps, pool_type)
    _close(got.numpy(), want, 1e-6, pool_type)
    with pytest.raises(ValueError):
        pool_features(torch.from_numpy(x), steps, "median")


# --------------------------------------------------------------------------
# the convs
# --------------------------------------------------------------------------

SHAPES = pytest.mark.parametrize("c_in,c_out", [(6, 8), (16, 5)], ids=["widen", "narrow"])


@SHAPES
@pytest.mark.parametrize("with_deg", [True, False], ids=["deg", "counted"])
@pytest.mark.parametrize("shuffled", [False, True], ids=["rows-sorted", "shuffled"])
def test_feast_conv_coo_matches_jax(c_in, c_out, with_deg, shuffled):
    """Host order (rows sorted), and the edges in a random order, as a
    reordered level's lists come (the port sorts them; JAX's default
    `rows_sorted=False` takes any order)."""
    ei, n, n_pad = _graph()
    if shuffled:
        ei = ei[:, np.random.default_rng(7).permutation(ei.shape[1])]
    prm = _feast_params(c_in, c_out, seed=1)
    x = np.zeros((n_pad, c_in), np.float32)
    x[:n] = np.random.default_rng(3).normal(size=(n, c_in))
    deg = np.zeros(n_pad, np.float32)
    np.add.at(deg, ei[0][ei[0] != ei[1]], 1.0)
    tei = torch.from_numpy(ei.astype(np.int64))
    for name, got, want in _both_with_grads(
            lambda p_, x_: jfeast.feast_conv(
                p_, x_, jnp.asarray(ei), deg=jnp.asarray(deg) if with_deg else None),
            lambda p_, x_: tfeast.feast_conv(
                p_, x_, tei, deg=torch.from_numpy(deg) if with_deg else None),
            prm, x, n, seed=4):
        _close(got, want, 1e-5, name)


@SHAPES
def test_feast_conv_dense_reference_matches_jax_and_the_coo_conv(c_in, c_out):
    ei, n, n_pad = _graph(pad=0)
    prm = _feast_params(c_in, c_out, seed=2)
    x = np.random.default_rng(5).normal(size=(n_pad, c_in)).astype(np.float32)
    x[n:] = 0.0
    want = jfeast.feast_conv_dense_reference(
        jfeast.FeastParams(**{k: jnp.asarray(v) for k, v in prm.items()}),
        jnp.asarray(x), jnp.asarray(ei))
    tp = {k: torch.from_numpy(v) for k, v in prm.items()}
    tei = torch.from_numpy(ei.astype(np.int64))
    got = tfeast.feast_conv_dense_reference(tp, torch.from_numpy(x), tei)
    _close(got.numpy(), want, 1e-5, "dense reference")
    _close(tfeast.feast_conv(tp, torch.from_numpy(x), tei).numpy()[:n],
           got.numpy()[:n], 1e-5, "COO conv vs dense reference")


@SHAPES
def test_feast_conv_table_matches_jax(c_in, c_out):
    ei, n, n_pad = _graph()
    nbr, kmask, _ = ttable.neighbor_table_np(ei, n_pad)
    rev, _ = ttable.reverse_table_np(nbr, n_pad)
    prm = _feast_params(c_in, c_out, seed=3)
    x = np.zeros((n_pad, c_in), np.float32)
    x[:n] = np.random.default_rng(6).normal(size=(n, c_in))
    t_nbr, t_rev = (torch.from_numpy(a.astype(np.int64)) for a in (nbr, rev))
    for name, got, want in _both_with_grads(
            lambda p_, x_: jfeast.feast_conv_table(
                p_, x_, jnp.asarray(nbr), jnp.asarray(kmask), jnp.asarray(rev)),
            lambda p_, x_: tfeast.feast_conv_table(
                p_, x_, t_nbr, torch.from_numpy(kmask), t_rev),
            prm, x, n, seed=7):
        _close(got, want, 1e-5, name)


def _hybrid_table_level(tile=32):
    """Slab-RCM ordered icosphere(3) vertex graph at a band ceiling of
    `tile`: the band mask over in-window edges and the compact boundary
    tables for the rest."""
    mesh = synth.add_noise(synth.icosphere(3), 0.2, seed=0)
    ei = graphs.build_vertex_graph_1ring(mesh.ev_indices, mesh.n_vertices)
    n = mesh.n_vertices
    perm, _ = jbanded.order_for_band(ei, n, max_tile=tile, target_tile=tile)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    ei_r = inv[ei.astype(np.int64)].astype(np.int32)
    n_band = round_up(n + 1, tile)
    _, m_b, k_b, r_b, s_b = jbanded.hybrid_widths(ei_r, n_band, tile=tile)
    assert m_b > 0
    arrs = jbanded.hybrid_arrays_np(ei_r, n_band, tile, m_b, k_b, r_b, s_b)
    return arrs, ei_r, n, n_band


def test_table_gather_compact_matches_jax():
    """x[nbr_b] and its gradient, which runs over the compact source list as
    the JAX backward does: every row, the trash row's zero included."""
    arrs, _, n, n_band = _hybrid_table_level()
    rng = np.random.default_rng(8)
    x = rng.normal(size=(n_band, 6)).astype(np.float32)
    g = rng.normal(size=arrs["nbr_b"].shape + (6,)).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    want, vjp = jax.vjp(lambda x_: jtable.table_gather_compact(
        x_, j["nbr_b"], j["src_b"], j["rev_b"]), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = ttable.table_gather_compact(
        tx, *(torch.from_numpy(arrs[k].astype(np.int64)) for k in ("nbr_b", "src_b", "rev_b")))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got_g, = torch.autograd.grad(got, tx, torch.from_numpy(g))
    _close(got_g.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), 1e-6, "gradient")
    assert (got_g[n_band - 1] == 0).all()


@SHAPES
def test_feast_conv_hybrid_tables_matches_jax(c_in, c_out):
    """Band + boundary-table hybrid: forward and gradients, float32."""
    arrs, ei_r, n, n_band = _hybrid_table_level()
    prm = _feast_params(c_in, c_out, seed=4)
    x = np.zeros((n_band, c_in), np.float32)
    x[:n] = np.random.default_rng(9).normal(size=(n, c_in))
    deg = np.zeros(n_band, np.float32)
    np.add.at(deg, ei_r[0], 1.0)
    order = ("m", "rows_b", "nbr_b", "kmask_b", "src_b", "rev_b")
    j = [jnp.asarray(arrs[k]) for k in order]
    t = [torch.from_numpy(arrs[k].astype(np.int64) if arrs[k].dtype == np.int32
                          else arrs[k]) for k in order]
    for name, got, want in _both_with_grads(
            lambda p_, x_: banded_pallas.feast_conv_hybrid(
                p_, x_, *j, jnp.asarray(deg), compute_dtype=jnp.float32),
            lambda p_, x_: banded_cuda.feast_conv_hybrid(
                p_, x_, *t, torch.from_numpy(deg), compute_dtype=torch.float32),
            prm, x, n, seed=10):
        _close(got, want, 1e-5, name)


# --------------------------------------------------------------------------
# the model over levels without a band
# --------------------------------------------------------------------------

def _sample(builder_mod, synth_mod, reorder, tables):
    m_n = synth_mod.add_noise(synth_mod.icosphere(2), 0.2, seed=1)
    bc = builder_mod.BuildConfig(granularity=64, reorder=reorder)
    s, _ = builder_mod.build_dual_sample(m_n, None, bc)
    if not tables:
        return s
    bv, bf, meta = builder_mod.build_raw(m_n, None, bc)
    w = builder_mod.widths_for(bv, bf, meta["fv_indices"], with_bands=reorder)
    return builder_mod.attach_tables(s, w)


@pytest.mark.parametrize("tables", [True, False], ids=["tables", "coo"])
def test_dual_gnn_without_bands_matches_jax(tables):
    """Config(reorder=False): every level takes the dense-table conv and the
    member-table pooling; a sample without tables takes the COO conv and
    segment pooling."""
    s_j = _sample(jbuilder, synth, False, tables)
    s_t = _sample(tbuilder, tsynth, False, tables)
    for lvl in s_t.v.levels + s_t.f.levels:
        assert lvl.band is None and (lvl.nbr is not None) == tables
    assert all((st.members is not None) == tables for st in s_t.v.steps + s_t.f.steps)

    model = DualGNN(fc_dtype=torch.bfloat16, device="cpu", seed=3)
    with torch.no_grad():
        v_t, n_t = model(s_t.to("cpu"))
    jparams = tparams.to_jax_params(model.state_dict())
    v_j, n_j = jax.jit(JDualGNN(fc_dtype=jnp.bfloat16).apply)(jparams, s_j)
    nv = int(s_t.v.levels[0].node_mask.sum())
    nf = int(s_t.f.levels[0].node_mask.sum())
    v_t, n_t = v_t.numpy()[:nv], n_t.numpy()[:nf]
    assert np.isfinite(v_t).all() and np.isfinite(n_t).all()
    np.testing.assert_allclose(v_t, np.asarray(v_j)[:nv], rtol=0, atol=2e-2)
    np.testing.assert_allclose(n_t, np.asarray(n_j)[:nf], rtol=0, atol=5e-2)
