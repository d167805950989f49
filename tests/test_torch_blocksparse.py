"""The port's block-sparse FeaStConv (plain versions of TPU kernels #5 and
#6, the conv and the model that dispatches to it) against the JAX package
on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_blocksparse.py runs them; jax.vjp goes through their custom VJP.
Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each relative to the largest magnitude of the tensor compared:
  * compute dtype float32: 1e-5 — the same float32 math, summed in another
    order;
  * bfloat16: 2e-2 — the casts sit at the same points, but a value summed in
    another order can round to the neighbouring bf16 value (2^-8 relative)
    in either package, and the cotangents go through two such roundings.
The model comparisons use the tolerances of tests/test_torch_model.py and
tests/test_torch_grads.py.  The CUDA kernels are held against the same plain
versions on the card (chip_smoke.py and tests/test_torch_cuda.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu import geometry as jgeometry
from geobignn_tpu import graphs
from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import synth
from geobignn_tpu.infer.predict import Predictor as JPredictor
from geobignn_tpu.models import DualGNN as JDualGNN
from geobignn_tpu.ops import banded as jbanded
from geobignn_tpu.ops import banded_pallas
from geobignn_tpu.ops import blocksparse as jbs
from geobignn_tpu.ops.feastconv import FeastParams
from geobignn_tpu.train import trainer as jtrainer
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import builder as tbuilder
from geobignn_tpu_torch.data import synth as tsynth
from geobignn_tpu_torch.infer import predict as tpredict
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.ops import banded as tbanded
from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.ops import blocksparse as tbs
from geobignn_tpu_torch.structs import GraphLevel, round_up
from geobignn_tpu_torch.train.trainer import _metrics_of
from geobignn_tpu import native as jnative
from geobignn_tpu_torch import testing

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (C_in, C_out, heads): aggregate-first (wider, equal) and transform-first
SHAPES = pytest.mark.parametrize(
    "c_in,c_out,heads", [(6, 8, 9), (8, 8, 3), (16, 5, 9), (7, 4, 2)],
    ids=["widen-h9", "equal-h3", "narrow-h9", "narrow-h2"])
DTYPES = pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} > {rel} x {scale:.3e}"


def _rcm_graph(subdiv=2, tile=32):
    """RCM-ordered, trash-padded vertex graph of an icosphere."""
    m = synth.icosphere(subdiv)
    ei = graphs.build_vertex_graph_1ring(m.ev_indices, m.n_vertices)
    n = m.n_vertices
    perm = jbanded.rcm_order(ei.astype(np.int64), n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    ei = inv[ei]
    n_pad = round_up(n + 1, tile)
    ei_pad = np.full((2, ei.shape[1] + 8), n_pad - 1, np.int32)
    ei_pad[:, : ei.shape[1]] = ei
    return ei_pad, n, n_pad


def _inputs(n_pad, n, c_in, c_out, heads, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((n_pad, c_in), np.float32)
    x[:n] = rng.normal(size=(n, c_in))
    a = x @ (rng.normal(size=(c_in, heads)) * 0.5).astype(np.float32)
    c = (rng.normal(size=heads) * 0.3).astype(np.float32)
    p = np.exp(a - a.max(1, keepdims=True)).astype(np.float32)
    ca = c - a
    r = np.exp(ca - ca.max(1, keepdims=True)).astype(np.float32)
    w = (rng.normal(size=(heads, c_in, c_out)) * 0.4).astype(np.float32)
    gout = rng.normal(size=(n_pad, c_out)).astype(np.float32)
    gout[n:] = 0.0
    return r, p, x, w, gout


def _t(blk_idx):
    """blk_idx as the port takes it: int64, as structs.to(device) makes it."""
    return torch.from_numpy(blk_idx.astype(np.int64))


# --------------------------------------------------------------------------
# host builders
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tile,k_extra", [(32, 0), (32, 3), (8, 0), (64, 1)])
def test_host_builders_bit_equal(tile, k_extra):
    """block_sparse_np / blocks_needed against the JAX package's, also with
    k_pad larger than needed (padded slots repeat the own block, zero mask)."""
    ei, n, n_pad = _rcm_graph(subdiv=3, tile=tile)
    k = jbs.blocks_needed(ei, n_pad, tile)
    assert tbs.blocks_needed(ei, n_pad, tile) == k
    want = jbs.block_sparse_np(ei, n_pad, tile, k_pad=k + k_extra)
    got = tbs.block_sparse_np(ei, n_pad, tile, k_pad=k + k_extra)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert got[2] == want[2] == k
    blk_idx, mask = got[:2]
    assert blk_idx.dtype == np.int32 and mask.shape == (n_pad // tile, tile, (k + k_extra) * tile)
    if k_extra:  # the padded slots: own block, all-zero mask
        own = np.arange(n_pad // tile)[:, None]
        assert np.array_equal(blk_idx[:, k:], np.broadcast_to(own, (n_pad // tile, k_extra)))
        assert not mask[:, :, k * tile:].any()
    with pytest.raises(ValueError, match="column blocks"):
        tbs.block_sparse_np(ei, n_pad, tile, k_pad=k - 1)


def test_blk_idx_is_int64_on_tensors_and_checked():
    """blk_idx is int32 from the host builder and int64 on every torch
    tensor (structs.to widens index arrays; the kernels read 64-bit): an
    int32 tensor raises instead of being reinterpreted."""
    ei, n, n_pad = _rcm_graph()
    blk_idx, mask, _ = tbs.block_sparse_np(ei, n_pad, 32)
    z = np.zeros(n_pad, np.float32)
    lvl = GraphLevel(edge_index=ei, edge_weight=np.zeros(ei.shape[1], np.float32),
                     deg=z, node_mask=z, band=mask, blk_idx=blk_idx).to("cpu")
    assert lvl.blk_idx.dtype == torch.int64 and lvl.band.dtype == torch.int8
    r, p, x, w, _ = (torch.from_numpy(a) for a in _inputs(n_pad, n, 6, 8, 3, seed=0))
    tbs.bs_aggregate(r, p, x, w, lvl.band, lvl.blk_idx)
    with pytest.raises(TypeError, match="int64"):
        tbs.bs_aggregate(r, p, x, w, lvl.band, torch.from_numpy(blk_idx))


# --------------------------------------------------------------------------
# the aggregate: forward and backward against the Pallas kernels
# --------------------------------------------------------------------------

@SHAPES
@DTYPES
@pytest.mark.parametrize("k_extra", [0, 2], ids=["k-needed", "k-padded"])
def test_plain_fwd_and_bwd_match_jax(c_in, c_out, heads, dtype_name, k_extra):
    """The plain forward against bs_aggregate (interpret mode) and all four
    cotangents of the plain backward against its jax.vjp; a padded list makes
    one column block stand twice in a row block's window."""
    ei, n, n_pad = _rcm_graph()
    k = tbs.blocks_needed(ei, n_pad, 32)
    blk_idx, m, _ = tbs.block_sparse_np(ei, n_pad, 32, k_pad=k + k_extra)
    r, p, x, w, gout = _inputs(n_pad, n, c_in, c_out, heads, seed=c_in + heads)
    want, vjp = jax.vjp(
        lambda r_, p_, x_, w_: jbs.bs_aggregate(
            r_, p_, x_, w_, jnp.asarray(m), jnp.asarray(blk_idx),
            getattr(jnp, dtype_name)),
        *(jnp.asarray(a) for a in (r, p, x, w)))
    want_bar = vjp(jnp.asarray(gout))
    cd = getattr(torch, dtype_name)
    tr, tp, tx, tw, tg = (torch.from_numpy(a) for a in (r, p, x, w, gout))
    tm, tb = torch.from_numpy(m), _t(blk_idx)
    got = tbs.bs_aggregate(tr, tp, tx, tw, tm, tb, cd)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, TOL[dtype_name], "forward")
    got_bar = tbs.bs_aggregate_bwd(tr, tp, tx, tw, tm, tb, tg, compute_dtype=cd)
    for name, g, j in zip(("r", "p", "x", "w"), got_bar, want_bar):
        _close(g.numpy(), j, TOL[dtype_name], f"{name} cotangent")


@pytest.mark.parametrize("c_in,c_out", [(6, 8), (16, 5)],
                         ids=["aggregate_first", "transform_first"])
def test_plain_bwd_matches_autograd_in_float32(c_in, c_out):
    """Independent check: in float32 compute the plain backward is the
    gradient of the plain forward."""
    ei, n, n_pad = _rcm_graph()
    blk_idx, m, _ = tbs.block_sparse_np(ei, n_pad, 32)
    r, p, x, w, gout = _inputs(n_pad, n, c_in, c_out, 9, seed=7)
    prim = [torch.from_numpy(a).requires_grad_() for a in (r, p, x, w)]
    out = tbs.bs_aggregate_plain(*prim, torch.from_numpy(m), _t(blk_idx), torch.float32)
    want = torch.autograd.grad(out, prim, torch.from_numpy(gout))
    got = tbs.bs_aggregate_bwd_plain(
        *prim, torch.from_numpy(m), _t(blk_idx), torch.from_numpy(gout), torch.float32)
    for name, g, a in zip(("r", "p", "x", "w"), got, want):
        _close(g.detach().numpy(), a.numpy(), 1e-5, f"{name} cotangent")


@pytest.mark.parametrize("c_in,c_out", [(6, 8), (16, 5)],
                         ids=["aggregate_first", "transform_first"])
def test_clamp_and_its_subgradient_match_jax(c_in, c_out):
    """Rows whose D = r.p falls under the 1e-12 clamp: the forward divides
    by the clamp and the backward's denominator path is cut there
    (`d > 1e-12`), in both packages."""
    ei, n, n_pad = _rcm_graph()
    blk_idx, m, _ = tbs.block_sparse_np(ei, n_pad, 32)
    r, p, x, w, gout = _inputs(n_pad, n, c_in, c_out, 9, seed=3)
    r[::3] *= 1e-16  # D of every third row lies far under the clamp
    d = (r[:, None, :] * p[None, :, :]).sum(-1)
    assert (d[::3] < 1e-12).all() and (d[1::3] > 1e-12).any()
    want, vjp = jax.vjp(
        lambda r_, p_, x_, w_: jbs.bs_aggregate(
            r_, p_, x_, w_, jnp.asarray(m), jnp.asarray(blk_idx), jnp.float32),
        *(jnp.asarray(a) for a in (r, p, x, w)))
    want_bar = vjp(jnp.asarray(gout))
    args = [torch.from_numpy(a) for a in (r, p, x, w)] + [torch.from_numpy(m), _t(blk_idx)]
    _close(tbs.bs_aggregate_plain(*args, torch.float32).numpy(), want, 1e-5, "forward")
    got_bar = tbs.bs_aggregate_bwd_plain(*args, torch.from_numpy(gout), torch.float32)
    for name, g, j in zip(("r", "p", "x", "w"), got_bar, want_bar):
        _close(g.numpy(), j, 1e-5, f"{name} cotangent")


@pytest.mark.parametrize("c_in,c_out", [(6, 8), (16, 5)],
                         ids=["aggregate_first", "transform_first"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64], ids=str)
def test_cotangents_in_primal_dtypes(c_in, c_out, dtype):
    """The autograd Function returns each cotangent in its primal's dtype
    (`_bs_bwd` does the same); the mask and blk_idx get none."""
    ei, n, n_pad = _rcm_graph()
    blk_idx, m, _ = tbs.block_sparse_np(ei, n_pad, 32)
    r, p, x, w, _ = _inputs(n_pad, n, c_in, c_out, 9, seed=2)
    prim = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (r, p, x, w)]
    out = tbs.bs_aggregate(*prim, torch.from_numpy(m), _t(blk_idx))
    out.sum().backward()
    for t in prim:
        assert t.grad is not None and t.grad.dtype == dtype
        assert torch.isfinite(t.grad).all()


def test_cpu_gradient_is_the_plain_backward():
    """On CPU tensors the aggregate's gradient comes from the plain backward
    through the one autograd Function, not from autograd through the
    forward's bf16 casts (which would round the incoming gradient)."""
    ei, n, n_pad = _rcm_graph()
    blk_idx, m, _ = tbs.block_sparse_np(ei, n_pad, 32)
    r, p, x, w, gout = _inputs(n_pad, n, 6, 8, 9, seed=4)
    prim = [torch.from_numpy(a).requires_grad_() for a in (r, p, x, w)]
    out = tbs.bs_aggregate(*prim, torch.from_numpy(m), _t(blk_idx))
    assert out.grad_fn.name() == "_BlockSparseAggregateBackward"
    got = torch.autograd.grad(out, prim, torch.from_numpy(gout))
    want = tbs.bs_aggregate_bwd_plain(
        *(t.detach() for t in prim), torch.from_numpy(m), _t(blk_idx),
        torch.from_numpy(gout))
    for g, a in zip(got, want):
        assert torch.equal(g, a)


def test_no_launch_is_counted_on_the_cpu():
    ei, n, n_pad = _rcm_graph()
    blk_idx, m, _ = tbs.block_sparse_np(ei, n_pad, 32)
    r, p, x, w, _ = (torch.from_numpy(a) for a in _inputs(n_pad, n, 6, 8, 9, seed=1))
    before = dict(banded_cuda.LAUNCHES)
    assert {"bs_aggregate_first", "bs_transform_first", "bs_aggregate_first_bwd",
            "bs_transform_first_bwd"} <= set(before)
    tbs.bs_aggregate(r, p, x.requires_grad_(), w, torch.from_numpy(m), _t(blk_idx)).sum().backward()
    assert banded_cuda.LAUNCHES == before


# --------------------------------------------------------------------------
# the conv
# --------------------------------------------------------------------------

def _feast_params(c_in, c_out, heads, seed):
    rng = np.random.default_rng(seed)
    return dict(
        u=(rng.normal(size=(c_in, heads)) * 0.5).astype(np.float32),
        c=(rng.normal(size=heads) * 0.3).astype(np.float32),
        w=(rng.normal(size=(heads, c_in, c_out)) * 0.4).astype(np.float32),
        b=rng.normal(size=c_out).astype(np.float32),
    )


@SHAPES
@DTYPES
def test_feast_conv_blocksparse_matches_jax(c_in, c_out, heads, dtype_name):
    """Forward and the gradients over (u, c, w, b, x) of sum(conv(x) * g)."""
    ei, n, n_pad = _rcm_graph()
    blk_idx, m, _ = tbs.block_sparse_np(ei, n_pad, 32, k_pad=4)
    prm = _feast_params(c_in, c_out, heads, seed=11)
    rng = np.random.default_rng(5)
    x = np.zeros((n_pad, c_in), np.float32)
    x[:n] = rng.normal(size=(n, c_in))
    deg = np.zeros(n_pad, np.float32)
    np.add.at(deg, ei[0][ei[0] != ei[1]], 1.0)
    g = rng.normal(size=(n_pad, c_out)).astype(np.float32)
    g[n:] = 0.0
    keys = ("u", "c", "w", "b")

    def jconv(u, c, w, b, x_):
        return jbs.feast_conv_blocksparse(
            FeastParams(u=u, c=c, w=w, b=b), x_, jnp.asarray(m), jnp.asarray(blk_idx),
            jnp.asarray(deg), compute_dtype=getattr(jnp, dtype_name))

    jargs = [jnp.asarray(prm[k]) for k in keys] + [jnp.asarray(x)]
    want = jconv(*jargs)
    want_g = jax.grad(lambda *a: (jconv(*a) * g).sum(), argnums=(0, 1, 2, 3, 4))(*jargs)

    tp = {k: torch.from_numpy(prm[k]).requires_grad_() for k in keys}
    tx = torch.from_numpy(x).requires_grad_()
    got = tbs.feast_conv_blocksparse(
        tp, tx, torch.from_numpy(m), _t(blk_idx), torch.from_numpy(deg),
        compute_dtype=getattr(torch, dtype_name))
    _close(got.detach().numpy()[:n], np.asarray(want)[:n], TOL[dtype_name], "forward")
    got_g = torch.autograd.grad((got * torch.from_numpy(g)).sum(),
                                [tp[k] for k in keys] + [tx])
    for name, a, b in zip(keys + ("x",), got_g, want_g):
        a, b = a.numpy(), np.asarray(b)
        if name == "x":
            a, b = a[:n], b[:n]
        _close(a, b, TOL[dtype_name], f"d/d{name}")


def test_feast_conv_blocksparse_matches_the_banded_conv():
    """On a graph both can serve, the block-sparse conv equals the port's
    own banded conv (float32 compute, 1e-5)."""
    ei, n, n_pad = _rcm_graph(subdiv=3, tile=64)
    band = tbanded.band_mask_np(ei, n_pad, 64)
    blk_idx, m, _ = tbs.block_sparse_np(ei, n_pad, 64, k_pad=5)
    prm = {k: torch.from_numpy(v) for k, v in _feast_params(6, 8, 9, seed=1).items()}
    x = np.zeros((n_pad, 6), np.float32)
    x[:n] = np.random.default_rng(2).normal(size=(n, 6))
    deg = np.zeros(n_pad, np.float32)
    np.add.at(deg, ei[0][ei[0] != ei[1]], 1.0)
    tx, td = torch.from_numpy(x), torch.from_numpy(deg)
    want = banded_cuda.feast_conv_banded_kernel(
        prm, tx, torch.from_numpy(band), td, compute_dtype=torch.float32)
    got = tbs.feast_conv_blocksparse(
        prm, tx, torch.from_numpy(m), _t(blk_idx), td, compute_dtype=torch.float32)
    _close(got.numpy()[:n], want.numpy()[:n], 1e-5, "block-sparse vs banded")


# --------------------------------------------------------------------------
# the slice as a whole: the model and the predictor
# --------------------------------------------------------------------------

def _bs_sample(builder_mod, synth_mod, clean: bool):
    """icosphere(3) with both branches' finest level forced onto the
    block-sparse path by dropping its band tile (what TableWidths.merge
    does when two samples disagree on it)."""
    m_o = synth_mod.icosphere(3)
    m_n = synth_mod.add_noise(m_o, 0.3, seed=1)
    bc = builder_mod.BuildConfig(granularity=64, reorder=True)
    bv, bf, meta = builder_mod.build_raw(m_n, m_o if clean else None, bc)
    s, _ = builder_mod.build_dual_sample(m_n, m_o if clean else None, bc)
    w = builder_mod.widths_for(bv, bf, meta["fv_indices"], with_bands=True)
    w = dataclasses.replace(w, tile_v=(0,) + w.tile_v[1:], tile_f=(0,) + w.tile_f[1:])
    return builder_mod.attach_tables(s, w)


@pytest.fixture
def bs_tile_64(monkeypatch):
    """Row blocks of 64 in both packages, so the small mesh has several."""
    monkeypatch.setenv("GBN_BS_TILE", "64")
    monkeypatch.setattr(tbs, "BS_TILE", 64)


def test_dual_gnn_blocksparse_levels_match_jax(bs_tile_64):
    """Forward of the DualGNN with block-sparse finest levels (bf16
    aggregate operands and heads, the Config defaults): positions within
    2e-2, unit normals within 5e-2, as tests/test_torch_model.py."""
    s_j = _bs_sample(jbuilder, synth, clean=False)
    s_t = _bs_sample(tbuilder, tsynth, clean=False)
    for a, b in ((s_j.v.levels[0], s_t.v.levels[0]), (s_j.f.levels[0], s_t.f.levels[0])):
        assert b.blk_idx is not None and b.band.shape[1] == 64
        assert np.array_equal(np.asarray(a.blk_idx), b.blk_idx)
        assert np.array_equal(np.asarray(a.band), b.band)
    assert all(lvl.blk_idx is None for lvl in s_t.v.levels[1:] + s_t.f.levels[1:])

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


def test_dual_gnn_blocksparse_grads_match_jax(bs_tile_64, monkeypatch):
    """The training loss and every parameter gradient with block-sparse
    finest levels, all aggregates and heads in float32: the loss within 1e-5
    relative, every gradient within 1e-4 of its max|g|, as
    tests/test_torch_grads.py."""
    j_band, t_band = banded_pallas.banded_aggregate, banded_cuda.banded_aggregate
    j_bs, t_bs = jbs.bs_aggregate, tbs.bs_aggregate
    monkeypatch.setattr(banded_pallas, "banded_aggregate",
                        lambda r, p, x, w, m, compute_dtype=None, vma=None:
                        j_band(r, p, x, w, m, jnp.float32, vma))
    monkeypatch.setattr(banded_cuda, "banded_aggregate",
                        lambda r, p, x, w, m, compute_dtype=None:
                        t_band(r, p, x, w, m, torch.float32))
    monkeypatch.setattr(jbs, "bs_aggregate",
                        lambda r, p, x, w, m, i, compute_dtype=None:
                        j_bs(r, p, x, w, m, i, jnp.float32))
    monkeypatch.setattr(tbs, "bs_aggregate",
                        lambda r, p, x, w, m, i, compute_dtype=None:
                        t_bs(r, p, x, w, m, i, torch.float32))
    s_j = _bs_sample(jbuilder, synth, clean=True)
    s_t = _bs_sample(tbuilder, tsynth, clean=True).to("cpu")
    assert s_t.f.levels[0].blk_idx is not None

    model = DualGNN(fc_dtype=None, device="cpu", seed=5)
    loss_t, _ = _metrics_of(*model(s_t), s_t, Config())
    loss_t.backward()
    jmodel = JDualGNN(fc_dtype=None)

    def jloss(p):
        return jtrainer._metrics_of(*jmodel.apply(p, s_j), s_j, JConfig())[0]

    with jax.default_matmul_precision("float32"):
        loss_j, g_j = jax.jit(jax.value_and_grad(jloss))(
            tparams.to_jax_params(model.state_dict()))
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    g_j = {k: v.numpy() for k, v in
           tparams.from_jax_params(jax.tree.map(np.asarray, g_j)).items()}
    g_t = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(g_t) == set(g_j)
    err = {k: float(np.abs(g_t[k] - g_j[k]).max()) / max(float(np.abs(g_j[k]).max()), 1e-30)
           for k in g_t}
    assert max(err.values()) <= 1e-4, sorted(err.items(), key=lambda kv: -kv[1])[:5]


def test_predictor_denoises_a_mesh_whose_patches_disagree_on_a_band(monkeypatch):
    """The merge drop itself: the three patches of this mesh have facet
    bandwidths 129, 123 and 128, so under a band ceiling of 128 one cannot
    band the finest facet level while the others can, TableWidths.merge
    drops the band for all, and every patch takes the block-sparse path.
    The port's Predictor used to raise NotImplementedError here; now it
    agrees with the JAX Predictor (positions within 1e-2 of the mean edge
    length, normals within 5e-2, as tests/test_torch_predict.py)."""
    monkeypatch.setattr(jbanded, "MAX_BAND_TILE", 128)
    monkeypatch.setattr(tbanded, "MAX_BAND_TILE", 128)
    mesh = synth.add_noise(synth.icosphere(4), 0.2, seed=1)
    state = DualGNN(fc_dtype=torch.bfloat16, device="cpu", seed=1).state_dict()
    pred = tpredict.Predictor(Config(), state, sub_size=3500, device="cpu")
    mem = pred.patch_dataset(mesh)
    assert len(mem.entries) == 3
    tiles = [tbuilder.widths_for(bv, bf, meta["fv_indices"], with_bands=True).tile_f[0]
             for bv, bf, meta, _, _ in mem.entries]
    assert sorted(map(bool, tiles)) == [False, True, True], tiles
    assert mem.widths.tile_f[0] == 0 and mem.widths.bsk_f[0] > 0
    for i in range(3):
        lvl = mem.get(i).f.levels[0]
        assert lvl.blk_idx is not None and lvl.band.shape[1] == tbs.bs_tile()

    v_d, n_d = pred.denoise(mesh, n_update_iters=3)
    assert v_d.shape == (mesh.n_vertices, 3) and n_d.shape == (mesh.n_faces, 3)
    assert np.isfinite(v_d).all() and np.isfinite(n_d).all()

    vp, npr = pred.predict_mesh(mesh)
    jpred = JPredictor(JConfig(), tparams.to_jax_params(state), sub_size=3500)
    vj, nj = jpred.predict_mesh(mesh)
    mel = jgeometry.mean_edge_length_np(mesh.points, mesh.ev_indices)
    np.testing.assert_allclose(vp, vj, rtol=0, atol=1e-2 * mel)
    np.testing.assert_allclose(npr, nj, rtol=0, atol=5e-2)
    np.testing.assert_array_equal(n_d, npr)
