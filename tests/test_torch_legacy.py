"""The legacy model family — ops/gcn.py, ops/gat.py and models/legacy.py —
against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
weights are the port's seeded init carried into the flax tree by
params.py.  The convs are float32 math summed in another order: forward
and every gradient within 1e-5 of the largest magnitude of the tensor
compared.  The four models run on the facet branch of a banded
icosphere(2) sample (BuildConfig(granularity=64), the bands attached as in
tests/test_torch_model.py) with the input slices of
tests/test_legacy_models.py.  The FeaStConv U-Nets run the banded
aggregate (Pallas in interpret mode against the port's plain version):
  * forward in the defaults (bf16 aggregate operands): unit normals within
    5e-2, as tests/test_torch_model.py;
  * every parameter gradient of the summed squared error with the
    aggregates in float32 compute in both packages: 1e-4 of each tensor's
    max|g|, or, for a tensor whose float32 sum cancels (the port's own
    float32 gradient further than that from its float64 one), three times
    that own distance (FacetAttentionGNN's a2.bias, one scalar summed over
    every row: 2.7e-3 apart, the port's float32 1.8e-3 from float64).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu import graphs as jgraphs
from geobignn_tpu import native as jnative
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.models import legacy as jlegacy
from geobignn_tpu.ops import banded_pallas
from geobignn_tpu.ops import gat as jgat
from geobignn_tpu.ops import gcn as jgcn
from geobignn_tpu_torch import params as pm
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.data import builder, synth
from geobignn_tpu_torch.models import legacy
from geobignn_tpu_torch.ops import gat, gcn

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores

MODELS = {  # (port class, JAX class, input channels of the facet features)
    "FacetAttentionGNN": (legacy.FacetAttentionGNN, jlegacy.FacetAttentionGNN, slice(3, 6)),
    "FGCNet": (legacy.FGCNet, jlegacy.FGCNet, slice(0, 6)),
    "FeaStGNNPrePool": (legacy.FeaStGNNPrePool, jlegacy.FeaStGNNPrePool, slice(0, 6)),
    "GATGNN": (legacy.GATGNN, jlegacy.GATGNN, slice(0, 6)),
}


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    testing.match_reference_native(jnative)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.fixture(scope="module")
def graph():
    """A padded edge list (trash row last, padded edges trash -> trash) of
    the noisy icosphere(2)'s vertex graph, and seeded features."""
    m = jsynth.add_noise(jsynth.icosphere(2), 0.2, seed=0)
    ei = np.asarray(jgraphs.build_vertex_graph_1ring(m.ev_indices, m.n_vertices))
    n = m.n_vertices + 6  # 5 padded rows and the trash row
    pad = np.full((2, 40), n - 1, ei.dtype)
    ei = np.concatenate([ei, pad], axis=1).astype(np.int32)
    x = np.random.default_rng(0).normal(size=(n, 5)).astype(np.float32)
    x[m.n_vertices:] = 0.0
    return ei, x


def test_gcn_conv_matches_jax(graph):
    ei, x = graph
    rng = np.random.default_rng(1)
    w = rng.normal(size=(5, 7)).astype(np.float32)
    b = rng.normal(size=7).astype(np.float32)
    gout = rng.normal(size=(x.shape[0], 7)).astype(np.float32)

    def jf(w_, b_, x_):
        return (jgcn.gcn_conv(jgcn.GCNParams(w_, b_), x_, jnp.asarray(ei)) * gout).sum()

    want = jgcn.gcn_conv(jgcn.GCNParams(jnp.asarray(w), jnp.asarray(b)), jnp.asarray(x),
                         jnp.asarray(ei))
    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    tw, tb, tx = (torch.tensor(a, requires_grad=True) for a in (w, b, x))
    out = gcn.gcn_conv(tw, tb, tx, torch.from_numpy(ei).long())
    (out * torch.from_numpy(gout)).sum().backward()
    assert _rel(out.detach(), want) <= 1e-5
    for t, g in zip((tw, tb, tx), jg):
        assert _rel(t.grad, g) <= 1e-5


def test_segment_softmax_matches_jax():
    """Sums to one per segment; an empty segment and a segment of -inf
    scores (its max zeroed, as jnp.isneginf) both as JAX; the gradient."""
    rng = np.random.default_rng(2)
    ids = np.array([0, 0, 0, 2, 2, 3, 3, 3, 3, 5], np.int32)  # 1 and 4 empty
    s = rng.normal(size=(10, 3)).astype(np.float32)
    s[5:9, 1] = -np.inf  # segment 3's column 1: all -inf
    gout = rng.normal(size=(10, 3)).astype(np.float32)
    want = jgat.segment_softmax(jnp.asarray(s), jnp.asarray(ids), 6)
    jg = jax.grad(lambda v: jnp.where(jnp.isfinite(want),
                                      jgat.segment_softmax(v, jnp.asarray(ids), 6) * gout,
                                      0.0).sum())(jnp.asarray(s))
    ts = torch.tensor(s, requires_grad=True)
    got = gat.segment_softmax(ts, torch.from_numpy(ids).long(), 6)
    np.testing.assert_array_equal(np.isnan(got.detach().numpy()), np.isnan(np.asarray(want)))
    fin = np.isfinite(np.asarray(want))
    torch.where(torch.from_numpy(fin), got * torch.from_numpy(gout), 0.0).sum().backward()
    assert _rel(got.detach().numpy()[fin], np.asarray(want)[fin]) <= 1e-6
    assert _rel(ts.grad, jg) <= 1e-5
    sums = np.zeros((6, 3))
    np.add.at(sums, ids, np.where(fin, got.detach().numpy(), 0.0))
    np.testing.assert_allclose(sums[[0, 2, 5]], 1.0, atol=1e-6)


def test_gat_conv_matches_jax(graph):
    ei, x = graph
    rng = np.random.default_rng(3)
    heads, c_out = 2, 4
    arrs = [rng.normal(size=sh).astype(np.float32) * 0.5 for sh in
            ((5, heads, c_out), (heads, c_out), (heads, c_out), (heads * c_out,))]
    gout = rng.normal(size=(x.shape[0], heads * c_out)).astype(np.float32)

    def jf(*a):
        return (jgat.gat_conv(jgat.GATParams(*a[:4]), a[4], jnp.asarray(ei)) * gout).sum()

    jargs = [jnp.asarray(a) for a in arrs + [x]]
    want = jgat.gat_conv(jgat.GATParams(*jargs[:4]), jargs[4], jnp.asarray(ei))
    jg = jax.grad(jf, argnums=tuple(range(5)))(*jargs)
    targs = [torch.tensor(a, requires_grad=True) for a in arrs + [x]]
    out = gat.gat_conv(*targs, torch.from_numpy(ei).long())
    (out * torch.from_numpy(gout)).sum().backward()
    assert _rel(out.detach(), want) <= 1e-5
    for t, g in zip(targs, jg):
        assert _rel(t.grad, g) <= 1e-5


def _branch(builder_mod, synth_mod):
    m_o = synth_mod.icosphere(2)
    m_n = synth_mod.add_noise(m_o, 0.2, seed=1)
    bc = builder_mod.BuildConfig(granularity=64, reorder=True)
    bv, bf, meta = builder_mod.build_raw(m_n, m_o, bc)
    s, _ = builder_mod.build_dual_sample(m_n, m_o, bc)
    w = builder_mod.widths_for(bv, bf, meta["fv_indices"], with_bands=True)
    return builder_mod.attach_tables(s, w).f


@pytest.fixture(scope="module")
def branches():
    return _branch(jbuilder, jsynth), _branch(builder, synth).to("cpu")


@pytest.mark.parametrize("name", list(MODELS))
def test_legacy_model_matches_jax(branches, name, monkeypatch):
    """Forward (bf16 aggregate operands) and every parameter gradient
    (float32 aggregates) against the JAX model with the same weights."""
    jb, tb = branches
    assert all(lvl.band is not None for lvl in tb.levels)
    cls, jcls, sl = MODELS[name]
    model = cls(device="cpu", seed=7)
    x = tb.x[:, sl]
    jx = jnp.asarray(np.asarray(jb.x)[:, sl])
    params = pm.to_jax_params(model.state_dict())
    jmodel = jcls()
    assert jax.tree.structure(params) == jax.tree.structure(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jb, jx))
    with torch.no_grad():
        out = model(tb, x)
    want = np.asarray(jax.jit(jmodel.apply)(params, jb, jx))
    n = int(tb.levels[0].node_mask.sum())
    assert np.isfinite(out.numpy()).all()
    assert np.abs(out.numpy()[:n] - want[:n]).max() <= 5e-2

    j_agg = banded_pallas.banded_aggregate
    monkeypatch.setattr(banded_pallas, "banded_aggregate",
                        lambda r, p, x_, w, m, compute_dtype=None, vma=None:
                        j_agg(r, p, x_, w, m, jnp.float32, vma))
    y = np.asarray(jb.y)
    with jax.default_matmul_precision("float32"):
        jg = jax.jit(jax.grad(lambda p: ((jmodel.apply(p, jb, jx) - y) ** 2).sum()))(params)
    grads = {}
    for dt in (torch.float32, torch.float64):
        m = cls(device="cpu").to(dt)
        m.load_state_dict(model.state_dict())
        b = testing.float64_sample(tb) if dt == torch.float64 else tb
        with testing.aggregates_in(dt):
            ((m(b, b.x[:, sl]) - b.y) ** 2).sum().backward()
        grads[dt] = {k: p.grad for k, p in m.named_parameters()}
    jg = pm.from_jax_params(jax.tree.map(np.asarray, jg))
    assert set(jg) == set(grads[torch.float32])
    for k, g in grads[torch.float32].items():
        # a tensor summed over every row with cancellation (FacetAttentionGNN's
        # a2.bias, one scalar) is as far from float64 in float32 as the two
        # packages are apart: its bound is three times the port's own distance
        own = _rel(g, grads[torch.float64][k])
        assert _rel(g, jg[k]) <= max(1e-4, 3 * own), (k, _rel(g, jg[k]), own)
