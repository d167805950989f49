"""Rematerialization in the port's DualGNN, as the JAX module has it: the fc
heads run rematerialized and, above `fc_chunk_rows` rows, in row chunks
(`run_head`, geobignn_tpu/models/dual_gnn.py:261-284); the convs of levels
without a band run rematerialized (`jax.checkpoint`, :141-145); the banded
and block-sparse aggregates are left as they are.

Bounds.  Rows are independent and the recomputation repeats the forward, so
outputs and every gradient upstream of the heads are bit-equal on one torch
thread; the fc parameters' gradients are sums over rows taken chunk by
chunk, so they move within 1e-5 of their max|g| (float32).  Against the JAX
package: test_torch_grads.py's float32 bounds (loss 1e-5 relative, every
gradient 1e-4 of its max|g|).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.models import DualGNN as JDualGNN
from geobignn_tpu.ops import banded_pallas
from geobignn_tpu.train import trainer as jtrainer
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import builder, synth
from geobignn_tpu_torch.models import dual_gnn
from geobignn_tpu_torch.models.dual_gnn import DualGNN, head_chunks
from geobignn_tpu_torch.testing import aggregates_in, without_remat
from geobignn_tpu_torch.train.trainer import _metrics_of
from geobignn_tpu import native as jnative
from geobignn_tpu_torch import testing

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


@pytest.fixture(autouse=True)
def one_thread():
    """torch's CPU kernels are bit-repeatable on one thread only."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sample(builder_mod, synth_mod, reorder=True, sub=3):
    m_o = synth_mod.icosphere(sub)
    m_n = synth_mod.add_noise(m_o, 0.3, seed=1)
    bc = builder_mod.BuildConfig(granularity=64, reorder=reorder)
    bv, bf, meta = builder_mod.build_raw(m_n, m_o, bc)
    s, _ = builder_mod.build_dual_sample(m_n, m_o, bc)
    w = builder_mod.widths_for(bv, bf, meta["fv_indices"], with_bands=reorder)
    return builder_mod.attach_tables(s, w)


def _step(model, sample):
    """Outputs and loss of one float32 forward and backward."""
    with aggregates_in(torch.float32):
        vert_p, norm_p = model(sample)
        loss = _metrics_of(vert_p, norm_p, sample, Config())[0]
        loss.backward()
    return vert_p.detach(), norm_p.detach(), loss.detach()


def _saved_bytes(fn):
    """Bytes of the distinct storages autograd keeps for the backward of fn()."""
    kept = {}

    def pack(t):
        st = t.untyped_storage()
        kept[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(kept.values())


@pytest.mark.parametrize("n,rows,chunks", [
    (1001, 64, 1),  # odd: never divisible
    (96, 1, 32),  # stops doubling at 32
    (4096, 64, 32),  # still above the rows at 32 chunks
    (48, 1, 16),  # stops where 2 * chunks no longer divides
    (704, 64, 16),
    (1 << 20, 1 << 18, 4),
    (1 << 18, 1 << 18, 1),  # not above the rows
])
def test_head_chunks_follow_the_jax_rule(n, rows, chunks):
    assert head_chunks(n, rows) == chunks


def test_chunked_rematerialized_heads_match_one_piece():
    s = _sample(builder, synth).to("cpu")
    assert head_chunks(s.v.levels[0].node_mask.shape[0], 64) > 1
    assert head_chunks(s.f.levels[0].node_mask.shape[0], 64) > 1
    one = DualGNN(device="cpu", seed=3)
    chunked = DualGNN(device="cpu", seed=3, fc_chunk_rows=64)
    with without_remat():
        want = _step(one, s)
    got = _step(chunked, s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    g_one = dict(one.named_parameters())
    for name, prm in chunked.named_parameters():
        ref = g_one[name].grad
        if name.startswith("fc_"):
            assert float((prm.grad - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), name
        else:
            assert torch.equal(prm.grad, ref), name


def _scan_chunks(jaxpr, rows_of):
    """The chunk counts c of every scan over a (c, n / c, 32) array whose
    rows c * (n / c) are one of rows_of, in a jaxpr and its sub-jaxprs."""
    found = set()
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "scan":
            for v in eqn.invars:
                shape = getattr(v.aval, "shape", ())
                if len(shape) == 3 and shape[2] == 32 and shape[0] * shape[1] in rows_of:
                    found.add((shape[0] * shape[1], shape[0]))
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found |= _scan_chunks(sub, rows_of)
    return found


def test_chunked_heads_match_jax(monkeypatch):
    """DualGNN(fc_chunk_rows=64) of both packages on the same sample and
    weights, aggregates in float32; and the JAX module scans its heads over
    as many chunks as head_chunks counts."""
    j_agg = banded_pallas.banded_aggregate
    monkeypatch.setattr(banded_pallas, "banded_aggregate",
                        lambda r, p, x, w, m, compute_dtype=None, vma=None:
                        j_agg(r, p, x, w, m, jnp.float32, vma))
    s_j = _sample(jbuilder, jsynth)
    s_t = _sample(builder, synth).to("cpu")
    model = DualGNN(device="cpu", seed=5, fc_chunk_rows=64)
    loss_t = _step(model, s_t)[2]
    jmodel = JDualGNN(fc_chunk_rows=64)

    def jloss(p):
        return jtrainer._metrics_of(*jmodel.apply(p, s_j), s_j, JConfig())[0]

    params = tparams.to_jax_params(model.state_dict())
    n_v, n_f = (int(b.levels[0].node_mask.shape[0]) for b in (s_t.v, s_t.f))
    scans = _scan_chunks(jax.make_jaxpr(jloss)(params).jaxpr, {n_v, n_f})
    assert scans == {(n_v, head_chunks(n_v, 64)), (n_f, head_chunks(n_f, 64))}, scans
    with jax.default_matmul_precision("float32"):
        loss_j, g_j = jax.jit(jax.value_and_grad(jloss))(params)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    g_j = tparams.from_jax_params(jax.tree.map(np.asarray, g_j))
    for name, prm in model.named_parameters():
        want = np.asarray(g_j[name])
        err = float(np.abs(prm.grad.numpy() - want).max())
        assert err <= 1e-4 * max(float(np.abs(want).max()), 1e-30), name


def test_unbanded_convs_are_rematerialized():
    """Config(reorder=False): every level is a table level.  Gradients are
    bit-equal with and without rematerialization, and autograd keeps fewer
    bytes with it."""
    s = _sample(builder, synth, reorder=False).to("cpu")
    assert all(lvl.band is None and lvl.nbr is not None for lvl in s.v.levels + s.f.levels)
    models = [DualGNN(device="cpu", seed=2) for _ in range(2)]
    (_, kept_remat) = _saved_bytes(lambda: _step(models[0], s))
    with without_remat():
        (_, kept_all) = _saved_bytes(lambda: _step(models[1], s))
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a.grad, b.grad)
    assert kept_remat < kept_all / 2, (kept_remat, kept_all)


def test_banded_convs_are_not_rematerialized(monkeypatch):
    """A banded level's conv never goes through `_remat` and keeps the same
    bytes either way; the unbanded conv of the same level does."""
    s = _sample(builder, synth).to("cpu")
    level = s.v.levels[0]
    assert level.band is not None
    conv = dual_gnn.FeaStConv(6, 32, device="cpu")
    torch.manual_seed(0)
    for prm in conv.parameters():
        torch.nn.init.normal_(prm, std=0.3)
    calls = []
    remat = dual_gnn._remat
    monkeypatch.setattr(dual_gnn, "_remat", lambda fn, *a: calls.append(fn) or remat(fn, *a))
    x = s.v.x.clone().requires_grad_()

    def run(lvl):
        return _saved_bytes(lambda: conv(x, lvl).square().sum())

    (out_r, kept_r) = run(level)
    with without_remat():
        (out_p, kept_p) = run(level)
    assert not calls and kept_r == kept_p and torch.equal(out_r, out_p)
    unbanded = level.replace(band=None)
    (_, kept_u) = run(unbanded)
    assert len(calls) == 1 and kept_u < kept_p
