"""precision="bfloat16" against the JAX package on the CPU: DualGNN with
bf16 activations (compute_dtype) against JAX's `compute_dtype=jnp.bfloat16`
on a banded sample and on a block-sparse one, and the cotangents' dtypes
through the aggregate Functions and the gathers
(tests/test_torch_modes_train.py holds the trainer against JAX's).

Tolerances: the loss within 1e-2 relative and every gradient at a cosine
of at least 0.99 to the JAX one, the bf16 bounds of
tests/test_torch_grads.py; but for the convs' `u` (a small difference of
large terms), every gradient within 1e-1 of its tensor's max|g|, twice
that file's 5e-2.  There only the aggregates' operands are bf16; here every
activation is rounded to bf16 between the ops, and the two packages round
at different points (XLA fuses elementwise chains and rounds once, torch
rounds each op's output), so the two gradients are two bf16 roundings of
one float32 gradient, as far apart as rounding makes them.  The witness
says so: the JAX model with float32 activations (the same weights, bf16
heads) gives that float32 gradient, and over the whole model (each
tensor's difference over its max|g|, then the root sum of squares) the
two packages' bf16 gradients must lie within twice the distance of JAX's
own bf16 gradients from it (two independent roundings lie sqrt(2) times
that apart), and the port's within twice JAX's distance from it.  The
readings, per tensor and whole-model, are in PERF.md.
The JAX convs run their Pallas kernels in interpret mode.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu import native as jnative
from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.models import DualGNN as JDualGNN
from geobignn_tpu.train import trainer as jtrainer
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import builder, synth
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.ops import blocksparse as tbs
from geobignn_tpu_torch.ops import table as tbl
from geobignn_tpu_torch.train.trainer import _metrics_of

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


def _sample(builder_mod, synth_mod, blocksparse: bool):
    """A noisy icosphere(3) with a clean target; with blocksparse, both
    branches' finest level loses its band tile (what TableWidths.merge does
    when two patches disagree on it) and runs the block-sparse aggregate."""
    m_o = synth_mod.icosphere(3)
    m_n = synth_mod.add_noise(m_o, 0.3, seed=1)
    bc = builder_mod.BuildConfig(granularity=64, reorder=True)
    bv, bf, meta = builder_mod.build_raw(m_n, m_o, bc)
    s, _ = builder_mod.build_dual_sample(m_n, m_o, bc)
    w = builder_mod.widths_for(bv, bf, meta["fv_indices"], with_bands=True)
    if blocksparse:
        w = dataclasses.replace(w, tile_v=(0,) + w.tile_v[1:], tile_f=(0,) + w.tile_f[1:])
    return builder_mod.attach_tables(s, w)


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("blocksparse", [False, True], ids=["banded", "blocksparse"])
def test_bf16_model_grads_match_jax(blocksparse, monkeypatch):
    if blocksparse:  # row blocks of 64 in both packages: the mesh has several
        monkeypatch.setenv("GBN_BS_TILE", "64")
        monkeypatch.setattr(tbs, "BS_TILE", 64)
    s_j = _sample(jbuilder, jsynth, blocksparse)
    s_t = _sample(builder, synth, blocksparse).to("cpu")
    assert (s_t.f.levels[0].blk_idx is not None) == blocksparse

    model = DualGNN(compute_dtype=torch.bfloat16, fc_dtype=torch.bfloat16,
                    device="cpu", seed=5)
    vert_p, norm_p = model(s_t)
    assert vert_p.dtype == norm_p.dtype == torch.float32  # heads cast back
    loss_t, _ = _metrics_of(vert_p, norm_p, s_t, Config())
    loss_t.backward()
    jmodel = JDualGNN(compute_dtype=jnp.bfloat16, fc_dtype=jnp.bfloat16)

    def jloss(p):
        return jtrainer._metrics_of(*jmodel.apply(p, s_j), s_j, JConfig())[0]

    jparams = tparams.to_jax_params(model.state_dict())
    loss_j, g_j = jax.jit(jax.value_and_grad(jloss))(jparams)
    loss_t, loss_j = float(loss_t.detach()), float(loss_j)
    assert abs(loss_t - loss_j) <= 1e-2 * abs(loss_j), (loss_t, loss_j)

    g_j = {k: v.numpy() for k, v in
           tparams.from_jax_params(jax.tree.map(np.asarray, g_j)).items()}
    g_t = {k: p.grad for k, p in model.named_parameters()}
    assert set(g_t) == set(g_j)
    assert all(g.dtype == torch.float32 for g in g_t.values())  # parameters stay f32
    g_t = {k: g.numpy() for k, g in g_t.items()}
    for k in g_t:
        a, b = g_t[k].astype(np.float64), g_j[k].astype(np.float64)
        cos = float((a * b).sum()) / max(float(np.linalg.norm(a) * np.linalg.norm(b)), 1e-300)
        assert cos >= 0.99, (k, cos)
    err = {k: _rel_err(g_t[k], g_j[k]) for k in g_t if not k.endswith(".u")}
    assert max(err.values()) <= 1e-1, sorted(err.items(), key=lambda kv: -kv[1])[:5]

    # the witness: JAX's float32-activation gradient, and the distances to it
    jf32 = JDualGNN(compute_dtype=jnp.float32, fc_dtype=jnp.bfloat16)
    g_f = jax.grad(lambda p: jtrainer._metrics_of(*jf32.apply(p, s_j), s_j, JConfig())[0])
    g_f = {k: v.numpy() for k, v in
           tparams.from_jax_params(jax.tree.map(np.asarray, jax.jit(g_f)(jparams))).items()}
    apart, jax_off, port_off = (_whole_model(a, b, g_f) for a, b in
                                ((g_t, g_j), (g_j, g_f), (g_t, g_f)))
    assert apart <= 2 * jax_off and port_off <= 2 * jax_off, (apart, jax_off, port_off)


def _whole_model(a: dict, b: dict, ref: dict) -> float:
    """||a - b|| / ||ref|| over all tensors at once, each tensor divided by
    its max|ref| first: a whole-model relative distance in which every
    tensor counts at its own scale."""
    num = den = 0.0
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), 1e-30)
        num += float(np.square((a[k].astype(np.float64) - b[k]) / scale).sum())
        den += float(np.square(ref[k].astype(np.float64) / scale).sum())
    return float(np.sqrt(num / den))


def _agg_inputs(dtype, blocksparse: bool):
    case = testing.edge_case_inputs(8, 16, blocksparse=blocksparse, seed=3)
    prim = [torch.from_numpy(case[k]).to(dtype).requires_grad_() for k in ("r", "p", "x", "w")]
    return case, prim


@pytest.mark.parametrize("op", ["banded", "blocksparse", "table_gather",
                                "table_gather_compact"])
def test_cotangents_come_back_in_the_primal_dtype(op):
    """bf16 primals get bf16 cotangents, as the JAX VJPs return them; the
    aggregates upcast to their accumulation dtype inside and run the same
    float32 plain backward as for float32 primals."""
    dt = torch.bfloat16
    if op in ("banded", "blocksparse"):
        case, prim = _agg_inputs(dt, op == "blocksparse")
        m = torch.from_numpy(case["m"])
        if op == "banded":
            out = banded_cuda.banded_aggregate(*prim, m)
        else:
            out = tbs.bs_aggregate(*prim, m, torch.from_numpy(case["blk_idx"]))
        assert out.dtype == torch.float32
        out.backward(torch.from_numpy(case["gout"]))
        # the same backward as the upcast float32 primals'
        ref = [p.detach().float().requires_grad_() for p in prim]
        out32 = (banded_cuda.banded_aggregate(*ref, m) if op == "banded"
                 else tbs.bs_aggregate(*ref, m, torch.from_numpy(case["blk_idx"])))
        out32.backward(torch.from_numpy(case["gout"]))
        for p, r in zip(prim, ref):
            assert p.grad.dtype == dt
            assert torch.equal(p.grad, r.grad.to(dt))
        return
    rng = np.random.default_rng(0)
    n, k = 40, 5
    nbr = rng.integers(0, n - 1, size=(n, k))
    nbr[:, -1] = n - 1  # a trash slot in every row
    x = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32)).to(dt).requires_grad_()
    rev_rows = [np.flatnonzero(nbr.reshape(-1) == i) for i in range(n)]
    r_w = max(len(r) for r in rev_rows)
    rev = np.full((n, r_w), nbr.size, np.int64)
    for i, r in enumerate(rev_rows[:-1]):  # the trash row is listed nowhere
        rev[i, : len(r)] = r
    if op == "table_gather":
        out = tbl.table_gather(x, torch.from_numpy(nbr), torch.from_numpy(rev))
    else:
        src = np.arange(n - 1)
        out = tbl.table_gather_compact(x, torch.from_numpy(nbr), torch.from_numpy(src),
                                       torch.from_numpy(rev[:-1]))
    out.float().pow(2).sum().backward()
    assert out.dtype == dt and x.grad.dtype == dt
    assert not x.grad[-1].any() and x.grad[:-1].any()
