"""The fusion layer (`Config.fusion_features`) against the JAX package on
the CPU: DualFusionLayer alone, DualGNN(fusion=16)'s loss and every
parameter gradient, and a fused run directory in the JAX file format
served by both packages' predictors.

One set of weights goes into both packages through params.py; both build
the same sample with their own host builders.  Tolerances are stated at
each comparison.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu import geometry as jgeometry
from geobignn_tpu import native as jnative
from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.infer.predict import Predictor as JPredictor
from geobignn_tpu.models import DualGNN as JDualGNN
from geobignn_tpu.models.fusion import DualFusionLayer as JDualFusionLayer
from geobignn_tpu.ops import banded_pallas
from geobignn_tpu.train import checkpoint as jckpt
from geobignn_tpu.train import trainer as jtrainer
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import builder, synth
from geobignn_tpu_torch.infer import predict as tpredict
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.models.fusion import DualFusionLayer
from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.train.trainer import _metrics_of

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


def _sample(builder_mod, synth_mod, sub=2):
    m_o = synth_mod.icosphere(sub)
    m_n = synth_mod.add_noise(m_o, 0.3, seed=2)
    bc = builder_mod.BuildConfig(granularity=64, reorder=True)
    bv, bf, meta = builder_mod.build_raw(m_n, m_o, bc)
    s, _ = builder_mod.build_dual_sample(m_n, m_o, bc)
    return builder_mod.attach_tables(
        s, builder_mod.widths_for(bv, bf, meta["fv_indices"], with_bands=True))


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def test_fusion_layer_matches_jax():
    """Outputs within 1e-5 of their max (float32, sums in another order)."""
    s_j = _sample(jbuilder, jsynth)
    s_t = _sample(builder, synth).to("cpu")
    layer = DualFusionLayer(6, 6, 16, device="cpu")
    tparams.init_(layer, seed=4)
    jlayer = JDualFusionLayer(16)
    tree = tparams.to_jax_params(layer.state_dict())
    want_shapes = jax.tree.map(np.shape, jlayer.init(jax.random.PRNGKey(0), s_j.v.x, s_j.f.x, s_j))
    assert jax.tree.map(np.shape, tree) == want_shapes
    h_vj, h_fj = jlayer.apply(tree, s_j.v.x, s_j.f.x, s_j)
    with torch.no_grad():
        h_vt, h_ft = layer(s_t.v.x, s_t.f.x, s_t)
    assert _rel_err(h_vt.numpy(), np.asarray(h_vj)) <= 1e-5
    assert _rel_err(h_ft.numpy(), np.asarray(h_fj)) <= 1e-5


def test_fused_dual_gnn_grads_match_jax(monkeypatch):
    """DualGNN(fusion=16) with the aggregates and heads in float32 in both
    packages: outputs within 1e-5 of their max, the loss within 1e-5
    relative, every gradient within 1e-4 of its max|g|
    (tests/test_torch_grads.py's float32 bounds)."""
    j_agg, t_agg = banded_pallas.banded_aggregate, banded_cuda.banded_aggregate
    monkeypatch.setattr(banded_pallas, "banded_aggregate",
                        lambda r, p, x, w, m, compute_dtype=None, vma=None:
                        j_agg(r, p, x, w, m, jnp.float32, vma))
    monkeypatch.setattr(banded_cuda, "banded_aggregate",
                        lambda r, p, x, w, m, compute_dtype=None:
                        t_agg(r, p, x, w, m, torch.float32))
    s_j = _sample(jbuilder, jsynth)
    s_t = _sample(builder, synth).to("cpu")
    model = DualGNN(fusion=16, device="cpu", seed=6)
    assert model.gnn_v.l_conv1.u.shape[0] == 6 + 16
    assert model.gnn_f.l_conv1.u.shape[0] == 12 + 16
    vert_p, norm_p = model(s_t)
    loss_t, _ = _metrics_of(vert_p, norm_p, s_t, Config())
    loss_t.backward()
    jmodel = JDualGNN(fusion=16)
    tree = tparams.to_jax_params(model.state_dict())
    assert jax.tree.map(np.shape, tree) == jax.tree.map(
        np.shape, jmodel.init(jax.random.PRNGKey(0), s_j))

    def jloss(p):
        v, n = jmodel.apply(p, s_j)
        return jtrainer._metrics_of(v, n, s_j, JConfig())[0], (v, n)

    with jax.default_matmul_precision("float32"):
        (loss_j, (v_j, n_j)), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(tree)
    assert _rel_err(vert_p.detach().numpy(), np.asarray(v_j)) <= 1e-5
    assert _rel_err(norm_p.detach().numpy(), np.asarray(n_j)) <= 1e-5
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    g_j = {k: v.numpy() for k, v in
           tparams.from_jax_params(jax.tree.map(np.asarray, g_j)).items()}
    g_t = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(g_t) == set(g_j) and any(k.startswith("fusion.lin_v1") for k in g_t)
    err = {k: _rel_err(g_t[k], g_j[k]) for k in g_t}
    assert max(err.values()) <= 1e-4, sorted(err.items(), key=lambda kv: -kv[1])[:5]


def test_fused_run_directory_is_served_like_jax(tmp_path):
    """A run directory of a fused model written with the JAX package's
    Config.to_json and save_checkpoint: the port's Predictor.from_run and the
    JAX one on a 2-patch mesh, positions within 1e-2 mean edge lengths and
    normals within 5e-2 (bf16 aggregate operands and heads in both, as
    tests/test_torch_predict.py); the weights arrive bit for bit."""
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    jcfg = JConfig(fusion_features=16, seed=0, sub_size=800)
    jcfg.to_json(os.path.join(run_dir, "params.json"))
    state = DualGNN(fusion=16, fc_dtype=torch.bfloat16, device="cpu", seed=2).state_dict()
    jckpt.save_checkpoint(os.path.join(run_dir, "ckpt_best.pkl"),
                          tparams.to_jax_params(state), epoch=0, best_error=1.0)
    mesh = jsynth.add_noise(jsynth.icosphere(3), 0.2, seed=0)
    pred = tpredict.Predictor.from_run(run_dir, pinned=False, device="cpu")
    assert pred.cfg.fusion_features == 16
    for k, v in pred.model.state_dict().items():
        assert v.numpy().tobytes() == state[k].numpy().tobytes(), k
    jpred = JPredictor.from_run(run_dir, pinned=False)
    vp, npr = pred.predict_mesh(mesh)
    vj, nj = jpred.predict_mesh(mesh)
    mel = jgeometry.mean_edge_length_np(mesh.points, mesh.ev_indices)
    assert np.isfinite(vp).all() and np.isfinite(npr).all()
    np.testing.assert_allclose(vp, vj, rtol=0, atol=1e-2 * mel)
    np.testing.assert_allclose(npr, nj, rtol=0, atol=5e-2)
