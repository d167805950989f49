"""The port's Predictor against the JAX Predictor on the CPU.

A 1280-face mesh split into patches of at most 800 faces (the stitched
path: merged plan and widths, overlap averaging with int32 counters,
un-permuting the RCM order, normal renormalisation, denormalization),
then a few iterations of update_positions.  One set of weights goes into
both through params.py.  Tolerances: positions within 1e-2 of the mean
edge length and unit normals within 5e-2 (bf16 convs and heads in both
packages, as in test_torch_model.py); the update loop, run on the same
inputs in both, agrees to f32 round-off (1e-5).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu import geometry as jgeometry
from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import synth
from geobignn_tpu.infer.predict import Predictor as JPredictor
from geobignn_tpu.infer.predict import update_positions as j_update
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import dataset as tdataset
from geobignn_tpu_torch.infer import predict as tpredict
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu import native as jnative
from geobignn_tpu_torch import testing

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


SUB_SIZE = 800


def test_predictor_matches_jax(tmp_path):
    mesh = synth.add_noise(synth.icosphere(3), 0.2, seed=0)
    assert len(tdataset.split_mesh(mesh, SUB_SIZE)) >= 2
    state = DualGNN(fc_dtype=torch.bfloat16, device="cpu", seed=1).state_dict()
    pred = tpredict.Predictor(Config(), state, sub_size=SUB_SIZE, device="cpu")
    jpred = JPredictor(JConfig(), tparams.to_jax_params(state), sub_size=SUB_SIZE)

    vp, npr = pred.predict_mesh(mesh)
    vj, nj = jpred.predict_mesh(mesh)
    mel = jgeometry.mean_edge_length_np(mesh.points, mesh.ev_indices)
    assert vp.shape == vj.shape == (mesh.n_vertices, 3)
    assert np.isfinite(vp).all() and np.isfinite(npr).all()
    np.testing.assert_allclose(vp, vj, rtol=0, atol=1e-2 * mel)
    np.testing.assert_allclose(npr, nj, rtol=0, atol=5e-2)

    # denoise = predict_mesh + update_positions; the loop itself on the
    # same inputs in both packages
    v_t = tpredict.update_positions(
        torch.from_numpy(vp), torch.from_numpy(mesh.fv_indices.astype(np.int64)),
        torch.from_numpy(mesh.vf_indices.astype(np.int64)),
        torch.from_numpy(npr), n_iter=5).numpy()
    v_j = np.asarray(j_update(jnp.asarray(vp), jnp.asarray(mesh.fv_indices),
                              jnp.asarray(mesh.vf_indices), jnp.asarray(npr),
                              n_iter=5))
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=1e-5)

    v_d, n_d = pred.denoise(mesh, n_update_iters=5)
    np.testing.assert_allclose(v_d, v_t, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n_d, npr)


def test_predict_dir_body_writes_meshes(tmp_path):
    """predict_dir's body: `{name}-{iters}.obj` per input mesh and the
    face-weighted angle means."""
    from geobignn_tpu_torch import meshio

    mesh = synth.add_noise(synth.icosphere(2), 0.2, seed=0)
    meshio.write_obj(str(tmp_path / "ball.obj"), mesh.points, mesh.fv_indices)
    state = DualGNN(fc_dtype=torch.bfloat16, device="cpu", seed=1).state_dict()
    pred = tpredict.Predictor(Config(flag="t"), state, device="cpu")
    res = tpredict.predict_dir_body(pred, data_dir=str(tmp_path), n_update_iters=3)
    out = meshio.read_obj(str(tmp_path / "result_t" / "ball-3.obj"))
    assert out.n_faces == mesh.n_faces and np.isfinite(out.points).all()
    assert [r["name"] for r in res["rows"]] == ["ball"]
