"""The port's DualGNN forward against the JAX DualGNN.apply on the CPU.

One set of weights (the port's seeded init) goes into both models through
params.py; both get the same sample from their own host builders (which
test_torch_host.py holds bit-equal).  The JAX convs run the Pallas kernels
in interpret mode; the port's run the plain versions, both in bf16 compute
with f32 accumulation, and both heads in bf16 as Config's
fc_precision="bfloat16" sets.  Tolerances are those of the JAX package's
own banded-vs-table model test (tests/test_banded_model.py): 2e-2 on the
normalized vertex positions and 5e-2 on the unit normals — bf16 operands
that round differently in a layer propagate through 16 convs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.models import DualGNN as JDualGNN
from geobignn_tpu.ops import banded as jbanded
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch.data import builder as tbuilder
from geobignn_tpu_torch.data import synth as tsynth
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.ops import banded as tbanded


def _sample(builder, synth, sub):
    m_n = synth.add_noise(synth.icosphere(sub), 0.2, seed=1)
    bc = builder.BuildConfig(granularity=64, reorder=True)
    bv, bf, meta = builder.build_raw(m_n, None, bc)
    s, _ = builder.build_dual_sample(m_n, None, bc)
    w = builder.widths_for(bv, bf, meta["fv_indices"], with_bands=True)
    return builder.attach_tables(s, w)


@pytest.mark.parametrize("max_tile,sub", [(384, 2), (64, 3)], ids=["band", "hybrid"])
def test_dual_gnn_matches_jax(max_tile, sub, monkeypatch):
    monkeypatch.setattr(jbanded, "MAX_BAND_TILE", max_tile)
    monkeypatch.setattr(tbanded, "MAX_BAND_TILE", max_tile)
    s_j = _sample(jbuilder, jsynth, sub)
    s_t = _sample(tbuilder, tsynth, sub)
    hybrid = [lvl.jnodes is not None for lvl in s_t.v.levels + s_t.f.levels]
    assert any(hybrid) == (max_tile == 64), hybrid
    assert all(lvl.band is not None for lvl in s_t.v.levels + s_t.f.levels)

    model = DualGNN(fc_dtype=torch.bfloat16, device="cpu", seed=3)
    with torch.no_grad():
        v_t, n_t = model(s_t.to("cpu"))
    jparams = tparams.to_jax_params(model.state_dict())
    v_j, n_j = jax.jit(JDualGNN(fc_dtype=jnp.bfloat16).apply)(jparams, s_j)

    nv = int(s_t.v.levels[0].node_mask.sum())
    nf = int(s_t.f.levels[0].node_mask.sum())
    v_t, n_t = v_t.numpy()[:nv], n_t.numpy()[:nf]
    v_j, n_j = np.asarray(v_j)[:nv], np.asarray(n_j)[:nf]
    assert np.isfinite(v_t).all() and np.isfinite(n_t).all()
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=2e-2)
    np.testing.assert_allclose(n_t, n_j, rtol=0, atol=5e-2)


def test_params_round_trip(tmp_path):
    """from_jax_params(to_jax_params(s)) and the .npz files are lossless,
    and the seeded init gives the flax tree's shapes."""
    model = DualGNN(device="cpu", seed=0)
    state = model.state_dict()
    tree = tparams.to_jax_params(state)
    assert tree["params"]["gnn_f"]["l_conv1"]["w"].shape == (9, 12, 32)
    assert tree["params"]["fc_v2"]["kernel"].shape == (1024, 3)
    back = tparams.from_jax_params(tree)
    tparams.save_npz(tmp_path / "w.npz", back)
    loaded = tparams.load_npz(tmp_path / "w.npz")
    assert set(loaded) == set(state)
    for k in state:
        assert torch.equal(loaded[k], state[k]), k
    # init distributions: zero biases, Glorot limit on w
    assert float(state["gnn_v.l_conv1.b"].abs().max()) == 0.0
    lim = (6.0 / (9 * 6 + 9 * 32)) ** 0.5
    assert float(state["gnn_v.l_conv1.w"].abs().max()) <= lim
