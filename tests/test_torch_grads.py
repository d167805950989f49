"""The port's DualGNN training loss and every parameter gradient against
jax.value_and_grad of the JAX DualGNN on the CPU.

One set of weights (the port's seeded init) goes into both models through
params.py; both get the same (noisy, clean) sample from their own host
builders.  The JAX convs run their Pallas kernels in interpret mode and
their custom VJPs; the port's run the plain versions through its autograd
Function.  Two comparisons:
  * float32: the banded aggregates and the heads computed in float32 in
    both packages (the aggregates' compute dtype patched to float32), so
    the algorithm is compared without bf16 rounding: the loss within 1e-5
    relative and every parameter gradient within 1e-4 of that tensor's
    max|g| (float32 sums in another order); once more with both fc heads
    in row chunks (the same fc_chunk_rows in both packages) beside the
    boundary sub-band levels, the combination a whole large mesh runs;
  * bfloat16, the Config defaults (bf16 aggregate operands, bf16 heads):
    the loss within 1e-2 relative; every tensor but the convs' `u` within
    5e-2 of its max|g|, and every tensor's gradient at a cosine of at least
    0.99 to the JAX one.  `u` enters p and r with opposite signs, so its
    gradient is a small difference of large terms (down to 1e-17 in the
    float32 run), and bf16 rounding, which differs between the packages,
    shows against its max; its direction still agrees.
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
from geobignn_tpu.ops import banded as jbanded
from geobignn_tpu.ops import banded_pallas
from geobignn_tpu.train import trainer as jtrainer
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import builder, synth
from geobignn_tpu_torch.models.dual_gnn import DualGNN, head_chunks
from geobignn_tpu_torch.ops import banded as tbanded
from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.train.trainer import _metrics_of
from geobignn_tpu import native as jnative
from geobignn_tpu_torch import testing

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


def _sample(builder_mod, synth_mod, sub):
    m_o = synth_mod.icosphere(sub)
    m_n = synth_mod.add_noise(m_o, 0.3, seed=1)
    bc = builder_mod.BuildConfig(granularity=64, reorder=True)
    bv, bf, meta = builder_mod.build_raw(m_n, m_o, bc)
    s, _ = builder_mod.build_dual_sample(m_n, m_o, bc)
    w = builder_mod.widths_for(bv, bf, meta["fv_indices"], with_bands=True)
    return builder_mod.attach_tables(s, w)


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


# fc_chunk_rows 256 cuts icosphere(3)'s heads into row chunks: 704 vertex
# rows in 4, 1,280 facet rows in 8
@pytest.mark.parametrize("max_tile,sub,dtype_name,fc_chunk_rows", [
    (384, 2, "float32", 1 << 18), (64, 3, "float32", 1 << 18),
    (64, 3, "bfloat16", 1 << 18), (64, 3, "float32", 256)],
    ids=["band-float32", "hybrid-float32", "hybrid-bfloat16", "hybrid-chunked-float32"])
def test_dual_gnn_grads_match_jax(max_tile, sub, dtype_name, fc_chunk_rows, monkeypatch):
    monkeypatch.setattr(jbanded, "MAX_BAND_TILE", max_tile)
    monkeypatch.setattr(tbanded, "MAX_BAND_TILE", max_tile)
    f32 = dtype_name == "float32"
    if f32:
        j_agg, t_agg = banded_pallas.banded_aggregate, banded_cuda.banded_aggregate
        monkeypatch.setattr(banded_pallas, "banded_aggregate",
                            lambda r, p, x, w, m, compute_dtype=None, vma=None:
                            j_agg(r, p, x, w, m, jnp.float32, vma))
        monkeypatch.setattr(banded_cuda, "banded_aggregate",
                            lambda r, p, x, w, m, compute_dtype=None:
                            t_agg(r, p, x, w, m, torch.float32))
    s_j = _sample(jbuilder, jsynth, sub)
    s_t = _sample(builder, synth, sub).to("cpu")
    hybrid = [lvl.jnodes is not None for lvl in s_t.v.levels + s_t.f.levels]
    assert any(hybrid) == (max_tile == 64), hybrid
    chunks = [head_chunks(b.x.shape[0], fc_chunk_rows) for b in (s_t.v, s_t.f)]
    assert (min(chunks) > 1) == (fc_chunk_rows < 1 << 18), chunks

    model = DualGNN(fc_dtype=None if f32 else torch.bfloat16, device="cpu", seed=5,
                    fc_chunk_rows=fc_chunk_rows)
    loss_t, _ = _metrics_of(*model(s_t), s_t, Config())
    loss_t.backward()
    jmodel = JDualGNN(fc_dtype=None if f32 else jnp.bfloat16, fc_chunk_rows=fc_chunk_rows)

    def jloss(p):
        return jtrainer._metrics_of(*jmodel.apply(p, s_j), s_j, JConfig())[0]

    with jax.default_matmul_precision("float32"):
        loss_j, g_j = jax.jit(jax.value_and_grad(jloss))(
            tparams.to_jax_params(model.state_dict()))
    loss_t, loss_j = float(loss_t.detach()), float(loss_j)
    assert abs(loss_t - loss_j) <= (1e-5 if f32 else 1e-2) * abs(loss_j)

    g_j = {k: v.numpy() for k, v in
           tparams.from_jax_params(jax.tree.map(np.asarray, g_j)).items()}
    g_t = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(g_t) == set(g_j)
    err = {k: _rel_err(g_t[k], g_j[k]) for k in g_t}
    if f32:
        assert max(err.values()) <= 1e-4, sorted(err.items(), key=lambda kv: -kv[1])[:5]
        return
    for k in g_t:
        a, b = g_t[k].astype(np.float64), g_j[k].astype(np.float64)
        cos = float((a * b).sum()) / max(float(np.linalg.norm(a) * np.linalg.norm(b)), 1e-300)
        assert cos >= 0.99, (k, cos)
    err = {k: e for k, e in err.items() if not k.endswith(".u")}
    assert max(err.values()) <= 5e-2, sorted(err.items(), key=lambda kv: -kv[1])[:5]


def test_float32_gradients_against_a_float64_step():
    """The float64 step of chip_smoke.py, here on the CPU: the port's plain
    path with params, sample and aggregates in float64 runs, and the
    float32 step's loss and every gradient sit near it (float32 rounding:
    1e-5 of the loss, 1e-4 of each tensor's max|g|)."""
    from geobignn_tpu_torch.testing import aggregates_in, float64_sample, grad_agreement

    s = _sample(builder, synth, 3).to("cpu")
    state = DualGNN(device="cpu", seed=5).state_dict()
    models, losses = [], []
    for dt, smp in ((torch.float32, s), (torch.float64, float64_sample(s))):
        model = DualGNN(compute_dtype=dt, fc_dtype=dt, device="cpu").to(dt)
        model.load_state_dict(state)
        with aggregates_in(dt):
            vert_p, norm_p = model(smp)
            loss = _metrics_of(vert_p, norm_p, smp, Config())[0]
            loss.backward()
        assert vert_p.dtype == norm_p.dtype == loss.dtype == dt
        models.append(model)
        losses.append(float(loss.detach()))
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    err = grad_agreement(*models)
    assert max(e for e, _ in err.values()) <= 1e-4, sorted(err.items(), key=lambda kv: -kv[1][0])[:3]
