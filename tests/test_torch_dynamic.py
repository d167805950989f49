"""The port's dynamic-pooling model (pool/dynamic.py) against the JAX
package's on the CPU: DualGNNDynamic's loss and every parameter gradient,
the learned pooling parameters' zero gradients in both packages, and
checkpoints of the dynamic tree in the JAX file format both ways
(tests/test_torch_modes_train.py holds the trainer against JAX's).

One set of weights (the port's seeded init) goes into both models through
params.py; both get the same sample from their own host builders.  The
banded aggregates of level 1 run in float32 in both packages (compute dtype
patched, as tests/test_torch_grads.py does), so the comparison holds at
the float32 tolerances there: the loss within 1e-5 relative and every
gradient within 1e-4 of its tensor's max|g|.  Equal outputs also show
that both packages picked the same representatives at every level.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu import native as jnative
from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.ops import banded_pallas
from geobignn_tpu.pool.dynamic import DualGNNDynamic as JDualGNNDynamic
from geobignn_tpu.train import checkpoint as jckpt
from geobignn_tpu.train import trainer as jtrainer
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import builder, synth
from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.pool.dynamic import DualGNNDynamic, fill_missing_grads
from geobignn_tpu_torch.train import checkpoint as ckpt
from geobignn_tpu_torch.train.trainer import _metrics_of

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores

POOL_LEAVES = ("att_l", "att_r", "lin")


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


@pytest.fixture
def float32_aggregates(monkeypatch):
    j_agg, t_agg = banded_pallas.banded_aggregate, banded_cuda.banded_aggregate
    monkeypatch.setattr(banded_pallas, "banded_aggregate",
                        lambda r, p, x, w, m, compute_dtype=None, vma=None:
                        j_agg(r, p, x, w, m, jnp.float32, vma))
    monkeypatch.setattr(banded_cuda, "banded_aggregate",
                        lambda r, p, x, w, m, compute_dtype=None:
                        t_agg(r, p, x, w, m, torch.float32))


def _pair(synth_mod, sub, seed):
    m_o = synth_mod.icosphere(sub)
    return synth_mod.add_noise(m_o, 0.25, seed=seed), m_o


def _sample(builder_mod, synth_mod, sub=2, seed=3):
    m_n, m_o = _pair(synth_mod, sub, seed)
    bc = builder_mod.BuildConfig(granularity=64, reorder=True)
    bv, bf, meta = builder_mod.build_raw(m_n, m_o, bc)
    s, _ = builder_mod.build_dual_sample(m_n, m_o, bc)
    return builder_mod.attach_tables(
        s, builder_mod.widths_for(bv, bf, meta["fv_indices"], with_bands=True))


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("wt", [3, 4, 10])
def test_dynamic_model_grads_match_jax(wt, float32_aggregates):
    s_j = _sample(jbuilder, jsynth)
    s_t = _sample(builder, synth).to("cpu")
    assert s_t.v.levels[0].band is not None  # level 1 runs the banded aggregate

    model = DualGNNDynamic(edge_weight_type=wt, device="cpu", seed=5)
    loss_t, _ = _metrics_of(*model(s_t), s_t, Config())
    loss_t.backward()
    fill_missing_grads(model)
    jmodel = JDualGNNDynamic(edge_weight_type=wt)

    def jloss(p):
        return jtrainer._metrics_of(*jmodel.apply(p, s_j), s_j, JConfig())[0]

    tree = tparams.to_jax_params(model.state_dict())
    # the port's tree is the flax tree: same names, same shapes
    want_shapes = jax.tree.map(np.shape, jmodel.init(jax.random.PRNGKey(0), s_j))
    assert jax.tree.map(np.shape, tree) == want_shapes
    with jax.default_matmul_precision("float32"):
        loss_j, g_j = jax.jit(jax.value_and_grad(jloss))(tree)
    loss_t, loss_j = float(loss_t.detach()), float(loss_j)
    assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j), (loss_t, loss_j)

    g_j = {k: v.numpy() for k, v in
           tparams.from_jax_params(jax.tree.map(np.asarray, g_j)).items()}
    g_t = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(g_t) == set(g_j)
    pool = [k for k in g_t if any(f".{leaf}" in k for leaf in POOL_LEAVES)]
    assert len(pool) == {3: 8, 4: 16, 10: 0}[wt]
    for k in pool:  # the loss reaches the learned weights only through sort keys
        assert not g_t[k].any() and not g_j[k].any(), k
    err = {k: _rel_err(g_t[k], g_j[k]) for k in g_t if k not in pool}
    assert max(err.values()) <= 1e-4, sorted(err.items(), key=lambda kv: -kv[1])[:5]


def test_dynamic_checkpoint_round_trips_with_jax(tmp_path):
    state = DualGNNDynamic(edge_weight_type=5, device="cpu", seed=2).state_dict()
    tree = tparams.to_jax_params(state)
    path, jpath = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    ckpt.save_checkpoint(path, state, epoch=1, best_error=0.5)
    got, _, scalars = jckpt.load_checkpoint(path, tree)
    assert scalars == dict(epoch=1, best_error=0.5)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    jckpt.save_checkpoint(jpath, tree, epoch=4, best_error=0.25)
    back, _, _ = ckpt.load_checkpoint(jpath)
    assert set(back) == set(state)
    for k, v in state.items():
        assert back[k].numpy().tobytes() == v.numpy().tobytes(), k
    model = DualGNNDynamic(edge_weight_type=5, device="cpu")
    model.load_state_dict(back)


def test_same_matchings_holds_near_ties_only(monkeypatch):
    """testing.same_matchings, as chip_smoke holds the CPU's dynamic step to
    the card's picks: a replay on weights moved by up to 1e-3 of their
    scale (the coarser levels' weights, means of moved ones moved again,
    up to about 1.5e-3) ranks some candidate edges apart, each pair within
    twice the weights' distance, picks some other representatives, takes
    the recorded ones (so the outputs are the recording run's, bit for
    bit) and reports them; with a tolerance below the move it raises."""
    from geobignn_tpu_torch.pool import edge_weight as ew
    from geobignn_tpu_torch.testing import same_matchings

    s = _sample(builder, synth).to("cpu")
    model = DualGNNDynamic(edge_weight_type=10, device="cpu", seed=1)
    records: list = []
    with torch.no_grad(), same_matchings(records, replay=False, weight_tol=0.0):
        want = model(s)
    assert len(records) == 8
    with torch.no_grad(), same_matchings(records, replay=True, weight_tol=0.0) as seen:
        again = model(s)
    assert [c[0] for c in seen] == [0] * 8 and [c[2] for c in seen] == [0] * 8
    assert all(torch.equal(a, b) for a, b in zip(want, again))

    weigh = ew.compute_edge_weight
    gen = torch.Generator().manual_seed(0)

    def moved(*args, **kw):
        w = weigh(*args, **kw)
        return w * (1 + 1e-3 * (2 * torch.rand(w.shape, generator=gen) - 1))

    monkeypatch.setattr(ew, "compute_edge_weight", moved)
    with torch.no_grad(), same_matchings(records, replay=True, weight_tol=1e-2) as seen:
        held = model(s)
    assert sum(c[0] for c in seen) > 0 and max(c[1] for c in seen) <= 1e-2
    # a pair ranked apart is at most twice the weights' distance apart
    assert sum(c[2] for c in seen) > 0 and all(c[3] <= 2 * c[1] for c in seen)
    assert all(torch.equal(a, b) for a, b in zip(want, held))
    with pytest.raises(AssertionError, match="not by a near-tie"):
        with torch.no_grad(), same_matchings(records, replay=True, weight_tol=1e-5):
            model(s)
