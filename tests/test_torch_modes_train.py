"""Two of this slice's modes trained by the port's Trainer against the JAX
trainer on the CPU: dynamic pooling (Config(edge_weight_type=4)) and bf16
activations (Config(precision="bfloat16")).  The models themselves are held
against JAX in tests/test_torch_dynamic.py and tests/test_torch_precision.py;
here the trainers' epoch losses, augment off, from the JAX trainer's initial
parameters.  Both packages build their own datasets from the same meshes.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from geobignn_tpu import native as jnative
from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import dataset as jdataset
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.train import trainer as jtrainer
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import builder, dataset, synth
from geobignn_tpu_torch.pool.dynamic import DualGNNDynamic
from geobignn_tpu_torch.train.trainer import Trainer

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


def _pair(synth_mod, sub, seed):
    m_o = synth_mod.icosphere(sub)
    return synth_mod.add_noise(m_o, 0.25, seed=seed), m_o


def test_dynamic_trainer_matches_jax():
    """Two epochs of Trainer(Config(edge_weight_type=4)) over two samples,
    augment off, the JAX trainer's initial parameters in the port; the
    per-epoch loss and normal error within 2e-2 relative, as
    tests/test_torch_train.py holds the static trainer (Adam's first steps
    move a near-zero gradient's parameter by up to 2 lr differently)."""
    kw = dict(max_epoch=2, seed=1, granularity=64, augment=False, lr=1e-3,
              edge_weight_type=4)
    bc_j, bc_t = (jbuilder.BuildConfig(granularity=64, reorder=True),
                  builder.BuildConfig(granularity=64, reorder=True))
    ds_j = jdataset.InMemoryDataset([_pair(jsynth, 2, s) for s in (1, 2)], bc_j)
    ds_t = dataset.InMemoryDataset([_pair(synth, 2, s) for s in (1, 2)], bc_t)
    jtr = jtrainer.Trainer(JConfig(preload=False, **kw), ds_j)
    tr = Trainer(Config(**kw), ds_t, device="cpu")
    assert isinstance(tr.model, DualGNNDynamic)
    tr.model.load_state_dict(tparams.from_jax_params(jax.tree.map(np.asarray, jtr.params)))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    hist_j, hist_t = [], []
    jtr.fit(on_epoch=lambda t, m, e: hist_j.append(m))
    tr.fit(on_epoch=lambda t, m, e: hist_t.append(m))
    for mt, mj in zip(hist_t, hist_j):
        for k in ("loss", "error_f"):
            assert abs(mt[k] - mj[k]) <= 2e-2 * abs(mj[k]), (k, mt[k], mj[k])
    # the learned pooling weights, with zero gradients and no weight decay,
    # stay where they were in both packages; every other tensor moved in both
    after_j = tparams.from_jax_params(jax.tree.map(np.asarray, jtr.params))
    for k, v in tr.model.state_dict().items():
        moved_t = not torch.equal(v, before[k])
        moved_j = not torch.equal(after_j[k], before[k])
        assert moved_t == moved_j, k


def test_bf16_trainer_steps_match_jax():
    """Two steps (one epoch over two samples) of Trainer(Config(precision=
    "bfloat16")), augment off, the JAX trainer's initial parameters in the
    port: the epoch's loss and normal error within 2e-2 relative, as
    tests/test_torch_train.py holds the float32 trainer."""
    kw = dict(max_epoch=1, seed=1, granularity=64, augment=False, lr=1e-3,
              precision="bfloat16")
    ds_j = jdataset.InMemoryDataset([_pair(jsynth, 2, s) for s in (1, 2)],
                                    jbuilder.BuildConfig(granularity=64, reorder=True))
    ds_t = dataset.InMemoryDataset([_pair(synth, 2, s) for s in (1, 2)],
                                   builder.BuildConfig(granularity=64, reorder=True))
    jtr = jtrainer.Trainer(JConfig(preload=False, **kw), ds_j)
    tr = Trainer(Config(**kw), ds_t, device="cpu")
    assert tr.model.gnn_v.compute_dtype == torch.bfloat16
    tr.model.load_state_dict(tparams.from_jax_params(jax.tree.map(np.asarray, jtr.params)))
    hist_j, hist_t = [], []
    jtr.fit(on_epoch=lambda t, m, e: hist_j.append(m))
    tr.fit(on_epoch=lambda t, m, e: hist_t.append(m))
    (mt,), (mj,) = hist_t, hist_j
    for k in ("loss", "error_f"):
        assert abs(mt[k] - mj[k]) <= 2e-2 * abs(mj[k]), (k, mt[k], mj[k])
    assert mt["n_v"] == mj["n_v"] and mt["n_f"] == mj["n_f"]
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
