"""Streaming and size bucketing against the JAX package on the CPU: the
prefetch iterator's order, overlap, errors and early exit (the cases of
tests/test_prefetch.py), `bucketize`'s bucket ids, plans and widths, and
a streamed, bucketed Trainer.fit against the JAX trainer's losses.
"""

from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch

from geobignn_tpu import native as jnative
from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import dataset as jdataset
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.data.builder import BuildConfig as JBuildConfig
from geobignn_tpu.train import trainer as jtrainer
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.capture import tensors
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import dataset, synth
from geobignn_tpu_torch.data.builder import BuildConfig
from geobignn_tpu_torch.data.prefetch import device_iter, prefetch_iter
from geobignn_tpu_torch.train.trainer import Trainer

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


# --------------------------------------------------------------------------
# the iterator (tests/test_prefetch.py's cases)
# --------------------------------------------------------------------------

def test_prefetch_order_and_overlap():
    seen_threads = set()

    def fetch(i):
        seen_threads.add(threading.get_ident())
        time.sleep(0.002)
        return i * 10

    assert list(prefetch_iter(range(20), fetch, depth=3)) == [i * 10 for i in range(20)]
    assert threading.get_ident() not in seen_threads  # ran off-thread


def test_prefetch_depth_zero_is_sync():
    seen = []
    out = list(prefetch_iter(range(5), lambda i: seen.append(threading.get_ident()) or i + 1,
                             depth=0))
    assert out == [1, 2, 3, 4, 5] and set(seen) == {threading.get_ident()}


def test_prefetch_propagates_errors_at_their_own_yield():
    def fetch(i):
        if i == 3:
            raise ValueError("boom")
        return i

    it = prefetch_iter(range(6), fetch, depth=2)
    assert [next(it), next(it), next(it)] == [0, 1, 2]
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_prefetch_early_exit_cancels_queued_fetches():
    started, gate = [], threading.Event()

    def fetch(i):
        started.append(i)
        gate.wait(5)
        return i

    it = prefetch_iter(range(100), fetch, depth=4)
    gate.set()
    assert next(it) == 0
    it.close()  # the consumer bails: queued fetches are cancelled
    assert len(started) <= 6, started


# --------------------------------------------------------------------------
# bucketing: bit-equal to the JAX package's
# --------------------------------------------------------------------------

def _mixed(synth_mod):
    """Meshes two octaves apart in size: bucketing must separate them."""
    pairs = []
    for sub, seed in [(1, 0), (1, 1), (2, 2), (3, 3), (3, 4)]:
        m_o = synth_mod.icosphere(sub)
        pairs.append((synth_mod.add_noise(m_o, 0.15, seed=seed), m_o))
    return pairs


@pytest.mark.parametrize("growth", [1.5, 2.0, 4.0])
def test_bucketize_matches_jax(growth):
    ds_t = dataset.InMemoryDataset(_mixed(synth), BuildConfig(granularity=16, reorder=True))
    ds_j = jdataset.InMemoryDataset(_mixed(jsynth), JBuildConfig(granularity=16, reorder=True))
    n = ds_t.bucketize(growth)
    assert n == ds_j.bucketize(growth) and n >= 2
    assert ds_t.bucket_of == ds_j.bucket_of
    for pt, pj in zip(ds_t._bucket_plans, ds_j._bucket_plans):
        assert repr(pt) == repr(pj)
    for wt, wj in zip(ds_t._bucket_widths, ds_j._bucket_widths):
        assert repr(wt) == repr(wj)
    for i in range(len(ds_t)):  # each entry padded to its bucket's plan, as JAX pads it
        st, sj = ds_t.get(i), ds_j.get(i)
        assert st.v.x.shape == np.asarray(sj.v.x).shape
        np.testing.assert_array_equal(st.v.x, np.asarray(sj.v.x))
        np.testing.assert_array_equal(st.f.levels[0].band, np.asarray(sj.f.levels[0].band))
    small, merged = ds_t.get(0), ds_t.get(0, ds_t.plan)
    assert small.v.x.shape[0] < merged.v.x.shape[0]  # over-padding removed
    k = int(small.v.levels[0].node_mask.sum())
    np.testing.assert_array_equal(small.v.x[:k], merged.v.x[:k])
    with pytest.raises(ValueError):
        ds_t.bucketize(1.0)


def test_staged_samples_equal_direct_copies():
    """device_iter's samples on the CPU are what `.to` gives, in order."""
    ds = dataset.InMemoryDataset(_mixed(synth)[:3], BuildConfig(granularity=16, reorder=True))
    ds.bucketize(1.5)
    got = list(device_iter(range(3), ds.get, "cpu", depth=2))
    for i, s in enumerate(got):
        want = ds.get(i).to("cpu")
        for a, b in zip(tensors(s), tensors(want)):
            assert torch.equal(a, b)
    for s in device_iter(range(1), ds.get, "cpu", depth=0):
        assert all(a.device.type == "cpu" for a in tensors(s))


# --------------------------------------------------------------------------
# the trainer, streamed and bucketed
# --------------------------------------------------------------------------

def test_streamed_bucketed_trainer_matches_jax():
    """Two epochs streamed (preload=False, prefetch_depth=2) over buckets of
    growth 1.5, augment off, the JAX trainer's initial parameters in the
    port: the same bucket count, and the per-epoch loss and normal error
    within 2e-2 relative of the JAX trainer's (tests/test_torch_train.py's
    bound); one graph-free step per sample on the CPU, and the same
    trajectory as the port's preloaded, unbucketed run within 1e-5
    relative (padding changes the order of the float sums only)."""
    kw = dict(max_epoch=2, seed=1, granularity=16, augment=False, lr=1e-3,
              preload=False, prefetch_depth=2, buckets_growth=1.5)
    pairs = [(sub, seed) for sub, seed in [(1, 0), (2, 2), (2, 3)]]

    def mk(synth_mod):
        return [(synth_mod.add_noise(synth_mod.icosphere(s), 0.15, seed=e),
                 synth_mod.icosphere(s)) for s, e in pairs]

    ds_j = jdataset.InMemoryDataset(mk(jsynth), JBuildConfig(granularity=16, reorder=True))
    ds_t = dataset.InMemoryDataset(mk(synth), BuildConfig(granularity=16, reorder=True))
    jtr = jtrainer.Trainer(JConfig(**kw), ds_j)
    tr = Trainer(Config(**kw), ds_t, device="cpu")
    assert tr.bucketed and ds_t.bucket_of == ds_j.bucket_of and len(set(ds_t.bucket_of)) == 2
    start = tparams.from_jax_params(jax.tree.map(np.asarray, jtr.params))
    tr.model.load_state_dict(start)
    hist_j, hist_t = [], []
    jtr.fit(on_epoch=lambda t, m, e: hist_j.append(m))
    tr.fit(on_epoch=lambda t, m, e: hist_t.append(m))
    for mt, mj in zip(hist_t, hist_j):
        for k in ("loss", "error_f"):
            assert abs(mt[k] - mj[k]) <= 2e-2 * abs(mj[k]), (k, mt[k], mj[k])
        assert mt["n_v"] == mj["n_v"] and mt["n_f"] == mj["n_f"]

    pre = dict(kw, preload=True, buckets_growth=0.0)
    ds_p = dataset.InMemoryDataset(mk(synth), BuildConfig(granularity=16, reorder=True))
    trp = Trainer(Config(**pre), ds_p, device="cpu")
    trp.model.load_state_dict(start)
    hist_p = []
    trp.fit(on_epoch=lambda t, m, e: hist_p.append(m))
    for mt, mp in zip(hist_t, hist_p):
        assert abs(mt["loss"] - mp["loss"]) <= 1e-5 * abs(mp["loss"]), (mt["loss"], mp["loss"])
