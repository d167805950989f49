"""A whole large mesh as one sample, built as chip_smoke.py's [large] phase
and bench.py's `large` field build it, in both packages.

add_noise(icosphere(6), 0.2, seed=0), 81,920 faces, under the build
config of Config(granularity=256): build_raw, build_dual_sample, widths_for
with bands, attach_tables over union_batch of the one sample.  Every array
is bit-equal to the JAX package's, and so are each level's band, blk_idx
and boundary sub-band shapes and the step's real edge messages: at this
size the facet levels 0 and 1 run the hybrid conv with a sub-band (the
327,680-face icosphere(7) has one at five of six levels).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from geobignn_tpu import native as jnative
from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import batching as jbatching
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import dataset as jdataset
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import batching as tbatching
from geobignn_tpu_torch.data import builder as tbuilder
from geobignn_tpu_torch.data import dataset as tdataset
from geobignn_tpu_torch.data import synth as tsynth

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


def _whole_sample(config, synth, builder, batching, dataset, subdiv):
    """(sample, real edge messages of one step) of one whole mesh."""
    clean = synth.icosphere(subdiv)
    noisy = synth.add_noise(clean, 0.2, seed=0)
    bc = config(granularity=256).build_config()
    bv, bf, meta = builder.build_raw(noisy, clean, bc)
    single, _ = builder.build_dual_sample(noisy, clean, bc)
    widths = builder.widths_for(bv, bf, meta["fv_indices"], with_bands=True)
    sample = builder.attach_tables(batching.union_batch([single]), widths)
    return sample, dataset.branch_messages(bv) + dataset.branch_messages(bf)


def assert_bit_equal(a, b, path="sample"):
    """Recursive equality of two samples (JAX pytree vs port dataclass)."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_bit_equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bit_equal(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, int):
        assert a == b, (path, a, b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (path, a.dtype, b.dtype,
                                                          a.shape, b.shape)
        assert np.array_equal(a, b), path


def _shapes(sample):
    return [(side, i) + tuple(None if a is None else tuple(a.shape)
                              for a in (lvl.band, lvl.blk_idx, lvl.jband))
            for side in ("v", "f") for i, lvl in enumerate(getattr(sample, side).levels)]


def test_whole_sample_structures_match_jax():
    s_j, msgs_j = _whole_sample(JConfig, jsynth, jbuilder, jbatching, jdataset, 6)
    s_t, msgs_t = _whole_sample(Config, tsynth, tbuilder, tbatching, tdataset, 6)
    assert _shapes(s_j) == _shapes(s_t)
    assert [sh[4] is not None for sh in _shapes(s_t)] == [False] * 3 + [True, True, False]
    assert all(sh[3] is None for sh in _shapes(s_t))
    assert msgs_j == msgs_t
    assert_bit_equal(s_j, s_t)
