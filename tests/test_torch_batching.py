"""The port's disjoint-union batching against the JAX package's.

`union_batch` and `batch_ids` (geobignn_tpu_torch/data/batching.py) on 2
and 3 small noisy icospheres of one SizePlan: every array bit-equal to
geobignn_tpu/data/batching.py's.  Then `attach_tables` (with the merged
widths, so `attach_band` runs too) over the union, bit-equal to the JAX
builders', and the port's model on the union against the same model on
each sample alone: the components do not see each other (float32
aggregates, 1e-4 of the largest output).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from geobignn_tpu import native as jnative
from geobignn_tpu.data import batching as jbatching
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.data import batching as tbatching
from geobignn_tpu_torch.data import builder as tbuilder
from geobignn_tpu_torch.data import synth as tsynth
from geobignn_tpu_torch.models.dual_gnn import DualGNN

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


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
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        assert np.array_equal(a, b), path


def _samples(synth, builder, n):
    """n noisy icosphere(2) samples of one plan, with their merged widths
    (bands included), in one package."""
    clean = synth.icosphere(2)
    meshes = [synth.add_noise(clean, 0.2, seed=s) for s in range(n)]
    bc = builder.BuildConfig(reorder=True, granularity=64)
    plan = widths = None
    for m in meshes:
        bv, bf, meta = builder.build_raw(m, clean, bc)
        p = builder.plan_for(bv, bf, bc.granularity)
        w = builder.widths_for(bv, bf, meta["fv_indices"], with_bands=True)
        plan = p if plan is None else plan.merge(p)
        widths = w if widths is None else widths.merge(w)
    return [builder.build_dual_sample(m, clean, bc, plan)[0] for m in meshes], widths


@pytest.mark.parametrize("n", [2, 3])
def test_union_batch_and_batch_ids_bit_equal(n):
    js, _ = _samples(jsynth, jbuilder, n)
    ts, _ = _samples(tsynth, tbuilder, n)
    union = tbatching.union_batch(ts)
    assert_bit_equal(jbatching.union_batch(js), union)
    for side in ("v", "f"):
        n_pad = np.asarray(getattr(ts[0], side).x).shape[0]
        ids = tbatching.batch_ids(n, n_pad)
        assert_bit_equal(jbatching.batch_ids(n, n_pad), ids)
        assert ids.shape == (getattr(union, side).x.shape[0],)


def test_tables_and_bands_after_a_union():
    js, jw = _samples(jsynth, jbuilder, 2)
    ts, tw = _samples(tsynth, tbuilder, 2)
    assert dataclasses.astuple(jw) == dataclasses.astuple(tw)
    union = tbuilder.attach_tables(tbatching.union_batch(ts), tw)
    assert_bit_equal(jbuilder.attach_tables(jbatching.union_batch(js), jw), union)
    assert all(lvl.band is not None for lvl in union.f.levels[:1] + union.v.levels[:1])

    model = DualGNN(device="cpu", seed=0)
    with torch.no_grad(), testing.aggregates_in(torch.float32):
        got = model(union.to("cpu"))
        alone = [model(tbuilder.attach_tables(s, tw).to("cpu")) for s in ts]
    for out, parts in zip(got, zip(*alone)):
        want = torch.cat(parts)
        assert out.shape == want.shape
        assert float((out - want).abs().max()) <= 1e-4 * float(want.abs().max())
