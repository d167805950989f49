"""The port's FLOP accounting and step timing against the JAX package's.

`dual_gnn_flops` and `roofline` (geobignn_tpu_torch/train/roofline.py) on
the same sample as geobignn_tpu/train/roofline.py, with the peak passed in
(JAX reads 197 TFLOP/s for the CPU device): the counts and every output
key equal, for banded levels, dense tables and COO edges.  Without a card
the port's roofline raises unless given the peak.  train/profiling.py's
host-side parts: the fence, the host-clock timer, the trace file.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from geobignn_tpu import native as jnative
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import dataset as jdataset
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.train import roofline as jroofline
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.data import builder as tbuilder
from geobignn_tpu_torch.data import dataset as tdataset
from geobignn_tpu_torch.data import synth as tsynth
from geobignn_tpu_torch.train import profiling, roofline

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores

JAX_CPU_PEAK = 197e12  # geobignn_tpu.train.roofline.chip_peak_flops' default


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


def _sample(synth, builder, dataset, layout):
    mesh = synth.add_noise(synth.icosphere(2), 0.2, seed=0)
    if layout == "coo":
        return builder.build_dual_sample(mesh, synth.icosphere(2),
                                         builder.BuildConfig(granularity=64))[0]
    bc = builder.BuildConfig(reorder=layout == "banded", granularity=64)
    (bv, bf, meta, _, _), = dataset.process_one_mesh(mesh, 100000, None, bc)
    mem = dataset.InMemoryDataset.__new__(dataset.InMemoryDataset)
    mem.entries = [(bv, bf, meta, None, None)]
    mem.plan, mem.build_cfg = builder.plan_for(bv, bf, bc.granularity), bc
    mem.widths = builder.widths_for(bv, bf, meta["fv_indices"],
                                    with_bands=layout == "banded")
    return mem.get(0)


@pytest.mark.parametrize("layout", ["banded", "tables", "coo"])
def test_flops_and_roofline_equal_jax(layout):
    js = _sample(jsynth, jbuilder, jdataset, layout)
    ts = _sample(tsynth, tbuilder, tdataset, layout)
    levels = ts.v.levels + ts.f.levels
    assert {"banded": all(lvl.band is not None for lvl in levels[:1] + levels[3:4]),
            "tables": all(lvl.nbr is not None and lvl.band is None for lvl in levels),
            "coo": all(lvl.nbr is None for lvl in levels)}[layout]
    assert roofline.dual_gnn_flops(ts) == jroofline.dual_gnn_flops(js)
    assert roofline.dual_gnn_flops(ts.to("cpu")) == jroofline.dual_gnn_flops(js)
    assert jroofline.chip_peak_flops() == JAX_CPU_PEAK
    assert roofline.roofline(ts, 0.0123, peak_flops=JAX_CPU_PEAK) \
        == jroofline.roofline(js, 0.0123)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card gives the peak")
def test_roofline_without_a_card_needs_the_peak():
    ts = _sample(tsynth, tbuilder, tdataset, "coo")
    with pytest.raises(RuntimeError, match="peak"):
        roofline.roofline(ts, 0.01)


def test_profiling_host_parts(tmp_path):
    x = torch.arange(5.0) + 2
    assert profiling.device_sync(x) == 2.0
    assert profiling.device_sync({"loss": (x, x)}) == 2.0
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer:
            x.sum()
    summ = timer.summary()
    assert summ["n"] == 3 and summ["max_ms"] >= summ["p50_ms"] >= 0
    with profiling.trace(str(tmp_path)):
        (x * 2).sum()
    with open(os.path.join(tmp_path, "trace.json")) as fh:
        assert json.load(fh)["traceEvents"]
    assert np.isfinite(summ["mean_ms"])
