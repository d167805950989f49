"""The port's host builders against the JAX package's: bit-equal arrays.

Every array of the padded, table- and band-attached sample (and the merged
table widths) must be identical in dtype, shape and value, so that the two
models see the same graphs, pooling hierarchies and band masks.  This needs
the native library on both sides or on neither (pool/hierarchy draws its
visit order from it when built).
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

from geobignn_tpu import native as jnative
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import dataset as jdataset
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.ops import banded as jbanded
from geobignn_tpu_torch import native as tnative
from geobignn_tpu_torch.data import builder as tbuilder
from geobignn_tpu_torch.data import dataset as tdataset
from geobignn_tpu_torch.data import synth as tsynth
from geobignn_tpu_torch.ops import banded as tbanded
from geobignn_tpu_torch import testing

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        assert np.array_equal(a, b), path


def _both(sub, sub_size, granularity=128):
    """Entries + merged widths + padded samples, as Predictor.predict_mesh
    builds them, in both packages."""
    out = []
    for synth, builder, dataset in ((jsynth, jbuilder, jdataset),
                                    (tsynth, tbuilder, tdataset)):
        mesh = synth.add_noise(synth.icosphere(sub), 0.2, seed=0)
        bc = builder.BuildConfig(reorder=True, granularity=granularity)
        entries = dataset.process_one_mesh(mesh, sub_size, None, bc)
        plan = widths = None
        for bv, bf, meta, _, _ in entries:
            p = builder.plan_for(bv, bf, bc.granularity)
            w = builder.widths_for(bv, bf, meta["fv_indices"], with_bands=True)
            plan = p if plan is None else plan.merge(p)
            widths = w if widths is None else widths.merge(w)
        mem = dataset.InMemoryDataset.__new__(dataset.InMemoryDataset)
        mem.entries, mem.plan, mem.build_cfg, mem.widths = entries, plan, bc, widths
        out.append((entries, widths, [mem.get(i) for i in range(len(entries))]))
    return out


def test_native_path_matches():
    assert tnative.has_native() == jnative.HAS_NATIVE


@pytest.mark.parametrize("stamp", ["absent", "of the whole file"])
def test_a_half_written_library_is_never_loaded(tmp_path, monkeypatch, stamp):
    """A library cut short at the port's build path, with no digest or the
    digest of the whole file beside it, is rebuilt under the lock; only the
    whole file is ever handed to the loader."""
    assert tnative.has_native()
    whole = open(tnative.library_path(), "rb").read()
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    path = tnative.library_path()
    with open(tmp_path / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        with open(path, "wb") as fh:
            fh.write(whole[: len(whole) // 2])
        if stamp != "absent":
            with open(path + ".sha256", "w") as fh:
                fh.write(hashlib.sha256(whole).hexdigest())
    loaded = []
    cdll = ctypes.CDLL
    monkeypatch.setattr(ctypes, "CDLL", lambda p, *a, **kw: loaded.append(
        open(p, "rb").read()) or cdll(p, *a, **kw))
    assert tnative.has_native()
    assert loaded and all(len(b) == len(whole) for b in loaded)
    assert open(path + ".sha256").read() == hashlib.sha256(open(path, "rb").read()).hexdigest()
    np.testing.assert_array_equal(tnative.permutation(97, 3), jnative.permutation(97, 3))


def test_processes_building_at_once_all_load_the_library(tmp_path):
    """Four processes that find no library build it once between them, under
    the lock, and every one loads it."""
    code = ("import sys, geobignn_tpu_torch.native as n\n"
            "n.BUILD_DIR = sys.argv[1]\n"
            "print(n.has_native(), n.permutation(11, 2).tolist())\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(outs)) == 1 and outs[0].startswith("True"), outs
    assert sorted(os.listdir(tmp_path)) == sorted(
        [".lock", os.path.basename(tnative.library_path()),
         os.path.basename(tnative.library_path()) + ".sha256"])


@pytest.mark.parametrize("max_tile,sub_size", [(384, 800), (64, 100000)],
                         ids=["band_patches", "hybrid_whole"])
def test_samples_bit_equal(max_tile, sub_size, monkeypatch):
    """icosphere(3): build_raw, widths_for and the attached samples, split
    into patches (band levels) or whole with MAX_BAND_TILE forced to 64
    (slab order, hybrid-band levels)."""
    monkeypatch.setattr(jbanded, "MAX_BAND_TILE", max_tile)
    monkeypatch.setattr(tbanded, "MAX_BAND_TILE", max_tile)
    (je, jw, js), (te, tw, ts) = _both(3, sub_size, granularity=64)
    assert len(je) == len(te) == (1 if sub_size > 1280 else 4)
    assert dataclasses.astuple(jw) == dataclasses.astuple(tw)
    for (jbv, jbf, jmeta, jv, jf), (tbv, tbf, tmeta, tv, tf) in zip(je, te):
        for a, b in ((jbv, tbv), (jbf, tbf)):
            for name in ("x", "edge_index", "edge_weight"):
                assert_bit_equal(getattr(a, name), getattr(b, name), name)
            for sa, sb in zip(a.specs, b.specs):
                assert_bit_equal(tuple(sa.step_clusters), tuple(sb.step_clusters), "clusters")
                assert tuple(sa.step_sizes) == tuple(sb.step_sizes)
                for name in ("unpool", "edge_index", "edge_weight"):
                    assert_bit_equal(getattr(sa, name), getattr(sb, name), name)
        for k in jmeta:
            assert_bit_equal(np.asarray(jmeta[k]), np.asarray(tmeta[k]), k)
        assert_bit_equal(jv, tv, "V_idx")
        assert_bit_equal(jf, tf, "F_idx")
    for a, b in zip(js, ts):
        assert_bit_equal(a, b)
    if max_tile == 64:
        assert any(lvl.jnodes is not None for s in ts for lvl in s.f.levels)


def test_ico5_hybrid_band_arrays_bit_equal():
    """The slice's mesh: icosphere(5) with noise, 2 patches of <= 20000
    faces.  The merged widths put the facet level 1 on the hybrid band; its
    jnodes / jband / jpos and every other array are bit-equal."""
    (_, jw, js), (_, tw, ts) = _both(5, 20000)
    assert len(ts) == 2
    assert dataclasses.astuple(jw) == dataclasses.astuple(tw)
    for s in ts:
        f1 = s.f.levels[0]
        assert f1.jnodes is not None and f1.band.shape[1] == 256
    for a, b in zip(js, ts):
        assert_bit_equal(a, b)
