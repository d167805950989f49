"""Faults of the port found against the reference, each held by a test that
fails on the code before its repair.

- The JAX trainers' initial weights for halo_convergence's Config at
  seeds 7-11, committed as geobignn_tpu_torch/examples/data/
  halo_conv_jax_init.npz (seed 7) and halo_conv_jax_init_s{8..11}.npz
  (halo_convergence.jax_init(seed), its --init): each equal to a fresh
  init bit for bit.  `python tests/test_torch_faults.py write-init 7 8 9 10
  11` regenerates them from the JAX package's Trainer and HaloTrainer on
  the script's corpus and checks at each seed that both start from the
  same tree.
- A second pinned from_run while a pin is held keeps the live package, so
  one unpin restores it (infer/predict._import_pinned).
- The COO conv's per-head branch above FUSED_HEADS_MAX elements
  (ops/feastconv._partial_aggregate, the JAX function's scan over heads),
  both branches against JAX's feast_conv within 1e-5.
- HaloTrainer on an empty corpus raises a ValueError that names mesh_pairs.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu import graphs as jgraphs
from geobignn_tpu import native as jnative
from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.models import DualGNN as JDualGNN
from geobignn_tpu.ops import feastconv as jfeast
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.examples import halo_convergence as hc
from geobignn_tpu_torch.infer import predict
from geobignn_tpu_torch.ops import feastconv as tfeast
from geobignn_tpu_torch.train.halo_trainer import HaloTrainer

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "geobignn_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


def _jax_config(mode: str, seed: int = 7) -> JConfig:
    cfg = hc.run_config(mode, 60, seed)
    return JConfig(**{f: getattr(cfg, f) for f in (
        "data_type", "flag", "seed", "max_epoch", "lr", "lr_sch", "lr_decay", "lr_step",
        "augment", "preload", "granularity", "batch_size", "halo_parts")})


@pytest.mark.parametrize("seed", hc.JAX_INIT_SEEDS)
def test_committed_jax_initial_weights_are_the_jax_trainers(seed):
    """The committed .npz of `seed` against the JAX model's init under the
    trainers' key, jax.random.PRNGKey(seed), on a small sample (flax draws
    each parameter from the key and the module path, so the sample's size
    does not enter): bit for bit, every one of the 939,128 parameters."""
    jcfg = _jax_config("halo", seed)
    m_o = jsynth.icosphere(1)
    sample, _ = jbuilder.build_dual_sample(
        jsynth.add_noise(m_o, 0.2, seed=0), m_o,
        jbuilder.BuildConfig(granularity=16, reorder=False))
    model = JDualGNN(force_depth=jcfg.force_depth, pool_type=jcfg.pool_type, heads=jcfg.heads)
    want = tparams.from_jax_params(jax.tree.map(
        np.asarray, model.init(jax.random.PRNGKey(jcfg.seed), sample)))
    got = tparams.load_npz(hc.jax_init(seed))
    assert set(got) == set(want)
    assert sum(v.numel() for v in got.values()) == 939_128
    assert all(got[k].dtype == torch.float32 and torch.equal(got[k], want[k]) for k in want)


# the port's own pairs at seeds 7-11 as an H100 measured them (rel_gap)
OWN_MEASURED = {7: 0.0616, 8: 0.0305, 9: 0.0172, 10: 0.0429, 11: 0.1422}


EVERY, ONE = "every JAX-weights pair meets", "a JAX-weights pair misses"  # gate's two rules
JAX_MEET = {7: 0.0048, 8: 0.01, 9: 0.02, 10: 0.03, 11: 0.04}
JAX_MISS = {7: 0.0048, 8: 0.06, 9: 0.02, 10: 0.03, 11: 0.01}


@pytest.mark.parametrize("own, jax_pairs, met, rule", [
    # every JAX-weights pair meets the bound: the port's seed-7 pair is held
    (OWN_MEASURED, JAX_MEET, False, EVERY),
    ({**OWN_MEASURED, 7: 0.03}, JAX_MEET, True, EVERY),
    # one JAX-weights pair misses it: the port's median against the larger of
    # the bound and the JAX median
    (OWN_MEASURED, JAX_MISS, True, ONE),
    ({7: 0.07, 8: 0.08, 9: 0.09, 10: 0.02, 11: 0.03},
     {7: 0.0048, 8: 0.06, 9: 0.07, 10: 0.075, 11: 0.1}, True, ONE),
    ({7: 0.07, 8: 0.08, 9: 0.09, 10: 0.02, 11: 0.03}, JAX_MISS, False, ONE),
])
def test_halo_convergence_gate(own, jax_pairs, met, rule):
    """halo_convergence.gate on both branches of its rule, the measured
    own-weights pairs among the cases; seeds that differ are refused."""
    got, said = hc.gate(own, jax_pairs, 0.05)
    assert got is met and said.startswith(rule), said
    with pytest.raises(ValueError, match="same seeds"):
        hc.gate(own, {k: v for k, v in jax_pairs.items() if k != 11}, 0.05)


def _fake_run(tmp_path, name: str) -> str:
    """A run directory whose code_bak holds a copy of the package's sources."""
    run_dir = tmp_path / name
    shutil.copytree(os.path.join(ROOT, PKG), run_dir / "code_bak" / PKG,
                    ignore=shutil.ignore_patterns("__pycache__", "examples"))
    return str(run_dir)


def test_second_pin_keeps_the_live_package(tmp_path):
    """Two pinned imports of two run directories' snapshots, then one
    unpin: afterwards sys.modules holds the live package's modules (by
    identity) and sys.path is as before."""
    live_pkg = sys.modules[PKG]
    live_predict = sys.modules[PKG + ".infer.predict"]
    path_before = list(sys.path)
    runs = [_fake_run(tmp_path, f"run{i}") for i in range(2)]
    try:
        first = predict._import_pinned(runs[0])
        second = predict._import_pinned(runs[1])
        assert first is not live_predict and second is not live_predict
        assert os.path.join(runs[1], "code_bak") in second.__file__
        assert os.path.join(runs[0], "code_bak") not in sys.path
    finally:
        predict.unpin_live_package()
    assert sys.modules[PKG] is live_pkg
    assert sys.modules[PKG + ".infer.predict"] is live_predict
    assert sys.path == path_before and predict._PINNED_STATE is None


@pytest.mark.parametrize("gate", ["fused", "per_head"])
def test_coo_conv_branches_match_jax(gate, monkeypatch):
    """feast_conv's fused-heads branch and, with FUSED_HEADS_MAX lowered to
    0, its per-head branch, against JAX's feast_conv (its fused branch at
    this size; the two branches compute one sum) on a noisy icosphere(2)'s
    vertex graph with unsorted rows: outputs and the gradients of x and of
    every parameter within 1e-5 of their max."""
    if gate == "per_head":
        monkeypatch.setattr(tfeast, "FUSED_HEADS_MAX", 0)
    mesh = jsynth.add_noise(jsynth.icosphere(2), 0.2, seed=4)
    ei = jgraphs.build_vertex_graph_1ring(mesh.ev_indices, mesh.n_vertices)
    ei = ei[:, np.random.default_rng(0).permutation(ei.shape[1])]
    n, c_in, c_out, heads = mesh.n_vertices + 1, 8, 5, 9
    rng = np.random.default_rng(1)
    x = np.zeros((n, c_in), np.float32)
    x[:-1] = rng.normal(size=(n - 1, c_in))
    prm = dict(u=rng.normal(size=(c_in, heads)) * 0.5, c=rng.normal(size=heads) * 0.3,
               w=rng.normal(size=(heads, c_in, c_out)) * 0.4, b=rng.normal(size=c_out))
    prm = {k: v.astype(np.float32) for k, v in prm.items()}
    cot = rng.normal(size=(n, c_out)).astype(np.float32)

    def jloss(p, xx):
        out = jfeast.feast_conv(jfeast.FeastParams(**p), xx, jnp.asarray(ei))
        return (out * cot).sum(), out

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in prm.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in prm.items()}
    tx = torch.tensor(x, requires_grad=True)
    got = tfeast.feast_conv(tp, tx, torch.from_numpy(ei))
    (got * torch.from_numpy(cot)).sum().backward()
    pairs = [(got.detach().numpy(), np.asarray(want)), (tx.grad.numpy(), np.asarray(gx))]
    pairs += [(tp[k].grad.numpy(), np.asarray(gp[k])) for k in prm]
    for a, b in pairs:
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), np.abs(a - b).max()


def test_halo_trainer_refuses_an_empty_corpus():
    with pytest.raises(ValueError, match="mesh_pairs is empty"):
        HaloTrainer(hc.run_config("halo", 1, 7), [], device="cpu")


def write_initial_weights(seeds):
    """The JAX Trainer's and HaloTrainer's initial weights for
    halo_convergence's Config at each of `seeds` on the script's corpus,
    checked equal, written to hc.jax_init(seed) in the port's names."""
    from geobignn_tpu.data import dataset as jdataset
    from geobignn_tpu.train import trainer as jtrainer
    from geobignn_tpu.train.halo_trainer import HaloTrainer as JHaloTrainer

    spec = importlib.util.spec_from_file_location(
        "jax_halo_convergence", os.path.join(ROOT, "examples", "halo_convergence.py"))
    jh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jh)
    train, evals = jh.corpus()
    for seed in seeds:
        jcfg = _jax_config("single", seed)
        bc = jcfg.build_config()
        trees = {"single": jtrainer.Trainer(jcfg, jdataset.InMemoryDataset(train, bc),
                                            jdataset.InMemoryDataset(evals, bc)).params,
                 "halo": JHaloTrainer(_jax_config("halo", seed), train, evals).params}
        states = {m: tparams.from_jax_params(jax.tree.map(np.asarray, t))
                  for m, t in trees.items()}
        same = set(states["single"]) == set(states["halo"]) and all(
            torch.equal(states["single"][k], states["halo"][k]) for k in states["single"])
        print(f"seed {seed}: single-device and 8-part trainers start from the same tree: {same}")
        assert same
        path = hc.jax_init(seed)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tparams.save_npz(path, states["single"])
        print(f"{sum(v.numel() for v in states['single'].values())} parameters -> {path}")


if __name__ == "__main__":  # python tests/test_torch_faults.py write-init [SEED ...]
    import conftest  # noqa: F401  (the JAX CPU settings of the test suite)

    testing.match_reference_native(jnative)
    if sys.argv[1:2] == ["write-init"]:
        write_initial_weights([int(s) for s in sys.argv[2:]] or [7])
