"""params.init_ draws each leaf from the distribution flax draws it from.

The two frameworks' generators differ, so the draws are compared in
distribution, leaf by leaf, for halo_convergence.run_config's model at the
seeds whose runs chip_smoke.py --halo-conv compares (7-11): the port's
DualGNN(seed=s) against the JAX model's init under jax.random.PRNGKey(s)
(its Trainer's and HaloTrainer's key).  On each leaf: shape and dtype;
zeros exactly where flax gives zeros; and on the others, with n the leaf's
size and sigma, kappa the JAX draw's standard deviation and kurtosis,

- the means within Z standard errors of their difference, Z * sigma *
  sqrt(2 / n);
- the standard deviations within Z * sigma * sqrt((kappa - 1) / (2 n)),
  the large-sample standard error of the difference of two sample
  standard deviations;
- max|.| of each draw at least the other draw's TOP-th largest |.|: for two
  samples of one continuous distribution, the chance that the TOP largest
  of the pooled 2n values all come from one side is below 2^-TOP.

Z = 5 puts a false alarm near 6e-7 a comparison, under 1e-3 over the 720
comparisons here (36 random leaves, four comparisons, five seeds); a
distribution that differs in scale by 10% is caught on every leaf of
2,000 values or more.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from geobignn_tpu import native as jnative
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.models import DualGNN as JDualGNN
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.examples import halo_convergence as hc
from geobignn_tpu_torch.models.dual_gnn import DualGNN

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores

SEEDS = (7, 8, 9, 10, 11)
Z = 5.0
TOP = 21


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


@pytest.fixture(scope="module")
def jax_draws():
    """The JAX model's init at each seed, in the port's names (flax draws
    each parameter from the key and the module path, so the small sample's
    size does not enter)."""
    cfg = hc.run_config("halo", 60, 7)
    m_o = jsynth.icosphere(1)
    sample, _ = jbuilder.build_dual_sample(
        jsynth.add_noise(m_o, 0.2, seed=0), m_o,
        jbuilder.BuildConfig(granularity=16, reorder=False))
    model = JDualGNN(force_depth=cfg.force_depth, pool_type=cfg.pool_type, heads=cfg.heads)
    return {s: tparams.from_jax_params(jax.tree.map(
        np.asarray, model.init(jax.random.PRNGKey(s), sample))) for s in SEEDS}


def _misses(name, mine, theirs):
    """What one leaf's draw gets wrong against flax's, as strings."""
    if mine.shape != theirs.shape or mine.dtype != theirs.dtype:
        return [f"{name}: {tuple(mine.shape)} {mine.dtype} against "
                f"{tuple(theirs.shape)} {theirs.dtype}"]
    a, b = mine.numpy().astype(np.float64).ravel(), theirs.numpy().astype(np.float64).ravel()
    if not b.any() or not a.any():
        return [] if not (a.any() or b.any()) else [f"{name}: zeros on one side only"]
    n = b.size
    assert n >= TOP, (name, n)
    sigma = b.std()
    kappa = np.mean((b - b.mean()) ** 4) / sigma ** 4
    out = []
    d_mean, tol_mean = abs(a.mean() - b.mean()), Z * sigma * np.sqrt(2.0 / n)
    if d_mean > tol_mean:
        out.append(f"{name}: means {a.mean():.4e} / {b.mean():.4e}, tol {tol_mean:.2e}")
    d_std, tol_std = abs(a.std() - sigma), Z * sigma * np.sqrt((kappa - 1) / (2.0 * n))
    if d_std > tol_std:
        out.append(f"{name}: stds {a.std():.4e} / {sigma:.4e}, tol {tol_std:.2e}")
    ma, mb = np.sort(np.abs(a)), np.sort(np.abs(b))
    if ma[-1] < mb[-TOP] or mb[-1] < ma[-TOP]:
        out.append(f"{name}: max|.| {ma[-1]:.4e} / {mb[-1]:.4e}, TOP-th largest "
                   f"{ma[-TOP]:.4e} / {mb[-TOP]:.4e}")
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_init_draws_each_leaf_as_flax(jax_draws, seed):
    cfg = hc.run_config("halo", 60, seed)
    mine = DualGNN(force_depth=cfg.force_depth, pool_type=cfg.pool_type, heads=cfg.heads,
                   device="cpu", seed=seed).state_dict()
    theirs = jax_draws[seed]
    assert set(mine) == set(theirs)
    assert sum(v.numel() for v in mine.values()) == 939_128
    misses = [m for k in sorted(theirs) for m in _misses(k, mine[k], theirs[k])]
    assert not misses, "\n".join(misses)


def test_the_comparison_sees_a_wrong_scale(jax_draws):
    """The same comparison on the seed-7 draw with a 10% scale error (every
    leaf times 1.1) misses on each of the 19 leaves of 2,000 values or more:
    the 16 convs' `w` but the vertex branch's first and the 4 Dense
    kernels."""
    mine = DualGNN(device="cpu", seed=7).state_dict()
    theirs = jax_draws[7]
    big = [k for k, v in theirs.items() if v.numel() >= 2000 and bool(v.any())]
    assert len(big) == 19
    assert all(_misses(k, mine[k] * 1.1, theirs[k]) for k in big)
    assert all(not _misses(k, mine[k], theirs[k]) for k in big)
