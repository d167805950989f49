"""The port's training path against the JAX package on the CPU: losses and
metrics, the rotation, the optimizers and learning-rate policies, and two
epochs of the Trainer (the DualGNN gradients are in test_torch_grads.py).

Inputs are made with numpy from a seed and handed to both packages; the
JAX convs run their Pallas kernels in interpret mode.  Tolerances are
stated at each comparison.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import augment as jaugment
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu.data import dataset as jdataset
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.models import losses as jlosses
from geobignn_tpu.train import optim as joptim
from geobignn_tpu.train import trainer as jtrainer
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import augment, builder, dataset, synth
from geobignn_tpu_torch.models import losses
from geobignn_tpu_torch.train import optim
from geobignn_tpu_torch.train.trainer import Trainer


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


# --------------------------------------------------------------------------
# losses and metrics: float32, 1e-5 relative (the same math, summed in
# another order), except the euclidean nearest distance, 1e-4: it expands
# |a|^2 - 2 a.b + |b|^2, which cancels to an absolute error of about
# eps |a|^2 that the square root magnifies for the closest pairs
# --------------------------------------------------------------------------

def _loss_inputs():
    rng = np.random.default_rng(0)
    n = 300
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = (a + 0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    na = a / np.linalg.norm(a, axis=1, keepdims=True)
    nb = b / np.linalg.norm(b, axis=1, keepdims=True)
    mask = (rng.random(n) > 0.2).astype(np.float32)
    row = rng.integers(0, n, 900)
    col = rng.integers(0, n, 900)
    keep = row != col
    ei = np.stack([row[keep], col[keep]]).astype(np.int64)
    return dict(a=a, b=b, na=na, nb=nb, mask=mask, ei=ei)


LOSS_CASES = {
    "masked_mean": lambda L, d: L.masked_mean(d["a"][:, 0], d["mask"]),
    "loss_v_L1": lambda L, d: L.loss_v(d["a"], d["b"], d["mask"], "L1"),
    "loss_v_L2": lambda L, d: L.loss_v(d["a"], d["b"], d["mask"], "L2"),
    "loss_v_CD": lambda L, d: L.loss_v(d["a"], d["b"], d["mask"], "CD"),
    "loss_n_L1": lambda L, d: L.loss_n(d["na"], d["nb"], d["mask"], "L1"),
    "loss_n_L2": lambda L, d: L.loss_n(d["na"], d["nb"], d["mask"], "L2"),
    "loss_n_sided": lambda L, d: L.loss_n(d["na"], d["nb"], d["mask"], "sided",
                                          d["a"], d["b"]),
    "dual_loss": lambda L, d: L.dual_loss(d["a"][0, 0], d["b"][0, 0], 2.0, 0.5),
    "dual_loss_alpha": lambda L, d: L.dual_loss(d["a"][0, 0], d["b"][0, 0], 2.0, 0.5, 0.3),
    "error_v": lambda L, d: L.error_v(d["a"], d["b"], d["mask"]),
    "error_n": lambda L, d: L.error_n(d["na"], d["nb"], d["mask"]),
    "laplacian": lambda L, d: L.laplacian_loss(d["a"], d["b"], d["ei"], d["mask"]),
    "laplacian_normal": lambda L, d: L.laplacian_loss(d["a"], d["b"], d["ei"], d["mask"],
                                                      d["na"]),
    "chamfer": lambda L, d: L.chamfer_distance(d["a"], d["b"], d["mask"], d["mask"],
                                               block=128),
    "nearest_index": lambda L, d: L.nearest_index(d["a"], d["b"], d["mask"], block=128),
    "nearest_euclidean": lambda L, d: L.nearest_distance(d["a"], d["b"], 128, "euclidean"),
    "nearest_manhattan": lambda L, d: L.nearest_distance(d["a"], d["b"], 128, "manhattan"),
    "nearest_chebyshev": lambda L, d: L.nearest_distance(d["a"], d["b"], 128, "chebyshev"),
    "nearest_cosine": lambda L, d: L.nearest_distance(d["a"], d["b"], 128, "cosine"),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_jax(name):
    d = _loss_inputs()
    want = np.asarray(LOSS_CASES[name](jlosses, {k: jnp.asarray(v) for k, v in d.items()}))
    got = LOSS_CASES[name](losses, {k: torch.from_numpy(v) for k, v in d.items()}).numpy()
    if name == "nearest_index":
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel_err(got, want) <= (1e-4 if name == "nearest_euclidean" else 1e-5), name


def test_loss_v_icp_is_not_ported():
    d = {k: torch.from_numpy(v) for k, v in _loss_inputs().items()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        losses.loss_v(d["a"], d["b"], d["mask"], apply_icp=True)


# --------------------------------------------------------------------------
# rotation
# --------------------------------------------------------------------------

def _pair(synth_mod, sub, seed):
    m_o = synth_mod.icosphere(sub)
    return synth_mod.add_noise(m_o, 0.3, seed=seed), m_o


def _sample(builder_mod, synth_mod, sub=2, seed=1, granularity=64):
    m_n, m_o = _pair(synth_mod, sub, seed)
    bc = builder_mod.BuildConfig(granularity=granularity, reorder=True)
    bv, bf, meta = builder_mod.build_raw(m_n, m_o, bc)
    s, _ = builder_mod.build_dual_sample(m_n, m_o, bc)
    w = builder_mod.widths_for(bv, bf, meta["fv_indices"], with_bands=True)
    return builder_mod.attach_tables(s, w)


def test_rotate_sample_matches_jax():
    """rotate_sample with one given matrix (the JAX package's own draw):
    every rotated field equal to float32 rounding (1e-6 relative)."""
    rot = np.asarray(jaugment.random_rotation_matrix(jax.random.PRNGKey(3)))
    s_j = jaugment.rotate_sample(_sample(jbuilder, jsynth), jnp.asarray(rot))
    s_t = augment.rotate_sample(_sample(builder, synth).to("cpu"), torch.from_numpy(rot))
    for a, b in ((s_t.v.x, s_j.v.x), (s_t.v.y, s_j.v.y), (s_t.f.x, s_j.f.x),
                 (s_t.f.y, s_j.f.y)):
        assert _rel_err(a.numpy(), b) <= 1e-6
    assert s_t.v.depth_direction is None and s_j.v.depth_direction is None


def test_random_rotation_is_a_rotation():
    gen = torch.Generator().manual_seed(0)
    for z_only in (False, True):
        r = augment.random_rotation_matrix(gen, z_only).double()
        torch.testing.assert_close(r @ r.T, torch.eye(3, dtype=torch.float64),
                                   rtol=0, atol=1e-6)
        assert abs(float(torch.linalg.det(r)) - 1.0) < 1e-6
    assert float(r[2, 2]) == 1.0  # z_only: a rotation about z


# --------------------------------------------------------------------------
# optimizers and learning-rate policies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["plain", "decay"])
@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop"])
def test_optimizer_matches_optax(name, weight_decay):
    """Five identical gradient steps (the learning rate changed after the
    second, through set_lr) into the port's optimizer and the JAX package's
    optax one: parameters within 1e-6 relative (float32 rounding)."""
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(7, 5)).astype(np.float32)
    grads = [rng.normal(size=(7, 5)).astype(np.float32) for _ in range(5)]
    cfg = dict(optimizer=name, lr=1e-2, weight_decay=weight_decay)

    tx = joptim.make_optimizer(JConfig(**cfg))
    pj = {"w": jnp.asarray(p0)}
    state = tx.init(pj)
    prm = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optim.make_optimizer(Config(**cfg), [prm])
    for step, g in enumerate(grads):
        if step == 2:
            state = joptim.set_lr(state, 5e-3)
            optim.set_lr(opt, 5e-3)
        upd, state = tx.update({"w": jnp.asarray(g)}, state, pj)
        pj = {"w": pj["w"] + upd["w"]}
        prm.grad = torch.from_numpy(g.copy())
        opt.step()
    assert _rel_err(prm.detach().numpy(), pj["w"]) <= 1e-6


def test_lr_policies_match_jax():
    for kw in (dict(lr_sch="lmd"), dict(lr_sch="step"),
               dict(lr_sch="multi_step", lr_step=(3, 7)), dict(lr_sch="exp")):
        base = dict(lr=0.1, lr_decay=0.5, lr_step=(4,))
        base.update(kw)
        for epoch in range(12):
            assert optim.lr_at_epoch(Config(**base), epoch) == pytest.approx(
                joptim.lr_at_epoch(JConfig(**base), epoch), rel=1e-12)
    with pytest.raises(ValueError):
        optim.lr_at_epoch(Config(lr_sch="auto"), 0)
    pt = optim.PlateauState(lr=1.0, factor=0.1, patience=2)
    pj = joptim.PlateauState(lr=1.0, factor=0.1, patience=2)
    for v in (1.0, 0.9, 0.9, 0.9, 0.9, 0.5, 0.5, 0.5, 0.5):
        assert pt.step(v) == pj.step(v)


def test_branch_messages_match_jax():
    pairs_t = [_pair(synth, 2, s) for s in (1, 2)]
    pairs_j = [_pair(jsynth, 2, s) for s in (1, 2)]
    ds_t = dataset.InMemoryDataset(pairs_t, builder.BuildConfig(granularity=64, reorder=True))
    ds_j = jdataset.InMemoryDataset(pairs_j, jbuilder.BuildConfig(granularity=64, reorder=True))
    np.testing.assert_array_equal(ds_t.messages_per_sample(), ds_j.messages_per_sample())
    bv = ds_t.entries[0][0]
    assert dataset.branch_messages(bv) == jdataset.branch_messages(ds_j.entries[0][0]) > 0


# --------------------------------------------------------------------------
# two epochs of the Trainer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [1, 2])
def test_trainer_matches_jax(batch_size):
    """Two epochs over two samples, augment off, the JAX trainer's initial
    parameters loaded into the port.  Adam's first step is about
    lr * sign(g), so a parameter whose gradient is near zero can move by up
    to 2 lr differently per step in the two packages; the comparison is on
    the trajectories: the per-epoch train loss and normal error within
    2e-2 relative, and the same plateau-free lr schedule."""
    kw = dict(max_epoch=2, seed=1, granularity=64, augment=False,
              batch_size=batch_size, lr=1e-3)
    ds_j = jdataset.InMemoryDataset([_pair(jsynth, 2, s) for s in (1, 2)],
                                    jbuilder.BuildConfig(granularity=64, reorder=True))
    ds_t = dataset.InMemoryDataset([_pair(synth, 2, s) for s in (1, 2)],
                                   builder.BuildConfig(granularity=64, reorder=True))
    hist_j, hist_t = [], []
    # preload=False keeps the JAX trainer on its per-step path (the same
    # updates as its whole-epoch scan, which takes twice as long to compile)
    jtr = jtrainer.Trainer(JConfig(preload=False, **kw), ds_j)
    tr = Trainer(Config(**kw), ds_t, device="cpu")
    tr.model.load_state_dict(tparams.from_jax_params(jax.tree.map(np.asarray, jtr.params)))
    jtr.fit(on_epoch=lambda t, m, e: hist_j.append(m))
    tr.fit(on_epoch=lambda t, m, e: hist_t.append(m))
    assert len(hist_t) == len(hist_j) == 2
    for mt, mj in zip(hist_t, hist_j):
        for k in ("loss", "error_f"):
            assert abs(mt[k] - mj[k]) <= 2e-2 * abs(mj[k]), (k, mt[k], mj[k])
        assert mt["n_v"] == mj["n_v"] and mt["n_f"] == mj["n_f"]
        assert mt["edges_per_s"] > 0 and mt["samples_per_s"] > 0
    assert hist_t[1]["loss"] < hist_t[0]["loss"]


def test_trainer_refuses_unported_modes():
    ds = dataset.InMemoryDataset([_pair(synth, 1, 1)],
                                 builder.BuildConfig(granularity=32, reorder=True))
    for kw in (dict(edge_weight_type=3),
               dict(dynamic_pool=True), dict(dp=2), dict(precision="bfloat16"),
               dict(preload=False), dict(preload=False, buckets_growth=1.5)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(Config(granularity=32, **kw), ds, device="cpu")
    # checkpoints are ported: a run directory, and the restore / auto_resume
    # flags that train() acts on, no longer raise (tests/test_torch_rundir.py)
    for kw in (dict(restore=True), dict(auto_resume=True)):
        Trainer(Config(granularity=32, **kw), ds, device="cpu")
    assert Trainer(Config(granularity=32), ds, run_dir="runs", device="cpu").run_dir == "runs"
