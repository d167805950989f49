"""Halo-sharded training against the JAX package: one step of
`make_halo_train_step` (loss 1e-5, every parameter after the step within
1e-4 of its max|change|, see `_assert_params_close`), `HaloTrainer`'s
first epoch (1e-4), and the trainer's surface (fit, eval, checkpoints,
resume, `train()` routing, the surface-to-volume warning) on the CPU, 2
and 4 parts.  Augmentation is off in the parity runs but one, where the
two packages draw rotations from different generators: there the JAX
step is handed the rotations the port draws before its step, one per
chained step."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geobignn_tpu import meshio as jmeshio
from geobignn_tpu import native as jnative
from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.data.builder import BuildConfig as JBuildConfig
from geobignn_tpu.parallel import halo_train as jht
from geobignn_tpu.parallel.api import make_mesh as jmake_mesh
from geobignn_tpu.train.halo_trainer import HaloTrainer as JHaloTrainer
from geobignn_tpu_torch import params as pm
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import builder
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.parallel import halo_model as hm
from geobignn_tpu_torch.parallel import halo_train as ht
from geobignn_tpu_torch.train.halo_trainer import HaloTrainer
from test_torch_halo import band_gate_128, mixed_band_pair  # noqa: F401 (a fixture)

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    testing.match_reference_native(jnative)


def _pairs(n=2, noise=0.2):
    m_o = jsynth.icosphere(2)
    return [(jsynth.add_noise(m_o, noise, seed=i), m_o) for i in range(n)]


@pytest.fixture
def banded_in_float32(monkeypatch):
    """Both packages' halo banded conv with its aggregate in float32."""
    import functools

    from geobignn_tpu.parallel import partition as jhp

    monkeypatch.setattr(jhp, "halo_feast_conv_banded", functools.partial(
        jhp.halo_feast_conv_banded, compute_dtype=jnp.float32))
    with testing.aggregates_in(torch.float32):
        yield


def _assert_params_close(model, jtree, before: dict, lr: float, tol: float = 1e-4):
    """After one Adam step from `before`: every parameter within tol of its
    max|change|, plus two terms that no float32 computation avoids — one
    ulp of the parameter (the rounding of adding the change), and Adam's
    first-step sensitivity to a gradient that agrees within 1e-5 of the
    tensor's max|g| (the bound tests/test_torch_halo_model.py holds): the
    update -lr g / (|g| + eps) moves by lr eps dg / (|g| + eps)^2, which is
    large only where |g| is near eps.  The gradient is the port's, left in
    .grad by the step."""
    jflat = pm.from_jax_params(jtree)
    ulp, eps = torch.finfo(torch.float32).eps, 1e-8
    for name, prm in model.named_parameters():
        got, want, g = prm.detach(), jflat[name], prm.grad.abs()
        step = (want - before[name]).abs().max()
        adam = lr * eps * 1e-5 * g.max() / (g + eps) ** 2
        assert ((got - want).abs() <= tol * step + ulp * want.abs() + adam).all(), name


@pytest.mark.parametrize("n_parts,mode", [(4, "table"), (8, "mixed")],
                         ids=["4-table", "8-mixed"])
def test_halo_train_step_matches_jax(n_parts, mode, request):
    """One Adam step: the port's make_halo_train_step against JAX's under
    shard_map.  4 parts in table mode; 8 parts in the mixed mode of
    examples/run_1m.py's mesh at a small size (test_torch_halo.py's
    mixed_band_pair, BuildConfig(granularity=256, reorder=False), the tile
    gate at 128 in both packages): the vertex level banded, the facet branch
    on tables.  The banded aggregate computes in float32 in both packages
    there: with their default bf16 operands, which the two round at
    different points, Adam's first step carries the gradients' rounding to
    3e-3 of a tensor's change."""
    if mode == "mixed":
        request.getfixturevalue("band_gate_128")
        request.getfixturevalue("banded_in_float32")
        (m_n, m_o), kw, seed = mixed_band_pair(), dict(granularity=256, reorder=False), 0
    else:
        (m_n, m_o), kw, seed = _pairs(2)[1], dict(granularity=16), 1
    s = ht.build_halo_train_sample(m_n, m_o, builder.BuildConfig(**kw), n_parts, seed=seed,
                                   banded=mode == "mixed")
    js = jht.build_halo_train_sample(m_n, m_o, JBuildConfig(**kw), n_parts, seed=seed,
                                     banded=mode == "mixed")
    assert (s.structure.v.band0 is not None, s.structure.f.band0 is not None) == (
        mode == "mixed", False)
    model = DualGNN(device="cpu", seed=11)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
    metrics = ht.make_halo_train_step(model, opt, s.static)(s.arrays, seed=7)

    tx = optax.adam(1e-3)
    p0 = pm.to_jax_params(before)["params"]
    step = jht.make_halo_train_step(tx, jmake_mesh(1, n_parts), js.arrays, static_d=js.static)
    p1, _, jm = step(p0, tx.init(p0), jax.tree.map(jnp.asarray, js.arrays),
                     jax.random.PRNGKey(7))
    for k in ("loss", "loss_v", "loss_f", "error_v", "error_f", "n_v", "n_f"):
        assert abs(float(metrics[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    _assert_params_close(model, jax.tree.map(np.asarray, p1), before, 1e-3)
    with pytest.raises(ValueError, match="static_d"):
        ht.make_halo_train_step(model, opt, None)  # an empty schedule is refused


def test_chained_halo_step_rotations_drawn_before_the_step_match_jax(monkeypatch):
    """n_steps=2 with augmentation: the port draws both chained steps'
    rotations from the step's seed before the step (as the CUDA graph of
    the step takes them in); JAX's scan, given the same two rotations for
    its two keys, ends on the same metrics (1e-5) and parameters (1e-4 of
    each tensor's max|change| and an ulp, as `_assert_params_close`).  SGD:
    Adam's second step would carry the first step's rounding, amplified
    where a gradient is near eps."""
    from geobignn_tpu_torch.data.augment import random_rotation_matrix

    m_n, m_o = _pairs(1)[0]
    s = ht.build_halo_train_sample(m_n, m_o, builder.BuildConfig(granularity=16), 2, seed=1)
    js = jht.build_halo_train_sample(m_n, m_o, JBuildConfig(granularity=16), 2, seed=1)
    model = DualGNN(device="cpu", seed=11)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    metrics = ht.make_halo_train_step(model, opt, s.static, augment=True, n_steps=2)(
        s.arrays, seed=7)

    gen = torch.Generator().manual_seed(7)
    rots = jnp.asarray(np.stack([random_rotation_matrix(gen).numpy() for _ in range(2)]))
    keys = jax.random.split(jax.random.PRNGKey(3), 2)

    def port_rotation(key, z_only=False):  # the scan's k-th key -> the port's k-th draw
        return rots[jnp.argmax(jnp.all(keys == key, axis=1))]

    monkeypatch.setattr(jht, "random_rotation_matrix", port_rotation)
    tx = optax.sgd(1e-2)
    p0 = pm.to_jax_params(before)["params"]
    step = jht.make_halo_train_step(tx, jmake_mesh(1, 2), js.arrays, static_d=js.static,
                                    augment=True, n_steps=2)
    p1, _, jm = step(p0, tx.init(p0), jax.tree.map(jnp.asarray, js.arrays),
                     jax.random.PRNGKey(3))
    for k in ("loss", "loss_v", "loss_f", "error_v", "error_f", "n_v", "n_f"):
        assert abs(float(metrics[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    jflat = pm.from_jax_params(jax.tree.map(np.asarray, p1))
    ulp = torch.finfo(torch.float32).eps
    for name, prm in model.named_parameters():
        got, want = prm.detach(), jflat[name]
        step = (want - before[name]).abs().max()
        assert ((got - want).abs() <= 1e-4 * step + ulp * want.abs()).all(), name


def test_halo_trainer_first_epoch_matches_jax():
    """HaloTrainer.run_epoch on 2 parts, from the same weights, against the
    JAX HaloTrainer's (its build, lr and Adam; one mesh, one step)."""
    kw = dict(max_epoch=1, seed=7, halo_parts=2, augment=False, granularity=16,
              lr_sch="lmd", lr=1e-3)
    pairs = _pairs(1)
    tr = HaloTrainer(Config(**kw), pairs, device="cpu")
    jtr = JHaloTrainer(JConfig(**kw), pairs)
    before = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    jtr.params = pm.to_jax_params(before)["params"]
    jtr.opt_state = jtr.tx.init(jtr.params)
    m = tr.run_epoch(np.random.default_rng(kw["seed"]))
    jm = jtr.run_epoch(np.random.default_rng(kw["seed"]))
    for k in ("loss", "loss_v", "loss_f", "error_v", "error_f"):
        assert abs(m[k] - jm[k]) <= 1e-4 * abs(jm[k]), k
    assert m["edges_per_s"] > 0 and m["edges_per_s_chip"] == m["edges_per_s"] / 2
    _assert_params_close(tr.model, jax.tree.map(np.asarray, jtr.params), before, kw["lr"])


def test_halo_trainer_fit_eval_checkpoints_resume(tmp_path, capsys):
    """fit (3 epochs, loss falls), node-weighted eval, best/last
    checkpoints, resume continuing the epoch counter, and the
    surface-to-volume warning below the knee."""
    cfg = Config(max_epoch=3, seed=1, halo_parts=4, lr=2e-3, augment=True, granularity=16)
    pairs = _pairs(2)
    tr = HaloTrainer(cfg, pairs, eval_pairs=pairs[:1], run_dir=str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert "surface-to-volume knee" in out and "80 faces/partition" in out
    losses = []
    tr.fit(on_epoch=lambda t, m, e: losses.append(m["loss"]))
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    ev = tr.evaluate()
    assert np.isfinite(ev["error_f"]) and np.isfinite(ev["loss_v"])
    assert os.path.exists(tmp_path / "ckpt_best.pkl")
    tr2 = HaloTrainer(cfg.with_updates(max_epoch=4), pairs, None, device="cpu")
    tr2.restore(str(tmp_path / "ckpt_last.pkl"))
    assert tr2.epoch == 3
    for a, b in zip(tr2.model.parameters(), tr.model.parameters()):
        assert torch.equal(a, b)
    assert np.isfinite(tr2.run_epoch(np.random.default_rng(0))["loss"])
    with pytest.raises(ValueError, match="2 parts, 1 devices"):
        HaloTrainer(cfg.with_updates(halo_parts=2), pairs, devices=["cpu"])


def test_train_entry_dispatches_halo(tmp_path, monkeypatch):
    """`train --halo_parts=2` on the command line end to end on disk (the
    parts on the CPU): train() routes to the HaloTrainer, writes the run
    directory, checkpoints in the JAX file format and the metric stream,
    and the chained inference denoises the test split."""
    from geobignn_tpu_torch import cli
    from geobignn_tpu_torch.train import checkpoint as ckpt

    root = tmp_path / "data"
    for split in ("train", "test"):
        nd, od = root / "Synthetic" / split / "noisy", root / "Synthetic" / split / "original"
        nd.mkdir(parents=True)
        od.mkdir(parents=True)
        m_o = jsynth.icosphere(2)
        jmeshio.write_obj(str(od / "s.obj"), m_o.points, m_o.fv_indices)
        m_n = jsynth.add_noise(m_o, 0.2, seed=0)
        jmeshio.write_obj(str(nd / "s_n1.obj"), m_n.points, m_n.fv_indices)
        (root / "Synthetic" / f"{split}_list.txt").write_text("s\n")
    monkeypatch.chdir(tmp_path)  # the run directory lands under tmp log/
    cli.main(["train", "--data_type=Synthetic", "--flag=halo-test", f"--dataset_dir={root}",
              "--max_epoch=2", "--seed=3", "--halo_parts=2", "--granularity=16",
              "--augment=False", "--device=cpu"])
    (run_dir,) = (tmp_path / "log" / "GeoBi-GNN_Synthetic_halo-test").iterdir()
    state, _, scalars = ckpt.load_checkpoint(str(run_dir / "ckpt_last.pkl"))
    assert scalars["epoch"] == 1 and len(state) == 72
    assert len((run_dir / "metrics.jsonl").read_text().strip().splitlines()) >= 4
    assert (run_dir / "training_info.txt").read_text().startswith("Halo training (2 parts)")
    assert (root / "Synthetic" / "test" / "result_halo-test" / "s_n1-60.obj").exists()


def test_halo_step_with_chamfer_and_sided_losses_matches_jax():
    """loss_v="CD" (one chamfer over the gathered parts, the JAX psum(cd/P))
    and loss_n="sided" (each local face matched to the nearest global
    one): one step's metrics within 1e-5 of JAX's and the parameters as in
    test_halo_train_step_matches_jax; the halo loss's value and gradient
    against the single-device losses on the same hierarchies, 1e-5."""
    from geobignn_tpu_torch.models import losses

    m_n, m_o = _pairs(1)[0]
    loss_cfg = dict(loss_v="CD", loss_n="sided")
    s = ht.build_halo_train_sample(m_n, m_o, builder.BuildConfig(granularity=16), 2, seed=1)
    js = jht.build_halo_train_sample(m_n, m_o, JBuildConfig(granularity=16), 2, seed=1)
    model = DualGNN(device="cpu", seed=11)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    # value and gradient against the single-device losses of the same forward
    loss, _ = ht._halo_loss(pm.tree_of(model), s.arrays, s.static, "max", loss_cfg)
    g_halo = torch.autograd.grad(loss, list(model.parameters()))
    yv, yf = ht.unshard_predictions(s, [a["yv"] for a in s.arrays], [a["yf"] for a in s.arrays])

    def global_rows(parts, sh, n):  # the parts' rows in global order, with autograd
        order = sh.owner[:n].astype(np.int64) * sh.n_loc + sh.slot_of[:n]
        return torch.cat(parts)[torch.from_numpy(order)]

    vp_parts, np_parts = hm.halo_dual_gnn(
        pm.tree_of(model), [a["xv"] for a in s.arrays], [a["xf"] for a in s.arrays],
        [a["d"] for a in s.arrays], s.static)
    vp = global_rows(vp_parts, s.structure.v.levels[0], s.n_v)
    nf = global_rows(np_parts, s.structure.f.levels[0], s.n_f)
    fv = torch.from_numpy(s.meta["fv_indices"].astype(np.int64))
    yv_t, yf_t = torch.from_numpy(yv), torch.from_numpy(yf)
    ref = (losses.loss_v(vp, yv_t, torch.ones(s.n_v), "CD")
           + losses.loss_n(nf, yf_t, torch.ones(s.n_f), "sided", vp.detach()[fv].mean(1),
                           yv_t[fv].mean(1)))
    g_ref = torch.autograd.grad(ref, list(model.parameters()))
    assert abs(float(loss.detach()) - float(ref.detach())) <= 1e-5 * abs(float(ref.detach()))
    for (name, _), a, b in zip(model.named_parameters(), g_halo, g_ref):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max() + 1e-12, name

    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
    metrics = ht.make_halo_train_step(model, opt, s.static, loss_cfg)(s.arrays)
    tx = optax.adam(1e-3)
    p0 = pm.to_jax_params(before)["params"]
    step = jht.make_halo_train_step(tx, jmake_mesh(1, 2), js.arrays, static_d=js.static,
                                    loss_cfg=loss_cfg)
    p1, _, jm = step(p0, tx.init(p0), jax.tree.map(jnp.asarray, js.arrays),
                     jax.random.PRNGKey(0))
    for k in ("loss", "loss_v", "loss_f", "error_v", "error_f"):
        assert abs(float(metrics[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    _assert_params_close(model, jax.tree.map(np.asarray, p1), before, 1e-3)
