"""dcn > 1: the (dcn, dp, gp) grid and its step against the JAX package, and
the multi-process form over torch.distributed.

  * the layout: `make_mesh(dp, gp, devices, dcn)` lays devices out
    (dcn, dp, gp), as JAX's `make_mesh(dp, gp, dcn=dcn)` does;
  * a 2 x 2 x 2 step (tests/test_multihost.py::
    test_dcn_step_matches_single_device's samples and JAX step, on
    conftest's 8 virtual devices) against the port's step on a (2, 2, 2)
    grid of CPU entries: the metrics within 1e-4 relative and the applied
    mean gradient within 1e-4 of each tensor's max|g| (float32 sums in
    another order);
  * `distributed_init` is a no-op for one process;
  * two processes joined over gloo (a FileStore under tmp_path, so that
    test workers cannot collide on a port), each holding a (1, 1) grid,
    take the same step as one process holding the (2, 1, 1) grid: the
    gradients and metrics within 1e-6 relative (plus 1e-12 for the convs'
    `u`, whose gradient cancels to 1e-14 here, tests/test_torch_grads.py);
    inside the group a step stays eager even on one card
    (`capture.one_card` is false).
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geobignn_tpu import native as jnative
from geobignn_tpu import parallel as jparallel
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.data.builder import BuildConfig as JBuildConfig
from geobignn_tpu.data.builder import build_dual_sample as jbuild_dual_sample
from geobignn_tpu.data.builder import build_raw as jbuild_raw
from geobignn_tpu.data.builder import plan_for as jplan_for
from geobignn_tpu.models import DualGNN as JDualGNN
from geobignn_tpu_torch import params as pm
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.data import builder, synth
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.parallel import api

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    testing.match_reference_native(jnative)


def _samples(build_raw, plan_for, build_dual_sample, cfg, seeds, sub=2):
    meshes = [(jsynth.add_noise(jsynth.icosphere(sub), 0.2, seed=s), jsynth.icosphere(sub))
              for s in seeds]
    plan = None
    for m_n, m_o in meshes:
        p = plan_for(*build_raw(m_n, m_o, cfg)[:2], cfg.granularity)
        plan = p if plan is None else plan.merge(p)
    return [build_dual_sample(m_n, m_o, cfg, plan)[0] for m_n, m_o in meshes]


def test_dcn_mesh_layout():
    devs = [torch.device("cuda", i) for i in range(8)]  # named only, never used
    mesh = api.make_mesh(2, 2, devs, dcn=2)
    jmesh = jparallel.make_mesh(2, 2, dcn=2)
    assert jmesh.shape == {"dcn": 2, "dp": 2, "gp": 2}
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    assert [[[d.index for d in row] for row in grid] for grid in mesh] == ids.tolist()
    assert api.replica_rows(mesh) == [devs[0:2], devs[2:4], devs[4:6], devs[6:8]]
    assert api.make_mesh(2, 2, devs) == [devs[0:2], devs[2:4]]  # dcn = 1: (dp, gp)
    with pytest.raises(ValueError, match="need 8 devices"):
        api.make_mesh(2, 2, devs[:7], dcn=2)


def test_dcn_step_matches_jax():
    """The JAX step of tests/test_multihost.py (its four icosphere(2)
    pairs, BuildConfig(granularity=64), here with the default Config's
    reorder=True: on reorder=False samples near-ties of the LeakyReLU split
    the two packages, see tests/test_torch_parallel.py) on a (2, 2, 2)
    mesh; the port's on [cpu] * 8.  The JAX optimizer hands the applied
    gradient back as its state (tests/test_torch_parallel.py's `grab`)."""
    jsamples = _samples(jbuild_raw, jplan_for, jbuild_dual_sample,
                        JBuildConfig(granularity=64, reorder=True), (1, 2, 3, 4))
    samples = _samples(builder.build_raw, builder.plan_for, builder.build_dual_sample,
                       builder.BuildConfig(granularity=64, reorder=True), (1, 2, 3, 4))
    model = DualGNN(device="cpu", seed=0)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    step = api.make_sharded_train_step(model, opt, api.make_mesh(2, 2, [CPU] * 8, dcn=2))
    metrics = step(api.stack_samples(samples), 0)

    grab = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    params = {"params": pm.to_jax_params(before)["params"]}
    stacked = jparallel.stack_samples(jsamples)
    jstep = jparallel.make_sharded_train_step(JDualGNN(gp_axis="gp"), grab,
                                              jparallel.make_mesh(2, 2, dcn=2), stacked)
    _, jgrads, jm = jstep(params, grab.init(params), stacked, jax.random.PRNGKey(0))
    for k in ("loss", "loss_v", "loss_f", "error_v", "error_f"):
        assert abs(float(metrics[k]) - float(jm[k])) <= 1e-4 * abs(float(jm[k])), k
    jflat = pm.from_jax_params(jax.tree.map(np.asarray, jgrads))
    err = {n: float((p.grad - jflat[n]).abs().max() / jflat[n].abs().max())
           for n, p in model.named_parameters()}
    assert max(err.values()) <= 1e-4, sorted(err.items(), key=lambda kv: -kv[1])[:3]
    for name, prm in model.named_parameters():
        assert torch.equal(prm.detach(), before[name] - prm.grad), name


def test_distributed_init_is_a_no_op_for_one_process():
    api.distributed_init()
    api.distributed_init("file:///nonexistent/store", num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()


_WORKER = r"""
import sys, torch
from geobignn_tpu_torch import capture
from geobignn_tpu_torch.data import builder, synth
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.parallel import api
store, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
api.distributed_init(store, num_processes=2, process_id=rank, device="cpu")
# in a group of two processes a step stays eager, even with its grid on one card
assert capture.one_card([torch.device("cuda", 0)] * 2) is False
meshes = [(synth.add_noise(synth.icosphere(1), 0.2, seed=s), synth.icosphere(1)) for s in (1, 2)]
cfg = builder.BuildConfig(granularity=32, reorder=True)
plan = builder.plan_for(*builder.build_raw(*meshes[0], cfg)[:2], 32)
plan = plan.merge(builder.plan_for(*builder.build_raw(*meshes[1], cfg)[:2], 32))
batch = api.stack_samples([builder.build_dual_sample(m_n, m_o, cfg, plan)[0] for m_n, m_o in meshes])
model = DualGNN(device="cpu", seed=3)
mesh = api.make_mesh(1, 1, ["cpu"], dcn=2)
assert mesh == [[torch.device("cpu")]], mesh
step = api.make_sharded_train_step(model, torch.optim.SGD(model.parameters(), lr=1.0), mesh,
                                   augment=True)
metrics = step(batch, 7)
if rank == 0:
    torch.save({"grads": {k: p.grad for k, p in model.named_parameters()},
                "metrics": {k: float(v) for k, v in metrics.items()}}, out)
torch.distributed.destroy_process_group()
"""


def test_two_processes_equal_one_process_dcn_step(tmp_path):
    store, out = "file://" + str(tmp_path / "store"), str(tmp_path / "rank0.pt")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, store, str(r), out], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    got = torch.load(out)

    meshes = [(synth.add_noise(synth.icosphere(1), 0.2, seed=s), synth.icosphere(1))
              for s in (1, 2)]
    cfg = builder.BuildConfig(granularity=32, reorder=True)
    plan = builder.plan_for(*builder.build_raw(*meshes[0], cfg)[:2], 32)
    plan = plan.merge(builder.plan_for(*builder.build_raw(*meshes[1], cfg)[:2], 32))
    batch = api.stack_samples([builder.build_dual_sample(m_n, m_o, cfg, plan)[0]
                               for m_n, m_o in meshes])
    model = DualGNN(device="cpu", seed=3)
    step = api.make_sharded_train_step(model, torch.optim.SGD(model.parameters(), lr=1.0),
                                       api.make_mesh(1, 1, [CPU] * 2, dcn=2), augment=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the two processes (OMP_NUM_THREADS=1): the same sums
    try:
        metrics = step(batch, 7)
    finally:
        torch.set_num_threads(threads)
    for k, v in metrics.items():
        assert abs(float(v) - got["metrics"][k]) <= 1e-6 * abs(float(v)), k
    for name, prm in model.named_parameters():
        want = got["grads"][name]
        assert (prm.grad - want).abs().max() <= 1e-6 * want.abs().max() + 1e-12, name
