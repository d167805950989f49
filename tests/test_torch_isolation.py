"""The port stands alone: it imports nothing of JAX, flax, optax, msgpack or
geobignn_tpu (chip_smoke.py neither), nor the repo's scripts (bench.py,
bench_baseline_torch.py, chip_smoke.py, profile_train_step.py: its
examples/ probes and halo_convergence's helpers included), and
its entry points refuse to run without a GPU unless asked for the CPU."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from geobignn_tpu_torch.testing import share_cores

share_cores()  # torch's CPU threads: this test worker's share of the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import geobignn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
need = {pkg.__name__ + "." + m for m in (
    "models.losses", "data.augment", "train.optim", "train.logging",
    "train.tb_writer", "train.trainer", "ops.banded_cuda", "ops.blocksparse",
    "ops.segment", "ops.feastconv", "train.checkpoint", "ops.nn_cuda",
    "infer.evaluate", "infer.predict", "data.dataset", "cli", "__main__",
    "ops.coalesce", "ops.matching", "pool.dynamic", "models.fusion", "data.prefetch",
    "utils", "ops.gcn", "ops.gat", "models.legacy", "viz", "viz3d", "infer.gt_transfer",
    "parallel.api", "examples.kernel_probe", "examples.trace_step", "examples.profile_step",
    "examples.profile_large", "examples.probe_serial", "examples.probe_f1_327k",
    "examples.bench_dynamic", "examples.probe_dynamic", "examples.halo_scaling_report",
    "examples._sample", "examples._probe", "examples.halo_convergence",
    "examples.train_synthetic_campaign")}
for name in names:
    importlib.import_module(name)
import os
from geobignn_tpu_torch.examples import halo_convergence as hc
assert all(os.path.isfile(hc.jax_init(s)) for s in hc.JAX_INIT_SEEDS)
pairs = dict.fromkeys(hc.JAX_INIT_SEEDS, 0.01)
assert hc.gate(pairs, pairs, 0.05)[0]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack",
                                    "geobignn_tpu")
             or m in ("bench", "bench_baseline_torch", "chip_smoke", "profile_train_step"))
print(len(names), bad, sorted(need - set(names)))
sys.exit(1 if bad or need - set(names) or len(names) < 50 else 0)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_names_no_jax_module():
    """chip_smoke.py runs where there is no JAX: it imports none of these."""
    import ast

    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "optax", "msgpack", "geobignn_tpu"}
    assert "geobignn_tpu_torch" in roots


def test_entry_points_need_a_gpu_unless_cpu(monkeypatch):
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.data.builder import BuildConfig
    from geobignn_tpu_torch.data.dataset import InMemoryDataset
    from geobignn_tpu_torch.infer.predict import Predictor
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.train.trainer import Trainer
    from geobignn_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DualGNN()
    state = DualGNN(device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(Config(), state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert Predictor(Config(), state, device="cpu").device.type == "cpu"

    ds = InMemoryDataset([(synth.icosphere(1), synth.icosphere(1))],
                         BuildConfig(granularity=32, reorder=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(Config(granularity=32), ds)
    assert Trainer(Config(granularity=32), ds, device="cpu").device.type == "cpu"


def test_no_level_structure_raises_not_ported(tmp_path):
    """FeaStConv dispatches every level structure the host builders make,
    and the fusion layer constructs; dp, gp, dcn and halo training route to
    their paths: nothing of the JAX package is refused any more (the port
    has no `not_ported` left)."""
    import inspect

    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import synth
    from geobignn_tpu_torch.data.builder import BuildConfig
    from geobignn_tpu_torch.data.dataset import InMemoryDataset
    from geobignn_tpu_torch.models import dual_gnn
    from geobignn_tpu_torch.train.trainer import Trainer, train

    assert "not_ported" not in inspect.getsource(dual_gnn)
    model = dual_gnn.DualGNN(fusion=8, device="cpu")
    assert model.fusion.lin_v1.kernel.shape == (12, 8)
    assert model.gnn_v.l_conv1.u.shape[0] == 6 + 8

    ds = InMemoryDataset([(synth.icosphere(1), synth.icosphere(1))],
                         BuildConfig(granularity=32, reorder=True))
    for kw in (dict(dp=2), dict(gp=2), dict(dcn=2)):
        tr = Trainer(Config(granularity=32, **kw), ds, device="cpu")
        assert tr._sharded_step is not None and tr.n_chips == 2
    assert tr._global_batch == 2 and len(tr._mesh) == 2  # dcn: a (2, 1, 1) grid
    from geobignn_tpu_torch import utils

    assert not hasattr(utils, "not_ported")
    # halo training routes to train/halo_trainer.py: its dataset lookup runs
    with pytest.raises(FileNotFoundError):
        train(Config(halo_parts=2, dataset_dir=str(tmp_path / "none"),
                     log_dir=str(tmp_path)), device="cpu")
    (info,) = tmp_path.glob("*/*/training_info.txt")
    assert info.read_text().startswith("Halo training (2 parts)")
