"""The port stands alone: it imports nothing of JAX or of geobignn_tpu, and
its entry points refuse to run without a GPU unless asked for the CPU."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import geobignn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "geobignn_tpu"))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_need_a_gpu_unless_cpu(monkeypatch):
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.infer.predict import Predictor
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
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
