"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: skips without an NVIDIA GPU.  This file imports only torch,
numpy and the port (the card's machine has no JAX); run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX).  Tolerances: bf16 compute
within 2e-2 of max|out| (a D summed in another order may round an operand to
the neighbouring bf16 value), float32 within 1e-4 (summation order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from geobignn_tpu_torch import graphs
from geobignn_tpu_torch.data import synth
from geobignn_tpu_torch.ops import banded, banded_cuda
from geobignn_tpu_torch.structs import round_up


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out", [(12, 32), (64, 32)],
                         ids=["aggregate_first", "transform_first"])
def test_kernel_matches_plain_on_card(c_in, c_out, cuda_device):
    mesh = synth.icosphere(4)
    ei = graphs.build_vertex_graph_1ring(mesh.ev_indices, mesh.n_vertices)
    n, tile, heads = mesh.n_vertices, 128, 9
    perm = banded.rcm_order(ei.astype(np.int64), n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    n_pad = round_up(n + 1, tile)
    m = banded.band_mask_np(inv[ei.astype(np.int64)], n_pad, tile)

    rng = np.random.default_rng(1)
    x = np.zeros((n_pad, c_in), np.float32)
    x[:n] = rng.normal(size=(n, c_in))
    w = (rng.normal(size=(heads, c_in, c_out)) * 0.4).astype(np.float32)
    p, r = banded.factorized_softmax(
        torch.from_numpy(x),
        torch.from_numpy((rng.normal(size=(c_in, heads)) * 0.5).astype(np.float32)),
        torch.from_numpy((rng.normal(size=heads) * 0.3).astype(np.float32)))
    args = [t.to(cuda_device) for t in (r, p, torch.from_numpy(x),
                                        torch.from_numpy(w), torch.from_numpy(m))]
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        before = sum(banded_cuda.LAUNCHES.values())
        out = banded_cuda.banded_aggregate(*args, compute_dtype=dt)
        torch.cuda.synchronize()
        assert sum(banded_cuda.LAUNCHES.values()) == before + 1
        ref = banded_cuda.banded_aggregate_plain(*args, compute_dtype=dt)
        assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
