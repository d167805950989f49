"""The port's CUDA kernels (banded and block-sparse, forward and backward)
against their plain versions, on the card.

Marked `cuda`: skips without an NVIDIA GPU.  This file imports only torch,
numpy and the port (the card's machine has no JAX); run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX).  Tolerances, relative to
the largest magnitude of each output or cotangent: bf16 compute within 2e-2
(a D summed in another order may round an operand to the neighbouring bf16
value), float32 within 1e-4 (summation order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from geobignn_tpu_torch import graphs
from geobignn_tpu_torch.data import synth
from geobignn_tpu_torch.ops import banded, banded_cuda, blocksparse
from geobignn_tpu_torch.structs import round_up


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda")


def _problem(c_in, c_out, device, subdiv=4, tile=128, heads=9, seed=1,
             k_extra=None):
    """An RCM-ordered icosphere vertex graph's band mask and seeded inputs
    (r, p from the factorized softmax, a gout with zero padded rows).  With
    k_extra, the block-sparse mask instead and its blk_idx (int64) after the
    mask, padded by k_extra list entries that repeat the own block."""
    mesh = synth.icosphere(subdiv)
    ei = graphs.build_vertex_graph_1ring(mesh.ev_indices, mesh.n_vertices)
    n = mesh.n_vertices
    perm = banded.rcm_order(ei.astype(np.int64), n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    n_pad = round_up(n + 1, tile)
    if k_extra is None:
        masks = [banded.band_mask_np(inv[ei.astype(np.int64)], n_pad, tile)]
    else:
        k = blocksparse.blocks_needed(inv[ei.astype(np.int64)], n_pad, tile)
        blk_idx, m, _ = blocksparse.block_sparse_np(
            inv[ei.astype(np.int64)], n_pad, tile, k_pad=k + k_extra)
        masks = [m, blk_idx.astype(np.int64)]

    rng = np.random.default_rng(seed)
    x = np.zeros((n_pad, c_in), np.float32)
    x[:n] = rng.normal(size=(n, c_in))
    w = (rng.normal(size=(heads, c_in, c_out)) * 0.4).astype(np.float32)
    p, r = banded.factorized_softmax(
        torch.from_numpy(x),
        torch.from_numpy((rng.normal(size=(c_in, heads)) * 0.5).astype(np.float32)),
        torch.from_numpy((rng.normal(size=heads) * 0.3).astype(np.float32)))
    gout = rng.normal(size=(n_pad, c_out)).astype(np.float32)
    gout[n:] = 0.0
    return [t.to(device) for t in (r, p, torch.from_numpy(x), torch.from_numpy(w),
                                   *map(torch.from_numpy, masks),
                                   torch.from_numpy(gout))]


SCHEDULES = pytest.mark.parametrize("c_in,c_out", [(12, 32), (64, 32)],
                                    ids=["aggregate_first", "transform_first"])


@pytest.mark.cuda
@SCHEDULES
def test_kernel_matches_plain_on_card(c_in, c_out, cuda_device):
    *args, _ = _problem(c_in, c_out, cuda_device)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        before = sum(banded_cuda.LAUNCHES.values())
        out = banded_cuda.banded_aggregate(*args, compute_dtype=dt)
        torch.cuda.synchronize()
        assert sum(banded_cuda.LAUNCHES.values()) == before + 1
        ref = banded_cuda.banded_aggregate_plain(*args, compute_dtype=dt)
        assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
@SCHEDULES
def test_backward_kernel_matches_plain_on_card(c_in, c_out, cuda_device):
    """Each cotangent of TPU kernels #3/#4 on Hopper against the plain
    backward on the same inputs, relative to that cotangent's max."""
    args = _problem(c_in, c_out, cuda_device, seed=2)
    key = ("transform_first_bwd" if c_out < c_in else "aggregate_first_bwd")
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        before = banded_cuda.LAUNCHES[key]
        got = banded_cuda.banded_aggregate_bwd(*args, compute_dtype=dt)
        torch.cuda.synchronize()
        assert banded_cuda.LAUNCHES[key] == before + 1
        want = banded_cuda.banded_aggregate_bwd_plain(*args, compute_dtype=dt)
        for name, g, ref in zip(("r", "p", "x", "w"), got, want):
            err = float((g - ref).abs().max())
            assert err <= tol * float(ref.abs().max()), (name, dt, err)


@pytest.mark.cuda
@SCHEDULES
def test_conv_gradients_on_card_match_cpu(c_in, c_out, cuda_device):
    """Autograd through feast_conv_banded_kernel: the card (kernels) against
    the CPU (plain versions), float32 compute, 1e-4 of each gradient's max."""
    r, p, x, w, m, gout = _problem(c_in, c_out, "cpu", subdiv=3, seed=3)
    rng = np.random.default_rng(4)
    prm = {"u": torch.from_numpy((rng.normal(size=(c_in, 9)) * 0.5).astype(np.float32)),
           "c": torch.from_numpy((rng.normal(size=9) * 0.3).astype(np.float32)),
           "w": w, "b": torch.zeros(c_out)}
    deg = (m.sum(dim=(2,)).reshape(-1)).to(torch.float32)
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = {k: v.detach().to(dev).requires_grad_() for k, v in prm.items()}
        xd = x.detach().to(dev).requires_grad_()
        out = banded_cuda.feast_conv_banded_kernel(
            leaves, xd, m.to(dev), deg.to(dev), compute_dtype=torch.float32)
        (out * gout.to(dev)).sum().backward()
        grads[str(dev)] = [t.grad.cpu() for t in (*leaves.values(), xd)]
    for a, b in zip(grads["cpu"], grads[str(cuda_device)]):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())


@pytest.mark.cuda
@SCHEDULES
@pytest.mark.parametrize("tile,k_extra", [(128, 0), (32, 2)],
                         ids=["tile128", "tile32-repeated-blocks"])
def test_blocksparse_kernels_match_plain_on_card(c_in, c_out, tile, k_extra,
                                                 cuda_device):
    """TPU kernels #5/#6 on Hopper against their plain versions: the
    forward and each cotangent, also with padded list entries that repeat a
    row block's own column block under an all-zero mask."""
    *args, gout = _problem(c_in, c_out, cuda_device, tile=tile, seed=5,
                           k_extra=k_extra)
    blk_idx = args[5]
    if k_extra:  # some column block stands twice in a row block's list
        assert any(len(set(row)) < len(row) for row in blk_idx.tolist())
    tf = c_out < c_in
    fwd_key = "bs_transform_first" if tf else "bs_aggregate_first"
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        before = dict(banded_cuda.LAUNCHES)
        out = blocksparse.bs_aggregate(*args, compute_dtype=dt)
        got = blocksparse.bs_aggregate_bwd(*args, gout, compute_dtype=dt)
        torch.cuda.synchronize()
        after = dict(banded_cuda.LAUNCHES)
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
            == {fwd_key: 1, fwd_key + "_bwd": 1}
        ref = blocksparse.bs_aggregate_plain(*args, compute_dtype=dt)
        assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
        want = blocksparse.bs_aggregate_bwd_plain(*args, gout, compute_dtype=dt)
        for name, g, ref in zip(("r", "p", "x", "w"), got, want):
            err = float((g - ref).abs().max())
            assert err <= tol * float(ref.abs().max()), (name, dt, err)


@pytest.mark.cuda
def test_blocksparse_wrapper_checks_before_launch(cuda_device):
    """An int32 blk_idx, a CPU mask or a list of the wrong width raise; none
    gives way to the plain version."""
    *args, gout = _problem(12, 32, cuda_device, subdiv=3, tile=32, k_extra=0)
    r, p, x, w, m, blk_idx = args
    with pytest.raises(TypeError, match="int64"):
        blocksparse.bs_aggregate(r, p, x, w, m, blk_idx.to(torch.int32))
    with pytest.raises(ValueError, match="is on cpu"):
        blocksparse.bs_aggregate(r, p, x, w, m.cpu(), blk_idx)
    with pytest.raises(ValueError, match="blk_idx"):
        blocksparse.bs_aggregate(r, p, x, w, m, blk_idx[:, :-1].contiguous())
    with pytest.raises(ValueError, match="gout"):
        blocksparse.bs_aggregate_bwd(r, p, x, w, m, blk_idx, gout[:, :-1].contiguous())


@pytest.mark.cuda
@SCHEDULES
def test_blocksparse_conv_gradients_on_card_match_cpu(c_in, c_out, cuda_device):
    """Autograd through feast_conv_blocksparse: the card (kernels) against
    the CPU (plain versions), float32 compute, 1e-4 of each gradient's max."""
    r, p, x, w, m, blk_idx, gout = _problem(c_in, c_out, "cpu", subdiv=3, tile=32,
                                            seed=3, k_extra=1)
    rng = np.random.default_rng(4)
    prm = {"u": torch.from_numpy((rng.normal(size=(c_in, 9)) * 0.5).astype(np.float32)),
           "c": torch.from_numpy((rng.normal(size=9) * 0.3).astype(np.float32)),
           "w": w, "b": torch.zeros(c_out)}
    deg = (m.sum(dim=(2,)).reshape(-1)).to(torch.float32)
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = {k: v.detach().to(dev).requires_grad_() for k, v in prm.items()}
        xd = x.detach().to(dev).requires_grad_()
        out = blocksparse.feast_conv_blocksparse(
            leaves, xd, m.to(dev), blk_idx.to(dev), deg.to(dev),
            compute_dtype=torch.float32)
        (out * gout.to(dev)).sum().backward()
        grads[str(dev)] = [t.grad.cpu() for t in (*leaves.values(), xd)]
    for a, b in zip(grads["cpu"], grads[str(cuda_device)]):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())


# --------------------------------------------------------------------------
# TPU kernel #7: nearest distance (ops/nn_cuda.py, csrc/nearest.cu)
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 64, 130])
@pytest.mark.parametrize("n,m", [(1, 5), (129, 1), (700, 1500), (1031, 1025)],
                         ids=lambda v: str(v))
def test_nearest_kernel_matches_plain_on_card(n, m, k, cuda_device):
    """Odd sizes around the tiles (128 queries a block; 1024 or 32 rows of b
    a tile; chunks of 16 coordinates), M below one tile, N = 1.  Squared
    distances against the plain version on the card and a float64 brute
    force within 1e-5 * max(|a|^2 + |b|^2); distances never NaN."""
    from geobignn_tpu_torch.ops import nn_cuda

    rng = np.random.default_rng(1000 * k + n)
    a = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda_device)
    b[: min(n, m) // 2] = a[: min(n, m) // 2]  # coincident points: the residual case
    before = dict(banded_cuda.LAUNCHES)
    d2 = nn_cuda.nearest_distance(a, b, squared=True)
    d = nn_cuda.nearest_distance(a, b)
    torch.cuda.synchronize()
    assert banded_cuda.LAUNCHES["nearest"] == before["nearest"] + 2
    assert {k_: v for k_, v in banded_cuda.LAUNCHES.items() if k_ != "nearest"} \
        == {k_: v for k_, v in before.items() if k_ != "nearest"}
    ref = (torch.cdist(a.double(), b.double()) ** 2).amin(dim=1)
    plain = nn_cuda.nearest_distance_plain(a, b, squared=True)
    bound = 1e-5 * float((a.double() ** 2).sum(1).max() + (b.double() ** 2).sum(1).max())
    assert d2.shape == d.shape == (n,) and d.dtype == torch.float32
    assert float((d2.double() - ref).abs().max()) <= bound
    assert float((d2 - plain).abs().max()) <= bound
    assert torch.isfinite(d).all() and float(d.min()) >= 0.0
    assert float((d.double() ** 2 - ref).abs().max()) <= bound


@pytest.mark.cuda
def test_nearest_wrapper_converts_and_checks_before_any_launch(cuda_device):
    from geobignn_tpu_torch.models import losses
    from geobignn_tpu_torch.ops import nn_cuda

    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(300, 3))).to(cuda_device)  # float64
    b = torch.from_numpy(rng.normal(size=(3, 400)).astype(np.float32)).to(cuda_device).T
    before = banded_cuda.LAUNCHES["nearest"]
    for bad_a, bad_b in ((a, b[:, :2]), (a[0], b), (a, b[:0]), (a, b.cpu())):
        with pytest.raises(ValueError):
            nn_cuda.nearest_distance(bad_a, bad_b)
    assert banded_cuda.LAUNCHES["nearest"] == before
    got = losses.nearest_distance(a, b)  # the metric's entry: euclidean on the card
    torch.cuda.synchronize()
    assert banded_cuda.LAUNCHES["nearest"] == before + 1
    want = nn_cuda.nearest_distance_plain(a.float(), b.contiguous())
    assert float((got - want).abs().max()) <= 1e-4
    for metric in ("manhattan", "chebyshev", "cosine"):  # no kernel: plain torch
        assert losses.nearest_distance(a.float(), b, 128, metric).shape == (300,)
    assert banded_cuda.LAUNCHES["nearest"] == before + 1
