"""The port's CUDA kernels (banded and block-sparse, forward and backward)
against their plain versions, on the card; the trainer's and the
predictor's CUDA graphs against their eager steps.

Marked `cuda`: skips without an NVIDIA GPU.  This file imports only torch,
numpy and the port (the card's machine has no JAX); run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures JAX).  Tolerances, relative to
the largest magnitude of each output or cotangent: bf16 compute within 2e-2
(a D summed in another order may round an operand to the neighbouring bf16
value), float32 within 1e-4 (summation order).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch

from geobignn_tpu_torch import graphs
from geobignn_tpu_torch.data import synth
from geobignn_tpu_torch.ops import banded, banded_cuda, blocksparse
from geobignn_tpu_torch.structs import round_up
from geobignn_tpu_torch.testing import edge_case_inputs, share_cores

share_cores()  # torch's CPU threads: this test worker's share of the cores


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda")


def _problem(c_in, c_out, device, subdiv=4, tile=128, heads=9, seed=1,
             k_extra=None, mesh=None):
    """An RCM-ordered icosphere vertex graph's band mask and seeded inputs
    (r, p from the factorized softmax, a gout with zero padded rows).  With
    k_extra, the block-sparse mask instead and its blk_idx (int64) after the
    mask, padded by k_extra list entries that repeat the own block."""
    mesh = synth.icosphere(subdiv) if mesh is None else mesh
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
def test_backward_kernel_with_far_window_mates_on_card(c_in, c_out, cuda_device):
    """On a strip (a narrow band), each node's r scaled by 2^k and its p by
    2^-k, k growing along the order so that two nodes of one window differ
    by 128 or more (their r p past float32's range, as at level 0 of a
    whole 1,310,720-face mesh): the cotangents of #3/#4 and of the plain
    backward are finite, agree, and are the unscaled cotangents scaled."""
    r, p, *rest = _problem(c_in, c_out, cuda_device, tile=64, seed=3,
                           mesh=synth.grid_patch(3, 40))
    n = 120
    k = torch.zeros(r.shape[0], device=cuda_device)
    k[:n] = torch.round(1.5 * (torch.arange(n, device=cuda_device) - n // 2))
    s = torch.exp2(k)[:, None]
    base = banded_cuda.banded_aggregate_bwd(r, p, *rest, compute_dtype=torch.float32)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        got = banded_cuda.banded_aggregate_bwd(r * s, p / s, *rest, compute_dtype=dt)
        want = banded_cuda.banded_aggregate_bwd_plain(r * s, p / s, *rest, compute_dtype=dt)
        for name, g, ref in zip(("r", "p", "x", "w"), got, want):
            assert torch.isfinite(g).all() and torch.isfinite(ref).all(), (name, dt)
            assert float((g - ref).abs().max()) <= tol * float(ref.abs().max()), (name, dt)
    got = banded_cuda.banded_aggregate_bwd(r * s, p / s, *rest, compute_dtype=torch.float32)
    for name, g, b in zip(("r", "p", "x", "w"), got, (base[0] / s, base[1] * s, *base[2:])):
        assert float((g - b).abs().max()) <= 1e-4 * float(b.abs().max()), name


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


# the main path's widths of the products routed to the tensor cores (csrc/
# node_product.cuh): Y / V of the narrowing convs, gy / G of the widening ones
ROUTED_WIDTHS = pytest.mark.parametrize(
    "c_in,c_out", [(128, 64), (64, 32), (12, 32), (32, 64), (64, 128), (128, 128)],
    ids=["tf-128-64", "tf-64-32", "af-12-32", "af-32-64", "af-64-128", "af-128-128"])
# (icosphere subdivision, tile): N 2,592 rows, a ragged count of 64-row tiles,
# and N 256, the launch-bound size of the halo convergence runs
ROUTED_SIZES = pytest.mark.parametrize("subdiv,tile", [(4, 96), (2, 128)],
                                       ids=["ragged", "tiny"])


def _product_counts(fn):
    """PRODUCTS' increase over fn() (synchronised)."""
    before = dict(banded_cuda.PRODUCTS)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: banded_cuda.PRODUCTS[k] - before[k] for k in before}


@pytest.mark.cuda
@ROUTED_WIDTHS
@ROUTED_SIZES
def test_routed_products_match_plain_on_card(c_in, c_out, subdiv, tile, cuda_device):
    """#1-#4 with their cast-operand products on the tensor cores (bf16) and
    on the CUDA cores (float32): the forward and each cotangent against the
    plain versions, and PRODUCTS counting each sequence's products by route
    (Y / V forward and backward, gy / G on the tensor cores; out, x̄, W̄ and
    every float32 product on the CUDA cores)."""
    *args, gout = _problem(c_in, c_out, cuda_device, subdiv=subdiv, tile=tile, seed=8)
    assert args[2].shape[0] == {(4, 96): 2592, (2, 128): 256}[(subdiv, tile)]
    tf = c_out < c_in
    routed = {"fwd": int(tf), "bwd": 1}
    simt = {"fwd": 0 if tf else 1, "bwd": 2 if tf else 1}
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        bf16 = dt == torch.bfloat16
        out, fwd = _product_counts(lambda: banded_cuda.banded_aggregate(*args, compute_dtype=dt))
        got, bwd = _product_counts(
            lambda: banded_cuda.banded_aggregate_bwd(*args, gout, compute_dtype=dt))
        for tag, counted in (("fwd", fwd), ("bwd", bwd)):
            assert counted == {"mma": routed[tag] if bf16 else 0,
                               "simt": simt[tag] + (0 if bf16 else routed[tag])}, (tag, dt)
        ref = banded_cuda.banded_aggregate_plain(*args, compute_dtype=dt)
        assert float((out - ref).abs().max()) <= tol * float(ref.abs().max()), dt
        want = banded_cuda.banded_aggregate_bwd_plain(*args, gout, compute_dtype=dt)
        for name, g, ref in zip(("r", "p", "x", "w"), got, want):
            err = float((g - ref).abs().max())
            assert err <= tol * float(ref.abs().max()), (name, dt, err)


def _scratch_filled_with_nan(monkeypatch):
    """The wrappers' torch.empty scratch, filled with NaN and kept: a column
    the kernels leave unwritten stays NaN."""
    made, empty = [], torch.empty

    def nan_empty(*shape, **kw):
        t = empty(*shape, **kw)
        if t.is_floating_point():
            t.fill_(float("nan"))
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", nan_empty)
    return made


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out", [(64, 6), (128, 64), (6, 32), (12, 32)],
                         ids=["tf-64-6", "tf-128-64", "af-6-32", "af-12-32"])
def test_tensor_core_operands_are_exact_and_zero_padded(c_in, c_out, cuda_device,
                                                        monkeypatch):
    """The tensor-core route's operands, read from the wrappers' scratch:
    V = cd(p Y) and G = cd(r gy) within one bf16 step of the plain operands
    (the raw Y and gy differ by summation order alone), their padding
    columns up to the 16-byte row stride exactly zero (9 x 6 = 54 of 56)."""
    *args, gout = _problem(c_in, c_out, cuda_device, subdiv=3, seed=9)
    r, p, x, w, m = args
    tf = c_out < c_in
    heads = r.shape[1]
    cv = c_out if tf else c_in
    kk = heads * cv
    made = _scratch_filled_with_nan(monkeypatch)
    _, counted = _product_counts(lambda: banded_cuda._launch_bwd(*args, gout, torch.bfloat16))
    monkeypatch.undo()
    assert counted["mma"] == 1
    v, g, raw, _ = made[0]
    ldk = v.shape[1]
    assert ldk == -(-kk // 4) * 4
    cd = lambda t: t.to(torch.bfloat16).float()
    if tf:  # V = cd(p Y), Y = cd(x) cd(W2)
        raw_ref = cd(x) @ cd(w.permute(1, 0, 2).reshape(c_in, kk))
        heads_of = p.repeat_interleave(cv, dim=1)
        op = v
    else:  # G = cd(gy r), gy = cd(gout) cd(W_flat)^T
        raw_ref = cd(gout) @ cd(w.reshape(kk, c_out)).T
        heads_of = r.repeat_interleave(cv, dim=1)
        op = g
    op_ref = cd(heads_of * raw_ref)
    for t in (op, raw):
        assert torch.equal(t[:, kk:], torch.zeros_like(t[:, kk:]))
    # the raw sums differ by their order alone; a scaled value rounds to the
    # same bf16 number or a neighbour
    sum_err = 1e-5 * float(raw_ref.abs().max())
    assert float((raw[:, :kk] - raw_ref).abs().max()) <= sum_err
    step = torch.maximum(op[:, :kk].abs(), op_ref.abs()) * 2.0 ** -7
    assert bool(((op[:, :kk] - op_ref).abs() <= step + heads_of * sum_err).all())


@pytest.mark.cuda
def test_product_counts_match_the_trace(cuda_device):
    """PRODUCTS against the profiler: each counted product is one kernel of
    its route's name, node_product_kernel_mma on the tensor cores and
    node_product_kernel<...> on the CUDA cores."""
    from torch.profiler import ProfilerActivity, profile

    calls = []
    for c_in, c_out in ((64, 32), (12, 32)):
        *args, gout = _problem(c_in, c_out, cuda_device, subdiv=3, seed=10)
        for dt in (torch.bfloat16, torch.float32):
            calls.append(lambda a=args, g=gout, d=dt: (
                banded_cuda.banded_aggregate(*a, compute_dtype=d),
                banded_cuda.banded_aggregate_bwd(*a, g, compute_dtype=d)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, counted = _product_counts(lambda: [c() for c in calls])
    seen = {"mma": 0, "simt": 0}
    for e in prof.key_averages():
        if "node_product_kernel_mma" in e.key:
            seen["mma"] += e.count
        elif "node_product_kernel<" in e.key:
            seen["simt"] += e.count
    # tf bf16: Y/V twice on the mma route, x̄ and W̄ on the simt one; af bf16:
    # gy on mma, out and W̄ on simt; float32: all of them on simt
    assert counted == {"mma": 2 + 1, "simt": 2 + 2 + 4 + 3}
    assert seen == counted


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


EDGE_WIDTHS = pytest.mark.parametrize(
    "c_in,c_out", [(64, 32), (128, 64), (12, 32), (6, 32), (128, 128)],
    ids=lambda v: str(v))


@pytest.mark.cuda
@EDGE_WIDTHS
@pytest.mark.parametrize("blocksparse_", [False, True], ids=["band", "blocksparse"])
@pytest.mark.parametrize("tile,n_blk", [(32, 2), (64, 4)], ids=["2x32", "4x64"])
def test_kernels_match_plain_on_edge_cases(c_in, c_out, blocksparse_, tile, n_blk,
                                           cuda_device):
    """Rows without a set slot, set slots on absent neighbours at both ends,
    mask values 2 and 3, D under the clamp, more set slots than one batch of
    32 in a row and in a column (geobignn_tpu_torch.testing): the
    forward and each cotangent against the plain versions, both compute
    dtypes; r̄ of the rows under the clamp apart from the other rows'."""
    case = edge_case_inputs(c_in, c_out, tile=tile, n_blk=n_blk, seed=tile + n_blk,
                            blocksparse=blocksparse_)
    names = ("r", "p", "x", "w", "m") + (("blk_idx",) if blocksparse_ else ())
    args = [torch.from_numpy(case[k]).to(cuda_device) for k in names]
    gout = torch.from_numpy(case["gout"]).to(cuda_device)
    mod, stem = ((blocksparse, "bs_aggregate") if blocksparse_
                 else (banded_cuda, "banded_aggregate"))
    clamped = torch.from_numpy(case["clamped"]).to(cuda_device)
    rest = torch.ones(gout.shape[0], dtype=torch.bool, device=cuda_device)
    rest[clamped] = False
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        before = sum(banded_cuda.LAUNCHES.values())
        out = getattr(mod, stem)(*args, compute_dtype=dt)
        got = getattr(mod, stem + "_bwd")(*args, gout, compute_dtype=dt)
        torch.cuda.synchronize()
        assert sum(banded_cuda.LAUNCHES.values()) == before + 2
        ref = getattr(mod, stem + "_plain")(*args, compute_dtype=dt)
        want = getattr(mod, stem + "_bwd_plain")(*args, gout, compute_dtype=dt)
        assert torch.isfinite(out).all()
        assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
        pairs = [("r clamped", got[0][clamped], want[0][clamped]),
                 ("r rest", got[0][rest], want[0][rest])]
        pairs += [(k, g, w_) for k, g, w_ in zip("pxw", got[1:], want[1:])]
        for name, g, w_ in pairs:
            err = float((g - w_).abs().max())
            assert torch.isfinite(g).all(), name
            assert err <= tol * float(w_.abs().max()), (name, dt, err)


@pytest.mark.cuda
def test_backward_kernels_are_bit_repeatable(cuda_device):
    """No atomics: two launches on the same inputs give the same bits."""
    args = _problem(64, 32, cuda_device, seed=6)
    first = banded_cuda.banded_aggregate_bwd(*args)
    second = banded_cuda.banded_aggregate_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(banded_cuda.banded_aggregate(*args[:-1]),
                       banded_cuda.banded_aggregate(*args[:-1]))


@pytest.mark.cuda
@SCHEDULES
def test_parts_are_timed_on_request(c_in, c_out, cuda_device):
    """A dict handed in as `parts` receives each kernel's milliseconds under
    the names of FWD_PARTS / BWD_PARTS; the results do not change."""
    args = _problem(c_in, c_out, cuda_device, seed=7)
    tf = c_out < c_in
    fwd, bwd = {}, {}
    out = banded_cuda._launch(*args[:-1], torch.bfloat16, parts=fwd)
    got = banded_cuda._launch_bwd(*args, torch.bfloat16, parts=bwd)
    assert tuple(fwd) == banded_cuda.FWD_PARTS[tf] and tuple(bwd) == banded_cuda.BWD_PARTS[tf]
    assert all(0.0 < v < 100.0 for v in (*fwd.values(), *bwd.values()))
    assert torch.equal(out, banded_cuda.banded_aggregate(*args[:-1]))
    assert all(torch.equal(a, b) for a, b in
               zip(got, banded_cuda.banded_aggregate_bwd(*args)))


# --------------------------------------------------------------------------
# TPU kernel #7: nearest distance (ops/nn_cuda.py, csrc/nearest.cu)
# --------------------------------------------------------------------------

NEAREST_SIZES = [1, 31, 129, 1025, 10242]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 17, 64, 130])
@pytest.mark.parametrize("m", NEAREST_SIZES)
@pytest.mark.parametrize("n", NEAREST_SIZES)
def test_nearest_kernel_matches_plain_on_card(n, m, k, cuda_device):
    """Ragged sizes around the CTAs (512 queries, or 128 and tiles of 128
    rows of b, 16 coordinates a chunk), M below one slice, N = 1, and
    coincident points.  Squared distances against the plain version on the
    card and a float64 brute force within 1e-5 * max(|a|^2 + |b|^2);
    distances never NaN; one count per wrapper call."""
    from geobignn_tpu_torch.ops import nn_cuda

    rng = np.random.default_rng(1000 * k + 10 * n + m)
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
    ref = torch.cat([(torch.cdist(a[s:s + 2048].double(), b.double()) ** 2).amin(dim=1)
                     for s in range(0, n, 2048)])
    plain = nn_cuda.nearest_distance_plain(a, b, squared=True)
    bound = 1e-5 * float((a.double() ** 2).sum(1).max() + (b.double() ** 2).sum(1).max())
    assert d2.shape == d.shape == (n,) and d.dtype == torch.float32
    assert float((d2.double() - ref).abs().max()) <= bound
    assert float((d2 - plain).abs().max()) <= bound
    assert torch.isfinite(d).all() and float(d.min()) >= 0.0
    assert float((d.double() ** 2 - ref).abs().max()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 4, 64])
def test_nearest_kernel_bits_do_not_depend_on_the_call_or_the_split(k, cuda_device):
    """The minimum is exact and a pair's value is summed in one order: two
    calls, and every split of b into slices, give the same bits; a split
    that does not cover b is refused before any launch."""
    from geobignn_tpu_torch.ops import nn_cuda

    rng = np.random.default_rng(k)
    n, m = 3000, 5000
    a = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda_device)
    want = nn_cuda.nearest_distance(a, b, squared=True)
    assert torch.equal(want, nn_cuda.nearest_distance(a, b, squared=True))
    granule = nn_cuda.ROW_GRANULE[k <= nn_cuda.SMALL_K]
    for slices, rows in ((1, m), (2, 2500), (5, 1000), (40, 128), (-(-m // granule), granule),
                         (m, 1)):
        got = nn_cuda._launch(a, b, True, plan=(slices, rows))
        assert torch.equal(got, want), (slices, rows)
    before = banded_cuda.LAUNCHES["nearest"]
    for plan in ((2, 2000), (3, 2500), (0, m)):
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            nn_cuda._launch(a, b, True, plan=plan)
    assert banded_cuda.LAUNCHES["nearest"] == before


@pytest.mark.cuda
def test_nearest_parts_are_timed_on_request(cuda_device):
    from geobignn_tpu_torch.ops import nn_cuda

    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(4000, 3)).astype(np.float32)).to(cuda_device)
    parts = {}
    got = nn_cuda._launch(a, a, parts=parts)
    assert tuple(parts) == nn_cuda.PARTS and all(0.0 < v < 100.0 for v in parts.values())
    assert torch.equal(got, nn_cuda.nearest_distance(a, a))


@pytest.mark.cuda
def test_chunked_rematerialized_heads_lower_the_peak(cuda_device):
    """The bf16 facet head alone at N = 2^20 rows, forward and backward: in
    the default 4 chunks of 2^18 rows, rematerialized, against one piece
    with every intermediate kept (a (2^20, 1024) hidden is 2 GiB in bf16)."""
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.testing import heads_peak_bytes

    model = DualGNN(fc_dtype=torch.bfloat16, device=cuda_device)
    feat = torch.randn((1 << 20, 32), device=cuda_device)
    chunked = heads_peak_bytes(model, feat, chunked=True)
    whole = heads_peak_bytes(model, feat, chunked=False)
    print(f"heads at N = 2^20, bf16: peak {chunked / 2**30:.3f} GiB chunked and "
          f"rematerialized, {whole / 2**30:.3f} GiB in one piece")
    assert whole - chunked >= 4 * 2**30


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


def _small_train_set():
    """Patches of two noisy icosphere(3) meshes: every patch one plan."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import dataset

    clean = synth.icosphere(3)
    return dataset.InMemoryDataset(
        [(synth.add_noise(clean, 0.2, seed=s), clean) for s in (0, 1)],
        Config().build_config(), submesh_size=600)


@pytest.mark.cuda
def test_graphed_training_matches_eager_across_an_lr_change(cuda_device):
    """Trainer.fit on the card replays one CUDA graph of the step; 3 epochs
    with rotation on and the learning rate halved each epoch leave the same
    parameters and Adam moments, bit for bit, as the eager steps."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train.trainer import Trainer

    ds = _small_train_set()
    cfg = Config(seed=0, max_epoch=3, lr_sch="exp", lr_decay=0.5)
    graphed = Trainer(cfg, ds, None, device=cuda_device)
    graphed.fit()
    with eager_steps():
        eager = Trainer(cfg, ds, None, device=cuda_device)
        eager.fit()
    assert len(graphed._program.graphs) == 1 and not eager._program.graphs
    for a, b in zip(graphed.model.parameters(), eager.model.parameters()):
        assert torch.equal(a, b)
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(graphed.optimizer.state[a][k], eager.optimizer.state[b][k])


@pytest.mark.cuda
def test_a_replayed_step_reads_the_learning_rate_set_after_its_capture(cuda_device):
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.train import optim
    from geobignn_tpu_torch.train.trainer import Trainer

    ds = _small_train_set()
    tr = Trainer(Config(seed=0), ds, None, device=cuda_device)
    sample = tr._get(ds, "t", 0)
    tr.fused_step(sample, 0)  # the eager warm-up, then the capture
    tr.fused_step(sample, 1)
    before = [p.detach().clone() for p in tr.model.parameters()]
    optim.set_lr(tr.optimizer, 0.0)
    tr.fused_step(sample, 2)
    assert all(torch.equal(a, b) for a, b in zip(before, tr.model.parameters()))
    optim.set_lr(tr.optimizer, 1e-2)
    tr.fused_step(sample, 3)
    assert not all(torch.equal(a, b) for a, b in zip(before, tr.model.parameters()))
    assert len(tr._program.graphs) == 1


@pytest.mark.cuda
def test_a_traced_epoch_counts_its_graph_calls_and_stage_times(cuda_device):
    """While a profiler records: the first call of a step captures
    (`graph.captures`), each replay counts one `graph.runs` and copies every
    tensor of (sample, rotation) into the static inputs; an epoch reads the
    stage times of every replayed step.  With no profiler, nothing."""
    from torch.profiler import ProfilerActivity, profile

    from geobignn_tpu_torch import capture, tracing
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.train.trainer import STAGES, Trainer

    ds = _small_train_set()
    tr = Trainer(Config(seed=0), ds, None, device=cuda_device)
    samples = [tr._get(ds, "t", i) for i in range(2)]
    inputs = capture.tensors((samples[0], tr._rotation(0)))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):  # tracing on
        for seed in range(3):
            tr.fused_step(samples[seed % 2], seed)
        torch.cuda.synchronize()
        after_steps = tracing.counters()
        tr.run_epoch(np.random.default_rng(0))
    c = tracing.counters()
    assert after_steps == {"graph.captures": 1, "graph.runs": 2,
                           "graph.input_tensors": 2 * len(inputs),
                           "graph.input_bytes": 2 * sum(t.numel() * t.element_size()
                                                        for t in inputs)}
    assert c["graph.runs"] == 2 + len(ds) and c["graph.captures"] == 1
    assert c["graph.input_tensors"] == len(inputs) * c["graph.runs"]
    assert c["step.stage_readings"] == len(ds) and all(c[k] > 0.0 for k in STAGES)
    tracing.reset()
    tr.run_epoch(np.random.default_rng(1))
    assert tracing.counters() == {}


@pytest.mark.cuda
def test_the_stage_stamps_add_up_to_the_replay(cuda_device):
    """The four stamps a step's capture holds: every replay fills a row of
    the clock's ring, and a row's three intervals sum to within 2% of CUDA
    events around its replay."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.train.trainer import STAGE_ROWS, Trainer

    ds = _small_train_set()
    tr = Trainer(Config(seed=0), ds, None, device=cuda_device)
    sample = tr._get(ds, "t", 0)
    tr.fused_step(sample, 0)  # the eager warm-up, then the capture
    tr.fused_step(sample, 1)  # the first replay, which uploads the graph first
    (graph,) = tr._program.graphs.values()
    clock = tr._clock
    clock.restart()
    replays = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.graph.replay()
        end.record()
        replays.append((start, end))
    torch.cuda.synchronize()
    assert int(clock.index) == 5 and clock.table.shape == (STAGE_ROWS, 4)
    rows = clock.table[:5].cpu()
    read = [(start.elapsed_time(end), ((row[1:] - row[:-1]).double() * 1e-6).tolist())
            for (start, end), row in zip(replays, rows)]
    for replay, parts in read:
        print(f"replay {replay:.4f} ms, stages {parts}")
    for replay, parts in read:
        assert all(p > 0.0 for p in parts)
        assert abs(sum(parts) - replay) <= 0.02 * replay


@pytest.mark.cuda
def test_a_traced_fit_captures_under_the_profiler(cuda_device, tmp_path):
    """The README's use, `with profiling.trace(d): trainer.fit()`, from a
    fresh trainer: the step's and the eval pass's graphs are captured while
    CUPTI records the card, the graphed run equals an untraced one, and
    trace.json and counters.json are written."""
    import json
    import os

    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.train import profiling
    from geobignn_tpu_torch.train.trainer import STAGES, Trainer

    ds = ev = _small_train_set()
    cfg = Config(seed=0, max_epoch=2)
    traced = Trainer(cfg, ds, ev, device=cuda_device)
    with profiling.trace(str(tmp_path)):
        traced.fit()
    plain = Trainer(cfg, ds, ev, device=cuda_device)
    plain.fit()
    for a, b in zip(traced.model.parameters(), plain.model.parameters()):
        assert torch.equal(a, b)
    with open(os.path.join(tmp_path, "counters.json")) as f:
        c = json.load(f)
    assert c["graph.captures"] == 2  # the step's graph and the eval pass's
    assert len(traced._program.graphs) == 1 and len(traced._eval_program.graphs) == 1
    steps = cfg.max_epoch * len(ds)
    assert c["graph.runs"] == (steps - 1) + (cfg.max_epoch * len(ev) - 1)
    assert c["step.stage_readings"] == steps - 1 and all(c[k] > 0.0 for k in STAGES)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"graph.capture", "graph.run", "graph.replay", "trainer.epoch"} <= names
    assert any(e.get("cat") == "kernel" for e in events)


@pytest.mark.cuda
def test_graphed_forward_matches_eager_and_counts_its_launches(cuda_device):
    """Predictor.forward replays one graph per merged plan: the patches'
    outputs equal the eager forward's; the wrappers count the first patch's
    eager warm-up and its capture, and the device runs, by kernel name, the
    eager forwards' launches (a profile sees each replay's)."""
    import importlib.util
    import os

    from torch.profiler import ProfilerActivity, profile

    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.infer.predict import Predictor
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.testing import eager_steps

    spec = importlib.util.spec_from_file_location("profile_train_step", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "profile_train_step.py"))
    pts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pts)
    state = DualGNN(fc_dtype=torch.bfloat16, device="cpu", seed=0).state_dict()
    pred = Predictor(Config(), state, sub_size=600, device=cuda_device)
    mem = pred.patch_dataset(synth.add_noise(synth.icosphere(3), 0.2, seed=0))
    patches = [mem.get(i) for i in range(len(mem.entries))]
    n = len(patches)
    assert n > 1
    counts = {}
    for mode in ("graphed", "eager"):
        banded_cuda.reset_launches()
        with eager_steps() if mode == "eager" else contextlib.nullcontext():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = [pred._apply(s) for s in patches]
                torch.cuda.synchronize()
        counts[mode] = (out, dict(banded_cuda.LAUNCHES),
                        pts.aggregate_launches(pts.device_kernels(prof)))
    (graph,) = pred._program.graphs.values()
    eager = {k: v for k, v in counts["eager"][1].items() if v}
    assert eager and graph.replays == n - 1
    assert {k: n * v for k, v in graph.launches.items() if v} == eager
    assert counts["graphed"][1] == {k: 2 * v for k, v in graph.launches.items()}
    assert counts["graphed"][2] == counts["eager"][2] == eager
    for (vg, ng), (ve, ne) in zip(counts["graphed"][0], counts["eager"][0]):
        np.testing.assert_array_equal(vg, ve)
        np.testing.assert_array_equal(ng, ne)


# --------------------------------------------------------------------------
# bf16 activations, dynamic pooling, streaming
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("blocksparse_", [False, True], ids=["band", "blocksparse"])
def test_bf16_aggregates_on_card_match_cpu(blocksparse_, cuda_device):
    """bf16 primals through the aggregate Functions, on the card (the
    kernels) and on CPU tensors (the plain versions): outputs and bf16
    cotangents within 2e-2 of their max (bf16 compute)."""
    case = edge_case_inputs(16, 32, tile=64, n_blk=4, blocksparse=blocksparse_, seed=4)
    outs = {}
    for dev in ("cpu", cuda_device):
        prim = [torch.from_numpy(case[k]).to(dev, torch.bfloat16).requires_grad_()
                for k in ("r", "p", "x", "w")]
        m = torch.from_numpy(case["m"]).to(dev)
        if blocksparse_:
            out = blocksparse.bs_aggregate(*prim, m, torch.from_numpy(case["blk_idx"]).to(dev))
        else:
            out = banded_cuda.banded_aggregate(*prim, m)
        out.backward(torch.from_numpy(case["gout"]).to(dev))
        assert all(p.grad.dtype == torch.bfloat16 for p in prim)
        outs[str(dev)] = [out.detach().float().cpu()] + [p.grad.float().cpu() for p in prim]
    rows = torch.ones(case["x"].shape[0], dtype=torch.bool)
    rows[torch.from_numpy(np.asarray(case["clamped"], np.int64))] = False
    for i, (a, b) in enumerate(zip(outs["cpu"], outs[str(cuda_device)])):
        if i == 1:  # r̄ of the clamped rows is of the order of 1e12: compared apart
            a, b = a[rows], b[rows]
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 2e-2 * scale, i


@pytest.mark.cuda
def test_matching_and_coalesce_on_card_match_cpu(cuda_device):
    """parallel_matching and coalesce_edges on identical inputs: rep and
    edge lists bit-equal, the coalesced weights too (sorted sums, no
    atomics)."""
    from geobignn_tpu_torch.ops import coalesce, matching

    mesh = synth.add_noise(synth.icosphere(4), 0.2, seed=0)
    ei = graphs.build_vertex_graph_1ring(mesh.ev_indices, mesh.n_vertices).astype(np.int64)
    n_pad = mesh.n_vertices + 7
    ei_p = np.full((2, ei.shape[1] + 11), n_pad - 1, np.int64)
    ei_p[:, : ei.shape[1]] = ei
    rng = np.random.default_rng(0)
    w = rng.uniform(0.1, 1.0, ei_p.shape[1]).astype(np.float32)
    w[: ei.shape[1] // 4] = 0.5  # ties
    got = {}
    for dev in ("cpu", cuda_device):
        e, ww = torch.from_numpy(ei_p).to(dev), torch.from_numpy(w).to(dev)
        rep = matching.parallel_matching(e, ww, n_pad)
        e2, w2 = matching.pool_edges_with_rep(e, ww, rep, n_pad)
        rep2 = matching.parallel_matching(e2, w2, n_pad)
        oracle = matching._parallel_matching_scatter(e, ww, n_pad)
        got[str(dev)] = [t.cpu() for t in (rep, e2, w2, rep2, oracle)]
    for a, b in zip(got["cpu"], got[str(cuda_device)]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graphed_dynamic_training_matches_eager(cuda_device):
    """Trainer(Config(edge_weight_type=4)).fit on the card replays one CUDA
    graph of the dynamic step (matchings, coalesces and COO convs inside):
    2 epochs leave the parameters and Adam moments bit-equal to the eager
    steps', and the learned pooling parameters' Adam moments stay zero
    (their gradient is zero)."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train.trainer import Trainer

    ds = _small_train_set()
    cfg = Config(seed=0, max_epoch=2, edge_weight_type=4)
    graphed = Trainer(cfg, ds, None, device=cuda_device)
    graphed.fit()
    with eager_steps():
        eager = Trainer(cfg, ds, None, device=cuda_device)
        eager.fit()
    assert len(graphed._program.graphs) == 1 and not eager._program.graphs
    for (name, a), b in zip(graphed.model.named_parameters(), eager.model.parameters()):
        assert torch.equal(a, b), name
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(graphed.optimizer.state[a][k], eager.optimizer.state[b][k]), name
        if ".pooling" in name:
            assert not graphed.optimizer.state[a]["exp_avg"].any(), name


@pytest.mark.cuda
def test_pinned_prefetch_gives_the_synchronous_samples(cuda_device):
    """device_iter (pinned host buffers, a copy stream, events and
    record_stream) yields, in order, samples equal to synchronous copies,
    also when the consumer's stream is busy while the next copies run."""
    from geobignn_tpu_torch.capture import tensors
    from geobignn_tpu_torch.data.prefetch import device_iter

    ds = _small_train_set()
    ds.bucketize(1.5)
    order = [3, 0, 2, 1, 3]
    for i, s in zip(order, device_iter(order, ds.get, cuda_device, depth=2)):
        torch.cuda._sleep(2_000_000)  # keep the consumer's stream busy
        want = ds.get(i).to(cuda_device)
        for a, b in zip(tensors(s), tensors(want)):
            assert a.is_cuda and torch.equal(a, b)


# --------------------------------------------------------------------------
# the multi-device programs as CUDA graphs, every part or grid entry on one
# card
# --------------------------------------------------------------------------

def _halo_pairs():
    clean = synth.icosphere(3)
    return [(synth.add_noise(clean, 0.2, seed=s), clean) for s in (0, 1)]


@pytest.mark.cuda
def test_graphed_halo_forward_matches_eager(cuda_device):
    """Predictor.predict_mesh_halo over 2 banded parts on one card: the
    first call runs eagerly and captures the forward, the second replays
    it; both equal the eager forward bit for bit, and the capture recorded
    the parts' #1/#2 launches."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.infer.predict import Predictor
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.testing import eager_steps

    state = DualGNN(device="cpu", seed=0).state_dict()
    pred = Predictor(Config(), state, device=cuda_device)
    mesh, devs = _halo_pairs()[0][0], [cuda_device] * 2
    first = pred.predict_mesh_halo(mesh, 2, banded=True, devices=devs)
    replayed = pred.predict_mesh_halo(mesh, 2, banded=True, devices=devs)
    (graph,) = pred._halo[1].program.graphs.values()
    assert graph.replays == 1 and sum(graph.launches.values()) > 0
    with eager_steps():
        eager = pred.predict_mesh_halo(mesh, 2, banded=True, devices=devs)
    for a, b, c in zip(first, replayed, eager):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


def _same_training(a, b):
    """Parameters and Adam's moments bit-equal."""
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.state[p][k], b.optimizer.state[q][k]), name


def _metrics(hist):
    """The epochs' metrics without the host clock's rates."""
    return [{k: v for k, v in m.items() if not k.endswith("_per_s") and "per_s_" not in k}
            for m in hist]


@pytest.mark.cuda
def test_graphed_halo_steps_match_eager(cuda_device):
    """HaloTrainer.fit over 2 banded parts on one card: 3 epochs of one mesh
    (rotation on, the learning rate halved each epoch) and the evaluation
    of another replay one graph each after their warm-ups; the parameters,
    Adam's moments and every epoch's train and eval metrics are bit-equal
    to the eager run's."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train.halo_trainer import HaloTrainer

    cfg = Config(halo_parts=2, halo_banded=True, max_epoch=3, seed=0, lr_sch="exp",
                 lr_decay=0.5)
    pairs = _halo_pairs()
    runs = {}
    for mode in ("graphed", "eager"):
        with eager_steps() if mode == "eager" else contextlib.nullcontext():
            tr = HaloTrainer(cfg, pairs[:1], pairs[1:], devices=[cuda_device] * 2)
            hist = []
            tr.fit(on_epoch=lambda t, m, e: hist.append(dict(m, **{"eval_" + k: v
                                                                   for k, v in e.items()})))
        runs[mode] = (tr, hist)
    (g, g_hist), (e, e_hist) = runs["graphed"], runs["eager"]
    (step,), (fwd,) = g._steps.values(), g._fwds.values()
    assert [gr.replays for gr in step.program.graphs.values()] == [2]
    assert [gr.replays for gr in fwd.program.graphs.values()] == [2]
    assert not any(s.program.graphs for s in e._steps.values())
    assert _metrics(g_hist) == _metrics(e_hist)
    _same_training(g, e)


@pytest.mark.cuda
@pytest.mark.parametrize("loss_cfg", [{}, dict(loss_v="CD", loss_n="sided")],
                         ids=["L1", "chamfer-sided"])
def test_graphed_chained_halo_step_matches_eager(loss_cfg, cuda_device):
    """make_halo_train_step(n_steps=2, augment=True) over 2 parts on one
    card, with the default losses and with the chamfer and sided losses
    (the parts' rows gathered on the first part's device): 3 calls (the
    warm-up, then two replays of one graph, each with its two rotations
    copied in) leave the parameters and Adam's moments bit-equal to 3
    eager calls."""
    import dataclasses

    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.models.dual_gnn import DualGNN
    from geobignn_tpu_torch.parallel import halo_train as ht
    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train import optim

    m_n, m_o = _halo_pairs()[0]
    bc = dataclasses.replace(Config().build_config(), reorder=False)
    sample = ht.build_halo_train_sample(m_n, m_o, bc, 2, banded=True,
                                        devices=[cuda_device] * 2)
    runs = []
    for mode in ("graphed", "eager"):
        model = DualGNN(device=cuda_device, seed=3)
        opt = optim.make_optimizer(Config(), model.parameters())
        step = ht.make_halo_train_step(model, opt, sample.static, loss_cfg, augment=True,
                                       n_steps=2)
        with eager_steps() if mode == "eager" else contextlib.nullcontext():
            losses = [float(step(sample.arrays, seed)["loss"]) for seed in (1, 2, 3)]
        runs.append((model, opt, step, losses))
    (gm, go, gs, gl), (em, eo, es, el) = runs
    assert [gr.replays for gr in gs.program.graphs.values()] == [2] and not es.program.graphs
    assert gl == el
    for (name, p), q in zip(gm.named_parameters(), em.parameters()):
        assert torch.equal(p, q), name
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(go.state[p][k], eo.state[q][k]), name


@pytest.mark.cuda
def test_graphed_dp_steps_match_eager(cuda_device):
    """Trainer(Config(dp=2)) on [card] * 2: 3 epochs (rotation on, the
    learning rate halved each epoch) replay one graph of the sharded step
    after its warm-up; the parameters, Adam's moments and the epochs'
    metrics are bit-equal to the eager steps'."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train.trainer import Trainer

    ds = _small_train_set()
    cfg = Config(dp=2, seed=0, max_epoch=3, lr_sch="exp", lr_decay=0.5)
    runs = {}
    for mode in ("graphed", "eager"):
        with eager_steps() if mode == "eager" else contextlib.nullcontext():
            tr = Trainer(cfg, ds, None, devices=[cuda_device] * 2)
            hist = []
            tr.fit(on_epoch=lambda t, m, e: hist.append(m))
        runs[mode] = (tr, hist)
    (g, g_hist), (e, e_hist) = runs["graphed"], runs["eager"]
    steps = 3 * -(-len(ds) // 2)
    assert [gr.replays for gr in g._sharded_step.program.graphs.values()] == [steps - 1]
    assert not e._sharded_step.program.graphs
    assert _metrics(g_hist) == _metrics(e_hist)
    _same_training(g, e)


def _eval_set(subdivs=(3,), seeds=(7, 8)):
    """Noisy copies of icosphere(subdiv) meshes, patches of at most 600
    faces, as _small_train_set's."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.data import dataset

    pairs = [(synth.add_noise(synth.icosphere(d), 0.2, seed=s), synth.icosphere(d))
             for d in subdivs for s in seeds]
    return dataset.InMemoryDataset(pairs, Config().build_config(), submesh_size=600)


@pytest.mark.cuda
def test_graphed_eval_matches_eager_across_a_restore(cuda_device, tmp_path):
    """Trainer.evaluate on the card replays one CUDA graph of an eval
    sample's forward and metrics (one per plan: a preloaded run has one);
    over 3 epochs of Trainer.fit, the third after Trainer.restore of the
    second's ckpt_last.pkl, which drops the step's and the eval graphs, the
    eval metrics are bit-equal to the eager pass's, as are the weights."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.testing import eager_steps
    from geobignn_tpu_torch.train.trainer import Trainer

    ds, ev = _small_train_set(), _eval_set()
    runs = {}
    for mode in ("graphed", "eager"):
        run_dir = tmp_path / mode
        run_dir.mkdir()
        with eager_steps() if mode == "eager" else contextlib.nullcontext():
            tr = Trainer(Config(seed=0, max_epoch=2), ds, ev, str(run_dir), device=cuda_device)
            hist = []
            tr.fit(on_epoch=lambda t, m, e: hist.append(e))
            graphs = (len(tr._program.graphs), len(tr._eval_program.graphs))
            replays = [g.replays for g in tr._eval_program.graphs.values()]
            tr.restore(str(run_dir / "ckpt_last.pkl"))
            assert not tr._program.graphs and not tr._eval_program.graphs
            tr.cfg = tr.cfg.with_updates(max_epoch=3)
            tr.fit(on_epoch=lambda t, m, e: hist.append(e))
            graphs += (len(tr._program.graphs), len(tr._eval_program.graphs))
        runs[mode] = (tr, hist, graphs, replays)
    (g, g_hist, g_graphs, g_replays), (e, e_hist, e_graphs, _) = runs["graphed"], runs["eager"]
    assert g_graphs == (1, 1, 1, 1) and e_graphs == (0, 0, 0, 0)
    assert g_replays == [2 * len(ev) - 1]  # the first sample warms up and captures
    assert len(g_hist) == 3 and g_hist == e_hist, (g_hist, e_hist)
    for a, b in zip(g.model.parameters(), e.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_one_eval_graph_per_plan(cuda_device):
    """A preloaded run pads every eval sample to one plan: one eval graph.
    Streamed over size buckets, the step and the eval pass each keep one
    graph per bucket plan they met."""
    from geobignn_tpu_torch.config import Config
    from geobignn_tpu_torch.train.trainer import Trainer

    ds = _small_train_set()
    ev = _eval_set((2, 3), seeds=(7,))
    tr = Trainer(Config(seed=0), ds, ev, device=cuda_device)
    tr.evaluate()
    tr.evaluate()
    (graph,) = tr._eval_program.graphs.values()
    assert graph.replays == 2 * len(ev) - 1
    cfg = Config(seed=0, preload=False, buckets_growth=1.5)
    streamed = Trainer(cfg, _small_train_set(), _eval_set((2, 3), seeds=(7,)), device=cuda_device)
    first = streamed.evaluate()
    assert streamed.evaluate() == first
    plans = {streamed.eval_ds.bucket_of[i] for i in range(len(streamed.eval_ds))}
    assert len(plans) == 2 and len(streamed._eval_program.graphs) == len(plans)


@pytest.mark.cuda
def test_short_campaign_lowers_the_eval_error(cuda_device, tmp_path):
    """Two epochs of the campaign (train_synthetic_campaign.train) on its
    short corpus, 24 train and 6 eval samples, the eval pass replayed: the
    eval normal error falls, one step graph and one eval graph."""
    from geobignn_tpu_torch.examples import train_synthetic_campaign as tsc

    (train_pairs, _), (eval_pairs, _) = tsc.corpus(short=True)
    cfg = tsc.campaign_config(2, log_dir=str(tmp_path))
    train_ds, eval_ds = tsc.datasets(cfg, train_pairs, eval_pairs)
    hist = []
    tr, run_dir, best = tsc.train(cfg, train_ds, eval_ds, device=cuda_device,
                                  on_epoch=lambda t, m, e: hist.append(e["error_f"]))
    assert len(hist) == 2 and hist[1] < hist[0] and best == hist[1]
    assert len(tr._program.graphs) == len(tr._eval_program.graphs) == 1
    assert os.path.exists(os.path.join(run_dir, "ckpt_best.pkl"))
