"""Edge cases of the window aggregates, forward and backward: the port's
plain versions against the JAX package on the CPU.

The inputs come from geobignn_tpu_torch.testing.edge_case_inputs (numpy,
seeded): rows without a set slot, set slots on absent neighbours at both
ends of the band, mask values 2 and 3, rows and nodes whose D lies under
the 1e-12 clamp — at the default model's transform-first width pairs
(64 -> 32, 128 -> 64) and one aggregate-first pair, T = 32, two to four row
blocks.  The JAX side runs its Pallas kernels in interpret mode, as
tests/test_banded_pallas.py runs them; jax.vjp goes through their custom
VJP.  Tolerances, each relative to the largest magnitude of the tensor
compared, as in tests/test_torch_banded_bwd.py: float32 1e-5 (the same
math summed in another order), bfloat16 2e-2 (a value summed in another
order can round to the neighbouring bf16 value).  r̄ of the rows under the
clamp is of the order of 1e12 and is compared apart from the other rows'.
The CUDA kernels are held against the same plain versions on the same
inputs on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu.ops import banded_pallas
from geobignn_tpu.ops import blocksparse as jbs
from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.ops import blocksparse as tbs
from geobignn_tpu_torch.testing import edge_case_inputs, share_cores

share_cores()  # torch's CPU threads: this test worker's share of the cores

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
WIDTHS = pytest.mark.parametrize(
    "c_in,c_out", [(64, 32), (128, 64), (12, 32)],
    ids=["transform_first_64_32", "transform_first_128_64", "aggregate_first_12_32"])
DTYPES = pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
BLOCKS = pytest.mark.parametrize("n_blk", [2, 4])


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} > {rel} x {scale:.3e}"


def _close_cotangents(got, want, case, rel):
    """r̄ apart for the rows under the clamp; p̄, x̄, W̄ whole."""
    clamped = case["clamped"]
    rest = np.setdiff1d(np.arange(case["r"].shape[0]), clamped)
    for name, g, j in zip(("r", "p", "x", "w"), got, want):
        g, j = g.numpy(), np.asarray(j)
        if name == "r":
            _close(g[clamped], j[clamped], rel, "r cotangent, rows under the clamp")
            _close(g[rest], j[rest], rel, "r cotangent, other rows")
        else:
            _close(g, j, rel, f"{name} cotangent")


def test_generator_holds_every_case():
    case = edge_case_inputs(64, 32, tile=32, n_blk=3, seed=0)
    m, r, p = case["m"], case["r"], case["p"]
    n_blk, tile, win = m.shape
    rows = m.reshape(-1, win)
    assert win == 3 * tile and (rows == 0).all(axis=1).sum() >= 3
    assert (m[0, :, :tile] != 0).any() and (m[-1, :, 2 * tile:] != 0).any()
    assert set(np.unique(m)) == {0, 1, 2, 3}
    assert (rows != 0).sum(axis=1).max() > 32  # more than one batch of slots
    assert ((m[:, :, tile + 9 + tile] != 0).sum(axis=1) >= tile - 1).any()
    d = r[case["clamped"]] @ p.T
    assert (d < 1e-12).all() and ((r @ p[tile // 2]) < 1e-12).all()
    again = edge_case_inputs(64, 32, tile=32, n_blk=3, seed=0)
    assert all(np.array_equal(case[k], again[k]) for k in case)
    bs = edge_case_inputs(64, 32, tile=32, n_blk=3, seed=0, blocksparse=True)
    assert bs["m"].shape == (3, 32, 4 * 32) and bs["blk_idx"].dtype == np.int64
    assert (bs["blk_idx"][:, -1] == np.arange(3)).all()  # the padded entry
    assert (bs["m"][:, :, 3 * 32:] == 0).all()


@WIDTHS
@DTYPES
@BLOCKS
def test_plain_forward_matches_jax_on_edge_cases(c_in, c_out, dtype_name, n_blk):
    case = edge_case_inputs(c_in, c_out, tile=32, n_blk=n_blk, seed=n_blk)
    prim = [case[k] for k in ("r", "p", "x", "w")]
    want = banded_pallas.banded_aggregate(
        *(jnp.asarray(a) for a in prim), jnp.asarray(case["m"]),
        getattr(jnp, dtype_name))
    plain = (banded_cuda.transform_first_plain if c_out < c_in
             else banded_cuda.aggregate_first_plain)
    got = plain(*(torch.from_numpy(a) for a in prim), torch.from_numpy(case["m"]),
                compute_dtype=getattr(torch, dtype_name))
    assert np.isfinite(got.numpy()).all()
    _close(got.numpy(), want, TOL[dtype_name], "forward")
    empty = (case["m"].reshape(got.shape[0], -1) == 0).all(axis=1)
    assert empty.any() and (got.numpy()[empty] == 0).all()


@WIDTHS
@DTYPES
@BLOCKS
def test_plain_backward_matches_jax_vjp_on_edge_cases(c_in, c_out, dtype_name, n_blk):
    case = edge_case_inputs(c_in, c_out, tile=32, n_blk=n_blk, seed=10 + n_blk)
    prim = [case[k] for k in ("r", "p", "x", "w")]
    _, vjp = jax.vjp(
        lambda r_, p_, x_, w_: banded_pallas.banded_aggregate(
            r_, p_, x_, w_, jnp.asarray(case["m"]), getattr(jnp, dtype_name)),
        *(jnp.asarray(a) for a in prim))
    want = vjp(jnp.asarray(case["gout"]))
    plain = (banded_cuda.transform_first_bwd_plain if c_out < c_in
             else banded_cuda.aggregate_first_bwd_plain)
    got = plain(*(torch.from_numpy(a) for a in prim), torch.from_numpy(case["m"]),
                torch.from_numpy(case["gout"]), compute_dtype=getattr(torch, dtype_name))
    assert all(torch.isfinite(g).all() for g in got)
    _close_cotangents(got, want, case, TOL[dtype_name])


@WIDTHS
def test_blocksparse_plain_matches_jax_on_edge_cases(c_in, c_out):
    """The same cases over block-sparse windows with a padded list entry,
    forward and every cotangent, float32."""
    case = edge_case_inputs(c_in, c_out, tile=32, n_blk=3, seed=5, blocksparse=True)
    prim = [case[k] for k in ("r", "p", "x", "w")]
    want, vjp = jax.vjp(
        lambda r_, p_, x_, w_: jbs.bs_aggregate(
            r_, p_, x_, w_, jnp.asarray(case["m"]),
            jnp.asarray(case["blk_idx"].astype(np.int32)), jnp.float32),
        *(jnp.asarray(a) for a in prim))
    want_bar = vjp(jnp.asarray(case["gout"]))
    args = [torch.from_numpy(a) for a in prim] + [
        torch.from_numpy(case["m"]), torch.from_numpy(case["blk_idx"])]
    _close(tbs.bs_aggregate_plain(*args, torch.float32).numpy(), want, 1e-5, "forward")
    got_bar = tbs.bs_aggregate_bwd_plain(*args, torch.from_numpy(case["gout"]),
                                         torch.float32)
    _close_cotangents(got_bar, want_bar, case, 1e-5)
