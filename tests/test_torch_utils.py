"""utils.batch_quat_to_rotmat, utils.icp_align and loss_v(apply_icp=True)
against the JAX package on the CPU.

Inputs are made with numpy from a seed.  The quaternion matrices are
float32 products: 1e-6.  ICP compares R and t (never the SVD's U or V,
whose signs are free) on point sets whose nearest points are unique by a
wide margin, so no argmin tie can flip between the packages: 1e-5.  JAX
differentiates loss_v(apply_icp=True) through its 10-iteration fori_loop
and the SVD; the port through the same iterations by autograd: the loss
within 1e-5 relative, the gradient within 1e-4 of its max|g|, on a case
whose cross-covariance has distinct singular values.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geobignn_tpu import utils as jutils
from geobignn_tpu.models import losses as jlosses
from geobignn_tpu_torch import utils
from geobignn_tpu_torch.models import losses
from geobignn_tpu_torch.testing import share_cores

share_cores()  # torch's CPU threads: this test worker's share of the cores


def _rot_z(deg):
    a = math.radians(deg)
    return np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]],
                    dtype=np.float32)


@pytest.mark.parametrize("normalize", [True, False])
def test_quat_to_rotmat_matches_jax(normalize):
    q = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    if not normalize:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    got = utils.batch_quat_to_rotmat(torch.from_numpy(q), normalize).numpy()
    want = np.asarray(jutils.batch_quat_to_rotmat(jnp.asarray(q), normalize))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # rotations: orthonormal, det 1; q and -q and 3q (normalized) the same
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    if normalize:
        for scaled in (-q, 3.0 * q):
            np.testing.assert_allclose(
                utils.batch_quat_to_rotmat(torch.from_numpy(scaled)).numpy(), got, atol=1e-5)
    q90 = torch.tensor([[math.cos(math.pi / 4), 0, 0, math.sin(math.pi / 4)]])
    np.testing.assert_allclose(utils.batch_quat_to_rotmat(q90)[0].numpy() @ [1.0, 0, 0],
                               [0, 1, 0], atol=1e-6)


def _pair(n, deg, shift, seed, jitter=0.0):
    """Points spaced at least 0.25 apart and their rotated, shifted copy."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts = (grid[rng.permutation(len(grid))[:n]] * 0.3
           + rng.uniform(-0.02, 0.02, size=(n, 3))).astype(np.float32)
    pts -= pts.mean(0)
    dst = pts @ _rot_z(deg).T + np.float32(shift)
    dst += jitter * rng.normal(size=dst.shape).astype(np.float32)
    return pts, dst.astype(np.float32)


def test_icp_align_matches_jax():
    """tests/test_utils.py's recovery, on a jittered lattice whose points
    move less than half their spacing (each one's first nearest point is
    its own image): R and t as JAX's, the aligned points on their targets,
    masks honoured."""
    src, dst = _pair(400, 5, [0.03, -0.02, 0.05], seed=0)
    aligned, r, t = utils.icp_align(torch.from_numpy(src), torch.from_numpy(dst))
    j_aligned, jr, jt = jutils.icp_align(jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(r.numpy(), _rot_z(5), atol=1e-4)
    assert float(np.abs(aligned.numpy() - dst).max()) < 1e-4
    # a masked source row and a masked target row take no part
    ms = np.ones(400, np.float32)
    ms[7] = 0.0
    md = ms.copy()
    src_bad = src.copy()
    src_bad[7] += 5.0
    _, r2, t2 = utils.icp_align(torch.from_numpy(src_bad), torch.from_numpy(dst),
                                torch.from_numpy(ms), torch.from_numpy(md))
    _, jr2, jt2 = jutils.icp_align(jnp.asarray(src_bad), jnp.asarray(dst), jnp.asarray(ms),
                                   jnp.asarray(md))
    np.testing.assert_allclose(r2.numpy(), np.asarray(jr2), atol=1e-5)
    np.testing.assert_allclose(t2.numpy(), np.asarray(jt2), atol=1e-5)


def test_loss_v_with_icp_matches_jax():
    """Forward and gradient through the ICP iterations and the SVD; the
    plain loss is over ten times the aligned one (the jitter stays)."""
    v, vp = _pair(300, 5, [0.05, 0.0, -0.02], seed=1, jitter=0.004)
    mask = np.ones(300, np.float32)
    mask[-3:] = 0.0
    cov = (v - v.mean(0)).T @ (vp - vp.mean(0))
    sv = np.linalg.svd(cov, compute_uv=False)
    assert np.diff(sv).min() < -0.05 * sv[0]  # distinct singular values

    def jloss(p):
        return jlosses.loss_v(p, jnp.asarray(v), jnp.asarray(mask), "L1", apply_icp=True)

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(vp))
    tp = torch.tensor(vp, requires_grad=True)
    tl = losses.loss_v(tp, torch.from_numpy(v), torch.from_numpy(mask), "L1", apply_icp=True)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    jg = np.asarray(jg)
    assert np.abs(tp.grad.numpy() - jg).max() <= 1e-4 * np.abs(jg).max()
    plain = losses.loss_v(torch.from_numpy(vp), torch.from_numpy(v), torch.from_numpy(mask), "L1")
    assert float(tl.detach()) < 0.1 * float(plain)
