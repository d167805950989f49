"""Brute-force nearest-neighbour distance on Hopper: kernel wrapper and
plain version.

Counterpart of geobignn_tpu/ops/pallas_nn.py (TPU kernel #7, `_nn_kernel`
through `nearest_distance_pallas`): for each row of a (N, K), the Euclidean
distance to the nearest row of b (M, K), computed as
sqrt(max(min_j(|a|^2 - 2 a.b_j + |b_j|^2), 0)) in float32 — the vertex-
distance metric of infer/evaluate.py (reference my_hausdorff.py:17-49).

`nearest_distance` launches csrc/nearest.cu on CUDA tensors (one launch per
call, counted in `banded_cuda.LAUNCHES["nearest"]`; a failure to build or
launch raises) and runs `nearest_distance_plain` on CPU tensors; nothing
else decides the route.  The library is built with the other kernel sources
by `banded_cuda.build()` at first use and loaded by its full path.

Numerics.  The expansion cancels for near points: the error of a squared
distance is a few ulps of |a|^2 + |b|^2 (kernel, plain version and a
float64 brute force agree within 1e-5 * max(|a|^2 + |b|^2)), so a point of
a that is also in b gives a small residual, not zero, and a d^2 that comes
out slightly negative is clamped before the root.  The root magnifies the
error for the closest pairs: |err(d)| <= sqrt(err(d^2)), that is about
3e-3 at unit scale for coincident points, and err(d^2) / (2 d) elsewhere.
"""

from __future__ import annotations

import ctypes

import torch

from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.ops.banded_cuda import LAUNCHES

_lib = None


def _load():
    global _lib
    if _lib is None:
        banded_cuda.build()
        lib = ctypes.CDLL(banded_cuda.LIBRARIES["nearest"])
        lib.gbn_nearest_distance.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.gbn_nearest_distance.restype = ctypes.c_int
        _lib = lib
    return _lib


def nearest_distance_plain(a: torch.Tensor, b: torch.Tensor, block: int = 1024,
                           squared: bool = False) -> torch.Tensor:
    """Plain PyTorch version over row blocks of `a`, so that the (N, M)
    matrix never exists whole: the same expansion in float32."""
    a, b = _as_f32(a, b)
    b2 = (b * b).sum(dim=1)
    d2 = torch.cat([
        ((blk * blk).sum(dim=1, keepdim=True) - 2.0 * blk @ b.T + b2[None, :]).amin(dim=1)
        for blk in (a[s:s + block] for s in range(0, a.shape[0], block))])
    return d2 if squared else torch.sqrt(torch.clamp(d2, min=0.0))


def _as_f32(a, b):
    """Check the shapes and convert as `nearest_distance_pallas` does:
    float32 (and contiguous, for the kernel)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1] or a.shape[1] < 1:
        raise ValueError(f"nearest_distance needs a (N, K) and b (M, K) with one K >= 1; "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[0] < 1 or b.shape[0] < 1:
        raise ValueError(f"nearest_distance needs at least one point on each side; "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device} and b on {b.device}")
    return (a.detach().to(torch.float32).contiguous(),
            b.detach().to(torch.float32).contiguous())


def nearest_distance(a: torch.Tensor, b: torch.Tensor, squared: bool = False) -> torch.Tensor:
    """(N,) float32 distance from each row of a to its nearest row of b
    (`squared=True`: the squared distance as the expansion gives it, not
    clamped).  Not differentiable: it is a metric."""
    a, b = _as_f32(a, b)
    if not a.is_cuda:
        return nearest_distance_plain(a, b, squared=squared)
    lib = _load()
    out = torch.empty(a.shape[0], dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = lib.gbn_nearest_distance(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[0],
            a.shape[1], int(squared), torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nearest-distance kernel launch failed: CUDA error {rc}")
    LAUNCHES["nearest"] += 1
    return out
