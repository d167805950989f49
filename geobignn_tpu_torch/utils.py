"""Device selection, shared by the port's entry points, and small math
utilities.

Counterpart of geobignn_tpu/utils.py:
  * batch quaternion -> rotation matrix (reference code/net_util.py:14-42);
  * rigid ICP prealignment — the reference optionally ICP-aligns
    predictions before the vertex loss via pytorch3d (code/network.py:
    14-17,364-367); here the JAX package's SVD-based rigid ICP in torch.
`enable_compile_cache` is JAX's compile cache and has no counterpart.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for (the default) and no GPU is
    present — the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "geobignn_tpu_torch runs on CUDA by default and no GPU is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def batch_quat_to_rotmat(q: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """(B, 4) quaternions (w, x, y, z) -> (B, 3, 3) rotation matrices."""
    s = 2.0 / (q * q).sum(-1) if normalize else q.new_full(q.shape[:1], 2.0)
    h = torch.einsum("bi,bj->bij", q, q)
    w, x, y, z = 0, 1, 2, 3
    r = torch.stack(
        [
            1 - (h[:, y, y] + h[:, z, z]) * s,
            (h[:, x, y] - h[:, z, w]) * s,
            (h[:, x, z] + h[:, y, w]) * s,
            (h[:, x, y] + h[:, z, w]) * s,
            1 - (h[:, x, x] + h[:, z, z]) * s,
            (h[:, y, z] - h[:, x, w]) * s,
            (h[:, x, z] - h[:, y, w]) * s,
            (h[:, y, z] + h[:, x, w]) * s,
            1 - (h[:, x, x] + h[:, y, y]) * s,
        ],
        dim=-1,
    )
    return r.reshape(-1, 3, 3)


def _rigid_align(src, dst, weights):
    """Weighted Kabsch: the best R, t mapping src -> dst, with the
    reflection guard (R does not depend on the singular vectors' signs)."""
    wsum = torch.clamp(weights.sum(), min=1e-12)
    mu_s = (src * weights[:, None]).sum(0) / wsum
    mu_d = (dst * weights[:, None]).sum(0) / wsum
    a = (src - mu_s) * weights[:, None]
    b = dst - mu_d
    u, _, vt = torch.linalg.svd(a.T @ b)
    d = torch.sign(torch.linalg.det(vt.T @ u.T))
    one = torch.ones((), dtype=d.dtype, device=d.device)
    r = vt.T @ torch.diag(torch.stack([one, one, d])) @ u.T
    return r, mu_d - r @ mu_s


def icp_align(src: torch.Tensor, dst: torch.Tensor, mask_src=None, mask_dst=None,
              n_iters: int = 10, block: int = 1024):
    """Rigid ICP: (aligned_src, R, t) with aligned = src @ R.T + t.  Each
    iteration recomputes the nearest valid point of dst by the blocked
    search of models/losses.py and refits R, t; autograd differentiates
    through every iteration's Kabsch step, as JAX through its fori_loop."""
    from geobignn_tpu_torch.models.losses import nearest_index

    ms = torch.ones(src.shape[0], dtype=src.dtype, device=src.device) \
        if mask_src is None else mask_src
    md = torch.ones(dst.shape[0], dtype=dst.dtype, device=dst.device) \
        if mask_dst is None else mask_dst
    r = torch.eye(3, dtype=src.dtype, device=src.device)
    t = torch.zeros(3, dtype=src.dtype, device=src.device)
    for _ in range(n_iters):
        idx = nearest_index(src @ r.T + t, dst, md, block)
        r, t = _rigid_align(src, dst[idx], ms)
    return src @ r.T + t, r, t
