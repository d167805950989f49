"""Data augmentation — random SO(3) rotation on the device.

Counterpart of geobignn_tpu/data/augment.py (reference RandomRotate,
code/dataset.py:39-69): a joint rotation of positions, normals, targets and
depth rays of BOTH graphs.  Edge weights and the pooling hierarchy are
rotation-invariant, so only features rotate.  The angles come from an
explicit torch.Generator (the JAX package draws them from a PRNG key; the
two give different numbers, so parity is tested through `rotate_sample`
with a given matrix).
"""

from __future__ import annotations

import math

import torch

from geobignn_tpu_torch.structs import DualSample


def random_rotation_matrix(generator: torch.Generator, z_only: bool = False) -> torch.Tensor:
    """Rotation from three uniform Euler angles in [0, 2π): Rz, or Rz@Ry@Rx
    (the reference's parameterization, not Haar-uniform; kept for parity).
    Drawn on the generator's device."""
    a = torch.rand(3, generator=generator, device=generator.device) * (2.0 * math.pi)
    ca, sa = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a[0]), torch.zeros_like(a[0])
    rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, ca[0], -sa[0]]),
                      torch.stack([zero, sa[0], ca[0]])])
    ry = torch.stack([torch.stack([ca[1], zero, sa[1]]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-sa[1], zero, ca[1]])])
    rz = torch.stack([torch.stack([ca[2], -sa[2], zero]),
                      torch.stack([sa[2], ca[2], zero]),
                      torch.stack([zero, zero, one])])
    return rz if z_only else rz @ ry @ rx


def rotate_sample(sample: DualSample, rot: torch.Tensor) -> DualSample:
    def r3(m):
        return None if m is None else m @ rot

    def rot_x(x):
        return torch.cat([x[:, :3] @ rot, x[:, 3:6] @ rot], dim=1)

    v = sample.v.replace(x=rot_x(sample.v.x), y=r3(sample.v.y),
                         depth_direction=r3(sample.v.depth_direction))
    f = sample.f.replace(x=rot_x(sample.f.x), y=r3(sample.f.y))
    return sample.replace(v=v, f=f)
