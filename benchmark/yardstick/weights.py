"""The model's weights, made on the device from the run's seed.

One normal draw from a torch.Generator on the device for every parameter
at once, cut into leaves and scaled as flax initialises them in
distribution: FeaStConv `u` x 0.1, `w` by Glorot's rule over its fans,
Dense kernels by LeCun's (1 / sqrt(fan_in)); `c` and every bias zero.
The same weights go to the program and to the reference.
"""

from __future__ import annotations

import math

import torch


def make(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor on device} for {name: shape}."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for (name, shape), part in zip(shapes.items(), torch.split(flat, sizes)):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("c", "b", "bias"):
            scale = 0.0
        elif leaf == "u":
            scale = 0.1
        elif leaf == "w":  # (H, C_in, C_out): fans H*C_in and H*C_out
            scale = math.sqrt(2.0 / (shape[0] * shape[1] + shape[0] * shape[2]))
        elif leaf == "kernel":
            scale = 1.0 / math.sqrt(shape[0])
        else:
            raise KeyError(f"no initialiser for {name}")
        out[name] = (part * scale).reshape(shape)
    return out
