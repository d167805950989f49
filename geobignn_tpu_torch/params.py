"""Weights across the two packages, seeded init, flat .npz files.

The JAX package's parameter tree is nested dicts of arrays:
params["params"]["gnn_v"]["l_conv1"]["u"|"c"|"w"|"b"] for the convs
(dual_gnn.CONV_SCHEDULE) and params["params"]["fc_v1"]["kernel"|"bias"] for
the heads.  The port's DualGNN names its parameters by the same path joined
with dots ("gnn_v.l_conv1.u", "fc_v1.kernel") and keeps the same layouts,
so moving weights is a renaming.

`init_` follows flax's initialisers in distribution (not in bits — the two
frameworks' generators differ): Glorot-uniform conv `w`, normal x 0.1 `u`,
zero `c` and `b`, LeCun-normal (truncated) Dense kernels, zero Dense biases.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    """JAX/flax parameter tree (nested dicts of arrays, with or without the
    top-level "params" key) -> the port's DualGNN state dict (CPU f32)."""
    tree = tree.get("params", tree)
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, name)
            else:
                out[name] = torch.from_numpy(np.array(v, dtype=np.float32))

    walk(tree, "")
    return out


def to_jax_params(state: dict) -> dict:
    """Inverse of `from_jax_params`: {"params": nested dicts of numpy}."""
    root: dict = {}
    for name, v in state.items():
        node = root
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v.detach().cpu().numpy().astype(np.float32)
    return {"params": root}


def save_npz(path: str, state: dict) -> None:
    """Flat .npz with keys "gnn_v/l_conv1/u", readable by either package."""
    np.savez(path, **{k.replace(".", "/"): v.detach().cpu().numpy()
                      for k, v in state.items()})


def load_npz(path: str) -> dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k.replace("/", "."): torch.from_numpy(z[k].copy()) for k in z.files}


def _trunc_normal(shape, std, gen):
    """Normal(0, std) truncated to +-2 std, by inverse CDF (as flax's
    truncated_normal)."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.empty(shape, dtype=torch.float64).uniform_(lo, hi, generator=gen)
    return (math.sqrt(2) * torch.erfinv(2 * u - 1) * std).to(torch.float32)


@torch.no_grad()
def init_(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded init of a DualGNN's parameters in place, drawn on the CPU from
    one torch.Generator (so every device gets the same weights)."""
    gen = torch.Generator().manual_seed(seed)
    for name, prm in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(prm.shape)
        if leaf in ("c", "b", "bias"):
            val = torch.zeros(shape)
        elif leaf == "u":
            val = torch.randn(shape, generator=gen) * 0.1
        elif leaf == "w":  # glorot_uniform over (H, C_in, C_out): fan = C*H
            heads, c_in, c_out = shape
            limit = math.sqrt(6.0 / (heads * c_in + heads * c_out))
            val = (torch.rand(shape, generator=gen) * 2 - 1) * limit
        elif leaf == "kernel":  # lecun_normal, truncated
            std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
            val = _trunc_normal(shape, std, gen)
        else:
            raise KeyError(f"no initialiser for parameter {name}")
        prm.copy_(val.to(prm.device, prm.dtype))
    return model
