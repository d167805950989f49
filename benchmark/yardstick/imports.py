"""The check that nothing of JAX, or of the JAX package, is loaded."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "geobignn_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names in `modules` (default sys.modules) that are on the
    list, compared whole: `geobignn_tpu_torch` is not `geobignn_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
