"""Seeded edge-case inputs of the window aggregates, made with numpy.

One generator for the CPU tests (port against the JAX package), the
card-only tests and chip_smoke.py (kernels against the plain versions), so
that all of them hold the same cases:

  * rows without a set slot, and nodes that no row's window sets;
  * absent neighbours: set slots of the first row block's first third
    (nodes below 0) and of the last row block's last third (nodes from N
    on), which read as zero;
  * mask values 2 and 3 beside 1 (the mask is taken as a number);
  * a row with more than 32 set slots and a node set by every row of the
    row blocks that see it (the kernels walk set slots in batches of 32);
  * rows and nodes whose D = sum_h r[i,h] p[j,h] lies under the 1e-12
    clamp, where the forward divides by the clamp and the backward's
    denominator path is cut.
"""

from __future__ import annotations

import numpy as np


def edge_case_inputs(c_in: int, c_out: int, tile: int = 32, n_blk: int = 3,
                     heads: int = 9, seed: int = 0, blocksparse: bool = False) -> dict:
    """Inputs of `banded_aggregate` (or, with blocksparse, `bs_aggregate`)
    and its backward: float32 r, p (N, H), x (N, C_in), w (H, C_in, C_out),
    gout (N, C_out), int8 m (B, T, 3T) — or (B, T, K T) beside an int64
    blk_idx (B, K), K = 4, whose last entry is a padded one (the row
    block's own index again under an all-zero mask) — and `clamped`, the
    rows whose D lies under the clamp (their r̄ is of the order of 1e12 and
    is compared apart from the other rows')."""
    rng = np.random.default_rng(seed)
    n = n_blk * tile
    x = rng.normal(size=(n, c_in)).astype(np.float32)
    a = x @ (rng.normal(size=(c_in, heads)) * 0.5).astype(np.float32)
    c = (rng.normal(size=heads) * 0.3).astype(np.float32)
    p = np.exp(a - a.max(1, keepdims=True)).astype(np.float32)
    ca = c - a
    r = np.exp(ca - ca.max(1, keepdims=True)).astype(np.float32)
    w = (rng.normal(size=(heads, c_in, c_out)) * 0.4).astype(np.float32)
    gout = rng.normal(size=(n, c_out)).astype(np.float32)

    k_blk = 4 if blocksparse else 3
    win = k_blk * tile
    m = np.zeros((n_blk, tile, win), np.int8)
    live = (k_blk - 1) * tile if blocksparse else win  # the padded entry stays empty
    for b in range(n_blk):
        for t in range(tile):
            slots = rng.choice(live, size=int(rng.integers(3, 9)), replace=False)
            m[b, t, slots] = rng.integers(1, 4, size=slots.size)
    out = {}
    if blocksparse:
        # each row block lists itself, two other column blocks (sorted, as
        # block_sparse_np lists them) and itself again as the padded entry
        blk_idx = np.empty((n_blk, k_blk), np.int64)
        for b in range(n_blk):
            others = rng.choice([q for q in range(n_blk) if q != b],
                                size=min(2, n_blk - 1), replace=False)
            lst = sorted({b, *others.tolist()})
            lst += [b] * (k_blk - len(lst))
            blk_idx[b] = lst
            m[b, :, (k_blk - 1) * tile:] = 0
            for pos in range(len(set(lst)), k_blk):  # every repeated entry is padding
                m[b, :, pos * tile:(pos + 1) * tile] = 0
        out["blk_idx"] = blk_idx
    else:
        # absent neighbours at both ends, set on purpose
        m[0, ::3, : tile : 5] = 2
        m[-1, 1::3, 2 * tile + 1 :: 7] = 3

    # a dense row and a dense column: more set slots than one batch holds
    dense = rng.choice(live, size=min(live - 8, 70), replace=False)
    m[0, 7, dense] = rng.integers(1, 4, size=dense.size)
    if blocksparse:
        m[:, :, 9] = 1  # node blk_idx[b, 0] * tile + 9, in every row of block b
    else:
        j = tile + 9
        for b in range(n_blk):
            w_slot = j - (b - 1) * tile
            if 0 <= w_slot < win:
                m[b, :, w_slot] = 1

    empty_rows = np.array([1, tile, n - 2])
    m.reshape(n, win)[empty_rows] = 0
    if not blocksparse:  # a node that no window sets: its column in the three blocks
        j = tile + 5
        for b in range(n_blk):
            w_slot = j - (b - 1) * tile
            if 0 <= w_slot < win:
                m[b, :, w_slot] = 0

    clamped = np.array([3, tile + 3, n - 5])
    r[clamped] *= np.float32(1e-16)
    p[tile // 2] *= np.float32(1e-16)  # a node under the clamp for every row
    assert (m.reshape(n, win)[clamped] != 0).any(axis=1).all()
    d = r[clamped] @ p.T
    assert (d < 1e-12).all()
    out.update(r=r, p=p, x=x, w=w, m=m, gout=gout, clamped=clamped)
    return out
