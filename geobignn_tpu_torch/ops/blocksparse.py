"""Block-sparse FeaStConv windows: host builders only.

Counterpart of the host part of geobignn_tpu/ops/blocksparse.py, copied
unchanged: `builder.widths_for` and `TableWidths.merge` record the
block-sparse column-block counts per level.  The device kernels (TPU kernels
#5 and #6) are not ported yet; a level that would need them makes the model
raise NotImplementedError (models/dual_gnn.py).
"""

from __future__ import annotations

import numpy as np

from geobignn_tpu_torch.structs import round_up

BS_TILE = 256  # row-block size for block-sparse levels


def bs_tile() -> int:
    """Row-block size for block-sparse levels (the JAX package's default;
    its GBN_BS_TILE override is left out)."""
    return BS_TILE


# --------------------------------------------------------------------------
# host-side builders
# --------------------------------------------------------------------------

def block_sparse_np(
    edge_index: np.ndarray,  # (2, E) trash-padded COO in RCM order
    n_pad: int,  # multiple of tile
    tile: int,
    k_pad: int | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-row-block column-block lists + in-window edge mask.

    Returns (blk_idx (B, K) int32, mask (B, T, K*T) int8, k_needed):
    mask[b, t, j*T + w] = 1 iff edge (b*T + t) <- (blk_idx[b, j]*T + w).
    Padded blk_idx slots repeat the row block's own index (cheap refetch,
    zero mask).  Raises if the graph needs more than k_pad column blocks
    for some row block."""
    assert n_pad % tile == 0, (n_pad, tile)
    n_blk = n_pad // tile
    row = edge_index[0].astype(np.int64)
    col = edge_index[1].astype(np.int64)
    real = row != col  # trash padding is (trash, trash); stored graphs are
    # self-loop-free, so this strips exactly the padding
    row, col = row[real], col[real]
    b = row // tile
    cb = col // tile

    key = b * n_blk + cb
    uniq = np.unique(key)  # sorted (b-major)
    ub, uc = uniq // n_blk, uniq % n_blk
    counts = np.bincount(ub, minlength=n_blk)
    k_needed = int(counts.max()) if uniq.size else 1
    k = k_pad or k_needed
    if k_needed > k:
        raise ValueError(f"needs {k_needed} column blocks > k_pad {k}")

    offsets = np.zeros(n_blk + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    blk_idx = np.broadcast_to(
        np.arange(n_blk, dtype=np.int32)[:, None], (n_blk, k)
    ).copy()  # default: own block (mask-zero repeat)
    j_of_uniq = np.arange(uniq.size) - offsets[ub]
    blk_idx[ub, j_of_uniq] = uc.astype(np.int32)

    pos = np.searchsorted(uniq, key)  # per-edge slot in the uniq list
    j_e = pos - offsets[b]
    t = row - b * tile
    w = j_e * tile + (col - cb * tile)
    mask = np.zeros((n_blk, tile, k * tile), np.int8)
    mask[b, t, w] = 1
    return blk_idx, mask, k_needed


def blocks_needed(edge_index: np.ndarray, n: int, tile: int | None = None) -> int:
    """Max column blocks any row block needs (cheap; no mask built)."""
    tile = bs_tile() if tile is None else tile
    row = edge_index[0].astype(np.int64)
    col = edge_index[1].astype(np.int64)
    real = row != col
    row, col = row[real], col[real]
    if row.size == 0:
        return 1
    n_blk = (round_up(n, tile)) // tile
    key = (row // tile) * n_blk + (col // tile)
    uniq = np.unique(key)
    return int(np.bincount(uniq // n_blk, minlength=n_blk).max())
