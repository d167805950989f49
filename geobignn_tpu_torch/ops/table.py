"""Dense neighbor/member tables: host builders and torch gathers.

Counterpart of geobignn_tpu/ops/table.py.  The host builders are copied
unchanged (bit-identical tables); the device side is the forward of the
JAX package's gather primitives.  Their scatter-free custom backwards (the
`rev` tables) belong to the training slice and are not ported yet: the
`rev` arguments are accepted so the call sites read like the JAX ones.
"""

from __future__ import annotations

import numpy as np
import torch

from geobignn_tpu_torch.structs import round_up


# --------------------------------------------------------------------------
# the primitive
# --------------------------------------------------------------------------

def table_gather(x: torch.Tensor, nbr: torch.Tensor, rev=None) -> torch.Tensor:
    """out[..m, k] = x[nbr[..m, k]] (forward of the JAX table_gather)."""
    del rev  # backward table, used by the training slice
    return x[nbr]


# --------------------------------------------------------------------------
# host-side builders (vectorized numpy)
# --------------------------------------------------------------------------

def neighbor_table_np(
    edge_index: np.ndarray,  # (2, E) trash-padded COO (row==col==trash on pad)
    n_pad: int,
    k_pad: int | None = None,
    granularity: int = 8,
) -> tuple[np.ndarray, np.ndarray, int]:
    """COO -> (nbr (n_pad, K) int32, kmask (n_pad, K) f32, K).

    Rows need not be sorted.  Padded/self-loop edges (row == col) are
    dropped — the framework's edge lists never carry real self-loops
    (implicit-self-loop convention, ops/feastconv.py)."""
    trash = n_pad - 1
    row = edge_index[0].astype(np.int64)
    col = edge_index[1].astype(np.int64)
    real = row != col
    row, col = row[real], col[real]

    order = np.argsort(row, kind="stable")
    row_s, col_s = row[order], col[order]
    deg = np.bincount(row_s, minlength=n_pad)
    ptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(deg, out=ptr[1:])
    k = int(deg.max()) if deg.size else 0
    k_out = k_pad if k_pad is not None else round_up(max(k, 1), granularity)
    if k > k_out:
        raise ValueError(f"max degree {k} exceeds k_pad {k_out}")

    nbr = np.full((n_pad, k_out), trash, np.int32)
    pos = np.arange(row_s.size, dtype=np.int64) - ptr[row_s]
    nbr[row_s, pos] = col_s
    kmask = np.zeros((n_pad, k_out), np.float32)
    kmask[row_s, pos] = 1.0
    return nbr, kmask, k_out


def reverse_table_np(
    nbr: np.ndarray,  # (M, K) int32 source indices
    n_src: int,
    src_mask: np.ndarray | None = None,  # (n_src,) bool/f32: real source rows
    r_pad: int | None = None,
    granularity: int = 8,
) -> tuple[np.ndarray, int]:
    """Positions of each source row inside `nbr` -> rev (n_src, R) int32;
    pad value nbr.size (the zero row of the extended flattened gradient).

    `src_mask` marks REAL source rows; references to non-real rows (trash
    slots — note a disjoint-union batch has one PER COMPONENT, not just
    n_src-1) are dropped: every padding entry points at a trash slot, whose
    gradient is discarded anyway, and keeping them would blow up the padded
    fan-in R.  Default mask: everything but the final row."""
    m, kk = nbr.shape
    flat = nbr.reshape(-1).astype(np.int64)
    if src_mask is None:
        valid = flat != (n_src - 1)
    else:
        real = np.asarray(src_mask).astype(bool)
        valid = real[flat]
    positions = np.nonzero(valid)[0]
    vals = flat[positions]
    order = np.argsort(vals, kind="stable")
    vals_s, pos_s = vals[order], positions[order]
    cnt = np.bincount(vals_s, minlength=n_src)
    start = np.zeros(n_src + 1, np.int64)
    np.cumsum(cnt, out=start[1:])
    r = int(cnt.max()) if cnt.size else 0
    r_out = r_pad if r_pad is not None else round_up(max(r, 1), granularity)
    if r > r_out:
        raise ValueError(f"max fan-in {r} exceeds r_pad {r_out}")

    rev = np.full((n_src, r_out), m * kk, np.int32)
    rank = np.arange(vals_s.size, dtype=np.int64) - start[vals_s]
    rev[vals_s, rank] = pos_s
    return rev, r_out


def members_table_np(
    cluster: np.ndarray,  # (n_in,) int32 fine -> coarse (padding -> a trash)
    fine_mask: np.ndarray | None,  # (n_in,) real fine slots; None = all but last
    n_out: int,
    m_pad: int | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Cluster-member table for gather-pooling: members[c, j] = j-th fine
    slot of coarse c, padded with the FINE trash slot (whose features are
    zero under the framework invariant).  Only fine slots marked real in
    `fine_mask` enter the table — padding fine slots all map onto (possibly
    per-component) coarse trash rows and would blow up m_pad."""
    n_in = cluster.shape[0]
    fine_trash = n_in - 1
    if fine_mask is None:
        real_fine = np.ones(n_in, bool)
        real_fine[-1] = False
    else:
        real_fine = np.asarray(fine_mask).astype(bool)
    fines = np.nonzero(real_fine)[0]
    cl = cluster[fines].astype(np.int64)
    order = np.argsort(cl, kind="stable")
    cl_s = cl[order]
    fines_s = fines[order]
    cnt = np.bincount(cl_s, minlength=n_out)
    start = np.zeros(n_out + 1, np.int64)
    np.cumsum(cnt, out=start[1:])
    m = int(cnt.max()) if cnt.size else 0
    m_out = m_pad if m_pad is not None else max(m, 1)
    if m > m_out:
        raise ValueError(f"max cluster size {m} exceeds m_pad {m_out}")

    members = np.full((n_out, m_out), fine_trash, np.int32)
    rank = np.arange(cl_s.size, dtype=np.int64) - start[cl_s]
    members[cl_s, rank] = fines_s
    mmask = np.zeros((n_out, m_out), np.float32)
    mmask[cl_s, rank] = 1.0
    return members, mmask, m_out


# --------------------------------------------------------------------------
# gather-formulated reductions built on the primitive
# --------------------------------------------------------------------------

def gather_pool_max(x, members, rev, mmask):
    """segment_max(x, cluster) re-expressed as max over gathered members.
    Padding members are masked to -inf (a zero-fill would clip genuinely
    negative maxima — activations are LeakyReLU outputs); empty coarse rows
    (only the trash row) fall back to 0, matching segment_max's
    fill_value=0 convention."""
    g = table_gather(x, members, rev)  # (n_out, m, C)
    neg = torch.tensor(-torch.inf, dtype=g.dtype, device=g.device)
    m = torch.where(mmask[..., None] > 0, g, neg).amax(dim=1)
    has = mmask.sum(dim=1) > 0
    return torch.where(has[:, None], m, torch.zeros((), dtype=m.dtype, device=m.device))


def gather_pool_mean(x, members, rev, mmask):
    g = table_gather(x, members, rev)
    cnt = torch.clamp(mmask.sum(dim=1), min=1.0)
    return (g * mmask[..., None]).sum(dim=1) / cnt[:, None]


def gather_unpool(x, unpool, rev):
    """x[unpool] (forward of the JAX gather_unpool)."""
    return table_gather(x, unpool[:, None], rev)[:, 0]
