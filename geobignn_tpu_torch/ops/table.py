"""Dense neighbor/member tables: host builders and torch gathers.

Counterpart of geobignn_tpu/ops/table.py.  The host builders are copied
unchanged (bit-identical tables).  The gathers are `torch.autograd.Function`s
with the JAX custom VJPs as their backward: the gradient of `x[nbr]` is
itself a gather, through the precomputed reverse table `rev` of the
zero-extended output gradient (`_tg_bwd`), or, for the boundary tables'
compact source list, a gather through `rev_c` and one `index_add_` over the
distinct sources `src_b` (`_tgc_bwd`).  Autograd's own backward of an index
would be a scatter-add, whose sort and serial accumulation cost more on the
card than the gather.  As in JAX, rows that `rev` does not list (the trash
slots) get zero gradient.  Without `rev` a gather is plain indexing, as the
JAX model calls it then.
"""

from __future__ import annotations

import numpy as np
import torch

from geobignn_tpu_torch.structs import round_up


# --------------------------------------------------------------------------
# the primitive
# --------------------------------------------------------------------------

def zero_extended(g: torch.Tensor) -> torch.Tensor:
    """g flattened to (rows, C) with one zero row after it: the row that a
    reverse table's padding value (or jpos's sentinel) points at."""
    g = g.reshape(-1, g.shape[-1])
    return torch.cat([g, g.new_zeros((1, g.shape[1]))])


class _TableGather(torch.autograd.Function):
    """x[nbr]; backward `_tg_bwd`: dx = pad(g)[rev].sum(1)."""

    @staticmethod
    def forward(ctx, x, nbr, rev):
        ctx.save_for_backward(rev)
        return x[nbr]

    @staticmethod
    def backward(ctx, g):
        (rev,) = ctx.saved_tensors
        return zero_extended(g)[rev].sum(dim=1), None, None


class _TableGatherCompact(torch.autograd.Function):
    """x[nbr]; backward `_tgc_bwd`: contrib = pad(g)[rev_c].sum(1), added
    into the rows src_b lists."""

    @staticmethod
    def forward(ctx, x, nbr, src_b, rev_c):
        ctx.save_for_backward(src_b, rev_c)
        ctx.x_meta = (x.shape, x.dtype)
        return x[nbr]

    @staticmethod
    def backward(ctx, g):
        src_b, rev_c = ctx.saved_tensors
        shape, dtype = ctx.x_meta
        contrib = zero_extended(g)[rev_c].sum(dim=1)
        dx = g.new_zeros(shape, dtype=dtype).index_add_(0, src_b, contrib.to(dtype))
        return dx, None, None, None


def table_gather(x: torch.Tensor, nbr: torch.Tensor, rev=None) -> torch.Tensor:
    """out[..m, k] = x[nbr[..m, k]]; its gradient w.r.t. x gathers through
    `rev` (positions into the flattened leading axes of out; the value
    nbr.numel() means no reference and contributes zero), so rows `rev`
    does not list get zero gradient.  Without `rev`, plain indexing."""
    if rev is None:
        return x[nbr]
    return _TableGather.apply(x, nbr, rev)


def table_gather_compact(x: torch.Tensor, nbr: torch.Tensor, src_b=None,
                         rev_c=None) -> torch.Tensor:
    """x[nbr] for boundary-style tables, whose backward runs over the
    compact source list: `src_b` (S,) the distinct sources (trash-padded),
    `rev_c` (S, R) their positions in the flattened nbr (pad nbr.numel()).
    Without them, plain indexing."""
    if src_b is None or rev_c is None:
        return x[nbr]
    return _TableGatherCompact.apply(x, nbr, src_b, rev_c)


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
    neg = g.new_full((), -torch.inf)  # a fill, no host copy (capture-safe)
    m = torch.where(mmask[..., None] > 0, g, neg).amax(dim=1)
    has = mmask.sum(dim=1) > 0
    return torch.where(has[:, None], m, torch.zeros((), dtype=m.dtype, device=m.device))


def gather_pool_mean(x, members, rev, mmask):
    g = table_gather(x, members, rev)
    cnt = torch.clamp(mmask.sum(dim=1), min=1.0)
    return (g * mmask[..., None]).sum(dim=1) / cnt[:, None]


def gather_unpool(x, unpool, rev):
    """x[unpool] (the JAX gather_unpool)."""
    return table_gather(x, unpool[:, None], rev)[:, 0]
