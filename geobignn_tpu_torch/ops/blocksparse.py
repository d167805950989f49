"""Block-sparse FeaStConv on Hopper: host builders, kernel wrappers and plain
versions.

Counterpart of geobignn_tpu/ops/blocksparse.py.  Each row block of T rows
carries its own list of K column blocks (`blk_idx`, from the RCM order), so
a level too wide for the band — or one whose band `TableWidths.merge`
dropped because two samples disagreed on it — still runs a masked window
product instead of gathers.  It holds

  * the host builders (`block_sparse_np`, `blocks_needed`), copied
    unchanged so the masks and lists are bit-identical to the JAX package's;
  * `bs_aggregate`, one autograd Function for CUDA and CPU tensors: on CUDA
    tensors its forward and backward launch the hand-written kernels
    (csrc/blocksparse_fwd.cu, csrc/blocksparse_bwd.cu: TPU kernels #5 and
    #6, both schedules), on CPU tensors they run the plain versions —
    nothing else decides the route;
  * the plain versions: ops/banded_cuda.py's, whose math is the same, over
    the window that `blk_idx` lists instead of the three neighbouring blocks;
  * `feast_conv_blocksparse`, the conv built on the aggregate.

`blk_idx` is int32 where the host builders make it and int64 on every
torch tensor: `structs.to(device)` widens index arrays, torch gathers with
it, and the kernels read it as 64-bit.  The wrappers check that type and
raise on any other.  Launches are counted in `banded_cuda.LAUNCHES` under
`bs_aggregate_first`, `bs_transform_first` and their `_bwd` names, their
per-node products in `banded_cuda.PRODUCTS`.
"""

from __future__ import annotations

import numpy as np
import torch

from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.ops.banded import factorized_softmax, self_loop_epilogue
from geobignn_tpu_torch.ops.banded_cuda import LAUNCHES, use_transform_first
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


# --------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the kernels' yardstick on the card)
# --------------------------------------------------------------------------

class _BlockWindow:
    """The window of a block-sparse mask m (B, T, K*T): block b sees the K
    column blocks blk_idx[b, :], as `_window_ops_T` concatenates them
    (blocksparse.py:139-147 of the JAX package)."""

    def __init__(self, m, blk_idx):
        self.n_blk, self.tile, _ = m.shape
        self.blk_idx = blk_idx.to(torch.int64)

    def gather(self, t):
        """(N, C) node rows -> (B, K*T, C) per-block windows."""
        c = t.shape[-1]
        blocks = t.reshape(self.n_blk, self.tile, c)[self.blk_idx]  # (B, K, T, C)
        return blocks.reshape(self.n_blk, -1, c)

    def fold(self, slabs):
        """(B, K*T, C) per-block window cotangents -> (N, C) node rows: the
        block-granular sum over the column-block ids of `_fold_blocks_T`
        (blocksparse.py:373-384); padded list entries carry exact zeros."""
        c = slabs.shape[-1]
        out = slabs.new_zeros((self.n_blk, self.tile, c))
        out.index_add_(0, self.blk_idx.reshape(-1),
                       slabs.reshape(-1, self.tile, c))
        return out.reshape(self.n_blk * self.tile, c)


def bs_aggregate_first_plain(r, p, x, w, m, blk_idx, compute_dtype=torch.bfloat16):
    """Plain version of TPU kernel #5, aggregate-first (`_fwd_kernel`,
    blocksparse.py:164-179): the banded plain version over blk_idx's window."""
    return banded_cuda.aggregate_first_plain(
        r, p, x, w, m, compute_dtype, _BlockWindow(m, blk_idx))


def bs_transform_first_plain(r, p, x, w, m, blk_idx, compute_dtype=torch.bfloat16):
    """Plain version of TPU kernel #5, transform-first (`_fwd_kernel_tf`,
    which runs banded_pallas._fwd_body_tf on the gathered window)."""
    return banded_cuda.transform_first_plain(
        r, p, x, w, m, compute_dtype, _BlockWindow(m, blk_idx))


def bs_aggregate_first_bwd_plain(r, p, x, w, m, blk_idx, gout,
                                 compute_dtype=torch.bfloat16):
    """Plain version of TPU kernel #6, aggregate-first (`_bwd_kernel`,
    blocksparse.py:182-247) with `_bs_bwd`'s fold and W̄ sum over row
    blocks.  Returns (r̄, p̄, x̄, W̄), f32."""
    return banded_cuda.aggregate_first_bwd_plain(
        r, p, x, w, m, gout, compute_dtype, _BlockWindow(m, blk_idx))


def bs_transform_first_bwd_plain(r, p, x, w, m, blk_idx, gout,
                                 compute_dtype=torch.bfloat16):
    """Plain version of TPU kernel #6, transform-first (`_bwd_kernel_tf`,
    which runs banded_pallas._bwd_body_tf: each row block's slab is cast
    before the fold).  Returns (r̄, p̄, x̄, W̄), f32."""
    return banded_cuda.transform_first_bwd_plain(
        r, p, x, w, m, gout, compute_dtype, _BlockWindow(m, blk_idx))


def bs_aggregate_plain(r, p, x, w, m, blk_idx, compute_dtype=torch.bfloat16):
    if use_transform_first(w.shape[1], w.shape[2]):
        return bs_transform_first_plain(r, p, x, w, m, blk_idx, compute_dtype)
    return bs_aggregate_first_plain(r, p, x, w, m, blk_idx, compute_dtype)


def bs_aggregate_bwd_plain(r, p, x, w, m, blk_idx, gout, compute_dtype=torch.bfloat16):
    if use_transform_first(w.shape[1], w.shape[2]):
        return bs_transform_first_bwd_plain(r, p, x, w, m, blk_idx, gout, compute_dtype)
    return bs_aggregate_first_bwd_plain(r, p, x, w, m, blk_idx, gout, compute_dtype)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def _launch(r, p, x, w, m, blk_idx, compute_dtype, parts=None) -> torch.Tensor:
    """TPU kernel #5 on Hopper: (N, C_out) f32."""
    lib = banded_cuda._load()["bs_fwd"]
    banded_cuda._check(r, p, x, w, m, compute_dtype, blk_idx=blk_idx)
    tile = m.shape[1]
    n, c_in = x.shape
    heads = r.shape[1]
    c_out = w.shape[2]
    dev = x.device
    tf = use_transform_first(c_in, c_out)
    ldk = banded_cuda._fit(lib, "gbn_bs_", m, heads, c_out if tf else c_in)
    f32 = dict(dtype=torch.float32, device=dev)
    v = torch.empty((n, ldk), **f32)
    zr = None if tf else torch.empty((n, ldk), **f32)
    out = torch.empty((n, c_out), **f32)
    ms = banded_cuda._Parts(parts)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gbn_bs_aggregate_fwd(
            r.data_ptr(), p.data_ptr(), x.data_ptr(), w.data_ptr(), m.data_ptr(),
            blk_idx.data_ptr(), v.data_ptr(), None if tf else zr.data_ptr(),
            out.data_ptr(), n, tile, blk_idx.shape[1], heads, c_in, c_out, ldk,
            int(tf), int(compute_dtype == torch.bfloat16), stream, ms.ptr,
        )
    if rc != 0:
        raise RuntimeError(f"block-sparse aggregate kernel launch failed: CUDA error {rc}")
    LAUNCHES["bs_transform_first" if tf else "bs_aggregate_first"] += 1
    banded_cuda.count_products(tf, False, x, None, compute_dtype)
    ms.fill(banded_cuda.FWD_PARTS[tf])
    return out


def _transpose_lists(blk_idx):
    """CSR transpose of blk_idx (B, K), on its device and without a sync:
    colptr (B+1) and pairs (B*K), where pairs[colptr[c]:colptr[c+1]] hold
    b*K + position for every entry of blk_idx equal to c."""
    n_blk = blk_idx.shape[0]
    ids, pairs = torch.sort(blk_idx.reshape(-1), stable=True)
    colptr = torch.searchsorted(
        ids, torch.arange(n_blk + 1, device=blk_idx.device, dtype=torch.int64))
    return colptr.contiguous(), pairs.contiguous()


def _launch_bwd(r, p, x, w, m, blk_idx, gout, compute_dtype, parts=None):
    """TPU kernel #6 on Hopper: (r̄, p̄, x̄, W̄) in f32.  The kernel owns its
    output rows, so no window slabs are folded; W̄ is summed from the
    per-row-block partials as `_bs_bwd` sums the TPU kernel's slabs."""
    lib = banded_cuda._load()["bs_bwd"]
    banded_cuda._check(r, p, x, w, m, compute_dtype, gout, blk_idx)
    n_blk, tile, _ = m.shape
    n, c_in = x.shape
    heads = r.shape[1]
    c_out = w.shape[2]
    dev = x.device
    tf = use_transform_first(c_in, c_out)
    cv = c_out if tf else c_in
    ldk = banded_cuda._fit(lib, "gbn_bs_bwd_", m, heads, cv)
    colptr, pairs = _transpose_lists(blk_idx)
    f32 = dict(dtype=torch.float32, device=dev)
    v, g, y_or_gy, wl = torch.empty((4, n, ldk), **f32)
    wpart = torch.empty((n_blk, heads * cv, c_in if tf else c_out), **f32)
    rbar = torch.empty((n, heads), **f32)
    pbar = torch.empty((n, heads), **f32)
    xbar = torch.empty((n, c_in), **f32)
    y, gy = (y_or_gy, None) if tf else (None, y_or_gy)
    ptr = lambda t: None if t is None else t.data_ptr()
    ms = banded_cuda._Parts(parts)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gbn_bs_aggregate_bwd(
            *(ptr(t) for t in (r, p, x, w, m, blk_idx, colptr, pairs, gout, v, g,
                               y, gy, wl, wpart, rbar, pbar, xbar)),
            n, tile, blk_idx.shape[1], heads, c_in, c_out, ldk, int(tf),
            int(compute_dtype == torch.bfloat16), stream, ms.ptr,
        )
    if rc != 0:
        raise RuntimeError(f"block-sparse aggregate backward launch failed: CUDA error {rc}")
    LAUNCHES["bs_transform_first_bwd" if tf else "bs_aggregate_first_bwd"] += 1
    banded_cuda.count_products(tf, True, x, gout, compute_dtype)
    ms.fill(banded_cuda.BWD_PARTS[tf])
    wbar = wpart.sum(dim=0)
    if tf:
        dw = wbar.reshape(heads, c_out, c_in).transpose(1, 2)
    else:
        dw = wbar.reshape(heads, c_in, c_out)
    return rbar, pbar, xbar, dw


def bs_aggregate_bwd(r, p, x, w, m, blk_idx, gout, compute_dtype=torch.bfloat16):
    """(r̄, p̄, x̄, W̄) in f32: the backward kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if gout.is_cuda:
        return _launch_bwd(r, p, x, w, m, blk_idx, gout, compute_dtype)
    if gout.device.type == "cpu":
        return bs_aggregate_bwd_plain(r, p, x, w, m, blk_idx, gout, compute_dtype)
    raise RuntimeError(f"bs_aggregate_bwd: unsupported device {gout.device}")


class _BlockSparseAggregate(torch.autograd.Function):
    """The aggregate with its custom backward, on either device: the
    kernels for CUDA tensors, the plain versions for CPU tensors (never
    autograd through the plain forward's casts).  m and blk_idx get no
    gradient."""

    @staticmethod
    def forward(ctx, r, p, x, w, m, blk_idx, compute_dtype):
        ctx.save_for_backward(r, p, x, w, m, blk_idx)
        ctx.compute_dtype = compute_dtype
        acc = banded_cuda.accumulation_dtype(compute_dtype)
        r, p, x, w = (t.to(acc) for t in (r, p, x, w))
        if x.is_cuda:
            return _launch(r, p, x, w, m, blk_idx, compute_dtype)
        return bs_aggregate_plain(r, p, x, w, m, blk_idx, compute_dtype)

    @staticmethod
    def backward(ctx, gout):
        r, p, x, w, m, blk_idx = ctx.saved_tensors
        acc = banded_cuda.accumulation_dtype(ctx.compute_dtype)
        dr, dp, dx, dw = bs_aggregate_bwd(
            *(t.to(acc) for t in (r, p, x, w)), m, blk_idx, gout.to(acc).contiguous(),
            ctx.compute_dtype)
        # cotangents in the primal dtypes, as `_bs_bwd` returns them
        return (dr.to(r.dtype), dp.to(p.dtype), dx.to(x.dtype), dw.to(w.dtype),
                None, None, None)


def bs_aggregate(r, p, x, w, m, blk_idx, compute_dtype=torch.bfloat16):
    """sum_h r_h ⊙ ((M ⊙ p_h / D) @ x_win) @ W_h over block-sparse windows.

    r, p: (N, H); x: (N, C_in); w: (H, C_in, C_out); m: (B, T, K*T) int8;
    blk_idx: (B, K) int64 with entries in [0, B), as block_sparse_np lists
    them (the kernels bound every node they derive from it, the plain
    versions index with it); N must be B*T.  Returns (N, C_out) f32.  Products take compute_dtype operands with f32
    accumulation; D and the clamp are f32.  CUDA tensors launch the
    kernels, CPU tensors run the plain versions, forward and backward."""
    if not (x.is_cuda or x.device.type == "cpu"):
        raise RuntimeError(f"bs_aggregate: unsupported device {x.device}")
    if blk_idx.dtype != torch.int64:
        raise TypeError(f"blk_idx must be torch.int64, got {blk_idx.dtype}")
    return _BlockSparseAggregate.apply(r, p, x, w, m, blk_idx, compute_dtype)


def feast_conv_blocksparse(params: dict, x, m, blk_idx, deg, *,
                           compute_dtype=torch.bfloat16):
    """FeaStConv over block-sparse windows; drop-in for
    feast_conv_banded_kernel with (m, blk_idx) instead of a band.
    x: (N, C_in) with N = B*T (caller pads); deg: (N,) real in-degree."""
    p, r = factorized_softmax(x, params["u"], params["c"])
    num = bs_aggregate(r, p, x, params["w"], m, blk_idx, compute_dtype)
    return self_loop_epilogue(num, x, params, deg)
