"""Banded FeaStConv aggregate on Hopper: kernel wrappers and plain versions.

Counterpart of geobignn_tpu/ops/banded_pallas.py.  It holds

  * `banded_aggregate`, one autograd Function for CUDA and CPU tensors: on
    CUDA tensors its forward and backward launch the hand-written kernels
    (csrc/banded_fwd.cu, csrc/banded_bwd.cu), on CPU tensors they run the
    plain PyTorch versions — nothing else decides the route;
  * the plain versions of both schedules (aggregate-first and
    transform-first), forward and backward, which repeat the Pallas bodies'
    casts at the same points; with compute_dtype=torch.float32 they are
    exact float32 math, with torch.float64 (no kernel takes it) float64;
  * `feast_conv_banded_kernel` (the counterpart of
    `feast_conv_banded_pallas`), `feast_conv_hybrid_band` and
    `feast_conv_hybrid`.

Each kernel source — the banded ones, the block-sparse ones that
ops/blocksparse.py wraps, the nearest-distance one of ops/nn_cuda.py and
the timestamp of ops/clock_cuda.py — is built with nvcc for sm_90a into its own
library under build/geobignn_tpu_torch/ at first use (one nvcc per source,
started together), from the repo's sources only, and loaded through ctypes.
Each schedule counts its forward and backward launches in `LAUNCHES`, the
block-sparse ones under `bs_` names, the nearest-distance kernel under
`nearest`.  One launch of a wrapper is a short sequence of kernels (the
per-node operand or product, the walk over the set mask slots, the
products that close it: csrc/window_fwd.cuh, window_bwd.cuh); handed a dict
as `parts`, a wrapper fills it with each kernel's milliseconds (CUDA
events inside the library), under the names of `FWD_PARTS` / `BWD_PARTS`.

The plain versions take the window as a pair of functions (`_BandWindow`
here, ops/blocksparse.py's over `blk_idx`): the gather of node rows into
per-block windows and the fold of window cotangents back; the math is
written once for both.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

import torch

from geobignn_tpu_torch.ops import table as tbl
from geobignn_tpu_torch.ops.banded import self_loop_epilogue, window, factorized_softmax

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
SOURCES = {"fwd": os.path.join(_CSRC, "banded_fwd.cu"),
           "bwd": os.path.join(_CSRC, "banded_bwd.cu"),
           "bs_fwd": os.path.join(_CSRC, "blocksparse_fwd.cu"),
           "bs_bwd": os.path.join(_CSRC, "blocksparse_bwd.cu"),
           "nearest": os.path.join(_CSRC, "nearest.cu"),
           "stamp": os.path.join(_CSRC, "stamp.cu")}
HEADERS = tuple(sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "geobignn_tpu_torch")
LIBRARIES = {k: os.path.join(
    BUILD_DIR, "lib" + os.path.splitext(os.path.basename(src))[0] + ".so")
    for k, src in SOURCES.items()}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches per schedule and direction, counted where the wrappers launch
LAUNCHES = {"aggregate_first": 0, "transform_first": 0,
            "aggregate_first_bwd": 0, "transform_first_bwd": 0,
            "bs_aggregate_first": 0, "bs_transform_first": 0,
            "bs_aggregate_first_bwd": 0, "bs_transform_first_bwd": 0,
            "nearest": 0}

# the kernels of one launch sequence, in order, by schedule (False:
# aggregate-first, True: transform-first)
FWD_PARTS = {False: ("operand", "window kernel", "output product"),
             True: ("operand product", "window kernel")}
BWD_PARTS = {False: ("operand", "gy product", "row pass", "column pass",
                     "wbar product"),
             True: ("operand product", "row operand", "row pass", "column pass",
                    "xbar product", "wbar product")}
_MAX_PARTS = 8  # kMaxParts of csrc/banded_common.cuh

_libs: dict = {}
BUILD_LOG = ""  # nvcc/ptxas output of the last build (registers, smem)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _stale(key: str) -> bool:
    lib = LIBRARIES[key]
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(f) for f in (SOURCES[key], *HEADERS))
    return os.path.getmtime(lib) < newest


def build(force: bool = False) -> float:
    """Compile every kernel library older than its source or the shared
    headers, one nvcc per source, all started together.  Returns the seconds
    the builds took (0.0 when nothing was built)."""
    global BUILD_LOG
    todo = [k for k in SOURCES if force or _stale(k)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for k in todo:
        tmp = f"{LIBRARIES[k]}.{os.getpid()}.tmp"
        procs[k] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[k]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for k, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"== {SOURCES[k]}\n{out}")
        if proc.returncode != 0:
            failed.append(SOURCES[k])
        else:
            os.replace(tmp, LIBRARIES[k])
    BUILD_LOG = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
    return time.perf_counter() - t0


def _load():
    if not _libs:
        build()
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # pointers, ints, then the stream and the parts' milliseconds
        fwd = ctypes.CDLL(LIBRARIES["fwd"])
        fwd.gbn_banded_aggregate_fwd.argtypes = [vp] * 8 + [ci] * 8 + [vp] * 2
        fwd.gbn_banded_aggregate_fwd.restype = ci
        bwd = ctypes.CDLL(LIBRARIES["bwd"])
        bwd.gbn_banded_aggregate_bwd.argtypes = [vp] * 15 + [ci] * 8 + [vp] * 2
        bwd.gbn_banded_aggregate_bwd.restype = ci
        bs_fwd = ctypes.CDLL(LIBRARIES["bs_fwd"])
        bs_fwd.gbn_bs_aggregate_fwd.argtypes = [vp] * 9 + [ci] * 9 + [vp] * 2
        bs_fwd.gbn_bs_aggregate_fwd.restype = ci
        bs_bwd = ctypes.CDLL(LIBRARIES["bs_bwd"])
        bs_bwd.gbn_bs_aggregate_bwd.argtypes = [vp] * 18 + [ci] * 9 + [vp] * 2
        bs_bwd.gbn_bs_aggregate_bwd.restype = ci
        for lib, prefix in ((fwd, "gbn_banded_"), (bwd, "gbn_banded_bwd_"),
                            (bs_fwd, "gbn_bs_"), (bs_bwd, "gbn_bs_bwd_")):
            for name in _LIMITS:
                getattr(lib, prefix + name).restype = ci
        _libs.update(fwd=fwd, bwd=bwd, bs_fwd=bs_fwd, bs_bwd=bs_bwd)
    return _libs


_LIMITS = ("tile_multiple", "max_heads", "max_width")
_limits: dict = {}  # by library prefix, read once


def _fit(lib, prefix, m, heads, cv) -> int:
    """Raise unless the library's kernels take this mask, head count and
    strip width cv (C_in or C_out); returns ldk, the row stride of the
    (N, heads*cv) scratch operands: heads*cv rounded up to a multiple of 4,
    so that a lane's 16-byte loads are aligned."""
    if prefix not in _limits:
        _limits[prefix] = tuple(getattr(lib, prefix + name)() for name in _LIMITS)
    mult, max_heads, max_width = _limits[prefix]
    if m.shape[1] % mult:
        raise ValueError(f"tile {m.shape[1]} is not a multiple of {mult}")
    if heads > max_heads or heads * cv > max_width:
        raise ValueError(f"heads {heads} / width {heads} x {cv} exceed the kernels' "
                         f"{max_heads} / {max_width}")
    if m.data_ptr() % 16:
        raise ValueError("the mask must be 16-byte aligned")
    return -(-heads * cv // 4) * 4


class _Parts:
    """The optional per-kernel milliseconds of one launch sequence: a float
    buffer for the library when the caller handed in a dict, else NULL."""

    def __init__(self, parts):
        self.parts = parts
        self.buf = None if parts is None else (ctypes.c_float * _MAX_PARTS)()

    @property
    def ptr(self):
        return None if self.buf is None else ctypes.cast(self.buf, ctypes.c_void_p)

    def fill(self, names):
        if self.parts is not None:
            self.parts.update(zip(names, self.buf))


def use_transform_first(c_in: int, c_out: int) -> bool:
    """The JAX package's schedule choice (`_use_tf`): transform-first when
    the conv narrows, so the window products run at H*C_out columns."""
    return c_out < c_in


# --------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the kernel's yardstick on the card)
# --------------------------------------------------------------------------

def accumulation_dtype(compute_dtype) -> torch.dtype:
    """What products of compute_dtype operands accumulate in: float32, like
    the kernels' preferred_element_type, and float64 for a float64 compute
    dtype (the plain versions' float64 reference; no kernel takes it)."""
    return torch.float64 if compute_dtype == torch.float64 else torch.float32


def _cast(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Round to compute_dtype and come back to the accumulation dtype."""
    return t.to(compute_dtype).to(accumulation_dtype(compute_dtype))


class _BandWindow:
    """The contiguous band's window of mask m (B, T, 3T): block b sees the
    3T nodes from (b-1)T, zero rows outside [0, N)."""

    def __init__(self, m):
        self.tile = m.shape[1]

    def gather(self, t):
        """(N, C) node rows -> (B, W, C) per-block windows."""
        return window(t, self.tile)

    def fold(self, slabs):
        """(B, W, C) per-block window cotangents -> (N, C) node rows."""
        return _fold_windows(slabs, self.tile)


def _block_d(r, p, m, win):
    """Per block: r (B, T, H), the p window (B, W, H) and D = r pᵀ (B, T, W)."""
    n_blk, tile, _ = m.shape
    r_blk = r.reshape(n_blk, tile, r.shape[1])
    p_win = win.gather(p)
    return r_blk, p_win, torch.einsum("bth,bwh->btw", r_blk, p_win)


def _block_weights(r, p, m, compute_dtype, win):
    """A = cd(M / max(rᵀp, 1e-12)) per block: (B, T, W), and r per block."""
    r_blk, _, d = _block_d(r, p, m, win)
    minv = m.to(accumulation_dtype(compute_dtype)) / torch.clamp(d, min=1e-12)
    return _cast(minv, compute_dtype), r_blk


def aggregate_first_plain(r, p, x, w, m, compute_dtype=torch.bfloat16, win=None):
    """Plain version of TPU kernel #1 (`_fwd_kernel`): the casts of
    banded_pallas.py:226-238 — minv, xpwT, zrT and w in compute_dtype.
    `win` is the window of the mask (the band's by default)."""
    win = win or _BandWindow(m)
    n, c_in = x.shape
    heads, _, c_out = w.shape
    minv, r_blk = _block_weights(r, p, m, compute_dtype, win)
    xpw = _cast((p[:, :, None] * x[:, None, :]).reshape(n, heads * c_in), compute_dtype)
    z = torch.matmul(minv, win.gather(xpw))  # (B, T, H*C_in)
    zr = _cast(z * r_blk.repeat_interleave(c_in, dim=2), compute_dtype)
    out = zr @ _cast(w.reshape(heads * c_in, c_out), compute_dtype)
    return out.reshape(n, c_out)


def transform_first_plain(r, p, x, w, m, compute_dtype=torch.bfloat16, win=None):
    """Plain version of TPU kernel #2 (`_fwd_body_tf`): the casts of
    banded_pallas.py:120-138 — minv, w2, x, ypwT and zrT in compute_dtype,
    then the head sum."""
    win = win or _BandWindow(m)
    n, c_in = x.shape
    heads, _, c_out = w.shape
    minv, r_blk = _block_weights(r, p, m, compute_dtype, win)
    w2 = _cast(w.permute(1, 0, 2).reshape(c_in, heads * c_out), compute_dtype)
    y = _cast(x, compute_dtype) @ w2  # (N, H*C_out), column h*C_out + o
    ypw = _cast(y * p.repeat_interleave(c_out, dim=1), compute_dtype)
    z = torch.matmul(minv, win.gather(ypw))  # (B, T, H*C_out)
    zr = _cast(z * r_blk.repeat_interleave(c_out, dim=2), compute_dtype)
    return zr.reshape(n, heads, c_out).sum(dim=1)


def banded_aggregate_plain(r, p, x, w, m, compute_dtype=torch.bfloat16, win=None):
    c_in, c_out = w.shape[1], w.shape[2]
    if use_transform_first(c_in, c_out):
        return transform_first_plain(r, p, x, w, m, compute_dtype, win)
    return aggregate_first_plain(r, p, x, w, m, compute_dtype, win)


def _bwd_weights(r, p, m, compute_dtype, win):
    """Per block: r (B, T, H), the p window (B, W, H), cd(M/D) and the clamp
    subgradient mdd = where(D > 1e-12, -(M/D)/D, 0), both (B, T, W)."""
    r_blk, p_win, d = _block_d(r, p, m, win)
    dinv = 1.0 / torch.clamp(d, min=1e-12)
    minv = m.to(accumulation_dtype(compute_dtype)) * dinv
    mdd = torch.where(d > 1e-12, -minv * dinv, torch.zeros_like(d))
    return r_blk, p_win, _cast(minv, compute_dtype), mdd


def _denominator_path(mdd, rows, cols):
    """dbar = mdd * (rows colsᵀ) per block, on the slots where mdd is set
    and zero elsewhere.  `rows` carries each row's r and `cols` each window
    column's p; their product is of the order of the pair's D, which is
    moderate for neighbours but, under the middle shift of
    ops/banded.factorized_softmax, can pass float32's range for two far
    apart nodes of one window (a whole mesh's boundary sub-band gathers
    rows from across it): there the dense product is inf or NaN, which
    mdd's zero would not cancel."""
    return torch.where(mdd != 0, mdd * (rows @ cols.transpose(1, 2)), mdd)


def _fold_windows(slabs: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, 3T, C) per-block window cotangents -> (N, C) node rows by the
    overlap-add of `_fold_windows_T` (banded_pallas.py:494-504)."""
    n_blk, _, c = slabs.shape
    parts = slabs.reshape(n_blk, 3, tile, c)
    z = slabs.new_zeros((1, tile, c))
    prev = torch.cat([parts[1:, 0], z])  # block b+1's "previous" third
    nxt = torch.cat([z, parts[:-1, 2]])  # block b-1's "next" third
    return (prev + parts[:, 1] + nxt).reshape(n_blk * tile, c)


def _head_sum(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., H*S) -> (..., H): the sum of each head's strip."""
    return t.reshape(*t.shape[:-1], heads, -1).sum(dim=-1)


def aggregate_first_bwd_plain(r, p, x, w, m, gout, compute_dtype=torch.bfloat16,
                              win=None):
    """Plain version of TPU kernel #3 (`_bwd_kernel`, banded_pallas.py:
    241-321): minv, xpw, gout, w, zr, gz and ybar in compute_dtype; a, K,
    dbar and the r̄/p̄ denominator parts in f32.  Returns (r̄, p̄, x̄, W̄), f32."""
    win = win or _BandWindow(m)
    n_blk, tile, _ = m.shape
    n, c_in = x.shape
    heads, _, c_out = w.shape
    r_blk, p_win, minv_c, mdd = _bwd_weights(r, p, m, compute_dtype, win)
    x_win = win.gather(x)
    xpw = _cast((p_win[..., :, None] * x_win[..., None, :]).flatten(2), compute_dtype)
    rw = r_blk.repeat_interleave(c_in, dim=2)  # (B, T, H*C_in)
    gt_c = _cast(gout.reshape(n_blk, tile, c_out), compute_dtype)
    w_flat = _cast(w.reshape(heads * c_in, c_out), compute_dtype)

    z = minv_c @ xpw  # (B, T, H*C_in), the forward recompute
    gy = gt_c @ w_flat.T  # cotangent at zr
    zr = _cast(z * rw, compute_dtype)
    wbar = zr.transpose(1, 2) @ gt_c  # per-block W̄ slabs
    rbar_direct = _head_sum(_cast(gy * z, compute_dtype), heads)
    ybar = _cast(gy * rw, compute_dtype)
    a = minv_c.transpose(1, 2) @ ybar  # (B, W, H*C_in)
    a4 = a.reshape(n_blk, -1, heads, c_in)
    xbar_win = (p_win[..., None] * a4).sum(dim=2)
    pbar_direct = (a4 * x_win[:, :, None, :]).sum(dim=3)
    dbar = _denominator_path(mdd, ybar, xpw)
    rbar = rbar_direct + dbar @ p_win
    pbar_win = pbar_direct + dbar.transpose(1, 2) @ r_blk
    return (rbar.reshape(n, heads), win.fold(pbar_win), win.fold(xbar_win),
            wbar.sum(dim=0).reshape(heads, c_in, c_out))


def transform_first_bwd_plain(r, p, x, w, m, gout, compute_dtype=torch.bfloat16,
                              win=None):
    """Plain version of TPU kernel #4 (`_bwd_body_tf`, banded_pallas.py:
    159-217): minv, x, w2, ypw, gz*z, zbar, y*ybarpw and ybar in
    compute_dtype (gout itself is not cast); K, dbar and the r̄/p̄
    denominator parts in f32.  Returns (r̄, p̄, x̄, W̄), f32."""
    win = win or _BandWindow(m)
    n_blk, tile, _ = m.shape
    n, c_in = x.shape
    heads, _, c_out = w.shape
    r_blk, p_win, minv_c, mdd = _bwd_weights(r, p, m, compute_dtype, win)
    xw_c = _cast(win.gather(x), compute_dtype)
    w2 = _cast(w.permute(0, 2, 1).reshape(heads * c_out, c_in), compute_dtype)
    pw = p_win.repeat_interleave(c_out, dim=2)  # (B, W, H*C_out)
    rw = r_blk.repeat_interleave(c_out, dim=2)  # (B, T, H*C_out)
    gz = gout.to(minv_c.dtype).reshape(n_blk, tile, c_out).repeat(1, 1, heads)

    y = xw_c @ w2.T  # (B, W, H*C_out), the forward recompute
    ypw = _cast(pw * y, compute_dtype)
    z = minv_c @ ypw
    rbar_direct = _head_sum(_cast(gz * z, compute_dtype), heads)
    zbar = _cast(gz * rw, compute_dtype)
    ybarpw = minv_c.transpose(1, 2) @ zbar  # (B, W, H*C_out)
    dbar = _denominator_path(mdd, zbar, ypw)
    rbar = rbar_direct + dbar @ p_win
    pbar_win = (_head_sum(_cast(y * ybarpw, compute_dtype), heads)
                + dbar.transpose(1, 2) @ r_blk)
    ybar = _cast(pw * ybarpw, compute_dtype)
    xbar_win = ybar @ w2  # (B, W, C_in)
    wbar = ybar.transpose(1, 2) @ xw_c  # per-block W̄2 slabs (H*C_out, C_in)
    dw = wbar.sum(dim=0).reshape(heads, c_out, c_in).transpose(1, 2)
    return rbar.reshape(n, heads), win.fold(pbar_win), win.fold(xbar_win), dw


def banded_aggregate_bwd_plain(r, p, x, w, m, gout, compute_dtype=torch.bfloat16,
                               win=None):
    c_in, c_out = w.shape[1], w.shape[2]
    if use_transform_first(c_in, c_out):
        return transform_first_bwd_plain(r, p, x, w, m, gout, compute_dtype, win)
    return aggregate_first_bwd_plain(r, p, x, w, m, gout, compute_dtype, win)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def _check(r, p, x, w, m, compute_dtype, gout=None, blk_idx=None):
    """What a kernel is never launched without: devices, dtypes, contiguity
    and shapes.  With blk_idx the mask is block-sparse, (B, T, K*T) beside a
    (B, K) int64 list; without, the band's (B, T, 3T)."""
    n_blk, tile, win = m.shape
    n, c_in = x.shape
    heads = r.shape[1]
    dev = x.device
    named = [("r", r, torch.float32), ("p", p, torch.float32),
             ("x", x, torch.float32), ("w", w, torch.float32), ("m", m, torch.int8)]
    if gout is not None:
        named.append(("gout", gout, torch.float32))
    if blk_idx is not None:
        named.append(("blk_idx", blk_idx, torch.int64))
    for name, t, dt in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"compute_dtype must be bfloat16 or float32, got {compute_dtype}")
    if (blk_idx is None and win != 3 * tile) or n != n_blk * tile:
        raise ValueError(f"mask {tuple(m.shape)} does not band x {tuple(x.shape)}")
    if blk_idx is not None and (win % tile or blk_idx.shape != (n_blk, win // tile)):
        raise ValueError(f"blk_idx {tuple(blk_idx.shape)} does not list the "
                         f"column blocks of mask {tuple(m.shape)}")
    if r.shape != (n, heads) or p.shape != (n, heads) or w.shape[:2] != (heads, c_in):
        raise ValueError(f"shapes r {tuple(r.shape)} p {tuple(p.shape)} "
                         f"w {tuple(w.shape)} x {tuple(x.shape)} disagree")
    if gout is not None and gout.shape != (n, w.shape[2]):
        raise ValueError(f"gout {tuple(gout.shape)} is not ({n}, {w.shape[2]})")


def _launch(r, p, x, w, m, compute_dtype, parts=None) -> torch.Tensor:
    """TPU kernels #1/#2 on Hopper: (N, C_out) f32."""
    lib = _load()["fwd"]
    _check(r, p, x, w, m, compute_dtype)
    tile = m.shape[1]
    n, c_in = x.shape
    heads = r.shape[1]
    c_out = w.shape[2]
    dev = x.device
    tf = use_transform_first(c_in, c_out)
    ldk = _fit(lib, "gbn_banded_", m, heads, c_out if tf else c_in)
    f32 = dict(dtype=torch.float32, device=dev)
    v = torch.empty((n, ldk), **f32)
    zr = None if tf else torch.empty((n, ldk), **f32)
    out = torch.empty((n, c_out), **f32)
    ms = _Parts(parts)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gbn_banded_aggregate_fwd(
            r.data_ptr(), p.data_ptr(), x.data_ptr(), w.data_ptr(), m.data_ptr(),
            v.data_ptr(), None if tf else zr.data_ptr(), out.data_ptr(), n, tile,
            heads, c_in, c_out, ldk, int(tf), int(compute_dtype == torch.bfloat16),
            stream, ms.ptr,
        )
    if rc != 0:
        raise RuntimeError(f"banded aggregate kernel launch failed: CUDA error {rc}")
    LAUNCHES["transform_first" if tf else "aggregate_first"] += 1
    ms.fill(FWD_PARTS[tf])
    return out


def _launch_bwd(r, p, x, w, m, gout, compute_dtype, parts=None):
    """TPU kernels #3/#4 on Hopper: (r̄, p̄, x̄, W̄) in f32."""
    lib = _load()["bwd"]
    _check(r, p, x, w, m, compute_dtype, gout)
    n_blk, tile, _ = m.shape
    n, c_in = x.shape
    heads = r.shape[1]
    c_out = w.shape[2]
    dev = x.device
    tf = use_transform_first(c_in, c_out)
    cv = c_out if tf else c_in
    ldk = _fit(lib, "gbn_banded_bwd_", m, heads, cv)
    f32 = dict(dtype=torch.float32, device=dev)
    v, g, y_or_gy, wl = torch.empty((4, n, ldk), **f32)
    wpart = torch.empty((n_blk, heads * cv, c_in if tf else c_out), **f32)
    rbar = torch.empty((n, heads), **f32)
    pbar = torch.empty((n, heads), **f32)
    xbar = torch.empty((n, c_in), **f32)
    y, gy = (y_or_gy, None) if tf else (None, y_or_gy)
    ptr = lambda t: None if t is None else t.data_ptr()
    ms = _Parts(parts)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gbn_banded_aggregate_bwd(
            *(ptr(t) for t in (r, p, x, w, m, gout, v, g, y, gy, wl, wpart,
                               rbar, pbar, xbar)),
            n, tile, heads, c_in, c_out, ldk, int(tf),
            int(compute_dtype == torch.bfloat16), stream, ms.ptr,
        )
    if rc != 0:
        raise RuntimeError(f"banded aggregate backward launch failed: CUDA error {rc}")
    LAUNCHES["transform_first_bwd" if tf else "aggregate_first_bwd"] += 1
    ms.fill(BWD_PARTS[tf])
    wbar = wpart.sum(dim=0)
    if tf:
        dw = wbar.reshape(heads, c_out, c_in).transpose(1, 2)
    else:
        dw = wbar.reshape(heads, c_in, c_out)
    return rbar, pbar, xbar, dw


def banded_aggregate_bwd(r, p, x, w, m, gout, compute_dtype=torch.bfloat16):
    """(r̄, p̄, x̄, W̄) in f32: the backward kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if gout.is_cuda:
        return _launch_bwd(r, p, x, w, m, gout, compute_dtype)
    if gout.device.type == "cpu":
        return banded_aggregate_bwd_plain(r, p, x, w, m, gout, compute_dtype)
    raise RuntimeError(f"banded_aggregate_bwd: unsupported device {gout.device}")


class _BandedAggregate(torch.autograd.Function):
    """The aggregate with its custom backward, on either device: the
    kernels for CUDA tensors, the plain versions for CPU tensors (never
    autograd through the plain forward's casts, whose backward would round
    the incoming gradients instead)."""

    @staticmethod
    def forward(ctx, r, p, x, w, m, compute_dtype):
        ctx.save_for_backward(r, p, x, w, m)
        ctx.compute_dtype = compute_dtype
        acc = accumulation_dtype(compute_dtype)
        r, p, x, w = (t.to(acc) for t in (r, p, x, w))
        if x.is_cuda:
            return _launch(r, p, x, w, m, compute_dtype)
        return banded_aggregate_plain(r, p, x, w, m, compute_dtype)

    @staticmethod
    def backward(ctx, gout):
        r, p, x, w, m = ctx.saved_tensors
        acc = accumulation_dtype(ctx.compute_dtype)
        dr, dp, dx, dw = banded_aggregate_bwd(
            *(t.to(acc) for t in (r, p, x, w)), m, gout.to(acc).contiguous(),
            ctx.compute_dtype)
        # cotangents in the primal dtypes (the JAX fix 7e51064)
        return dr.to(r.dtype), dp.to(p.dtype), dx.to(x.dtype), dw.to(w.dtype), None, None


def banded_aggregate(r, p, x, w, m, compute_dtype=torch.bfloat16):
    """sum_h r_h ⊙ ((M ⊙ p_h / D) @ x_win) @ W_h over the band mask.

    r, p: (N, H); x: (N, C_in); w: (H, C_in, C_out); m: (B, T, 3T) int8.
    Returns (N, C_out) f32.  Products take compute_dtype operands with f32
    accumulation; D and the clamp are f32.  CUDA tensors launch the
    kernels, CPU tensors run the plain versions, forward and backward."""
    if not (x.is_cuda or x.device.type == "cpu"):
        raise RuntimeError(f"banded_aggregate: unsupported device {x.device}")
    return _BandedAggregate.apply(r, p, x, w, m, compute_dtype)


# --------------------------------------------------------------------------
# convs built on the aggregate
# --------------------------------------------------------------------------

def feast_conv_banded_kernel(params: dict, x, m, deg, *, compute_dtype=torch.bfloat16):
    """Counterpart of feast_conv_banded_pallas: the factorized softmax, the
    banded aggregate, the implicit self-loop, mean and bias."""
    p, r = factorized_softmax(x, params["u"], params["c"])
    num = banded_aggregate(r, p, x, params["w"], m, compute_dtype)
    return self_loop_epilogue(num, x, params, deg)


class _GatherUnique(torch.autograd.Function):
    """(N, C) -> (S, C) row gather x[jnodes] whose backward is a gather too:
    jnodes hits each real row at most once and jpos is its inverse
    (sentinel S elsewhere), so the scatter-add transpose is pad(g)[jpos].
    The trash slots jnodes repeats get no gradient: their rows never reach
    the output (empty sub-band mask rows)."""

    @staticmethod
    def forward(ctx, x, jnodes, jpos):
        ctx.save_for_backward(jpos)
        return x[jnodes]

    @staticmethod
    def backward(ctx, g):
        (jpos,) = ctx.saved_tensors
        return tbl.zero_extended(g)[jpos], None, None


class _ScatterAddUnique(torch.autograd.Function):
    """num.at[jnodes].add(corr) as a gather, num + pad(corr)[jpos] (the
    contract of _GatherUnique); backward (ḡ, ḡ[jnodes])."""

    @staticmethod
    def forward(ctx, num, corr, jnodes, jpos):
        ctx.save_for_backward(jnodes)
        return num + tbl.zero_extended(corr)[jpos]

    @staticmethod
    def backward(ctx, g):
        (jnodes,) = ctx.saved_tensors
        return g, g[jnodes], None, None


def _gather_unique(x, jnodes, jpos):
    return _GatherUnique.apply(x, jnodes, jpos)


def _scatter_add_unique(num, corr, jnodes, jpos):
    return _ScatterAddUnique.apply(num, corr, jnodes, jpos)


def feast_conv_hybrid_band(params: dict, x, m, jnodes, jband, jpos, deg, *,
                           compute_dtype=torch.bfloat16):
    """Band + banded-sub-graph hybrid FeaStConv: in-window edges run the
    banded aggregate; the out-of-window boundary runs the same aggregate
    over the gathered boundary nodes at the sub-band's small tile.  The
    per-edge head softmax is exact under any edge split, so the two partial
    aggregates add; `deg` counts both edge sets.  p/r of the sub-problem are
    recomputed from the gathered x (the factorized softmax is invariant to
    the per-node max shift)."""
    p, r = factorized_softmax(x, params["u"], params["c"])
    num = banded_aggregate(r, p, x, params["w"], m, compute_dtype)

    x_s = _gather_unique(x, jnodes, jpos)
    p_s, r_s = factorized_softmax(x_s, params["u"], params["c"])
    corr = banded_aggregate(r_s, p_s, x_s, params["w"], jband, compute_dtype)
    num = _scatter_add_unique(num, corr, jnodes, jpos)
    return self_loop_epilogue(num, x, params, deg)


def feast_conv_hybrid(params: dict, x, m, rows_b, nbr_b, kmask_b, src_b, rev_b, deg, *,
                      compute_dtype=torch.bfloat16):
    """Band + boundary-table hybrid FeaStConv (the fallback when the boundary
    sub-graph's own bandwidth is too large for a sub-band): in-window edges
    run the banded aggregate; the out-of-window boundary runs a compact
    per-edge softmax correction over `rows_b` only, in the input's dtype.
    Trash-padded rows_b carry kmask 0, so their duplicate adds are zero."""
    p, r = factorized_softmax(x, params["u"], params["c"])
    num = banded_aggregate(r, p, x, params["w"], m, compute_dtype)

    x_i = x[rows_b]  # (M_b, C)
    xnb = tbl.table_gather_compact(x, nbr_b, src_b, rev_b)  # (M_b, K_b, C)
    s = torch.einsum("mkc,ch->mkh", xnb - x_i[:, None, :], params["u"].to(x.dtype)) \
        + params["c"]
    q = torch.softmax(s, dim=-1) * kmask_b[..., None]
    z = torch.einsum("mkh,mkc->mhc", q, xnb)
    corr = torch.einsum("mhc,hco->mo", z, params["w"])
    num = num.index_add(0, rows_b, corr.to(num.dtype))
    return self_loop_epilogue(num, x, params, deg)
