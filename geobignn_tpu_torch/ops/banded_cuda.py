"""Banded FeaStConv aggregate on Hopper: kernel wrapper and plain versions.

Counterpart of geobignn_tpu/ops/banded_pallas.py (forward only).  It holds

  * `banded_aggregate`, which launches the hand-written CUDA kernel
    (csrc/banded_fwd.cu) for CUDA tensors and runs the plain PyTorch version
    for CPU tensors — nothing else decides the route;
  * the plain versions of both schedules (aggregate-first and
    transform-first), which repeat the Pallas bodies' casts at the same
    points; with compute_dtype=torch.float32 they are exact float32 math;
  * `feast_conv_banded_kernel` (the counterpart of
    `feast_conv_banded_pallas`) and `feast_conv_hybrid_band`.

The kernel is built with nvcc for sm_90a into build/geobignn_tpu_torch/ at
first use, from the repo's sources only, and loaded through ctypes.  Each
schedule counts its launches in `LAUNCHES`.  The backward (TPU kernels #3
and #4) belongs to the training slice: the autograd Function raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

from geobignn_tpu_torch.ops.banded import self_loop_epilogue, window, factorized_softmax

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "banded_fwd.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "geobignn_tpu_torch")
LIBRARY = os.path.join(BUILD_DIR, "libbanded_fwd.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches per schedule, counted where the wrapper launches
LAUNCHES = {"aggregate_first": 0, "transform_first": 0}

_lib = None
BUILD_LOG = ""  # nvcc/ptxas output of the last build (registers, smem)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the banded CUDA kernel cannot be built")
    return found


def build(force: bool = False) -> float:
    """Compile csrc/banded_fwd.cu unless an up-to-date library exists.
    Returns the seconds nvcc took (0.0 when nothing was built)."""
    global BUILD_LOG
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                         capture_output=True, text=True)
    BUILD_LOG = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{BUILD_LOG}")
    os.replace(tmp, LIBRARY)
    return time.perf_counter() - t0


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIBRARY)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gbn_banded_aggregate_fwd.argtypes = [vp] * 7 + [ci] * 7 + [vp]
        lib.gbn_banded_aggregate_fwd.restype = ci
        for name in ("gbn_banded_rows_per_cta", "gbn_banded_max_heads",
                     "gbn_banded_max_out"):
            getattr(lib, name).restype = ci
        _lib = lib
    return _lib


def use_transform_first(c_in: int, c_out: int) -> bool:
    """The JAX package's schedule choice (`_use_tf`): transform-first when
    the conv narrows, so the window products run at H*C_out columns."""
    return c_out < c_in


# --------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the kernel's yardstick on the card)
# --------------------------------------------------------------------------

def _cast(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Round to compute_dtype and come back to f32: products of the rounded
    values accumulate in f32, like the kernels' preferred_element_type."""
    return t.to(compute_dtype).to(torch.float32)


def _block_weights(r, p, m, compute_dtype):
    """A = cd(M / max(rᵀp, 1e-12)) per block: (B, T, 3T), and r per block."""
    n_blk, tile, _ = m.shape
    heads = r.shape[1]
    r_blk = r.reshape(n_blk, tile, heads)
    d = torch.einsum("bth,bwh->btw", r_blk, window(p, tile))
    return _cast(m.to(torch.float32) / torch.clamp(d, min=1e-12), compute_dtype), r_blk


def aggregate_first_plain(r, p, x, w, m, compute_dtype=torch.bfloat16):
    """Plain version of TPU kernel #1 (`_fwd_kernel`): the casts of
    banded_pallas.py:226-238 — minv, xpwT, zrT and w in compute_dtype."""
    n_blk, tile, _ = m.shape
    n, c_in = x.shape
    heads, _, c_out = w.shape
    minv, r_blk = _block_weights(r, p, m, compute_dtype)
    xpw = _cast((p[:, :, None] * x[:, None, :]).reshape(n, heads * c_in), compute_dtype)
    z = torch.matmul(minv, window(xpw, tile))  # (B, T, H*C_in)
    zr = _cast(z * r_blk.repeat_interleave(c_in, dim=2), compute_dtype)
    out = zr @ _cast(w.reshape(heads * c_in, c_out), compute_dtype)
    return out.reshape(n, c_out)


def transform_first_plain(r, p, x, w, m, compute_dtype=torch.bfloat16):
    """Plain version of TPU kernel #2 (`_fwd_body_tf`): the casts of
    banded_pallas.py:120-138 — minv, w2, x, ypwT and zrT in compute_dtype,
    then the head sum."""
    n_blk, tile, _ = m.shape
    n, c_in = x.shape
    heads, _, c_out = w.shape
    minv, r_blk = _block_weights(r, p, m, compute_dtype)
    w2 = _cast(w.permute(1, 0, 2).reshape(c_in, heads * c_out), compute_dtype)
    y = _cast(x, compute_dtype) @ w2  # (N, H*C_out), column h*C_out + o
    ypw = _cast(y * p.repeat_interleave(c_out, dim=1), compute_dtype)
    z = torch.matmul(minv, window(ypw, tile))  # (B, T, H*C_out)
    zr = _cast(z * r_blk.repeat_interleave(c_out, dim=2), compute_dtype)
    return zr.reshape(n, heads, c_out).sum(dim=1)


def banded_aggregate_plain(r, p, x, w, m, compute_dtype=torch.bfloat16):
    c_in, c_out = w.shape[1], w.shape[2]
    if use_transform_first(c_in, c_out):
        return transform_first_plain(r, p, x, w, m, compute_dtype)
    return aggregate_first_plain(r, p, x, w, m, compute_dtype)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

def _launch(r, p, x, w, m, compute_dtype) -> torch.Tensor:
    lib = _load()
    n_blk, tile, win = m.shape
    n, c_in = x.shape
    heads = r.shape[1]
    c_out = w.shape[2]
    dev = x.device
    for name, t, dt in (("r", r, torch.float32), ("p", p, torch.float32),
                        ("x", x, torch.float32), ("w", w, torch.float32),
                        ("m", m, torch.int8)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"compute_dtype must be bfloat16 or float32, got {compute_dtype}")
    if win != 3 * tile or n != n_blk * tile:
        raise ValueError(f"mask {tuple(m.shape)} does not band x {tuple(x.shape)}")
    if r.shape != (n, heads) or p.shape != (n, heads) or w.shape[:2] != (heads, c_in):
        raise ValueError(f"shapes r {tuple(r.shape)} p {tuple(p.shape)} "
                         f"w {tuple(w.shape)} x {tuple(x.shape)} disagree")
    if tile % lib.gbn_banded_rows_per_cta():
        raise ValueError(f"tile {tile} is not a multiple of "
                         f"{lib.gbn_banded_rows_per_cta()}")
    if heads > lib.gbn_banded_max_heads() or c_out > lib.gbn_banded_max_out():
        raise ValueError(f"heads {heads} / c_out {c_out} exceed the kernel's "
                         f"{lib.gbn_banded_max_heads()} / {lib.gbn_banded_max_out()}")
    tf = use_transform_first(c_in, c_out)
    v = torch.empty((n, heads * (c_out if tf else c_in)), dtype=torch.float32, device=dev)
    out = torch.empty((n, c_out), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gbn_banded_aggregate_fwd(
            r.data_ptr(), p.data_ptr(), x.data_ptr(), w.data_ptr(), m.data_ptr(),
            v.data_ptr(), out.data_ptr(), n, tile, heads, c_in, c_out,
            int(tf), int(compute_dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"banded aggregate kernel launch failed: CUDA error {rc}")
    LAUNCHES["transform_first" if tf else "aggregate_first"] += 1
    return out


class _BandedAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, p, x, w, m, compute_dtype):
        return _launch(r, p, x, w, m, compute_dtype)

    @staticmethod
    def backward(ctx, gout):
        raise NotImplementedError(
            "banded aggregate backward (TPU kernels #3/#4, banded_pallas."
            "_bwd_kernel/_bwd_kernel_tf) is not ported yet: ROADMAP, TPU "
            "kernels to port, kernels #3/#4"
        )


def banded_aggregate(r, p, x, w, m, compute_dtype=torch.bfloat16):
    """sum_h r_h ⊙ ((M ⊙ p_h / D) @ x_win) @ W_h over the band mask.

    r, p: (N, H); x: (N, C_in); w: (H, C_in, C_out); m: (B, T, 3T) int8.
    Returns (N, C_out) f32.  Products take compute_dtype operands with f32
    accumulation; D and the clamp are f32.  CUDA tensors launch the kernel,
    CPU tensors run the plain version."""
    if x.is_cuda:
        return _BandedAggregate.apply(r, p, x, w, m, compute_dtype)
    if x.device.type == "cpu":
        return banded_aggregate_plain(r, p, x, w, m, compute_dtype)
    raise RuntimeError(f"banded_aggregate: unsupported device {x.device}")


# --------------------------------------------------------------------------
# convs built on the aggregate
# --------------------------------------------------------------------------

def feast_conv_banded_kernel(params: dict, x, m, deg, *, compute_dtype=torch.bfloat16):
    """Counterpart of feast_conv_banded_pallas: the factorized softmax, the
    banded aggregate, the implicit self-loop, mean and bias."""
    p, r = factorized_softmax(x, params["u"], params["c"])
    num = banded_aggregate(r, p, x, params["w"], m, compute_dtype)
    return self_loop_epilogue(num, x, params, deg)


def _gather_unique(x, jnodes):
    """(N, C) -> (S, C) row gather through the boundary node list."""
    return x[jnodes]


def _scatter_add_unique(num, corr, jpos):
    """num.at[jnodes].add(corr) as a gather: pad corr with one zero row, then
    gather back through jpos (the inverse of jnodes, sentinel S elsewhere)."""
    return num + torch.cat([corr, corr.new_zeros((1, corr.shape[1]))])[jpos]


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

    x_s = _gather_unique(x, jnodes)
    p_s, r_s = factorized_softmax(x_s, params["u"], params["c"])
    corr = banded_aggregate(r_s, p_s, x_s, params["w"], jband, compute_dtype)
    num = _scatter_add_unique(num, corr, jpos)
    return self_loop_epilogue(num, x, params, deg)
