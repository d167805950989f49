"""ctypes bindings for the repo's native mesh kernel (native/meshkernel.cpp).

The port's own binding to the same C++ source the JAX package binds
(geobignn_tpu/native.py).  It builds `native/libmeshkernel.so` with
`make -C native` at first use, from the `native/` directory beside this
package; `has_native()` reports whether the library is loaded.

The native and the numpy implementations draw different seeded visit orders
in pool/hierarchy.greedy_matching, so they build different pooling
hierarchies from the same mesh.  Which one runs must therefore depend on
the machine alone, as it does for the JAX package: where `make` or the
compiler is missing, both packages take the numpy implementations.  It must
not depend on where the package was copied to: when the sources are not
beside the package (a copy of the package without `native/`), `_load`
raises instead of quietly taking the numpy path.  A run directory's code
snapshot carries the sources for that reason
(train/trainer.snapshot_code)."""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
SOURCE_FILES = ("meshkernel.cpp", "Makefile")
_SO_PATH = os.path.join(NATIVE_DIR, "libmeshkernel.so")

_lib = None
_tried = False  # one build attempt per process; a failed one is not retried


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    missing = [f for f in SOURCE_FILES if not os.path.exists(os.path.join(NATIVE_DIR, f))]
    if missing:
        raise RuntimeError(
            f"the native mesh kernel's sources {missing} are not in {NATIVE_DIR}: "
            "this copy of geobignn_tpu_torch has no native/ directory beside it, and "
            "the numpy implementations build other pooling hierarchies than the "
            "native ones")
    _tried = True
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(
                ["make", "-C", NATIVE_DIR, "-s"], check=True, capture_output=True
            )
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    lib.gbn_permutation.argtypes = [ctypes.c_int64, ctypes.c_uint64, i64p]
    lib.gbn_greedy_matching.argtypes = [
        ctypes.c_int64, i64p, i64p, f32p, i64p, i64p, ctypes.c_uint64,
    ]
    lib.gbn_grow_patch.restype = ctypes.c_int64
    lib.gbn_grow_patch.argtypes = [
        ctypes.c_int64, i32p, ctypes.c_int64, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p, u8p,
    ]
    lib.gbn_obj_counts.restype = ctypes.c_int
    lib.gbn_obj_counts.argtypes = [ctypes.c_char_p, i64p, i64p]
    lib.gbn_obj_read.restype = ctypes.c_int
    lib.gbn_obj_read.argtypes = [ctypes.c_char_p, f32p, i32p]
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def has_native() -> bool:
    """True when the native library is built (building it on first call)."""
    return _load() is not None


def permutation(n: int, seed: int) -> np.ndarray:
    lib = _load()
    out = np.empty(n, dtype=np.int64)
    lib.gbn_permutation(n, ctypes.c_uint64(seed), _ptr(out, ctypes.c_int64))
    return out


def greedy_matching_csr(
    row_ptr: np.ndarray,
    cols: np.ndarray,
    weights: np.ndarray | None,
    order: np.ndarray,
) -> np.ndarray:
    """Match pool/hierarchy semantics over CSR; returns representative ids."""
    lib = _load()
    n = row_ptr.shape[0] - 1
    out = np.empty(n, dtype=np.int64)
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    wp = None
    if weights is not None:
        weights = np.ascontiguousarray(weights, dtype=np.float32)
        wp = _ptr(weights, ctypes.c_float)
    lib.gbn_greedy_matching(
        n, _ptr(row_ptr, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
        wp, _ptr(order, ctypes.c_int64), _ptr(out, ctypes.c_int64),
        ctypes.c_uint64(0),
    )
    return out


def grow_patch(
    fv_indices: np.ndarray,
    vf_indices: np.ndarray,
    seed_face: int,
    max_faces: int | None = None,
    max_rings: int | None = None,
) -> np.ndarray:
    lib = _load()
    n_faces = fv_indices.shape[0]
    cap = n_faces if max_faces is None else min(max_faces, n_faces)
    rings = (1 << 60) if max_rings is None else max_rings
    fv = np.ascontiguousarray(fv_indices, dtype=np.int32)
    vf = np.ascontiguousarray(vf_indices, dtype=np.int32)
    out = np.empty(max(cap, 1), dtype=np.int64)
    visited = np.zeros(n_faces, dtype=np.uint8)
    count = lib.gbn_grow_patch(
        n_faces, _ptr(fv, ctypes.c_int32), vf.shape[1], _ptr(vf, ctypes.c_int32),
        seed_face, cap, rings, _ptr(out, ctypes.c_int64),
        _ptr(visited, ctypes.c_uint8),
    )
    return out[:count].copy()


def read_obj_arrays(path: str):
    """Fast .obj parse; returns (points f32 (V,3), fv_indices i32 (F,3)) or
    None when native is unavailable / the file can't be opened."""
    lib = _load()
    if lib is None:
        return None
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    if lib.gbn_obj_counts(path.encode(), ctypes.byref(nv), ctypes.byref(nt)) != 0:
        return None
    verts = np.empty((nv.value, 3), dtype=np.float32)
    tris = np.empty((nt.value, 3), dtype=np.int32)
    if lib.gbn_obj_read(path.encode(), _ptr(verts, ctypes.c_float), _ptr(tris, ctypes.c_int32)) != 0:
        return None
    return verts, tris
