"""ctypes bindings for the repo's native mesh kernel (native/meshkernel.cpp).

The port's own binding to the same C++ source the JAX package binds
(geobignn_tpu/native.py).  At first use it builds its own copy of the
library, with the rule and flags of `native/Makefile`, into
`build/native/libmeshkernel-<hash>.so` beside the package (the hash is of
the two sources), and never loads the JAX package's `native/libmeshkernel.so`;
`has_native()` reports whether the library is loaded.

Several processes may import the package at once (pytest workers, a
trainer beside a server), so the build runs under an exclusive `fcntl`
lock on `build/native/.lock`, into a temporary directory, and reaches its
final path by `os.replace`, beside the digest of the finished file: a
process never loads a file another one is still writing, and a file at the
final path whose digest differs (one written there by other means, or cut
short) is rebuilt under the same lock.

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
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
SOURCE_FILES = ("meshkernel.cpp", "Makefile")
BUILD_DIR = os.path.join(os.path.dirname(NATIVE_DIR), "build", "native")

_lib = None
_tried = False  # one build attempt per process; a failed one is not retried


def library_path() -> str:
    """Where this package builds and loads its library: keyed on a hash of
    the sources, so that an edited source never loads a stale build."""
    digest = hashlib.sha256()
    for name in SOURCE_FILES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"libmeshkernel-{digest.hexdigest()[:16]}.so")


def _digest(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _build_and_open(path: str):
    """The library at `path`, built there first unless the file there is
    the one a build recorded (its digest in `path + ".sha256"`, which a
    truncated or half-written file fails); under the exclusive lock, so one
    process builds and the others wait for the finished file.  None when
    the build fails."""
    stamp = path + ".sha256"
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        whole = (os.path.exists(path) and os.path.exists(stamp)
                 and open(stamp).read() == _digest(path))
        if not whole:
            tmp = tempfile.mkdtemp(dir=BUILD_DIR)
            try:
                # the Makefile's own rule and flags, on a copy of the sources
                for name in SOURCE_FILES:
                    shutil.copy2(os.path.join(NATIVE_DIR, name), tmp)
                subprocess.run(["make", "-s", "-C", tmp, "libmeshkernel.so"],
                               check=True, capture_output=True)
                built = os.path.join(tmp, "libmeshkernel.so")
                with open(os.path.join(tmp, "stamp"), "w") as fh:
                    fh.write(_digest(built))
                os.replace(built, path)
                os.replace(os.path.join(tmp, "stamp"), stamp)
            except (OSError, subprocess.CalledProcessError):
                return None
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        try:
            return ctypes.CDLL(path)
        except OSError:
            return None


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
    lib = _build_and_open(library_path())
    if lib is None:
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
    """True when the native library is loaded (building it on first call)."""
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
