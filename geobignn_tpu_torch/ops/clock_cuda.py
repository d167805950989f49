"""Device timestamps inside a CUDA graph: the kernel wrapper.

`stamp(table, index, col)` launches csrc/stamp.cu on the current stream:
one thread writes the device's global nanosecond timer into column `col`
of row `index mod rows` of the int64 `table`, and the last column's stamp
moves the int32 `index` on.  Captured into a graph, the stamps are nodes
that every replay runs, so each replay fills a row of its own (a CUDA
event in a graph keeps only the last replay's time).  The library is
built with the other kernel sources by `banded_cuda.build()` at first use
and loaded by its full path; a failure to build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from geobignn_tpu_torch.ops import banded_cuda

_lib = None


def _load():
    global _lib
    if _lib is None:
        banded_cuda.build()
        lib = ctypes.CDLL(banded_cuda.LIBRARIES["stamp"])
        lib.gbn_stamp.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.gbn_stamp.restype = ctypes.c_int
        _lib = lib
    return _lib


def stamp(table: torch.Tensor, index: torch.Tensor, col: int) -> None:
    """Stamp column `col` of the row `index` points at (see the module)."""
    if (table.dtype != torch.int64 or table.dim() != 2 or not table.is_contiguous()
            or index.dtype != torch.int32 or index.numel() != 1
            or table.device != index.device or table.device.type != "cuda"):
        raise ValueError("stamp needs a contiguous (rows, cols) int64 table and a one-element "
                         "int32 index on one CUDA device")
    rows, cols = table.shape
    err = _load().gbn_stamp(table.data_ptr(), index.data_ptr(), rows, cols, col,
                            torch.cuda.current_stream(table.device).cuda_stream)
    if err:
        raise RuntimeError(f"gbn_stamp failed with CUDA error {err}")
