"""Checkpoints: params + optimizer state + schedule scalars in one file.

Counterpart of geobignn_tpu/train/checkpoint.py, with the same framing, so
a file written by either package is read by the other:

    b"GBNCKPT1", then three blobs, each behind a little-endian uint64 length:
      1. params    — what flax.serialization.to_bytes writes for the JAX
                     parameter tree: msgpack of nested str-keyed maps whose
                     leaves are ext type 1 = msgpack of
                     (shape, dtype.name, C-order bytes);
      2. optimizer — empty, or a msgpack tree (below);
      3. scalars   — JSON (epoch, best_error, plateau, ...).

Writes are atomic (tmp + os.replace), so a run killed while it saves keeps
its last resume point.  The params go to disk in the JAX tree layout
(`params.to_jax_params`, keys sorted as jax.tree.map leaves them), so the
params blob of the same weights is the same bytes from both packages.

The optimizer blob is this port's own: {"writer": "geobignn_tpu_torch",
"state_dict": the torch optimizer's state_dict()} with tensors as ext 1
and the integer parameter ids as decimal strings.  A blob written by optax
has no counterpart in torch's optimizers: `load_checkpoint(path,
with_opt=True)` raises for it and names `with_opt=False`, which loads the
weights alone.

The msgpack codec below covers exactly what those blobs hold — nil, bool,
ints, float64 (float32 read too), str, bin, array, map, ext 1 (ndarray) and
ext 3 (numpy scalar) — and raises on anything else: ext 2 (complex), other
ext types, and arrays chunked above flax's 1 GiB limit.  The JAX package's
round-1 pickle files hold pickled JAX arrays and are refused, with the
reason.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from geobignn_tpu_torch import params as params_mod

_MAGIC = b"GBNCKPT1"
WRITER = "geobignn_tpu_torch"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_MAX_CHUNK = 2 ** 30  # flax chunks array leaves above this many bytes
_CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------------
# msgpack, the subset the checkpoint blobs use
# --------------------------------------------------------------------------

def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out += struct.pack("B", v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0 <= v:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's 64 bits")


def _pack_len(n: int, out: bytearray, fix, codes) -> None:
    """Header of a str / bin / array / map of length n: `fix` is (base byte,
    limit) of the one-byte form or None, `codes` the (code, struct format,
    limit) forms after it."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt, top in codes:
        if n < top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


_STR = ((0xA0, 32), ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32)))
_BIN = (None, ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32)))
_ARR = ((0x90, 16), ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)))
_MAP = ((0x80, 16), ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)))


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise TypeError("object and structured arrays cannot be serialized")
    if arr.size * arr.dtype.itemsize > _MAX_CHUNK:
        raise ValueError(
            f"array of {arr.size * arr.dtype.itemsize} bytes: leaves above 1 GiB "
            "(flax's chunked form) are not supported")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(n, out, None, ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                                 (0xC9, ">I", 1 << 32)))
    out += struct.pack("b", code) + data


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):  # before float: np.float64 is a float
        _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, *_STR)
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), out, *_BIN)
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, *_ARR)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, *_MAP)
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k).__name__}")
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of a tree of None, bool, int, float, str, bytes, list,
    tuple, str-keyed dict, numpy arrays and numpy scalars — byte for byte
    what msgpack.packb / flax.serialization.msgpack_serialize write."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside a value (truncated)")
        got = self.data[self.pos:self.pos + n]
        self.pos += n
        return got

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(data)
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 array leaves are not supported (numpy has no such type)")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_payload(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_payload(data)[()]
    if code == _EXT_COMPLEX:
        raise ValueError("msgpack ext type 2 (complex) is not supported")
    raise ValueError(f"unknown msgpack ext type {code}")


_LEN_FMT = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
            0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
            0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_NUM_FMT = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _unpack(rd: _Reader):
    b = rd.num("B")
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _NUM_FMT:
        return rd.num(_NUM_FMT[b])
    if 0xA0 <= b < 0xC0 or b in (0xD9, 0xDA, 0xDB):
        n = b & 0x1F if b < 0xC0 else rd.num(_LEN_FMT[b])
        return bytes(rd.take(n)).decode("utf-8")
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(rd.take(rd.num(_LEN_FMT[b])))
    if 0x90 <= b < 0xA0 or b in (0xDC, 0xDD):
        n = b & 0x0F if b < 0xA0 else rd.num(_LEN_FMT[b])
        return [_unpack(rd) for _ in range(n)]
    if 0x80 <= b < 0x90 or b in (0xDE, 0xDF):
        n = b & 0x0F if b < 0x90 else rd.num(_LEN_FMT[b])
        out = {}
        for _ in range(n):
            k = _unpack(rd)
            if not isinstance(k, str):
                raise ValueError(f"map key of type {type(k).__name__}; only str keys are supported")
            out[k] = _unpack(rd)
        if _CHUNKED in out:
            raise ValueError("array leaves chunked above 1 GiB are not supported")
        return out
    if b in _FIXEXT or b in (0xC7, 0xC8, 0xC9):
        n = _FIXEXT[b] if b in _FIXEXT else rd.num(_LEN_FMT[b])
        code = rd.num("b")
        return _ext(code, bytes(rd.take(n)))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def unpackb(data: bytes):
    """Inverse of `packb`; also reads what msgpack.packb and
    flax.serialization.msgpack_serialize wrote, within the subset."""
    rd = _Reader(data)
    out = _unpack(rd)
    if rd.pos != len(rd.data):
        raise ValueError(f"{len(rd.data) - rd.pos} bytes left after the msgpack value")
    return out


# --------------------------------------------------------------------------
# optimizer state
# --------------------------------------------------------------------------

def _opt_to_tree(obj):
    """A torch optimizer's state_dict() as a msgpack tree: tensors become
    numpy arrays, integer keys decimal strings."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {str(k): _opt_to_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_opt_to_tree(v) for v in obj]
    return obj


def _opt_from_tree(tree: dict) -> dict:
    """Inverse of `_opt_to_tree` for an optimizer state_dict: parameter ids
    back to ints, arrays to tensors (0-d ones too: Adam's step)."""
    def leaf(v):
        if isinstance(v, np.ndarray):
            return torch.from_numpy(v)
        if isinstance(v, np.generic):
            return torch.from_numpy(np.asarray(v))
        return v

    return {
        "state": {int(pid): {k: leaf(v) for k, v in st.items()}
                  for pid, st in tree["state"].items()},
        "param_groups": tree["param_groups"],
    }


# --------------------------------------------------------------------------
# the file
# --------------------------------------------------------------------------

def _sorted_tree(node):
    if isinstance(node, dict):
        return {k: _sorted_tree(node[k]) for k in sorted(node)}
    return node


def save_checkpoint(path: str, state: dict, opt_state: dict | None = None,
                    **scalars) -> None:
    """Write `state` (a DualGNN state dict, or any {dotted name: tensor})
    and, when given, a torch optimizer's state_dict(), with the scalars."""
    p_bytes = packb(_sorted_tree(params_mod.to_jax_params(state)))
    o_bytes = b"" if opt_state is None else packb(
        {"writer": WRITER, "state_dict": _opt_to_tree(opt_state)})
    s_bytes = json.dumps(scalars, default=float).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        for blob in (p_bytes, o_bytes, s_bytes):
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
    os.replace(tmp, path)


def load_checkpoint(path: str, with_opt: bool = False):
    """(state dict, optimizer state_dict or None, scalars) of a checkpoint
    written by this package or by the JAX package.  `with_opt=True` also
    decodes the optimizer blob, and raises ValueError when another package
    wrote it."""
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
        if head != _MAGIC:
            raise ValueError(
                f"{path} does not start with {_MAGIC!r}: it is not a checkpoint, or it "
                "is the JAX package's round-1 pickle format, whose pickled JAX arrays "
                "this package cannot read (load it with geobignn_tpu and save it again)")
        blobs = []
        for name in ("params", "optimizer", "scalars"):
            raw = f.read(8)
            if len(raw) < 8:
                raise ValueError(f"{path} is truncated before its {name} blob")
            (size,) = struct.unpack("<Q", raw)
            blob = f.read(size)
            if len(blob) < size:
                raise ValueError(f"{path} is truncated inside its {name} blob")
            blobs.append(blob)
    p_bytes, o_bytes, s_bytes = blobs
    state = params_mod.from_jax_params(unpackb(p_bytes))
    opt_state = None
    if with_opt and o_bytes:
        tree = unpackb(o_bytes)
        if not isinstance(tree, dict) or tree.get("writer") != WRITER:
            raise ValueError(
                f"the optimizer state of {path} was not written by {WRITER} (an optax "
                "state has no counterpart in torch's optimizers); load the weights "
                "alone with with_opt=False")
        opt_state = _opt_from_tree(tree["state_dict"])
    return state, opt_state, json.loads(s_bytes.decode())
