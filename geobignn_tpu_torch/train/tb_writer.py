"""Minimal TensorBoard event-file writer (no TF/tensorboardX dependency).

Copy of geobignn_tpu/train/tb_writer.py (pure Python).

Observability parity with the reference's tensorboardX scalar writers
(code/train_dual.py:134-136, 222-226, 260-263): scalars written here load
in stock TensorBoard ('Scalars' tab) and anything else that reads TFRecord
event files.

Implements just the two wire formats involved, by hand:

  * TFRecord framing: {uint64 len, uint32 masked_crc32c(len), payload,
    uint32 masked_crc32c(payload)} — CRC32C (Castagnoli), masked per the
    TFRecord spec;
  * the tensorflow.Event protobuf subset: wall_time (double, field 1),
    step (int64, field 2), file_version (string, field 3) and
    Summary{ Value{ tag (string, field 1), simple_value (float, field 2)
    } } (field 5).
"""

from __future__ import annotations

import os
import socket
import struct
import time


# --------------------------------------------------------------------------
# CRC32C (software, table-driven) + TFRecord masking
# --------------------------------------------------------------------------

def _make_table() -> list[int]:
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# protobuf wire helpers (only what Event needs)
# --------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:  # protobuf int64: two's-complement 10-byte encoding
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_varint(num: int, val: int) -> bytes:
    return _varint(num << 3) + _varint(val)


def _field_bytes(num: int, val: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(val)) + val


def _field_double(num: int, val: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", val)


def _field_float(num: int, val: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", val)


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           scalars: dict[str, float] | None = None) -> bytes:
    msg = _field_double(1, wall_time)
    if step is not None:
        msg += _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(
                1,
                _field_bytes(1, tag.encode()) + _field_float(2, float(val)),
            )
            for tag, val in scalars.items()
        )
        msg += _field_bytes(5, summary)
    return msg


# --------------------------------------------------------------------------
# the writer
# --------------------------------------------------------------------------

class EventWriter:
    """Append-only TensorBoard event file in `logdir`.

    Usage:
        w = EventWriter(run_dir + "/tb/train")
        w.add_scalar("loss", 0.12, step=7)
        w.add_scalars({"loss": 0.12, "error_v": 0.05}, step=7)
        w.close()
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.v2"
        )
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.add_scalars({tag: value}, step)

    def add_scalars(self, scalars: dict[str, float], step: int) -> None:
        self._write(_event(time.time(), step=step, scalars=scalars))

    def close(self) -> None:
        self._f.close()
