"""Minimal TensorBoard event-file writer (pure Python, no TF dependency).

The reference's Lightning runs emit tfevents files next to the CSV logs
(reference model/CE/lightning_logs/version_*/events.out.tfevents.*); this
reproduces that logging surface first-party: scalar summaries in the TFRecord
framing TensorBoard reads (length + masked-CRC32C framing, hand-encoded
Event/Summary protobuf messages).

Wire format per record: uint64 length | masked crc32c(length bytes) |
payload | masked crc32c(payload). Event proto fields used: wall_time (1,
double), step (2, int64), file_version (3, string) / summary (5, message);
Summary.Value fields: tag (1, string), simple_value (2, float).

A copy of the TPU package's ``utils/tbevents.py``.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78  # CRC-32C (Castagnoli), reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _double_field(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _int64_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    summary_value = (_bytes_field(1, tag.encode()) +
                     _float_field(2, float(value)))
    summary = _bytes_field(1, summary_value)  # Summary.value (repeated, 1)
    return (_double_field(1, wall_time) + _int64_field(2, step) +
            _bytes_field(5, summary))  # Event.summary (5)


class EventFileWriter:
    """Append-only scalar-event writer; one file per instance."""

    def __init__(self, logdir: str, suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}{suffix}")
        self.path = os.path.join(logdir, name)
        self._file = open(self.path, "ab")
        # TensorBoard expects a leading file_version event.
        self._write_record(_double_field(1, time.time()) +
                           _bytes_field(3, b"brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._write_record(_scalar_event(tag, value, step,
                                         wall_time or time.time()))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()
