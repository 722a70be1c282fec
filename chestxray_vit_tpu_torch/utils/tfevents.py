"""Dependency-free TensorBoard scalar writer and reader of the port, a copy
of ``chestxray_vit_tpu/utils/tfevents.py``.

TFRecord framing (length, masked CRC32C, payload, masked CRC32C) around
hand-encoded ``tensorflow.Event`` protos: the three fields TensorBoard
needs for scalars (wall_time, step, summary{tag, simple_value}) plus the
``brain.Event:2`` file-version header record. ``read_scalars`` reads them
back.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator, List, Tuple

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — TFRecord framing checksums
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    # TFRecord's mask delta 0xA282EAD8 (NOT LevelDB's 0xA675BC5A)
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf encoding (wire format only, no protobuf dependency)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _f32(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _i64(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    # Summary.Value: tag=1 (string), simple_value=2 (float)
    sval = _bytes(1, tag.encode()) + _f32(2, value)
    summary = _bytes(1, sval)                  # Summary.value (repeated) = 1
    # Event: wall_time=1 (double), step=2 (int64), summary=5 (message)
    return _f64(1, wall_time) + _i64(2, step) + _bytes(5, summary)


def _version_event(wall_time: float) -> bytes:
    # Event.file_version = 3 (string)
    return _f64(1, wall_time) + _bytes(3, b"brain.Event:2")


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class EventWriter:
    """Append-only scalar event file, TensorBoard-loadable."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}.cxr")
        self._f = open(os.path.join(log_dir, name), "ab")
        self._f.write(_record(_version_event(time.time())))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(_record(_scalar_event(tag, float(value), int(step),
                                            time.time())))
        # per-event flush, like metrics.jsonl: a live TensorBoard must see
        # scalars as they land, and a SIGKILL mid-run must not lose the
        # buffered tail (scalar events are tiny; flush cost is noise)
        self._f.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


# ---------------------------------------------------------------------------
# Reader (tests + offline inspection)
# ---------------------------------------------------------------------------

def read_records(path: str) -> Iterator[bytes]:
    """TFRecord payloads of an event file, CRC-verified."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise ValueError("corrupt tfevents header CRC")
            (length,) = struct.unpack("<Q", header)
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if pcrc != _masked_crc(payload):
                raise ValueError("corrupt tfevents payload CRC")
            yield payload


def _decode_fields(data: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """(field, wire_type, raw value bytes) stream of one proto message."""
    i = 0
    while i < len(data):
        key = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:
            start = i
            while data[i] & 0x80:
                i += 1
            i += 1
            yield field, wire, data[start:i]
        elif wire == 1:
            yield field, wire, data[i:i + 8]
            i += 8
        elif wire == 5:
            yield field, wire, data[i:i + 4]
            i += 4
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, data[i:i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")


def read_scalars(path: str) -> List[Tuple[int, str, float]]:
    """All (step, tag, value) scalar points in an event file."""
    out: List[Tuple[int, str, float]] = []
    for payload in read_records(path):
        step, points = 0, []
        for field, wire, raw in _decode_fields(payload):
            if field == 2 and wire == 0:                     # Event.step
                v = 0
                for j, b in enumerate(raw):
                    v |= (b & 0x7F) << (7 * j)
                step = v
            elif field == 5 and wire == 2:                   # Event.summary
                for f2, w2, raw2 in _decode_fields(raw):
                    if f2 == 1 and w2 == 2:                  # Summary.value
                        tag, val = "", None
                        for f3, w3, raw3 in _decode_fields(raw2):
                            if f3 == 1 and w3 == 2:
                                tag = raw3.decode()
                            elif f3 == 2 and w3 == 5:
                                (val,) = struct.unpack("<f", raw3)
                        if val is not None:
                            points.append((tag, val))
        out.extend((step, t, v) for t, v in points)
    return out
