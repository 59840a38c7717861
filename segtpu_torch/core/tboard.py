"""Minimal TensorBoard scalar-event writer, no dependencies (port of
``segtpu/core/tboard.py``, copied: the byte layout is the JAX package's,
so both packages write the same event file for the same scalars and wall
times).

Training emits metrics through ``MetricsLogger`` (JSONL); this module
writes standard TensorBoard event files beside it, so `tensorboard
--logdir` renders the training curves with no glue code. (The reference
has no TensorBoard logging; its curves are matplotlib PNGs, the
reference's train.py:247-298.)

The on-disk format is the stable TFRecord framing of ``Event`` protos:

    uint64le  length
    uint32le  masked_crc32c(length bytes)
    bytes     serialized Event
    uint32le  masked_crc32c(data)

with ``masked_crc = ((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff``
over CRC-32C (Castagnoli). Only the three proto messages TensorBoard's
scalar dashboard needs are hand-encoded here (Event / Summary /
Summary.Value with ``simple_value``).
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
import warnings
from typing import Dict, Mapping, Optional

# ---------------------------------------------------------------- CRC-32C

_CRC_POLY = 0x82F63B78
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC_POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli). KAT: crc32c(b'123456789') == 0xE3069283."""
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding

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


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_int64(field: int, v: int) -> bytes:
    if v < 0:  # two's-complement varint, per proto3 int64
        v += 1 << 64
    return _key(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _summary_value(tag: str, value: float) -> bytes:
    # Summary.Value: tag = field 1 (string), simple_value = field 2 (float)
    return _f_bytes(1, tag.encode("utf-8")) + _f_float(2, float(value))


def encode_scalar_event(wall_time: float, step: int,
                        scalars: Mapping[str, float]) -> bytes:
    """Serialized ``Event`` proto carrying one ``Summary`` of simple_values.

    Event: wall_time = field 1 (double), step = field 2 (int64),
    summary = field 5 (Summary); Summary.value = field 1 (repeated)."""
    summary = b"".join(_f_bytes(1, _summary_value(t, v))
                       for t, v in scalars.items())
    return _f_double(1, wall_time) + _f_int64(2, int(step)) + \
        _f_bytes(5, summary)


def encode_file_version_event(wall_time: float) -> bytes:
    """The mandatory first record: file_version = Event field 3."""
    return _f_double(1, wall_time) + _f_bytes(3, b"brain.Event:2")


def frame_record(data: bytes) -> bytes:
    """TFRecord framing: len, masked crc(len), data, masked crc(data)."""
    header = struct.pack("<Q", len(data))
    return header + struct.pack("<I", _masked_crc(header)) + data + \
        struct.pack("<I", _masked_crc(data))


# ---------------------------------------------------------------- writer

class TBWriter:
    """Append-only scalar writer for one TensorBoard run directory.

    >>> with TBWriter("runs/exp1") as tb:
    ...     tb.add_scalar("val/iou", 0.91, step=3)
    ...     tb.add_scalars({"train/loss": 0.2, "val/loss": 0.3}, step=3)

    Thread-safe per instance (train_model logs from the host thread only,
    but serving/eval code may share a writer). Files are flushed on every
    event — an interrupted training still has every completed epoch's
    points, matching MetricsLogger's crash-visible JSONL semantics.
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        ts = time.time()
        host = socket.gethostname() or "local"
        self.path = os.path.join(
            logdir,
            f"events.out.tfevents.{ts:.6f}.{host}.{os.getpid()}"
            f"{filename_suffix}")
        self._lock = threading.Lock()
        self._f = open(self.path, "wb")
        self._f.write(frame_record(encode_file_version_event(ts)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self.add_scalars({tag: value}, step, wall_time)

    def add_scalars(self, scalars: Dict[str, float], step: int,
                    wall_time: Optional[float] = None) -> None:
        """One Event carrying every (tag, value) pair — epoch metrics land
        as a single record instead of len(metrics) framed events."""
        if not scalars:
            return
        wt = time.time() if wall_time is None else float(wall_time)
        rec = frame_record(encode_scalar_event(wt, step, scalars))
        with self._lock:
            if self._f.closed:
                raise ValueError("TBWriter is closed")
            self._f.write(rec)
            self._f.flush()

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self) -> "TBWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------- reader
# A tiny decoder for the subset this module writes — used by tests and by
# anyone who wants training curves back out of an event file without
# installing tensorboard.

def read_scalar_events(path: str):
    """Yield (wall_time, step, {tag: value}) from an event file written by
    TBWriter (or any file whose Events only carry simple_value summaries).
    Verifies both masked CRCs of every record.

    A truncated or CRC-failing FINAL record — the torn tail a process
    killed mid-write can leave — ends iteration after the complete prefix
    (with a RuntimeWarning) instead of raising, preserving the writer's
    crash-visible semantics: every completed epoch's points stay readable.
    Corruption in a non-tail record still raises ValueError."""
    with open(path, "rb") as f:
        blob = f.read()
    off = 0
    while off < len(blob):
        end = None
        try:
            if off + 12 > len(blob):
                raise _TornTail()
            header = blob[off:off + 8]
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", blob[off + 8:off + 12])
            # a failing header CRC means `length` is untrustworthy: only
            # treat it as a torn tail when the claimed record runs past EOF
            end = off + 16 + length
            if hcrc != _masked_crc(header):
                raise ValueError(f"bad length crc at offset {off}")
            if end > len(blob):
                raise _TornTail()
            data = blob[off + 12:off + 12 + length]
            (dcrc,) = struct.unpack("<I",
                                    blob[off + 12 + length:end])
            if dcrc != _masked_crc(data):
                raise ValueError(f"bad data crc at offset {off}")
        except _TornTail:
            warnings.warn(f"torn tail record at offset {off} of {path}; "
                          "returning the complete prefix", RuntimeWarning)
            return
        except ValueError:
            if end is None or end >= len(blob):
                warnings.warn(
                    f"torn tail record at offset {off} of {path}; "
                    "returning the complete prefix", RuntimeWarning)
                return
            raise
        off = end
        ev = _decode_event(data)
        if ev is not None:
            yield ev


class _TornTail(Exception):
    """Internal: a final record cut short by an interrupted write."""


def _read_varint(buf: bytes, i: int):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _decode_fields(buf: bytes):
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        else:  # pragma: no cover - groups unused
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _decode_event(data: bytes):
    wall_time, step, scalars = 0.0, 0, {}
    has_summary = False
    for field, wire, v in _decode_fields(data):
        if field == 1 and wire == 1:
            (wall_time,) = struct.unpack("<d", v)
        elif field == 2 and wire == 0:
            step = v - (1 << 64) if v >> 63 else v
        elif field == 5 and wire == 2:
            has_summary = True
            for sf, sw, sv in _decode_fields(v):
                if sf == 1 and sw == 2:
                    tag, val = None, None
                    for vf, vw, vv in _decode_fields(sv):
                        if vf == 1 and vw == 2:
                            tag = vv.decode("utf-8")
                        elif vf == 2 and vw == 5:
                            (val,) = struct.unpack("<f", vv)
                    if tag is not None and val is not None:
                        scalars[tag] = val
    if not has_summary:  # file_version record
        return None
    return wall_time, step, scalars
