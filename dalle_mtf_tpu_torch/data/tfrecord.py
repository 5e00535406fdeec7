"""Self-contained TFRecord + tf.train.Example I/O (copy of
``dalle_mtf_tpu/data/tfrecord.py``, which is JAX-free; importing it from the
JAX package would run that package's ``__init__``, which imports JAX). The
framing's crc32c is a Python loop eight bytes a step (slicing-by-8), with
the JAX package's values.

The reference reads/writes TFRecord files of tf.train.Example protos with
``{"image": bytes, "caption": int64 list}`` features (create_tfrecords.py:
38-56, input_fns.py:41-66). This module implements the exact wire formats —
TFRecord framing (length + masked crc32c + payload + masked crc32c) and the
Example protobuf — from scratch, so the TPU framework's data path has no
TensorFlow dependency. Interop is bidirectional: files written here parse
with tf.data, and the reference's files parse here (verified in tests
against TF itself).
"""

from __future__ import annotations

import struct
from typing import Any, Iterator, Mapping

import numpy as np

# ------------------------------------------------------------------- crc32c

_CRC_TABLES = None


def _crc_tables() -> list[list[int]]:
    """crc32c's slicing-by-8 tables (Castagnoli, reflected): table k maps a
    byte to its crc followed by k zero bytes."""
    global _CRC_TABLES
    if _CRC_TABLES is None:
        poly = 0x82F63B78
        t0 = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            t0.append(crc)
        tables = [t0]
        for _ in range(7):
            tables.append([(c >> 8) ^ t0[c & 0xFF] for c in tables[-1]])
        _CRC_TABLES = tables
    return _CRC_TABLES


def crc32c(data: bytes) -> int:
    t0, t1, t2, t3, t4, t5, t6, t7 = _crc_tables()
    crc = 0xFFFFFFFF
    n = len(data) - len(data) % 8
    words = np.frombuffer(data, "<u4", count=n // 4).tolist()
    for a, b in zip(words[0::2], words[1::2]):
        a ^= crc
        crc = (t7[a & 0xFF] ^ t6[(a >> 8) & 0xFF] ^ t5[(a >> 16) & 0xFF] ^ t4[a >> 24]
               ^ t3[b & 0xFF] ^ t2[(b >> 8) & 0xFF] ^ t1[(b >> 16) & 0xFF] ^ t0[b >> 24])
    for byte in data[n:]:
        crc = (crc >> 8) ^ t0[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --------------------------------------------------------- protobuf (subset)

# Wire format essentials for tf.train.Example:
#   Example{ Features features = 1 }
#   Features{ map<string, Feature> feature = 1 }   (map entry: key=1, value=2)
#   Feature{ oneof { BytesList=1, FloatList=2, Int64List=3 } }
#   BytesList{ repeated bytes value = 1 }
#   FloatList{ repeated float value = 1 [packed] }
#   Int64List{ repeated int64 value = 1 [packed] }


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's complement for negatives
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _encode_feature(value) -> bytes:
    if isinstance(value, (bytes, bytearray)):
        value = [bytes(value)]
    if isinstance(value, str):
        value = [value.encode()]
    value = list(value)
    if value and isinstance(value[0], (bytes, bytearray, str)):
        inner = b"".join(
            _len_delim(1, v.encode() if isinstance(v, str) else bytes(v))
            for v in value
        )
        return _len_delim(1, inner)  # BytesList
    if value and isinstance(value[0], (float, np.floating)):
        packed = struct.pack(f"<{len(value)}f", *value)
        return _len_delim(2, _len_delim(1, packed))  # FloatList (packed)
    packed = b"".join(_varint(int(v)) for v in value)
    return _len_delim(3, _len_delim(1, packed))  # Int64List (packed)


def serialize_example(features: Mapping[str, Any]) -> bytes:
    """Encode ``{"image": b"...", "caption": [1, 2, ...]}`` as tf.train.Example."""
    entries = b""
    for key, value in features.items():
        entry = _len_delim(1, key.encode()) + _len_delim(2, _encode_feature(value))
        entries += _len_delim(1, entry)  # map entry in Features.feature
    return _len_delim(1, entries)  # Example.features


def _decode_packed_varints(payload: bytes) -> list[int]:
    out, pos = [], 0
    while pos < len(payload):
        v, pos = _read_varint(payload, pos)
        if v >= 1 << 63:
            v -= 1 << 64
        out.append(v)
    return out


def _decode_feature(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        assert wire == 2, f"unexpected wire type {wire} in Feature"
        ln, pos = _read_varint(buf, pos)
        payload = buf[pos : pos + ln]
        pos += ln
        if field == 1:  # BytesList
            vals, p = [], 0
            while p < len(payload):
                t, p = _read_varint(payload, p)
                assert t >> 3 == 1
                l2, p = _read_varint(payload, p)
                vals.append(payload[p : p + l2])
                p += l2
            return vals
        if field == 2:  # FloatList
            vals, p = [], 0
            while p < len(payload):
                t, p = _read_varint(payload, p)
                if t & 7 == 2:  # packed
                    l2, p = _read_varint(payload, p)
                    vals.extend(struct.unpack(f"<{l2 // 4}f", payload[p : p + l2]))
                    p += l2
                else:  # unpacked fixed32
                    vals.append(struct.unpack("<f", payload[p : p + 4])[0])
                    p += 4
            return vals
        if field == 3:  # Int64List
            vals, p = [], 0
            while p < len(payload):
                t, p = _read_varint(payload, p)
                if t & 7 == 2:  # packed
                    l2, p = _read_varint(payload, p)
                    vals.extend(_decode_packed_varints(payload[p : p + l2]))
                    p += l2
                else:  # unpacked varint
                    v, p = _read_varint(payload, p)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    vals.append(v)
            return vals
    return []


def parse_example(data: bytes) -> dict:
    """Decode a serialized tf.train.Example into {name: list-of-values}."""
    out = {}
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        ln, pos = _read_varint(data, pos)
        payload = data[pos : pos + ln]
        pos += ln
        if tag >> 3 != 1:
            continue
        # payload = Features message: repeated map entries
        p = 0
        while p < len(payload):
            t, p = _read_varint(payload, p)
            l2, p = _read_varint(payload, p)
            entry = payload[p : p + l2]
            p += l2
            # entry: key (field 1), Feature (field 2)
            key, feat = None, None
            q = 0
            while q < len(entry):
                t2, q = _read_varint(entry, q)
                l3, q = _read_varint(entry, q)
                body = entry[q : q + l3]
                q += l3
                if t2 >> 3 == 1:
                    key = body.decode()
                else:
                    feat = body
            if key is not None and feat is not None:
                out[key] = _decode_feature(feat)
    return out


# ------------------------------------------------------------ record framing


class TFRecordWriter:
    def __init__(self, path: str):
        from dalle_mtf_tpu_torch.data.fs import open_file  # noqa: PLC0415

        self._f = open_file(path, "wb")

    def write(self, record: bytes):
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecord_file(path, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file.

    ``path`` may be a local path, a remote URL (gs://... via fsspec — the
    reference read GCS natively through tf.data, input_fns.py:85-104), or
    an already-open binary file object.
    """
    if hasattr(path, "read"):
        yield from _read_tfrecord_stream(path, verify_crc, name="<stream>")
        return
    from dalle_mtf_tpu_torch.data.fs import open_file  # noqa: PLC0415

    with open_file(path, "rb") as f:
        yield from _read_tfrecord_stream(f, verify_crc, name=str(path))


def _read_tfrecord_stream(f, verify_crc: bool, name: str) -> Iterator[bytes]:
    while True:
        header = f.read(8)
        if len(header) < 8:
            return
        (length,) = struct.unpack("<Q", header)
        (len_crc,) = struct.unpack("<I", f.read(4))
        if verify_crc and len_crc != _masked_crc(header):
            raise IOError(f"corrupt length crc in {name}")
        data = f.read(length)
        (data_crc,) = struct.unpack("<I", f.read(4))
        if verify_crc and data_crc != _masked_crc(data):
            raise IOError(f"corrupt record crc in {name}")
        yield data
