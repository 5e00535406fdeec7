"""TensorBoard metrics writer (port of ``dalle_mtf_tpu/utils/summaries.py``).

Metrics are fetched on the host loop's log cadence and written as
TensorBoard scalar events. The JAX writer goes through TensorFlow; here the
event file is written directly (TFRecord framing of ``Event`` protos, with
the codec of ``data/tfrecord.py``), because importing TensorBoard's own
writer loads TensorFlow and, with it, JAX. Images are ``Summary.Image``
values holding PNG bytes (``utils/png.py``). A model dir that is a URL
(gs://, memory://) takes its event file through fsspec (``data/fs.py``).
"""

from __future__ import annotations

import socket
import struct
import time

import numpy as np

from dalle_mtf_tpu_torch.data import fs
from dalle_mtf_tpu_torch.data.tfrecord import (
    TFRecordWriter,
    _len_delim,
    _read_varint,
    _tag,
    _varint,
    read_tfrecord_file,
)
from dalle_mtf_tpu_torch.utils.png import encode_png


def _event(step: int, body: bytes) -> bytes:
    """An ``Event`` proto: wall_time (1, double), step (2, int64), then
    ``body`` (an already-encoded field)."""
    return (_tag(1, 1) + struct.pack("<d", time.time())
            + _tag(2, 0) + _varint(int(step)) + body)


def _scalar(tag: str, value: float) -> bytes:
    """``Summary.Value``: tag (1, string), simple_value (2, float)."""
    return _len_delim(1, tag.encode()) + _tag(2, 5) + struct.pack("<f", float(value))


def _image(tag: str, img: np.ndarray) -> bytes:
    """``Summary.Value``: tag (1), image (4) = ``Summary.Image``{height (1),
    width (2), colorspace (3: 1 grey, 3 RGB), encoded_image_string (4)}."""
    h, w, c = img.shape
    body = (_tag(1, 0) + _varint(h) + _tag(2, 0) + _varint(w) + _tag(3, 0) + _varint(c)
            + _len_delim(4, encode_png(img)))
    return _len_delim(1, tag.encode()) + _len_delim(4, body)


class MetricsWriter:
    """Scalar events under ``model_dir``; with ``enabled`` False (every rank
    but 0 of a multi-process run) it writes nothing."""

    def __init__(self, model_dir: str, enabled: bool = True):
        self.logdir = model_dir
        self.enabled = enabled
        self._writer: TFRecordWriter | None = None

    def _file(self) -> TFRecordWriter:
        if self._writer is None:
            fs.makedirs(self.logdir)
            name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
            self._writer = TFRecordWriter(fs.join(self.logdir, name))
            # Event.file_version (3): what TensorBoard reads first
            self._writer.write(_event(0, _len_delim(3, b"brain.Event:2")))
        return self._writer

    def scalars(self, step: int, values: dict):
        if not self.enabled:
            return
        summary = b"".join(_len_delim(1, _scalar(k, v)) for k, v in values.items())
        self._file().write(_event(step, _len_delim(5, summary)))  # Event.summary

    def images(self, step: int, images: dict, max_outputs: int = 4):
        """images: name -> [B, H, W, C] floats in [0, 1] (clipped); the first
        ``max_outputs`` of each batch, tagged ``<name>/image/<i>``."""
        if not self.enabled:
            return
        summary = b"".join(
            _len_delim(1, _image(f"{name}/image/{i}", img))
            for name, batch in images.items()
            for i, img in enumerate(np.clip(np.asarray(batch, np.float32), 0.0, 1.0)[:max_outputs])
        )
        self._file().write(_event(step, _len_delim(5, summary)))

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def _fields(buf: bytes):
    """(field, value) of a proto message: ints for varints, bytes for
    length-delimited and 32/64-bit fields."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        wire = key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, pos = buf[pos:pos + n], pos + n
        else:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        yield key >> 3, value


def read_summaries(logdir: str) -> list[tuple[int, str, object]]:
    """(step, tag, value) of every summary value in the event files under
    ``logdir``, in file order: a float for a scalar, (height, width,
    colorspace, PNG bytes) for an image."""
    out = []
    for name in sorted(fs.listdir(logdir)):
        if not name.startswith("events.out.tfevents"):
            continue
        for rec in read_tfrecord_file(fs.join(logdir, name), verify_crc=True):
            event = dict(_fields(rec))
            for field, value in _fields(event.get(5, b"")):
                if field != 1:
                    continue
                v = dict(_fields(value))
                if 2 in v:
                    out.append((event[2], v[1].decode(), struct.unpack("<f", v[2])[0]))
                elif 4 in v:
                    img = dict(_fields(v[4]))
                    out.append((event[2], v[1].decode(), (img[1], img[2], img[3], img[4])))
    return out
