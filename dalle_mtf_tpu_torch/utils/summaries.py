"""TensorBoard metrics writer (port of ``dalle_mtf_tpu/utils/summaries.py``).

Metrics are fetched on the host loop's log cadence and written as
TensorBoard scalar events. The JAX writer goes through TensorFlow; here the
event file is written directly (TFRecord framing of ``Event`` protos, with
the codec of ``data/tfrecord.py``), because importing TensorBoard's own
writer loads TensorFlow and, with it, JAX. Image summaries are not ported.
"""

from __future__ import annotations

import os
import socket
import struct
import time

from dalle_mtf_tpu_torch.data.tfrecord import TFRecordWriter, _len_delim, _tag, _varint


def _event(step: int, body: bytes) -> bytes:
    """An ``Event`` proto: wall_time (1, double), step (2, int64), then
    ``body`` (an already-encoded field)."""
    return (_tag(1, 1) + struct.pack("<d", time.time())
            + _tag(2, 0) + _varint(int(step)) + body)


def _scalar(tag: str, value: float) -> bytes:
    """``Summary.Value``: tag (1, string), simple_value (2, float)."""
    return _len_delim(1, tag.encode()) + _tag(2, 5) + struct.pack("<f", float(value))


class MetricsWriter:
    """Scalar events under ``model_dir``; with ``enabled`` False (every rank
    but 0 of a multi-process run) it writes nothing."""

    def __init__(self, model_dir: str, enabled: bool = True):
        self.logdir = model_dir
        self.enabled = enabled
        self._writer: TFRecordWriter | None = None

    def _file(self) -> TFRecordWriter:
        if self._writer is None:
            os.makedirs(self.logdir, exist_ok=True)
            name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
            self._writer = TFRecordWriter(os.path.join(self.logdir, name))
            # Event.file_version (3): what TensorBoard reads first
            self._writer.write(_event(0, _len_delim(3, b"brain.Event:2")))
        return self._writer

    def scalars(self, step: int, values: dict):
        if not self.enabled:
            return
        summary = b"".join(_len_delim(1, _scalar(k, v)) for k, v in values.items())
        self._file().write(_event(step, _len_delim(5, summary)))  # Event.summary

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
