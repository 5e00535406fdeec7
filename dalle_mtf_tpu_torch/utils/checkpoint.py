"""Checkpoint files written one leaf at a time and read one block at a time.

A checkpoint is a file in ``torch.save``'s zip format, so ``torch.load``
reads it whole as before. ``write`` builds it the other way round:
``data.pkl`` first, from the tree's structure and every tensor's whole
shape and dtype, then each tensor's record in turn. A tensor may be given
as a ``Lazy`` leaf, fetched only at its turn and let go once written, so
the writer holds one leaf at a time (a sharded leaf is gathered to the
writer then: ``parallel/tensor.py::gather_to_host``). ``read`` maps the
file (``torch.load(mmap=True)``): its tensors are views of the file's
pages, and copying a block out of one reads only that block. A checkpoint
under a URL (gs://, file://, memory://: ``data/fs.py``) is streamed to a
temporary object as it is written, moved into place once it is whole, and
read whole.
"""

from __future__ import annotations

import collections
import io
import os
import pickle
import sys
import tempfile
from typing import Any, Callable, NamedTuple

import torch

from dalle_mtf_tpu_torch.data import fs


class Lazy(NamedTuple):
    """A tensor of ``shape`` and ``dtype`` that ``fetch()`` makes when it is
    written: a CPU tensor on the writer, None on a rank that only takes part
    (sends its block)."""

    shape: tuple
    dtype: torch.dtype
    fetch: Callable[[], torch.Tensor | None]


class _Record(NamedTuple):
    key: str
    shape: tuple
    dtype: torch.dtype


class _Storage(NamedTuple):
    record: _Record


def _storage_type(dtype: torch.dtype):
    return getattr(torch, torch.empty(0, dtype=dtype)._typed_storage()._pickle_storage_type())


def _contiguous_strides(shape) -> tuple:
    strides, n = [], 1
    for size in reversed(shape):
        strides.append(n)
        n *= size
    return tuple(reversed(strides))


class _Pickler(pickle.Pickler):
    """Pickles ``_Record``s as ``torch.save`` pickles a contiguous tensor:
    ``_rebuild_tensor_v2`` over a persistent storage reference."""

    def persistent_id(self, obj):
        if isinstance(obj, _Storage):
            r = obj.record
            numel = 1
            for size in r.shape:
                numel *= size
            return ("storage", _storage_type(r.dtype), r.key, "cpu", numel)
        return None

    def reducer_override(self, obj):
        if isinstance(obj, _Record):
            return (torch._utils._rebuild_tensor_v2,
                    (_Storage(obj), 0, obj.shape, _contiguous_strides(obj.shape), False,
                     collections.OrderedDict()))
        return NotImplemented


def _skeleton(obj, leaves: list):
    """``obj`` with every tensor and Lazy replaced by a _Record (appended,
    with its fetch and whether it is a Lazy, to ``leaves`` in the order they
    are met)."""
    if isinstance(obj, Lazy):
        rec = _Record(str(len(leaves)), tuple(obj.shape), obj.dtype)
        leaves.append((rec, obj.fetch, True))
        return rec
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        rec = _Record(str(len(leaves)), tuple(t.shape), t.dtype)
        leaves.append((rec, t.cpu, False))
        return rec
    if isinstance(obj, dict):
        return {k: _skeleton(v, leaves) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_skeleton(v, leaves) for v in obj)
    return obj


def write(path: str | None, tree: Any) -> None:
    """Write ``tree`` (dicts, lists and tuples of plain values, tensors and
    Lazy leaves) to ``path`` atomically (a temporary file in its directory,
    or ``<path>.tmp`` at a URL, then a rename: a write cut short leaves no
    ``path``), fetching each Lazy at its turn. With ``path`` None only the
    fetches run, in the same order (a rank taking part in the writer's
    gathers)."""
    leaves: list = []
    skeleton = _skeleton(tree, leaves)
    if path is None:
        for _rec, fetch, lazy in leaves:
            if lazy:
                fetch()
        return
    buf = io.BytesIO()
    _Pickler(buf, protocol=2).dump(skeleton)
    data = buf.getvalue()

    def records(writer) -> None:
        writer.write_record("data.pkl", data, len(data))
        writer.write_record("byteorder", sys.byteorder, len(sys.byteorder))
        for rec, fetch, _lazy in leaves:
            t = fetch()
            if tuple(t.shape) != rec.shape or t.dtype != rec.dtype:
                raise ValueError(f"checkpoint leaf {rec.key}: fetched {tuple(t.shape)} "
                                 f"{t.dtype}, expected {rec.shape} {rec.dtype}")
            t = t.contiguous()
            if t.storage_offset() or t.untyped_storage().nbytes() != t.numel() * t.element_size():
                t = t.clone()
            storage = t.untyped_storage()
            writer.write_record(f"data/{rec.key}", storage, storage.nbytes())
            del t, storage
        writer.write_end_of_file()

    if fs.is_remote(path):
        tmp = path + ".tmp"
        try:
            with fs.open_file(tmp, "wb") as f:
                records(torch._C.PyTorchFileWriter(f))
            fs.move(tmp, path)
        finally:
            if fs.exists(tmp):
                fs.remove(tmp)
        return
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    os.close(fd)
    try:
        writer = torch._C.PyTorchFileWriter(tmp)
        records(writer)
        del writer
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def read(path: str) -> Any:
    """The checkpoint at ``path`` (CPU): its tensors mapped from a local
    file (``torch.load(mmap=True)``), a URL's object read whole."""
    if fs.is_remote(path):
        with fs.open_file(path, "rb") as f:
            return torch.load(io.BytesIO(f.read()), map_location="cpu", weights_only=True)
    return torch.load(path, map_location="cpu", mmap=True, weights_only=True)
