"""Host input pipeline (port of ``dalle_mtf_tpu/data/pipeline.py``): VAE
image batches and DALLE batches, image + caption or tokens + caption.

Files -> records -> parsed samples -> shuffle buffer -> batches, on a
background prefetch thread. The stream is the JAX pipeline's, record for
record: the same cycle-length interleave over the (seeded, shuffled) file
list, the same 5x-batch shuffle buffer driven by ``random.Random(seed + 1)``,
the same drop-remainder batching, and the same deterministic resume
(``skip_steps``: the shuffle decisions are replayed on record indices and
the trained prefix is skipped without parsing).

Where the native library builds (``data/native.py``), local tfrecords are
read and interleaved on one io_uring, image records are parsed and decoded by
its C++ pool off the GIL, and ``decode_img`` decodes with libjpeg and a plain
bilinear resize, as the JAX package does by default. Otherwise, and for
remote shards, records are read in Python (a remote shard on a read-ahead
thread of its own, ``data/readahead.py``) and images decoded by PIL on a pool
of threads. Each pipeline says which path it took (``reader``, ``decoder``).
"""

from __future__ import annotations

import io
import logging
import os
import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Mapping

import numpy as np

from dalle_mtf_tpu_torch.data import native
from dalle_mtf_tpu_torch.data.fs import is_remote, list_files, open_file
from dalle_mtf_tpu_torch.data.native import read_tfrecord_file
from dalle_mtf_tpu_torch.data.readahead import prefetch_iter
from dalle_mtf_tpu_torch.data.tfrecord import parse_example

logger = logging.getLogger(__name__)

_SKIP_END = object()  # "record stream ended inside the resume prefix"
# threads an image pipeline decodes on with PIL: one thread cannot keep up
# with COCO-size photos at batch 32, and each thread more holds the GIL from
# the training loop's dispatch (chip_smoke.py ``vae_host_data``; PERF.md §5)
DECODE_WORKERS = 3
# C++ threads of the native decode pool, which hold no GIL: the JAX
# package's ``num_workers``, not yet measured against others on an H100 host
# (chip_smoke.py ``pool_sweep``; ROADMAP.md)
POOL_WORKERS = 16


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Round a normalized f32 image ([-1, 1]) back to uint8 pixels: the one
    rounding of ``dataset.uint8_images``, for the native pool and
    ``decode_img`` alike."""
    return np.clip(np.round(img * 127.5 + 127.5), 0, 255).astype(np.uint8)


def decode_img(data: bytes, size: int, channels: int = 3, normalize: bool = True) -> np.ndarray:
    """jpeg bytes -> f32 [size, size, channels] in [-1, 1]: the centered
    square crop, a bilinear resize and (x - 127.5) / 127.5. The native
    decoder (libjpeg, a plain bilinear resize) where it is available and the
    bytes are a JPEG, else PIL (whose bilinear filter smooths a downscale).
    ``normalize=False`` returns uint8 pixels (``dataset.uint8_images``; the
    task normalizes on the device with the same expression): PIL's own, or
    ``to_uint8`` of the native decoder's floats."""
    out = native.decode_img(data, size, channels)
    if out is not None:
        return out if normalize else to_uint8(out)
    from PIL import Image  # noqa: PLC0415

    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB" if channels == 3 else "L")
    w, h = img.size
    side = min(w, h)
    left, top = (w - side) // 2, (h - side) // 2
    img = img.crop((left, top, left + side, top + side))
    img = img.resize((size, size), Image.BILINEAR)
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if not normalize:
        return arr.astype(np.uint8)
    return (arr.astype(np.float32) - 127.5) / 127.5


class _Pipeline:
    """files -> records -> parse -> shuffle buffer -> batches."""

    def __init__(
        self,
        files: list[str],
        record_iter_fn: Callable[[str], Iterator[Any]],
        parse_fn: Callable[[Any], dict],
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
        prefetch: int = 4,
        repeat: bool = True,
        cycle_length: int = 4,
        skip_samples: int = 0,
        num_workers: int = 1,
        native_decode: Mapping[str, Any] | None = None,
        readahead_depth: int | None = None,
    ):
        if not files:
            raise FileNotFoundError("input pipeline got an empty file list")
        # {"size", "channels", "text_len", "padding_id", "uint8_out"}: the
        # standard image schema, which the native pool parses and decodes
        self.native_decode = dict(native_decode) if native_decode else None
        self.files = list(files)
        self.record_iter_fn = record_iter_fn
        self.parse_fn = parse_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.repeat = repeat
        self.num_workers = num_workers
        # parallel_interleave(cycle_length=4) (reference input_fns.py:87-92):
        # round-robin over N open files so a shuffle window sees several shards
        self.cycle_length = max(1, cycle_length)
        # records buffered ahead on each open remote shard's thread
        if readahead_depth is None:
            readahead_depth = int(os.environ.get("DALLE_TPU_READAHEAD_DEPTH", "64"))
        self.readahead_depth = max(1, int(readahead_depth))
        # the paths the stream took, set when it starts: "io_uring",
        # "native" or "python" (+ "readahead" over remote shards); "native
        # pool", "threads" or "this thread"
        self.reader: str | None = None
        self.decoder: str | None = None
        self.skip_samples = max(0, int(skip_samples))
        if self.skip_samples and shuffle and not repeat:
            # the resume replay assumes an unbounded stream; a finite shuffled
            # stream ends in a drain phase that the replay cannot reproduce
            raise ValueError("resume skip on a shuffled stream requires repeat=True")

    def _reading(self, reader: str) -> None:
        if self.reader != reader:
            logger.info("input pipeline: records read by %s", reader)
            self.reader = reader

    def _local_reader(self, files: list[str]) -> str:
        """The reader of a tfrecord file without io_uring: the native one
        where the library loads and the files are local."""
        if (self.record_iter_fn is read_tfrecord_file and native.available()
                and not any(is_remote(f) for f in files)):
            return "native"
        return "python"

    def _interleaved(self, files: list[str]) -> Iterator[Any]:
        """Round-robin one record at a time across cycle_length open files;
        an exhausted file is replaced by the next unopened one. Local
        tfrecords take the io_uring reader (the same order, every stream's
        reads in flight at once); a remote shard is read ahead on a thread
        of its own (``prefetch_iter``: the order unchanged)."""
        if self.record_iter_fn is read_tfrecord_file:
            g = native.read_interleaved(files, cycle=self.cycle_length)
            if g is not None:
                self._reading("io_uring")
                yield from g
                return
        remote = any(is_remote(f) for f in files)
        self._reading(self._local_reader(files) + (" + readahead" if remote else ""))
        file_iter = iter(files)
        active: deque = deque()

        def refill() -> None:
            for f in file_iter:
                it = self.record_iter_fn(f)
                if is_remote(f):
                    it = prefetch_iter(it, depth=self.readahead_depth)
                active.append(it)
                return

        while len(active) < self.cycle_length:
            n = len(active)
            refill()
            if len(active) == n:
                break
        while active:
            it = active[0]
            try:
                rec = next(it)
            except StopIteration:
                active.popleft()
                refill()
                continue
            yield rec
            active.rotate(-1)

    def _records(self) -> Iterator[Any]:
        rng = random.Random(self.seed)
        files = list(self.files)
        if self.shuffle:
            rng.shuffle(files)  # reshuffle_each_iteration=False (input_fns.py:82)
        while True:
            if self.cycle_length > 1 and len(files) > 1:
                yield from self._interleaved(files)
            else:
                self._reading(self._local_reader(files))
                for f in files:
                    yield from self.record_iter_fn(f)
            if not self.repeat:
                return

    def _decoding(self, decoder: str) -> None:
        if self.decoder != decoder:
            logger.info("input pipeline: samples parsed by %s", decoder)
            self.decoder = decoder

    def _samples(self, records: Iterator[Any] | None = None) -> Iterator[dict]:
        """Parsed samples in record order: image records of the standard
        schema by the native pool (``POOL_WORKERS`` C++ threads); otherwise
        on this thread, or with ``num_workers`` > 1 on a pool of threads
        with 2x that many parses in flight (the JAX pipeline's window).
        Tokens records parse on this thread: one thread parses 20-30x what a
        DALLE step takes (PERF.md §5), and a pool would only hold the GIL
        from the training loop."""
        if records is None:
            records = self._records()
        if self.native_decode is not None:
            g = native.decode_pool_samples(records, workers=POOL_WORKERS, **self.native_decode)
            if g is not None:
                self._decoding("native pool")
                yield from g
                return
        if self.num_workers <= 1:
            self._decoding("this thread")
            parsed = map(self.parse_fn, records)
        else:
            self._decoding("threads")
            parsed = self._parallel(records)
        for sample in parsed:
            if sample is not None:
                yield sample

    def _parallel(self, records: Iterator[Any]) -> Iterator[Any]:
        with ThreadPoolExecutor(self.num_workers) as pool:
            in_flight: deque = deque()
            for rec in records:
                in_flight.append(pool.submit(self.parse_fn, rec))
                if len(in_flight) >= 2 * self.num_workers:
                    yield in_flight.popleft().result()
            while in_flight:
                yield in_flight.popleft().result()

    def _resume_plan(self, n: int, buf_size: int, rng: random.Random) -> tuple[list[int], int]:
        """Replay the shuffle arithmetic on record INDICES to find the state
        after ``n`` yields: (buffer contents as record indices, in list
        order; records consumed). ``rng`` advances to the post-prefix state."""
        buf: list[int] = []
        idx = 0
        yielded = 0
        while yielded < n:
            buf.append(idx)
            idx += 1
            if len(buf) >= buf_size:
                i = rng.randrange(len(buf))
                buf[i], buf[-1] = buf[-1], buf[i]
                buf.pop()
                yielded += 1
        return buf, idx

    def _records_skipping(self, keep: set[int], consumed: int) -> Iterator[Any]:
        """The record stream minus the already-yielded prefix (unparsed),
        except the records still in the shuffle buffer (``keep``)."""
        for i, rec in enumerate(self._records()):
            if i >= consumed or i in keep:
                yield rec

    def _shuffled(self) -> Iterator[dict]:
        """Shuffle-buffer sample stream; with skip_samples > 0 it continues
        exactly where an uninterrupted stream would be after that many."""
        if not self.shuffle:
            records = self._records()
            for _ in range(self.skip_samples):
                if next(records, _SKIP_END) is _SKIP_END:
                    return
            yield from self._samples(records)
            return
        buf_size = self.batch_size * 5  # configure_for_performance (:26)
        rng = random.Random(self.seed + 1)
        buf: list = []
        if self.skip_samples:
            buf_idx, consumed = self._resume_plan(self.skip_samples, buf_size, rng)
            logger.info(
                "data resume: skipping %d samples (%d records read-through, "
                "%d shuffle-buffer residents re-parsed)",
                self.skip_samples, consumed, len(buf_idx),
            )
            samples = self._samples(self._records_skipping(set(buf_idx), consumed))
            # the surviving samples arrive in record order; the buffer's
            # list order is the swap-permuted one
            arrived = {}
            try:
                for i in sorted(buf_idx):
                    arrived[i] = next(samples)
            except StopIteration:
                return  # stream shorter than the resume point
            buf = [arrived[i] for i in buf_idx]
        else:
            samples = self._samples()
        for sample in samples:
            buf.append(sample)
            if len(buf) >= buf_size:
                i = rng.randrange(len(buf))
                buf[i], buf[-1] = buf[-1], buf[i]
                yield buf.pop()
        rng.shuffle(buf)
        yield from buf

    def _batches(self) -> Iterator[dict]:
        batch: list = []
        for sample in self._shuffled():
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield {k: np.stack([s[k] for s in batch]) for k in batch[0]}
                batch = []
        # drop_remainder=True (input_fns.py:27)

    def __iter__(self) -> Iterator[dict]:
        """Batches, prefetched on a background thread. Abandoning the
        iterator stops the producer; producer exceptions reach the
        consumer."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b in self._batches():
                    if not _put(b):
                        return
                _put(sentinel)
            except BaseException as e:  # surface in the consumer
                _put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def _resolve_shard(shard: tuple[int, int] | None) -> tuple[int, int]:
    """(index, count) of this process's data: ``shard``, which a run over
    several processes passes as its index and size on the data-parallel
    (``batch_dim``) mesh axis, so that the sequence-parallel ranks of one
    data-parallel group read the same rows; else (0, 1)."""
    return (0, 1) if shard is None else shard


def _shard_files(files: list[str], shard: tuple[int, int]) -> list[str]:
    index, count = shard
    if count > 1:
        sharded = files[index::count]
        return sharded if sharded else files  # fewer files than processes
    return files


def _host_batch(global_batch: int, shard: tuple[int, int]) -> int:
    """Per-process batch: each process feeds 1/count of the global batch."""
    count = shard[1]
    if global_batch % count != 0:
        raise ValueError(f"global batch {global_batch} must divide by process count {count}")
    return global_batch // count


def vae_input_fn(
    params: Mapping[str, Any],
    eval: bool = False,
    shard: tuple[int, int] | None = None,
    repeat: bool = True,
    skip_steps: int = 0,
) -> _Pipeline:
    """Image batches for VAE training (input_fns.py:69-104):
    ``{"image": f32[B, size, size, C] in [-1, 1]}``, or uint8 pixels with
    ``dataset.uint8_images``. Tfrecords (their ``image`` feature) when
    ``dataset.tfrecords`` is set, else a raw jpg glob; tfrecords are parsed
    and decoded by the native pool where it builds, else (and a glob always)
    by ``decode_img`` on ``DECODE_WORKERS`` threads. ``shard``: (index,
    count) of this process, which reads files[index::count] and feeds
    1/count of the batch. ``skip_steps``: resume point, that many
    already-trained batches skipped exactly, without decoding them."""
    ds = params["dataset"]
    path = ds["eval_path"] if eval else ds["train_path"]
    size = ds["image_size"]
    channels = params.get("n_channels") or 3
    shard = _resolve_shard(shard)
    batch = _host_batch(params["eval_batch_size" if eval else "train_batch_size"], shard)
    files = _shard_files(list_files(path), shard)
    normalize = not ds.get("uint8_images")

    native_decode = None
    if ds.get("tfrecords"):
        def parse(record: bytes) -> dict:
            ex = parse_example(record)
            return {"image": decode_img(ex["image"][0], size, channels, normalize=normalize)}

        read = read_tfrecord_file
        native_decode = {"size": size, "channels": channels, "text_len": 0, "padding_id": 0,
                         "uint8_out": not normalize}
    else:
        def read(path_: str):
            yield path_

        def parse(path_: str) -> dict:
            with open_file(path_, "rb") as f:
                return {"image": decode_img(f.read(), size, channels, normalize=normalize)}

    return _Pipeline(
        files, read, parse, batch, shuffle=not eval, repeat=repeat,
        skip_samples=skip_steps * batch, cycle_length=ds.get("cycle_length") or 4,
        num_workers=DECODE_WORKERS, native_decode=native_decode,
        readahead_depth=ds.get("readahead_depth"),
    )


def dalle_input_fn(
    params: Mapping[str, Any],
    eval: bool = False,
    shard: tuple[int, int] | None = None,
    repeat: bool = True,
    skip_steps: int = 0,
) -> _Pipeline:
    """DALLE batches (input_fns.py:106-120). Image mode: JPEG + caption
    tfrecords become ``{"image": f32[B, size, size, C] in [-1, 1] (uint8
    pixels with ``dataset.uint8_images``), "caption": i32[B,
    text_seq_len]}``, decoded by the native pool (else on ``DECODE_WORKERS``
    threads with PIL); the trainer's
    frozen VAE tokenizes the images. Tokens mode (``dataset.tokens: true``):
    records carry ``{tokens: int64 list, caption: int64 list}``
    (``data/encode_dataset.py``) and batches are ``{"tokens": i32[B,
    image_seq_len], "caption": ...}``, parsed on one thread. Captions are
    padded with the padding id, then cut to ``text_seq_len``. ``shard`` and
    ``skip_steps`` as in ``vae_input_fn``."""
    ds = params["dataset"]
    path = ds["eval_path"] if eval else ds["train_path"]
    shard = _resolve_shard(shard)
    batch = _host_batch(params["eval_batch_size" if eval else "train_batch_size"], shard)
    text_seq_len = params["text_seq_len"]
    padding_id = params.get("padding_id")
    if padding_id is None:
        padding_id = 50257
    files = _shard_files(list_files(path), shard)

    def _caption(ex: dict) -> np.ndarray:
        caption = (list(ex.get("caption", [])) + [padding_id] * text_seq_len)[:text_seq_len]
        return np.asarray(caption, np.int32)

    if ds.get("tokens"):
        def parse(record: bytes) -> dict:
            ex = parse_example(record)
            return {"tokens": np.asarray(ex["tokens"], np.int32), "caption": _caption(ex)}

        workers, native_decode = 1, None
    else:
        size = ds["image_size"]
        channels = params.get("n_channels") or 3
        normalize = not ds.get("uint8_images")

        def parse(record: bytes) -> dict:
            ex = parse_example(record)
            return {"image": decode_img(ex["image"][0], size, channels, normalize=normalize),
                    "caption": _caption(ex)}

        workers = DECODE_WORKERS
        native_decode = {"size": size, "channels": channels, "text_len": text_seq_len,
                         "padding_id": padding_id, "uint8_out": not normalize}
    return _Pipeline(
        files, read_tfrecord_file, parse, batch,
        shuffle=not eval, repeat=repeat,
        skip_samples=skip_steps * batch,
        cycle_length=ds.get("cycle_length") or 4,
        num_workers=workers, native_decode=native_decode,
        readahead_depth=ds.get("readahead_depth"),
    )
