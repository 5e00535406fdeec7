"""Background read-ahead for record streams (copy of
``dalle_mtf_tpu/data/readahead.py``, which is JAX-free; importing it from the
JAX package would run that package's ``__init__``, which imports JAX).

The reference's GCS input ran through tf.data's C++ parallel_interleave
(src/input_fns.py:85-104): every open shard keeps fetches in flight so
network latency never stalls the training input. Locally this repo gets the
same property from the io_uring reader (native/dataloader.cpp); REMOTE
shards (gs://, s3://, memory://) stream through the pure-Python record
reader, where a synchronous ``next()`` blocks the whole interleave on every
backend fetch.

``prefetch_iter`` moves a source iterator onto a daemon thread with a
bounded record queue, so each open shard's network reads overlap both each
other and the decode/train loop — the Python-side equivalent of
parallel_interleave's per-shard pipelining. Record ORDER is unchanged
(thread timing can never reorder a single queue), so the interleave stays
byte-identical with the synchronous reader; only the blocking moves.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

_SENTINEL = object()


def prefetch_iter(source: Iterator[Any], depth: int = 64) -> Iterator[Any]:
    """Iterate ``source`` on a background thread, buffering up to ``depth``
    items. Exceptions in the source re-raise at the consuming ``next()``.
    The thread is a daemon and also exits promptly if the consumer drops
    the iterator mid-stream (the queue's free slots are released on gc)."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that honors ``stop`` — every producer-side put must
        go through this, or an abandoned consumer (full queue, nobody
        draining) would pin the thread and its buffer forever."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def run() -> None:
        try:
            for item in source:
                if not _put(item):
                    return
            _put(_SENTINEL)
        except BaseException as e:  # propagate to the consumer
            _put(e)

    t = threading.Thread(target=run, daemon=True, name="readahead")
    t.start()

    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
