"""Batching inference serving for DALLE sampling (port of
``dalle_mtf_tpu/serve.py``: both engines and the HTTP front end).

``BatchingSampler``, the whole-batch engine:

- one fixed server batch size: short batches are padded with dummy rows and
  the extras discarded (decode cost is dominated by weight streaming, so
  padded rows are nearly free until the batch is full);
- ``temperature`` and ``top_p`` are per-request, per-row [B] tensors;
  ``top_k`` is rounded up into a small bucket set and a batch holds one
  bucket (and one top_p presence), as the JAX engine groups requests by
  compiled executable;
- one worker thread owns the device. Linger (default 5 ms) trades a little
  latency for batching under load. A failed call of a PROVEN bucket (one
  that has succeeded before) is retried once; a bucket's first call fails
  fast. The final failure surfaces to every waiter in the batch.

Each engine decodes through one ``sample.CapturedDecoder``: its KV cache and
buffers for the engine's life, and on the card a CUDA graph of one decode
step for each whole-batch bucket (captured on first use) or the continuous
chunk, replayed step after step; its generator, registered with the graphs,
is reseeded per batch (per reset, in the continuous engine) from (seed,
counter). A retry replays the same graph: there is no eager fallback.

``ContinuousBatchingSampler`` admits requests into free slots of a live
batch at chunk boundaries (see its docstring). Both engines share the client
API (``submit`` -> Future, ``drain``, ``close``, ``stats``), so
``make_server`` serves either.

Over a tensor-parallel model group (one process a rank, where the JAX
server is one controller over every device) each rank builds the engine on
its blocks with a ``GroupCommands``. Rank 0 alone takes requests: it owns
the queue, the batching, the linger and the futures, and its worker sends
the group one fixed-layout order before each device call (a whole batch;
in the continuous engine each reset, admission, park and chunk). Every
other rank runs ``follow``: it executes the same call on its blocks, and
returns on the stop that ``drain``/``close`` send. The orders wait for
rank 0 without a limit (an idle server sends none); the model's own
collectives keep the process group's timeout, so a rank that fails makes
the others' collectives raise, and the error reaches every waiting future
on rank 0. After such an error the group is broken and the engine closes.
Rank 0 alone decodes pixels with the VAE.
"""

from __future__ import annotations

import base64
import datetime
import json
import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from dalle_mtf_tpu_torch.utils.png import encode_png

logger = logging.getLogger(__name__)


class GroupCommands:
    """Rank 0's orders to every rank of a serving launch: one float64
    tensor of a fixed layout a call, broadcast from rank 0 over a gloo group
    of the whole world whose waits have no practical limit (``LIMIT``). The
    layout: the operation, the seed (in two 32-bit halves), the top_k, the
    nucleus flag, then the batch's texts [B, T], the per-row temperature,
    top_k and top_p, and the row mask. Every value is exact in float64.
    Every rank constructs it (``new_group`` is collective)."""

    STOP, GENERATE, RESET, ADMIT, PARK, CHUNK = range(6)
    LIMIT = datetime.timedelta(days=7)
    _HEAD = 5

    def __init__(self, batch: int, text_len: int):
        import torch.distributed as dist  # noqa: PLC0415

        self._dist = dist
        self.rank = dist.get_rank()
        self.batch, self.text_len = int(batch), int(text_len)
        self.group = dist.new_group(list(range(dist.get_world_size())), backend="gloo",
                                    timeout=self.LIMIT)
        self.sent = 0

    def _buffer(self) -> torch.Tensor:
        return torch.zeros(self._HEAD + self.batch * (self.text_len + 4), dtype=torch.float64)

    def send(self, op: int, seed: int = 0, texts=None, temperature=None, top_k: int = 0,
             top_k_rows=None, top_p=None, mask=None, nucleus: bool = False) -> None:
        """Broadcast one order (rank 0)."""
        b, t = self.batch, self.text_len
        buf = self._buffer()
        buf[:self._HEAD] = torch.tensor([op, seed >> 32, seed & 0xFFFFFFFF, top_k, nucleus],
                                        dtype=torch.float64)
        body = buf[self._HEAD:]
        for i, value in enumerate((texts, temperature, top_k_rows, top_p, mask)):
            if value is None:
                continue
            lo, n = (0, b * t) if i == 0 else (b * t + (i - 1) * b, b)
            value = torch.as_tensor(value).detach().cpu().to(torch.float64).reshape(-1)
            body[lo:lo + n] = value.expand(n) if value.numel() == 1 else value
        self._dist.broadcast(buf, 0, group=self.group)
        self.sent += 1

    def receive(self) -> dict:
        """The next order (every rank but 0): texts long [B, T] and mask
        bool [B] on the CPU, per-row float32 / long [B]."""
        b, t = self.batch, self.text_len
        buf = self._buffer()
        self._dist.broadcast(buf, 0, group=self.group)
        head, body = buf[:self._HEAD].long().tolist(), buf[self._HEAD:]
        rows = [body[b * t + i * b:b * t + (i + 1) * b] for i in range(4)]
        return dict(op=head[0], seed=(head[1] << 32) | head[2], top_k=head[3],
                    nucleus=bool(head[4]), texts=body[:b * t].long().reshape(b, t),
                    temperature=rows[0].float(), top_k_rows=rows[1].long(),
                    top_p=rows[2].float(), mask=rows[3].bool())


def follow(sampler) -> None:
    """The follower loop of either engine on a rank other than 0: execute
    rank 0's orders on this rank's blocks until the stop."""
    cmds, dec = sampler._commands, sampler._decoder
    dev = sampler.dalle.device
    while True:
        c = cmds.receive()
        op = c["op"]
        if op == GroupCommands.STOP:
            return
        if op == GroupCommands.GENERATE:
            dec.generator.manual_seed(c["seed"])
            dec.generate(c["texts"].to(dev), c["temperature"], c["top_k"],
                         c["top_p"] if c["nucleus"] else None)
        elif op == GroupCommands.RESET:
            dec.reset(c["seed"])
        elif op == GroupCommands.ADMIT:
            dec.admit(c["texts"].to(dev), c["mask"].to(dev))
        elif op == GroupCommands.PARK:
            _park_rows(dec, c["mask"], sampler._end_pos)
        elif op == GroupCommands.CHUNK:
            dec.decode_chunk(c["temperature"], c["top_k_rows"], c["top_p"], k_max=sampler.k_max)
        else:
            raise ValueError(f"unknown serving order {op}")


def _park_rows(decoder, mask, end_pos: int) -> None:
    """Park the ``mask`` rows (bool [B]) of the decoder's batch at the end."""
    positions = decoder.positions
    with torch.inference_mode():
        positions[mask.to(positions.device)] = end_pos


def _safe_resolve(fut: Future, result=None, exc=None) -> bool:
    """Resolve a Future exactly once, racing client-side cancel() (an
    unguarded set_result after a cancel raises InvalidStateError and would
    kill the worker thread)."""
    try:
        if fut.cancelled() or fut.done():
            return False
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
        return True
    except Exception:  # InvalidStateError: lost the race — request is dead
        return False


def _check_request(sampler, text_tokens, n, temperature, top_p):
    """Validate one request against ``sampler`` (either engine); returns
    (ids, n, temperature, top_p) with the sampler's defaults filled in."""
    if sampler._closed:
        raise RuntimeError("sampler is closed")
    n = int(n)
    if not 1 <= n <= sampler.batch_size:
        raise ValueError(f"n must be in [1, {sampler.batch_size}]")
    ids = list(text_tokens)
    if len(ids) != sampler.dalle.cfg.text_seq_len:
        raise ValueError(
            f"text must be tokenized+padded to {sampler.dalle.cfg.text_seq_len}"
        )
    temp = sampler.temperature if temperature is None else float(temperature)
    if not 0.0 <= temp <= 100.0:
        raise ValueError(f"temperature {temp} out of range [0, 100]")
    tp = 1.0 if top_p is None else float(top_p)
    if not 0.0 < tp <= 1.0:
        raise ValueError(f"top_p {tp} out of range (0, 1]")
    return ids, n, temp, tp


class BatchingSampler:
    """Queue + worker around ``sample.generate_images``."""

    def __init__(
        self,
        dalle,
        dalle_params,
        vae,
        vae_params,
        batch_size: int = 4,
        temperature: float = 1.0,
        top_k: int = 64,
        linger_ms: float = 5.0,
        seed: int = 0,
        top_k_buckets=(0, 16, 64, 256),
        max_retries: int = 1,
        commands: GroupCommands | None = None,
    ):
        from dalle_mtf_tpu_torch.sample import CapturedDecoder  # noqa: PLC0415

        self.dalle = dalle
        self.vae = vae
        self.batch_size = int(batch_size)
        self.temperature = float(temperature)  # default for requests
        self.top_k = int(top_k)                # default for requests
        self.top_k_buckets = tuple(sorted(set(top_k_buckets) | {int(top_k)}))
        self.max_retries = int(max_retries)
        self.linger_s = linger_ms / 1e3
        self._params = (dalle_params, vae_params)
        self._decoder = CapturedDecoder(dalle, dalle_params, self.batch_size)
        self._commands = commands
        self._seed = int(seed)
        self._batch_counter = 0
        # buckets that have completed at least once: only those are retried
        self._proven_buckets: set = set()
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()
        # requests that didn't fit (or didn't match the in-flight bucket):
        # FIFO, seeds the next batches ahead of newer arrivals
        self._holdback: deque = deque()
        self._worker = threading.Thread(target=self._run, daemon=True)
        if not _follows(commands):
            self._worker.start()

    # ------------------------------------------------------------ client API

    def _bucket(self, top_k: int) -> int:
        """Round a requested top_k UP into the bucket set (a slightly larger
        k only widens the candidate pool)."""
        k = int(top_k)
        if k <= 0:
            return 0
        for b in self.top_k_buckets:
            if b >= k > 0 and b > 0:
                return b
        # k above every bucket: honor the round-UP contract by dropping the
        # truncation entirely (bucket 0 = full vocab, a strictly WIDER pool)
        if 0 in self.top_k_buckets:
            logger.warning(
                "top_k=%d above every bucket %s; serving untruncated",
                k, self.top_k_buckets,
            )
            return 0
        logger.warning(
            "top_k=%d above every bucket %s and no 0 (untruncated) bucket "
            "configured; serving the widest bucket %d (narrower than "
            "requested)", k, self.top_k_buckets, max(self.top_k_buckets),
        )
        return max(self.top_k_buckets)

    def submit(self, text_tokens, n: int = 1, temperature=None,
               top_k=None, top_p=None) -> Future:
        """Enqueue one request: ``n`` images of one tokenized text
        (list[int] of length text_seq_len), with optional per-request
        sampling params (``top_p`` < 1 = nucleus sampling over the top-k
        candidate set). Resolves to f32[n, H, W, C] in [0, 1]."""
        ids, n, temp, tp = _check_request(self, text_tokens, n, temperature, top_p)
        kb = self._bucket(self.top_k if top_k is None else top_k)
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:  # close() may have won the race
                raise RuntimeError("sampler is closed")
            self._q.put((ids, n, temp, kb, tp, fut))
        return fut

    def close(self):
        """Shutdown. Drains: the sentinel is FIFO behind queued requests and
        the worker empties the holdback before reading it."""
        self.drain(timeout=30)

    def drain(self, timeout: float | None = None):
        """Graceful shutdown: stop accepting, serve everything already
        queued, then stop."""
        with self._submit_lock:
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=timeout)

    def stats(self) -> dict:
        """Live engine counters (served by the HTTP /stats endpoint)."""
        return {
            "engine": "whole-batch",
            "batch_size": self.batch_size,
            "queue_depth": self._q.qsize(),
            "holdback": len(self._holdback),
            "batches_done": self._batch_counter,
        }

    # ---------------------------------------------------------------- worker

    @staticmethod
    def _exe_key(item):
        """What a batch must share: the top_k bucket, plus whether nucleus
        sampling is active."""
        return (item[3], item[4] < 1.0)

    def _collect(self):
        """Block for one request, then linger briefly for batch-mates whose
        rows still fit AND share its key. A request that doesn't fit (or
        mismatches) is held back FIFO to seed the following batches."""
        if self._holdback:
            item = self._holdback.popleft()
        else:
            item = self._q.get()
            if item is None:
                return None
        batch = [item]
        rows = item[1]
        key = self._exe_key(item)
        while self._holdback:
            nxt = self._holdback[0]
            if self._exe_key(nxt) != key or rows + nxt[1] > self.batch_size:
                break
            batch.append(self._holdback.popleft())
            rows += nxt[1]
        deadline = time.monotonic() + self.linger_s
        while rows < self.batch_size:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-deliver shutdown to the outer loop
                break
            if self._exe_key(nxt) != key:
                self._holdback.append(nxt)
                continue
            if rows + nxt[1] > self.batch_size:
                self._holdback.append(nxt)
                break
            batch.append(nxt)
            rows += nxt[1]
        return batch

    def _batch_seed(self) -> int:
        """This batch's random stream: the decoder's generator is seeded
        from (seed, batch counter), as the JAX engine folds the counter into
        its key."""
        return (self._seed * 2**32 + self._batch_counter) % 2**63

    def _generate(self, texts, seed, temperature, top_k, top_p):
        """One batch through the decoder (the graph of ``top_k`` and top_p
        presence on the card), then the VAE: f32 [B, H, W, C]. Under a
        model group the other ranks are sent the batch first."""
        if self._commands is not None:
            self._commands.send(GroupCommands.GENERATE, seed, texts, temperature, top_k,
                                top_p=top_p, nucleus=top_p is not None)
        self._decoder.generator.manual_seed(seed)
        tokens = self._decoder.generate(texts, temperature, top_k, top_p)
        with torch.inference_mode():
            return self.vae.decode_tokens(self._params[1], tokens)

    def _run(self):
        b = self.batch_size
        t_len = self.dalle.cfg.text_seq_len
        dev = self.dalle.device
        while True:
            batch = self._collect()
            if batch is None:
                _stop(self._commands)
                return
            rows = np.zeros((b, t_len), np.int64)
            temps = np.full((b,), 1.0, np.float32)
            topps = np.ones((b,), np.float32)
            bucket, use_top_p = self._exe_key(batch[0])
            r = 0
            for ids, n, temp, _kb, tp, _fut in batch:
                rows[r:r + n] = np.asarray(ids, np.int64)
                temps[r:r + n] = temp
                topps[r:r + n] = tp
                r += n
            self._batch_counter += 1
            t0 = time.perf_counter()
            err = None
            imgs = None
            exe = (bucket, use_top_p)
            # under a model group a failed batch leaves the group broken: no retry
            retries = (self.max_retries if exe in self._proven_buckets
                       and self._commands is None else 0)
            for attempt in range(1 + retries):
                try:
                    imgs = self._generate(
                        torch.from_numpy(rows).to(dev), self._batch_seed(),
                        temperature=temps, top_k=bucket,
                        top_p=topps if use_top_p else None,
                    )
                    imgs = imgs.float().cpu().numpy()
                    self._proven_buckets.add(exe)
                    err = None
                    break
                except Exception as e:
                    # retry covers transient failures of a PROVEN bucket; a
                    # bucket that never succeeded fails fast
                    err = e
                    if attempt < retries:
                        logger.warning(
                            "batch failed (attempt %d), retrying: %s",
                            attempt + 1, e,
                        )
            if err is not None:  # surface failures to every waiter
                if self._commands is not None:  # the model group is broken
                    _close_broken(self, err, lambda: [
                        item[-1] for item in [*batch, *self._holdback, *_queued(self._q)]
                        if item is not None])
                    return
                for *_rest, fut in batch:
                    _safe_resolve(fut, exc=err)
                continue
            logger.info(
                "batch of %d request(s) / %d row(s) top_k=%d%s in %.2fs",
                len(batch), r, bucket, " +top_p" if use_top_p else "",
                time.perf_counter() - t0,
            )
            r = 0
            for _ids, n, _t, _kb, _tp, fut in batch:
                _safe_resolve(fut, result=imgs[r:r + n])
                r += n


_DRAIN = object()  # graceful-shutdown sentinel (None = hard stop)


def _follows(commands: GroupCommands | None) -> bool:
    """Whether an engine with ``commands`` runs rank 0's orders (every rank
    but 0) instead of a worker of its own."""
    return commands is not None and commands.rank != 0


def _queued(q: queue.Queue) -> list:
    """Every item in ``q`` now, taken out."""
    items = []
    while True:
        try:
            items.append(q.get_nowait())
        except queue.Empty:
            return items


def _close_broken(sampler, err: Exception, pending) -> None:
    """Close an engine whose model group is broken: take no more requests,
    fail every future that ``pending()`` lists (called once the engine is
    closed, so no request joins the queue after it is read), and send the
    followers the stop."""
    with sampler._submit_lock:
        sampler._closed = True
    for fut in pending():
        _safe_resolve(fut, exc=err)
    _stop(sampler._commands)


def _stop(commands: GroupCommands | None) -> None:
    """Send the followers the stop (rank 0, as its worker ends)."""
    if commands is None:
        return
    try:
        commands.send(GroupCommands.STOP)
    except Exception:  # a broken group: the followers' own waits end them
        logger.exception("could not send the followers the stop")


class ContinuousBatchingSampler:
    """Slot-level continuous batching for fixed-length image generation:
    requests join a live batch at chunk boundaries instead of waiting out
    the in-flight whole-image generation.

    The device loop is ``chunk`` steps of ``sample.CapturedDecoder``
    (on the card one graph at ``k_max``, replayed ``chunk`` times). Between
    chunks, finished rows leave (their image decodes and resolves at once),
    cancelled rows are reaped, and queued requests are admitted into free
    slots by a masked prefill (``sample.admit_rows``). A request of ``n``
    images takes ``n`` slots and resolves when all of them finish.

    Per-request sampling parameters need no buckets: ``top_k`` is a per-row
    rank mask over one ``k_max``-wide candidate set (k = 0, or k > k_max,
    is served untruncated: wider, never narrower); ``temperature`` and
    ``top_p`` are per-row vectors.

    Failure policy: a failed device call leaves the batch's state (cache,
    logits, positions) half updated, so every in-flight request gets the
    error and the engine resets to empty slots.
    """

    def __init__(
        self,
        dalle,
        dalle_params,
        vae,
        vae_params,
        batch_size: int = 4,
        temperature: float = 1.0,
        top_k: int = 64,
        seed: int = 0,
        chunk: int = 128,
        k_max: int = 256,
        commands: GroupCommands | None = None,
    ):
        from dalle_mtf_tpu_torch.sample import CapturedDecoder  # noqa: PLC0415

        self.dalle = dalle
        self.vae = vae
        self.batch_size = int(batch_size)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.chunk = int(chunk)
        self.k_max = int(k_max)
        self._params = (dalle_params, vae_params)
        cfg = dalle.cfg
        # the cache, the batch's buffers and the banded head, for the
        # engine's life
        self._decoder = CapturedDecoder(dalle, dalle_params, self.batch_size, chunk=self.chunk)
        self._commands = commands
        self._end_pos = cfg.text_seq_len + cfg.image_seq_len
        self._chunks_done = 0
        self._admits_done = 0
        self._resets = -1
        self._seed = int(seed)
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._draining = False
        self._submit_lock = threading.Lock()
        self._reset_state(send=False)  # every rank resets alike here
        self._worker = threading.Thread(target=self._run, daemon=True)
        if not _follows(commands):
            self._worker.start()

    # ------------------------------------------------------------ client API

    def _effective_top_k(self, top_k) -> int:
        k = int(self.top_k if top_k is None else top_k)
        if k <= 0:
            return 0
        if k > self.k_max:
            logger.warning("top_k=%d above k_max=%d; serving untruncated", k, self.k_max)
            return 0
        return k

    def submit(self, text_tokens, n: int = 1, temperature=None,
               top_k=None, top_p=None) -> Future:
        """Same contract as ``BatchingSampler.submit``."""
        ids, n, temp, tp = _check_request(self, text_tokens, n, temperature, top_p)
        k = self._effective_top_k(top_k)
        fut: Future = Future()
        group = {"fut": fut, "images": [None] * n}
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("sampler is closed")
            for i in range(n):
                self._q.put((ids, temp, k, tp, group, i))
        return fut

    def close(self):
        """Hard stop: in-flight generations get RuntimeError."""
        with self._submit_lock:
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=30)

    def drain(self, timeout: float | None = None):
        """Graceful shutdown: stop accepting, run until every queued request
        has been admitted, generated and resolved, then stop."""
        with self._submit_lock:
            self._closed = True
            self._q.put(_DRAIN)
        self._worker.join(timeout=timeout)

    def stats(self) -> dict:
        """Live engine counters (served by the HTTP /stats endpoint)."""
        return {
            "engine": "continuous",
            "slots_total": self.batch_size,
            "slots_busy": sum(s is not None for s in self._slot),
            "queue_depth": self._q.qsize(),
            "chunks_done": self._chunks_done,
            "admits_done": self._admits_done,
            "chunk": self.chunk,
        }

    # ---------------------------------------------------------------- engine

    def _reset_state(self, send: bool = True):
        b = self.batch_size
        # every slot parked at the end: none advances until something is
        # admitted; a reset counter in the seed: two identical requests
        # before and after a reset must not replay one sampling stream
        self._resets += 1
        seed = (self._seed * 2**32 + self._resets) % 2**63
        if send and self._commands is not None:
            self._commands.send(GroupCommands.RESET, seed)
        self._decoder.reset(seed)
        self._temps = np.full((b,), 1.0, np.float32)
        self._topks = np.zeros((b,), np.int64)
        self._topps = np.ones((b,), np.float32)
        # per-slot host bookkeeping: None = free
        self._slot: list[dict | None] = [None] * b
        self._slot_tokens: list[list[int]] = [[] for _ in range(b)]

    def _fail_all(self, err: Exception):
        # one exception per GROUP: an n > 1 request's rows share one Future
        seen: set[int] = set()
        for s in self._slot:
            if s is not None and id(s["group"]) not in seen:
                seen.add(id(s["group"]))
                _safe_resolve(s["group"]["fut"], exc=err)
        self._reset_state()

    def _park(self, slots: list[int]):
        mask = torch.zeros((self.batch_size,), dtype=torch.bool)
        mask[slots] = True
        if self._commands is not None:
            self._commands.send(GroupCommands.PARK, mask=mask)
        _park_rows(self._decoder, mask, self._end_pos)

    def _decode_chunk(self):
        """One chunk from the decoder's buffers; (tokens, active) [chunk, B]
        on the host."""
        if self._commands is not None:
            self._commands.send(GroupCommands.CHUNK, temperature=self._temps,
                                top_k_rows=self._topks, top_p=self._topps)
        tokens, active = self._decoder.decode_chunk(
            self._temps, self._topks, self._topps, k_max=self.k_max)
        return tokens.cpu().numpy(), active.cpu().numpy()

    def _reap_cancelled(self):
        """Free the slots of cancelled requests: park them so they stop
        advancing, and admit new work in their place."""
        cancelled = [i for i, s in enumerate(self._slot)
                     if s is not None and s["group"]["fut"].cancelled()]
        if not cancelled:
            return
        for slot in cancelled:
            self._slot[slot] = None
            self._slot_tokens[slot] = []
        self._park(cancelled)
        logger.info("reaped %d cancelled slot(s): %s", len(cancelled), cancelled)

    def _admit(self) -> bool | None:
        """Fill free slots from the queue. Blocks when the batch is idle;
        returns None on shutdown, else whether anything was admitted."""
        free = [i for i, s in enumerate(self._slot) if s is None]
        idle = len(free) == len(self._slot)
        admitted = []
        while free:
            try:
                item = self._q.get(block=idle and not admitted and not self._draining)
            except queue.Empty:
                break
            if item is None:
                return None
            if item is _DRAIN:
                self._draining = True
                continue  # everything queued before it is still served
            ids, temp, k, tp, group, idx = item
            if group["fut"].cancelled() or group["fut"].done():
                continue  # cancelled while queued, or its group already failed
            slot = free.pop(0)
            self._slot[slot] = {"group": group, "idx": idx, "t0": time.perf_counter()}
            self._slot_tokens[slot] = []
            self._temps[slot], self._topks[slot], self._topps[slot] = temp, k, tp
            admitted.append((slot, ids))
        if not admitted:
            return False
        b, t_len = self.batch_size, self.dalle.cfg.text_seq_len
        texts = np.zeros((b, t_len), np.int64)
        mask = np.zeros((b,), bool)
        for slot, ids in admitted:
            texts[slot] = np.asarray(ids, np.int64)
            mask[slot] = True
        dev = self.dalle.device
        if self._commands is not None:
            self._commands.send(GroupCommands.ADMIT, texts=texts, mask=mask)
        self._decoder.admit(torch.from_numpy(texts).to(dev), torch.from_numpy(mask).to(dev))
        self._admits_done += 1
        logger.info("admitted %d request row(s) into slots %s",
                    len(admitted), [slot for slot, _ in admitted])
        return True

    def _finish_rows(self, finished: list[int]):
        """VAE-decode the finished slots (one full-batch call; idle rows
        decode zeros and are discarded) and resolve every group whose rows
        are all done."""
        toks = np.zeros((self.batch_size, self.dalle.cfg.image_seq_len), np.int64)
        for slot in finished:
            toks[slot] = np.asarray(self._slot_tokens[slot], np.int64)
        with torch.inference_mode():
            imgs = self.vae.decode_tokens(
                self._params[1], torch.from_numpy(toks).to(self.dalle.device))
        imgs = imgs.float().cpu().numpy()
        for slot in finished:
            s = self._slot[slot]
            g = s["group"]
            g["images"][s["idx"]] = imgs[slot]
            logger.info("slot %d finished in %.2fs", slot, time.perf_counter() - s["t0"])
            self._slot[slot] = None
            self._slot_tokens[slot] = []
            if all(im is not None for im in g["images"]):
                _safe_resolve(g["fut"], result=np.stack(g["images"]))

    def _run(self):
        # every device call and the host bookkeeping sit under one guard: a
        # failure leaves the batch's state half updated, so the policy is
        # fail everyone + reset; an unguarded exception would kill the
        # worker and hang every outstanding Future
        image_len = self.dalle.cfg.image_seq_len
        while True:
            try:
                self._reap_cancelled()  # freed slots admit work right away
                got = self._admit()
                if got is None:
                    self._fail_all(RuntimeError("sampler is closed"))
                    _stop(self._commands)
                    return
                if all(s is None for s in self._slot):
                    if self._draining and self._q.empty():
                        _stop(self._commands)
                        return  # drained: everything served, nothing queued
                    continue
                tokens, active = self._decode_chunk()
                self._chunks_done += 1
                finished = []
                for slot, s in enumerate(self._slot):
                    if s is None:
                        continue
                    self._slot_tokens[slot].extend(tokens[active[:, slot], slot].tolist())
                    if len(self._slot_tokens[slot]) >= image_len:
                        finished.append(slot)
                if finished:
                    self._finish_rows(finished)
            except Exception as e:
                logger.exception("engine step failed; resetting")
                if self._commands is None:
                    self._fail_all(e)
                    continue
                # a model group's collectives failed with it: close
                groups = {id(s["group"]): s["group"]["fut"] for s in self._slot if s is not None}
                _close_broken(self, e, lambda: [*groups.values(), *(
                    item[4]["fut"] for item in _queued(self._q) if isinstance(item, tuple))])
                return


# ------------------------------------------------------------------- HTTP

def _png_b64(img: np.ndarray) -> str:
    """[H, W, 3] floats in [0, 1] -> base64 of an 8-bit RGB PNG."""
    return base64.b64encode(encode_png(img)).decode()


def make_server(sampler: BatchingSampler | ContinuousBatchingSampler,
                tokenizer, pad_len: int,
                host: str = "0.0.0.0", port: int = 8000,
                timeout_s: float = 120.0) -> ThreadingHTTPServer:
    """HTTP front end (either engine). POST /generate {"text": str, "n": int,
    "temperature": float?, "top_k": int?, "top_p": float?} ->
    {"images": [<b64 png>...], "latency_s": float}; GET /healthz -> ok;
    GET /stats -> live engine counters."""
    from dalle_mtf_tpu_torch.data.tokenizer import pad_or_truncate  # noqa: PLC0415

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug("http: " + fmt, *args)

        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/stats":
                self._reply(200, sampler.stats())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                text = req["text"]
                n = int(req.get("n", 1))
                ids = pad_or_truncate(
                    tokenizer.encode(text), pad_len, tokenizer.pad_token_id
                )
                t0 = time.perf_counter()
                fut = sampler.submit(
                    ids, n, temperature=req.get("temperature"),
                    top_k=req.get("top_k"), top_p=req.get("top_p"),
                )
                try:
                    imgs = fut.result(timeout=timeout_s)
                except FuturesTimeoutError:
                    fut.cancel()
                    self._reply(504, {"error": f"timed out after {timeout_s}s"})
                    return
                self._reply(200, {
                    "images": [_png_b64(im) for im in imgs],
                    "latency_s": round(time.perf_counter() - t0, 3),
                })
            except (KeyError, ValueError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # pragma: no cover - server-side failure
                logger.exception("generate failed")
                self._reply(500, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)
