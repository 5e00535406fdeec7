"""Batching inference serving for DALLE sampling (port of
``dalle_mtf_tpu/serve.py``: the whole-batch engine and the HTTP front end).

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

The continuous-batching engine is not ported yet.
"""

from __future__ import annotations

import base64
import json
import logging
import queue
import struct
import threading
import time
import zlib
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

logger = logging.getLogger(__name__)


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
    ):
        from dalle_mtf_tpu_torch.sample import generate_images  # noqa: PLC0415

        self.dalle = dalle
        self.vae = vae
        self.batch_size = int(batch_size)
        self.temperature = float(temperature)  # default for requests
        self.top_k = int(top_k)                # default for requests
        self.top_k_buckets = tuple(sorted(set(top_k_buckets) | {int(top_k)}))
        self.max_retries = int(max_retries)
        self.linger_s = linger_ms / 1e3
        self._params = (dalle_params, vae_params)
        self._generate = generate_images
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
        if self._closed:
            raise RuntimeError("sampler is closed")
        n = int(n)
        if not 1 <= n <= self.batch_size:
            raise ValueError(f"n must be in [1, {self.batch_size}]")
        ids = list(text_tokens)
        if len(ids) != self.dalle.cfg.text_seq_len:
            raise ValueError(
                f"text must be tokenized+padded to {self.dalle.cfg.text_seq_len}"
            )
        temp = self.temperature if temperature is None else float(temperature)
        if not 0.0 <= temp <= 100.0:
            raise ValueError(f"temperature {temp} out of range [0, 100]")
        tp = 1.0 if top_p is None else float(top_p)
        if not 0.0 < tp <= 1.0:
            raise ValueError(f"top_p {tp} out of range (0, 1]")
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

    def _batch_generator(self) -> torch.Generator:
        """This batch's random stream: a generator on the model's device
        seeded from (seed, batch counter), as the JAX engine folds the
        counter into its key."""
        g = torch.Generator(device=self.dalle.device)
        g.manual_seed((self._seed * 2**32 + self._batch_counter) % 2**63)
        return g

    def _run(self):
        b = self.batch_size
        t_len = self.dalle.cfg.text_seq_len
        dev = self.dalle.device
        while True:
            batch = self._collect()
            if batch is None:
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
            retries = self.max_retries if exe in self._proven_buckets else 0
            for attempt in range(1 + retries):
                try:
                    imgs = self._generate(
                        self.dalle, self._params[0], self.vae, self._params[1],
                        torch.from_numpy(rows).to(dev),
                        self._batch_generator(),
                        temperature=torch.from_numpy(temps).to(dev),
                        top_k=bucket,
                        top_p=torch.from_numpy(topps).to(dev) if use_top_p else None,
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


# ------------------------------------------------------------------- HTTP

def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_b64(img: np.ndarray) -> str:
    """[H, W, 3] floats in [0, 1] -> base64 of an 8-bit RGB PNG, written
    with the standard library alone (zlib + struct)."""
    arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    h, w, _c = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))  # filter 0
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(raw))
        + _png_chunk(b"IEND", b"")
    )
    return base64.b64encode(png).decode()


def make_server(sampler: BatchingSampler, tokenizer, pad_len: int,
                host: str = "0.0.0.0", port: int = 8000,
                timeout_s: float = 120.0) -> ThreadingHTTPServer:
    """HTTP front end. POST /generate {"text": str, "n": int,
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
