"""The port's batching server (dalle_mtf_tpu_torch/serve.py), mirroring
tests/test_serve.py: queue batching, bad requests, retry only on proven
buckets, holdback order, drain, and the HTTP front end (/generate with PNGs
that decode, /healthz, /stats) — on a tiny model with seeded weights, on the
CPU."""

import base64
import json
import struct
import threading
import urllib.error
import urllib.request
import zlib
from concurrent.futures import wait

import numpy as np
import pytest
import torch

from dalle_mtf_tpu_torch.models.dalle import DALLE, DalleConfig
from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig
from dalle_mtf_tpu_torch.serve import BatchingSampler, _png_b64, make_server

CFG = DalleConfig(
    n_embd=32, text_vocab_size=48, image_vocab_size=16,
    text_seq_len=4, image_seq_len=4, n_layers=1, n_heads=2,
)
VCFG = VAEConfig(num_tokens=16, image_size=8, convblocks=((1, 8), (1, 8)))


def _sampler(**kw):
    dalle, vae = DALLE(CFG), DiscreteVAE(VCFG)
    kw = {"batch_size": 2, "top_k": 4, "linger_ms": 5.0, **kw}
    return BatchingSampler(
        dalle, dalle.init(torch.Generator().manual_seed(0)),
        vae, vae.init(torch.Generator().manual_seed(1)), **kw,
    )


@pytest.fixture(scope="module")
def sampler():
    s = _sampler(batch_size=4, linger_ms=20.0)
    yield s
    s.close()


def _png_pixels(b64):
    """Decode an 8-bit RGB, filter-0 PNG with the standard library."""
    data = base64.b64decode(b64)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert zlib.crc32(kind + body) & 0xFFFFFFFF == crc
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert (depth, color) == (8, 2)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_b64_roundtrips_pixels():
    img = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    got = _png_pixels(_png_b64(img))
    np.testing.assert_array_equal(got, np.clip(img * 255.0, 0, 255).astype(np.uint8))


class TestBatchingSampler:
    def test_single_request(self, sampler):
        imgs = sampler.submit([1, 2, 3, 0], n=2).result(timeout=120)
        assert imgs.shape == (2, 8, 8, 3)
        assert np.isfinite(imgs).all()

    def test_many_requests_batch_and_resolve(self, sampler):
        before = sampler._batch_counter
        futs = [sampler.submit([i, 0, 0, 0], n=1) for i in range(7)]
        done, not_done = wait(futs, timeout=240)
        assert not not_done
        for f in done:
            assert f.result().shape == (1, 8, 8, 3)
        # 7 single-row requests at batch_size=4 shared batches
        assert 2 <= sampler._batch_counter - before < 7

    def test_bad_requests_rejected(self, sampler):
        with pytest.raises(ValueError):
            sampler.submit([1, 2, 3], n=1)  # wrong text length
        with pytest.raises(ValueError):
            sampler.submit([1, 2, 3, 4], n=99)  # n > batch
        with pytest.raises(ValueError):
            sampler.submit([1, 2, 3, 4], n=1, temperature=-1.0)
        with pytest.raises(ValueError):
            sampler.submit([1, 2, 3, 0], n=1, top_p=1.5)

    def test_temperature_zero_is_greedy_deterministic(self, sampler):
        a = sampler.submit([5, 1, 0, 0], n=1, temperature=0.0).result(timeout=120)
        b = sampler.submit([5, 1, 0, 0], n=1, temperature=0.0).result(timeout=120)
        np.testing.assert_array_equal(a, b)

    def test_mixed_params_and_top_p_resolve(self, sampler):
        futs = [
            sampler.submit([i, 0, 0, 0], n=1, temperature=[0.0, 0.5, 1.0][i % 3],
                           top_k=[0, 3, 4][i % 3],
                           top_p=None if i % 2 else 0.8)
            for i in range(8)
        ]
        done, not_done = wait(futs, timeout=240)
        assert not not_done
        assert all(f.result().shape == (1, 8, 8, 3) for f in done)

    def test_exe_key_groups_by_top_p_presence(self):
        key = BatchingSampler._exe_key
        a = ([1, 0, 0, 0], 1, 1.0, 4, 1.0, None)   # no nucleus
        b = ([1, 0, 0, 0], 1, 1.0, 4, 0.9, None)   # nucleus
        c = ([1, 0, 0, 0], 1, 0.5, 4, 0.7, None)   # nucleus, other values
        assert key(a) != key(b)
        assert key(b) == key(c)


class TestHttpServer:
    def test_generate_health_and_stats(self, sampler):
        class Tok:
            pad_token_id = 47

            def encode(self, text):
                return [min(ord(c), 46) for c in text]

        srv = make_server(sampler, Tok(), CFG.text_seq_len, host="127.0.0.1", port=0)
        port = srv.server_address[1]
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
                assert json.load(r)["status"] == "ok"
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps({"text": "ab", "n": 2, "top_p": 0.9}).encode(),
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=240) as r:
                out = json.load(r)
            assert len(out["images"]) == 2
            assert _png_pixels(out["images"][0]).shape == (8, 8, 3)
            bad = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps({"n": 1}).encode(), method="POST",
            )
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(bad, timeout=30)
            assert ei.value.code == 400
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
                st = json.load(r)
            assert st["engine"] == "whole-batch" and st["batch_size"] == 4
            assert st["batches_done"] >= 1 and "queue_depth" in st
        finally:
            srv.shutdown()
            srv.server_close()
            t.join(timeout=30)
        assert not t.is_alive()


class TestRetry:
    def test_midbatch_failure_retried_once(self):
        s = _sampler()
        real = s._generate
        calls = {"n": 0}

        def flaky(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("transient runtime blip")
            return real(*a, **kw)

        s._generate = flaky
        try:
            s.submit([1, 0, 0, 0], n=1).result(timeout=240)  # proves the bucket
            imgs = s.submit([1, 0, 0, 0], n=1).result(timeout=240)
            assert imgs.shape == (1, 8, 8, 3)
            assert calls["n"] == 3  # proven, failed once, retried
        finally:
            s.close()

    def test_first_call_failure_not_retried(self):
        s = _sampler()
        calls = {"n": 0}

        def broken(*a, **kw):
            calls["n"] += 1
            raise RuntimeError("deterministic failure")

        s._generate = broken
        try:
            with pytest.raises(RuntimeError, match="deterministic"):
                s.submit([1, 0, 0, 0], n=1).result(timeout=120)
            assert calls["n"] == 1
        finally:
            s.close()


def test_oversize_request_seeds_next_batch():
    s = _sampler(linger_ms=300.0)
    try:
        order = []
        f1 = s.submit([1, 0, 0, 0], n=1)
        f2 = s.submit([2, 0, 0, 0], n=2)  # can't join f1's batch
        f3 = s.submit([3, 0, 0, 0], n=1)  # arrives after f2
        f2.add_done_callback(lambda _: order.append(2))
        f3.add_done_callback(lambda _: order.append(3))
        done, not_done = wait([f1, f2, f3], timeout=240)
        assert not not_done
        assert order[0] == 2, order
    finally:
        s.close()


def test_drain_serves_queued_then_stops():
    s = _sampler()
    futs = [s.submit([i, 0, 0, 0], n=1) for i in range(5)]
    s.drain(timeout=240)
    assert not s._worker.is_alive()
    for f in futs:
        assert f.result(timeout=1).shape == (1, 8, 8, 3)
    with pytest.raises(RuntimeError, match="closed"):
        s.submit([1, 0, 0, 0], n=1)
