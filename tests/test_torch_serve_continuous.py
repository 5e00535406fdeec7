"""Continuous batching in the port (serve.ContinuousBatchingSampler, the
per-row decode of models/dalle.py and sample.py), the cases of
tests/test_serve_continuous.py at a small size on the CPU, plus the per-row
decode step and sampler against the JAX package.

The load-bearing check is greedy equivalence: at temperature 0 a request
served by the continuous engine, whatever slots it shares and whenever it
was admitted, gives exactly the image of a run of the whole-batch path
(sample.generate_images). That pins the per-row cache writes, the per-row
attention masks, the masked prefill and the parking of finished rows.

Tolerances: ``decode_step_rows`` against JAX's in fp32, atol 1e-4 (same math
through two layers, another summation order); the port's per-row step with
equal positions against its own ``decode_step``: equal bit for bit.
"""

import json
import threading
import time
import urllib.request
from concurrent.futures import wait

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu import quantize as jq
from dalle_mtf_tpu import sample as jsample
from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu_torch import sample as tsample
from dalle_mtf_tpu_torch.models.dalle import DALLE, DalleConfig
from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig
from dalle_mtf_tpu_torch.quantize import quantize_layers_int8
from dalle_mtf_tpu_torch.sample import generate_images
from dalle_mtf_tpu_torch.serve import (
    BatchingSampler,
    ContinuousBatchingSampler,
    make_server,
)
from dalle_mtf_tpu_torch.utils.convert import dalle_params_from_numpy

# one convblock: the 8 px VAE grid is 4x4 = 16 image tokens, matching
# image_seq_len (several chunks per image at chunk 3-4)
CFG = DalleConfig(
    n_embd=32, text_vocab_size=48, image_vocab_size=16,
    text_seq_len=4, image_seq_len=16, n_layers=2, n_heads=2,
)
VCFG = VAEConfig(num_tokens=16, image_size=8, convblocks=((1, 8),))


@pytest.fixture(scope="module")
def models():
    dalle, vae = DALLE(CFG, "cpu"), DiscreteVAE(VCFG, "cpu")
    return (dalle, dalle.init(torch.Generator().manual_seed(0)),
            vae, vae.init(torch.Generator().manual_seed(1)))


def _solo_greedy(models, ids, batch):
    """The whole-batch path's greedy image for ``ids``, run at the engine's
    batch size: the CPU's matmuls and convolutions may round a row
    differently at another batch size, never for other rows' contents."""
    dalle, dparams, vae, vparams = models
    return generate_images(
        dalle, dparams, vae, vparams, torch.tensor([ids] * batch),
        torch.Generator().manual_seed(7), temperature=0.0, top_k=0,
    )[0].numpy()


def _engine(models, **kw):
    dalle, dparams, vae, vparams = models
    kw = {"batch_size": 2, "temperature": 0.0, "top_k": 0, "chunk": 4, "k_max": 8, **kw}
    return ContinuousBatchingSampler(dalle, dparams, vae, vparams, **kw)


# ------------------------------------------------------- per-row decode step

def test_decode_step_rows_matches_jax_at_staggered_positions():
    kw = dict(n_embd=64, text_vocab_size=40, image_vocab_size=32, text_seq_len=8,
              image_seq_len=16, n_layers=2, n_heads=2)
    jm = jdalle.DALLE(jdalle.DalleConfig(**kw))
    tm = DALLE(DalleConfig(**kw), "cpu")
    for quantized in (False, True):
        jparams = jax.device_get(jm.init(jax.random.PRNGKey(5)))
        if quantized:
            jparams = jax.device_get(jq.quantize_layers_int8(jparams))
        tparams = dalle_params_from_numpy(jparams, tm)
        rng = np.random.default_rng(6)
        cache = rng.standard_normal((2, 3, 2, 24, 32)).astype(np.float32)
        jcache = {"k": jnp.asarray(cache), "v": jnp.asarray(cache[::-1])}
        tcache = {"k": torch.from_numpy(cache.copy()),
                  "v": torch.from_numpy(cache[::-1].copy())}
        for step in range(3):
            tok = rng.integers(40, 72, (3,))
            pos = np.array([8, 13, 23]) + np.array([step, step, 0])  # row 2 parked at the end
            jl, jcache = jm.decode_step_rows(jparams, jcache, jnp.asarray(tok, jnp.int32),
                                             jnp.asarray(pos, jnp.int32), band=(40, 72))
            tl = tm.decode_step_rows(tparams, tcache, torch.from_numpy(tok),
                                     torch.from_numpy(pos), band=(40, 72))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                       err_msg=f"quantized={quantized} step {step}")
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                       atol=1e-4)


def test_decode_step_rows_equals_decode_step_at_one_position(models):
    dalle, dparams, _, _ = models
    tok = torch.tensor([50, 60])
    caches = [dalle.init_cache(2) for _ in range(2)]
    for c in caches:
        dalle.prefill(dparams, torch.tensor([[1, 2, 3, 0], [4, 5, 6, 0]]), c)
    a = dalle.decode_step(dparams, caches[0], tok, 4)
    b = dalle.decode_step_rows(dparams, caches[1], tok, torch.tensor([4, 4]))
    assert torch.equal(a, b)
    assert torch.equal(caches[0]["k"], caches[1]["k"])


# ---------------------------------------------------------- per-row sampling

def test_sample_token_rows_masks_per_row():
    """Each row's token lies in its own top-k (k = 0: anywhere) and nucleus;
    greedy rows take the argmax, as JAX's sampler does."""
    rows, width = 512, 16
    logits = torch.randn((rows, width), generator=torch.Generator().manual_seed(1)) * 3
    ks = torch.tensor([0, 1, 3, 8] * (rows // 4))
    ps = torch.tensor([1.0, 1.0, 0.5, 0.9, 1.0, 0.3, 1.0, 1.0] * (rows // 8))
    temp = torch.where(torch.arange(rows) % 5 == 0, 0.0, 1.0)
    tok = tsample._sample_token_rows(torch.Generator().manual_seed(2), logits, temp,
                                     ks, k_max=8, top_p_rows=ps)
    order = torch.argsort(logits, dim=-1, descending=True)
    rank = torch.argsort(order, dim=-1).gather(1, tok[:, None])[:, 0]
    greedy = temp == 0
    assert torch.equal(tok[greedy], logits[greedy].argmax(-1))
    want = jsample._sample_token_rows(jax.random.PRNGKey(0), jnp.asarray(logits.numpy()),
                                      jnp.asarray(temp.numpy()), jnp.asarray(ks.numpy()),
                                      8, jnp.asarray(ps.numpy()))
    np.testing.assert_array_equal(tok[greedy].numpy(), np.asarray(want)[greedy.numpy()])
    sampled = ~greedy
    k_eff = torch.where((ks == 0) & (ps < 1.0), 8, ks)
    limited = sampled & (k_eff > 0)
    assert (rank[limited] < k_eff[limited]).all()
    vals = logits.gather(1, order)[:, :8]
    keep = tsample._nucleus_mask(vals, torch.ones((rows, 1)), ps)
    nucleus = limited & (ps < 1.0)
    assert keep.gather(1, rank.clamp_max(7)[:, None])[:, 0][nucleus].all()
    # k = 0 rows without nucleus draw from the whole band
    assert (rank[sampled & (ks == 0) & (ps >= 1.0)] >= 8).any()


# ------------------------------------------------------------ the engine

class TestGreedyEquivalence:
    def test_single_request_matches_whole_batch_path(self, models):
        s = _engine(models)
        try:
            ids = [1, 2, 3, 0]
            got = s.submit(ids, n=1, temperature=0.0).result(timeout=120)[0]
            np.testing.assert_array_equal(got, _solo_greedy(models, ids, 2))
        finally:
            s.close()

    def test_staggered_admission_matches_solo_runs(self, models):
        """A request admitted while its neighbour is mid-generation (slots at
        different positions) still reproduces its solo greedy image; chunk 3
        does not divide 16, so rows finish mid-chunk and park."""
        s = _engine(models, chunk=3)
        try:
            fa = s.submit([1, 2, 3, 0], n=1)
            deadline = time.monotonic() + 60
            while s.stats()["chunks_done"] < 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            fb = s.submit([4, 5, 6, 0], n=1)
            ga, gb = fa.result(timeout=120)[0], fb.result(timeout=120)[0]
            np.testing.assert_array_equal(ga, _solo_greedy(models, [1, 2, 3, 0], 2))
            np.testing.assert_array_equal(gb, _solo_greedy(models, [4, 5, 6, 0], 2))
            assert s.stats()["admits_done"] >= 2
        finally:
            s.close()

    def test_slot_reuse_after_finish_is_clean(self, models):
        """A slot vacated by a finished request (its parked writes land on
        its own last cache row) serves the next occupant exactly."""
        s = _engine(models, batch_size=1)
        try:
            first = s.submit([9, 9, 9, 0], n=1).result(timeout=120)[0]
            second = s.submit([1, 2, 3, 0], n=1).result(timeout=120)[0]
            np.testing.assert_array_equal(first, _solo_greedy(models, [9, 9, 9, 0], 1))
            np.testing.assert_array_equal(second, _solo_greedy(models, [1, 2, 3, 0], 1))
        finally:
            s.close()

    def test_int8_kernel_path_matches_whole_batch_engine(self):
        """int8 weights through the decode-matmul path (its plain version on
        the CPU): the continuous engine's greedy image equals the whole-batch
        engine's on the same weights, at the same batch size."""
        cfg = DalleConfig(n_embd=256, text_vocab_size=48, image_vocab_size=16,
                          text_seq_len=4, image_seq_len=16, n_layers=1, n_heads=2,
                          decode_kernels=True)
        dalle, vae = DALLE(cfg, "cpu"), DiscreteVAE(VCFG, "cpu")
        dparams = quantize_layers_int8(dalle.init(torch.Generator().manual_seed(2)))
        vparams = vae.init(torch.Generator().manual_seed(3))
        engines = [
            ContinuousBatchingSampler(dalle, dparams, vae, vparams, batch_size=2,
                                      temperature=0.0, top_k=0, chunk=5, k_max=8),
            BatchingSampler(dalle, dparams, vae, vparams, batch_size=2,
                            temperature=0.0, top_k=0, linger_ms=1.0),
        ]
        try:
            got = [e.submit([7, 1, 2, 0], n=1).result(timeout=120)[0] for e in engines]
            np.testing.assert_array_equal(got[0], got[1])
        finally:
            for e in engines:
                e.close()


class TestEngineBehavior:
    def test_mixed_params_and_multi_image_groups(self, models):
        """Per-request temperature / top_k / top_p ride as per-row vectors,
        and n > 1 groups resolve with all their rows."""
        s = _engine(models, batch_size=4, temperature=1.0, top_k=4)
        try:
            futs = [
                s.submit([1, 0, 0, 0], n=2, temperature=0.7, top_k=3),
                s.submit([2, 0, 0, 0], n=1, temperature=0.0),
                s.submit([3, 0, 0, 0], n=1, top_k=0, top_p=0.9),
                s.submit([4, 0, 0, 0], n=2, temperature=1.3, top_k=8, top_p=0.5),
            ]
            done, not_done = wait(futs, timeout=120)
            assert not not_done
            for f, n in zip(futs, (2, 1, 1, 2)):
                imgs = f.result()
                assert imgs.shape == (n, 8, 8, 3) and np.isfinite(imgs).all()
        finally:
            s.close()

    def test_top_k_above_k_max_served_untruncated(self, models):
        s = _engine(models, batch_size=1, temperature=1.0, top_k=4)
        try:
            assert s._effective_top_k(999) == 0  # wider, never narrower
            assert s._effective_top_k(8) == 8
            assert s._effective_top_k(0) == 0
            imgs = s.submit([1, 0, 0, 0], n=1, top_k=999).result(timeout=120)
            assert imgs.shape == (1, 8, 8, 3)
        finally:
            s.close()

    def test_validation_and_close(self, models):
        s = _engine(models)
        with pytest.raises(ValueError):
            s.submit([1, 2, 3], n=1)  # wrong text length
        with pytest.raises(ValueError):
            s.submit([1, 2, 3, 4], n=3)  # n > batch
        with pytest.raises(ValueError):
            s.submit([1, 2, 3, 4], n=1, top_p=0.0)
        s.close()
        assert not s._worker.is_alive()
        with pytest.raises(RuntimeError):
            s.submit([1, 2, 3, 4], n=1)


class TestCancellationAndStats:
    def test_cancelled_request_frees_slot(self, models):
        """A cancelled Future's slot is reaped at the next chunk boundary and
        serves the following request."""
        s = _engine(models, batch_size=1)
        try:
            s.submit([1, 0, 0, 0], n=1).result(timeout=120)
            f1 = s.submit([9, 9, 9, 0], n=1)
            f2 = s.submit([1, 2, 3, 0], n=1)  # queued behind f1 (one slot)
            f1.cancel()
            got = f2.result(timeout=120)[0]
            np.testing.assert_array_equal(got, _solo_greedy(models, [1, 2, 3, 0], 1))
            assert f1.cancelled()
        finally:
            s.close()

    def test_stats_counters(self, models):
        s = _engine(models)
        try:
            st = s.stats()
            assert st["engine"] == "continuous"
            assert st["slots_total"] == 2 and st["slots_busy"] == 0
            s.submit([1, 0, 0, 0], n=1).result(timeout=120)
            st = s.stats()
            # 16 image tokens at chunk 4: four chunks, one admission
            assert st["chunks_done"] == 4 and st["admits_done"] == 1
        finally:
            s.close()


def test_drain_serves_queued_then_stops(models):
    """drain(): queued requests beyond slot capacity all resolve, then the
    worker exits."""
    s = _engine(models, batch_size=1)
    f1 = s.submit([1, 2, 3, 0], n=1)
    f2 = s.submit([4, 5, 6, 0], n=1)  # queued behind f1 (one slot)
    s.drain(timeout=120)
    assert not s._worker.is_alive()
    assert f1.result(timeout=1).shape == (1, 8, 8, 3)
    assert f2.result(timeout=1).shape == (1, 8, 8, 3)
    with pytest.raises(RuntimeError):
        s.submit([1, 2, 3, 0], n=1)


def test_failure_with_multirow_group_resets_and_recovers(models):
    """A failure while an n > 1 group is in flight: the group's shared Future
    gets the error once, the engine resets, the next request is served."""
    s = _engine(models)
    real = s._decode_chunk
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return real(*a, **kw)

    s._decode_chunk = flaky
    try:
        f = s.submit([1, 2, 3, 0], n=2)  # both slots share one Future
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=120)
        assert s._worker.is_alive()
        got = s.submit([4, 5, 6, 0], n=1).result(timeout=120)[0]
        np.testing.assert_array_equal(got, _solo_greedy(models, [4, 5, 6, 0], 2))
    finally:
        s.close()


def test_http_server_over_continuous_engine(models):
    """make_server serves the continuous engine unchanged: /generate with
    per-request params, /stats, /healthz."""
    s = _engine(models, temperature=1.0, top_k=4)

    class Tok:
        pad_token_id = 47

        def encode(self, text):
            return [min(ord(c), 46) for c in text]

    srv = make_server(s, Tok(), CFG.text_seq_len, host="127.0.0.1", port=0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"text": "ab", "n": 2, "temperature": 0.8,
                             "top_k": 4, "top_p": 0.9}).encode(),
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert len(out["images"]) == 2
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
            assert json.loads(r.read())["engine"] == "continuous"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
        s.close()
    assert not t.is_alive()
