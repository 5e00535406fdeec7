"""The port's image input path (dalle_mtf_tpu_torch/data/pipeline.py:
``decode_img``, ``to_uint8``, ``vae_input_fn``) against the JAX package's, on
seeded JPEGs written with PIL: decoded images and whole batches bit-equal,
in tfrecords and jpg-glob modes, normalized and uint8, train (shuffled) and
eval, per-process shards, and a resume that skips trained batches.

Both packages are held to their PIL path: ``dalle_mtf_tpu.data.native.get_lib``
and ``dalle_mtf_tpu_torch.data.native.get_lib`` return None in every test
here, so no test builds or loads either native library (its decoder resizes
differently, and JAX's build is not this file's to run). The native path is
tests/test_torch_native.py's."""

import io
import os

import numpy as np
import pytest

from dalle_mtf_tpu.data import native as jnative
from dalle_mtf_tpu.data import pipeline as jpipe
from dalle_mtf_tpu_torch.data import native as tnative
from dalle_mtf_tpu_torch.data import pipeline as tpipe
from dalle_mtf_tpu_torch.data import tfrecord as ttfr


@pytest.fixture(autouse=True)
def jax_pil_path(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)


def _jpeg(rng, h, w) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def _size(rng):
    return int(rng.integers(12, 30)), int(rng.integers(12, 30))


def write_tfrecords(root, files=3, per_file=7, seed=0):
    """JPEG records of assorted, mostly non-square sizes."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for f in range(files):
        with ttfr.TFRecordWriter(os.path.join(root, f"imgs_{f}.tfrecords")) as w:
            for _ in range(per_file):
                jpeg = _jpeg(rng, *_size(rng))
                w.write(ttfr.serialize_example({"image": jpeg, "caption": [1, 2]}))
    return os.path.join(root, "*.tfrecords")


def write_jpgs(root, n=17, seed=1):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        with open(os.path.join(root, f"img_{i:02d}.jpg"), "wb") as f:
            f.write(_jpeg(rng, *_size(rng)))
    return os.path.join(root, "*.jpg")


def _params(pattern, tfrecords, **ds):
    return {"dataset": {"train_path": pattern, "eval_path": pattern, "image_size": 8,
                        "tfrecords": tfrecords, **ds},
            "train_batch_size": 4, "eval_batch_size": 3}


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("hw", [(20, 31), (31, 20), (16, 16), (9, 40)])
def test_decode_img_matches_jax(normalize, hw):
    data = _jpeg(np.random.default_rng(hw[0] * hw[1]), *hw)
    want = jpipe.decode_img(data, 12, normalize=normalize)
    got = tpipe.decode_img(data, 12, normalize=normalize)
    assert got.dtype == (np.float32 if normalize else np.uint8) == want.dtype
    assert got.shape == (12, 12, 3)
    np.testing.assert_array_equal(got, want)
    grey = tpipe.decode_img(data, 12, channels=1, normalize=normalize)
    np.testing.assert_array_equal(grey, jpipe.decode_img(data, 12, channels=1,
                                                         normalize=normalize))
    assert grey.shape == (12, 12, 1)


def test_to_uint8_matches_jax():
    x = np.random.default_rng(0).uniform(-1.1, 1.1, (5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpipe.to_uint8(x), jpipe.to_uint8(x))
    pixels = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tpipe.to_uint8((pixels.astype(np.float32) - 127.5) / 127.5),
                                  pixels)


def _same_batches(want, got, n, dtype):
    for _ in range(n):
        w, g = next(want), next(got)
        assert list(g) == ["image"] and g["image"].dtype == dtype
        np.testing.assert_array_equal(g["image"], w["image"])


@pytest.mark.parametrize("mode", ["tfrecords", "glob"])
@pytest.mark.parametrize("uint8", [False, True])
def test_vae_input_fn_matches_jax(tmp_path, mode, uint8):
    """12 train batches of 4 (past two passes over the 21 or 17 images:
    the repeat and the shuffle buffer), then 8 eval batches of 3."""
    pattern = (write_tfrecords(str(tmp_path)) if mode == "tfrecords"
               else write_jpgs(str(tmp_path)))
    params = _params(pattern, mode == "tfrecords", uint8_images=uint8)
    dtype = np.uint8 if uint8 else np.float32
    for eval_, n in ((False, 12), (True, 8)):
        want = iter(jpipe.vae_input_fn(params, eval=eval_, shard=(0, 1)))
        got = iter(tpipe.vae_input_fn(params, eval=eval_))
        _same_batches(want, got, n, dtype)
        want.close()
        got.close()


@pytest.mark.parametrize("skip_steps", [1, 4])
def test_vae_input_fn_resume_matches_jax(tmp_path, skip_steps):
    """``skip_steps`` continues the stream where an unbroken one is after
    that many batches, in both packages alike."""
    params = _params(write_tfrecords(str(tmp_path)), True)
    unbroken = iter(tpipe.vae_input_fn(params))
    for _ in range(skip_steps):
        next(unbroken)
    want = iter(jpipe.vae_input_fn(params, shard=(0, 1), skip_steps=skip_steps))
    got = iter(tpipe.vae_input_fn(params, skip_steps=skip_steps))
    for _ in range(6):
        g = next(got)
        np.testing.assert_array_equal(g["image"], next(want)["image"])
        np.testing.assert_array_equal(g["image"], next(unbroken)["image"])
    for it in (want, got, unbroken):
        it.close()


def test_vae_input_fn_shards_match_jax(tmp_path):
    """Process 1 of 2 reads files[1::2] and feeds half the batch."""
    params = _params(write_jpgs(str(tmp_path / "a")), False)
    want = iter(jpipe.vae_input_fn(params, shard=(1, 2)))
    got = iter(tpipe.vae_input_fn(params, shard=(1, 2)))
    for _ in range(5):
        g = next(got)
        assert g["image"].shape == (2, 8, 8, 3)
        np.testing.assert_array_equal(g["image"], next(want)["image"])
    want.close()
    got.close()
    with pytest.raises(ValueError, match="divide"):
        tpipe.vae_input_fn({**params, "train_batch_size": 3}, shard=(0, 2))


def test_decoding_on_threads_keeps_the_order(tmp_path):
    """The pool of decode threads yields the one-thread stream."""
    params = _params(write_tfrecords(str(tmp_path)), True)
    pooled = tpipe.vae_input_fn(params, repeat=False)
    assert pooled.num_workers == tpipe.DECODE_WORKERS > 1
    serial = tpipe.vae_input_fn(params, repeat=False)
    serial.num_workers = 1
    a, b = list(pooled), list(serial)
    assert len(a) == len(b) == 21 // 4
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["image"], y["image"])


def test_uint8_batches_normalize_to_the_host_values(tmp_path):
    """The task's on-device normalization of a uint8 batch equals the host
    pipeline's f32 batch bit for bit (PIL's resize output is uint8)."""
    import torch

    from dalle_mtf_tpu_torch.train.tasks import _image

    pattern = write_jpgs(str(tmp_path))
    f32 = next(iter(tpipe.vae_input_fn(_params(pattern, False), eval=True)))["image"]
    u8 = next(iter(tpipe.vae_input_fn(_params(pattern, False, uint8_images=True), eval=True)))
    got = _image({"image": torch.from_numpy(u8["image"])})
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), f32)
