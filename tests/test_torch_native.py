"""The port's native data path (dalle_mtf_tpu_torch/data/native.py, built from
native/dataloader.cpp into dalle_mtf_tpu_torch/_build/) on the CPU:

- crc32c and the record reader against the Python ones, corruption refused;
- the fused decode against a numpy centre crop + plain bilinear resize of
  PIL's decode (libjpeg's, bit-exact), atol 1e-3, as tests/test_native.py
  holds the JAX package's;
- the pool: strict record order, ``uint8_out`` equal to ``to_uint8`` of its
  f32 output, a non-JPEG record decoded in Python;
- the io_uring reader and the Python interleave in the record order of the
  JAX package's Python interleave at cycle 1, 2 and 4;
- ``vae_input_fn`` and ``dalle_input_fn`` batch for batch against the JAX
  package's default (native) path, the JAX package's ``get_lib`` replaced by
  the port's: the same C++ source, built once, into the port's directory;
- the build: into ``_build/`` only (never ``native/libdalle_data.so``, the
  JAX package's file), one library for builders racing on its lock, a
  failed build raised, and the fallback to Python and PIL without a
  toolchain.

Tests that need the library skip only where ``g++`` or ``jpeglib.h`` is
missing; a failed build fails them.
"""

import ctypes
import io
import os
import subprocess
import threading

import numpy as np
import pytest

from dalle_mtf_tpu.data import native as jnative
from dalle_mtf_tpu.data import pipeline as jpipe
from dalle_mtf_tpu.data import tfrecord as jtfr
from dalle_mtf_tpu_torch.data import native as tnative
from dalle_mtf_tpu_torch.data import pipeline as tpipe
from dalle_mtf_tpu_torch.data import tfrecord as ttfr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def jax_never_builds(monkeypatch):
    """The JAX package's loader never runs here: its native path, where a
    test takes it, runs on the port's library."""
    monkeypatch.setattr(jnative, "get_lib", lambda: None)


@pytest.fixture
def lib():
    reason = tnative.missing_toolchain()
    if reason is not None:
        pytest.skip(f"the native library cannot be built here: {reason}")
    tnative.build()  # a failed build raises: a failure, not a skip
    loaded = tnative.get_lib()
    assert loaded is not None
    return loaded


@pytest.fixture
def fresh_load():
    """A cleared load cache, cleared again after the test (which may load
    a library from elsewhere or none)."""
    tnative._load.cache_clear()
    yield
    tnative._load.cache_clear()


def _jpeg(arr, quality=95) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _png(arr) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def _plain_bilinear(data: bytes, size: int) -> np.ndarray:
    """PIL's decode (libjpeg's), the centred square, a plain bilinear resize
    in numpy (tf.image.crop_and_resize's sampling), normalized."""
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    w, h = img.size
    side = min(w, h)
    left, top = (w - side) // 2, (h - side) // 2
    crop = np.asarray(img.crop((left, top, left + side, top + side)), np.float32)
    coords = np.clip((np.arange(size) + 0.5) * (side / size) - 0.5, 0, None)
    i0 = coords.astype(np.int32)
    i1 = np.minimum(i0 + 1, side - 1)
    frac = coords - i0
    tmp = crop[i0] * (1 - frac)[:, None, None] + crop[i1] * frac[:, None, None]
    ref = tmp[:, i0] * (1 - frac)[None, :, None] + tmp[:, i1] * frac[None, :, None]
    return (ref - 127.5) / 127.5


# ----------------------------------------------------------- reader, crc

def test_crc32c_matches_python(lib):
    for data in [b"", b"123456789", bytes(32), bytes(range(256)) * 33]:
        assert tnative.crc32c(data) == ttfr.crc32c(data)
    assert tnative.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 15, 16, 17, 1000, 65539])
def test_python_crc32c_matches_jax(n):
    """The Python fallback (eight bytes a step) gives the JAX package's
    byte-at-a-time values."""
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert ttfr.crc32c(data) == jtfr.crc32c(data)
    assert ttfr._masked_crc(data) == jtfr._masked_crc(data)


@pytest.mark.parametrize("remote", [False, True])
def test_writer_bytes_equal_jax(tmp_path, remote):
    """The port's writer (its Python crc32c; to a memory:// URL through
    fsspec or to a local file) writes the JAX package's bytes."""
    import uuid

    from dalle_mtf_tpu_torch.data import fs

    records = [bytes(range(n % 256)) * (n // 7 + 1) for n in (0, 3, 300, 5000)]
    port = f"memory://writer-{uuid.uuid4().hex}/port" if remote else str(tmp_path / "port")
    with ttfr.TFRecordWriter(port) as w:
        for r in records:
            w.write(r)
    with jtfr.TFRecordWriter(str(tmp_path / "jax")) as w:
        for r in records:
            w.write(r)
    with fs.open_file(port, "rb") as f:
        assert f.read() == (tmp_path / "jax").read_bytes()
    assert list(ttfr.read_tfrecord_file(port, verify_crc=True)) == records
    if remote:
        fs.remove_tree(port.rsplit("/", 1)[0])


def _corrupt(path):
    raw = bytearray(open(path, "rb").read())
    raw[14] ^= 0xFF  # a payload byte of the first record
    open(path, "wb").write(bytes(raw))


def test_reader_matches_python_and_refuses_corruption(lib, tmp_path):
    path = str(tmp_path / "x.tfrecords")
    records = [b"a" * n for n in (1, 100, 65536)] + [b"last"]
    with ttfr.TFRecordWriter(path) as w:
        for r in records:
            w.write(r)
    assert list(tnative.read_tfrecord_file(path, verify_crc=True)) == records
    assert list(ttfr.read_tfrecord_file(path, verify_crc=True)) == records
    _corrupt(path)
    with pytest.raises(IOError):
        list(tnative.read_tfrecord_file(path, verify_crc=True))
    g = tnative.read_interleaved([path], cycle=1, verify_crc=True)
    if g is None:
        pytest.skip("io_uring is refused here")
    with pytest.raises(IOError):
        list(g)


# --------------------------------------------------------------- decode

@pytest.mark.parametrize("hw,size", [((48, 64), 32), ((64, 48), 32), ((40, 40), 24),
                                     ((300, 200), 64), ((20, 30), 32)])
def test_decode_img_matches_plain_bilinear(lib, hw, size):
    arr = np.random.RandomState(hw[0] + hw[1]).randint(0, 255, (*hw, 3), np.uint8)
    data = _jpeg(arr)
    out = tnative.decode_img(data, size, 3)
    assert out.shape == (size, size, 3) and out.dtype == np.float32
    assert out.min() >= -1.0 and out.max() <= 1.0
    np.testing.assert_allclose(out, _plain_bilinear(data, size), atol=1e-3)
    # the pipeline's decode is this one, uint8 its one rounding
    np.testing.assert_array_equal(tpipe.decode_img(data, size), out)
    np.testing.assert_array_equal(tpipe.decode_img(data, size, normalize=False),
                                  tpipe.to_uint8(out))


def test_decode_img_falls_back_to_pil_for_other_formats(lib, monkeypatch):
    data = _png(np.random.RandomState(0).randint(0, 255, (20, 28, 3), np.uint8))
    assert tnative.decode_img(data, 16) is None
    assert tnative.decode_img(b"not an image at all", 16) is None
    got = tpipe.decode_img(data, 16)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    np.testing.assert_array_equal(got, tpipe.decode_img(data, 16))


def _records(n=7, seed=3, png_at=()):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        arr = rng.randint(0, 255, (40 + i, 56 - i, 3), np.uint8)
        image = _png(arr) if i in png_at else _jpeg(arr)
        out.append(ttfr.serialize_example({"image": image, "caption": list(range(i, 2 * i + 1))}))
    return out


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_pool_keeps_order_and_uint8_is_the_one_rounding(lib, workers):
    records = _records(png_at=(2,))
    f32 = list(tnative.decode_pool_samples(iter(records), size=24, channels=3, text_len=4,
                                           padding_id=99, workers=workers))
    u8 = list(tnative.decode_pool_samples(iter(records), size=24, channels=3, text_len=4,
                                          padding_id=99, workers=workers, uint8_out=True))
    assert len(f32) == len(u8) == len(records)
    for rec, a, b in zip(records, f32, u8):
        ex = ttfr.parse_example(rec)
        want_cap = (list(ex["caption"]) + [99] * 4)[:4]
        np.testing.assert_array_equal(a["caption"], want_cap)
        np.testing.assert_array_equal(b["caption"], want_cap)
        np.testing.assert_array_equal(a["image"], tpipe.decode_img(ex["image"][0], 24))
        assert b["image"].dtype == np.uint8
        np.testing.assert_array_equal(b["image"], tpipe.to_uint8(a["image"]))
    tokens_only = list(tnative.decode_pool_samples(iter(records[:3]), size=24, channels=3,
                                                   text_len=0, padding_id=0, workers=workers))
    assert all(set(s) == {"image"} for s in tokens_only)


def test_abandoning_the_pool_mid_stream_waits_for_its_jobs(lib):
    """A stream closed with jobs in flight (a pipeline dropped after a
    batch) frees no record or buffer a C++ thread still uses: repeated, so
    a job that outlived its buffers would corrupt the heap."""
    rng = np.random.RandomState(5)
    records = [ttfr.serialize_example({"image": _jpeg(rng.randint(0, 255, (160, 200, 3),
                                                                  np.uint8))})
               for _ in range(24)]
    for i in range(40):
        g = tnative.decode_pool_samples(iter(records), size=96, channels=3, text_len=0,
                                        padding_id=0, workers=8, window=16)
        for _ in range(i % 3):
            assert next(g)["image"].shape == (96, 96, 3)
        g.close()
    full = list(tnative.decode_pool_samples(iter(records), size=96, channels=3, text_len=0,
                                            padding_id=0, workers=8, window=16))
    assert len(full) == 24


# ---------------------------------------------------------- interleave

def _shards(tmp_path, n_files=5, per_file=7):
    paths = []
    for i in range(n_files):
        p = str(tmp_path / f"shard_{i}.tfrecords")
        with ttfr.TFRecordWriter(p) as w:
            for j in range(per_file + i):  # uneven shard sizes
                w.write(f"rec-{i}-{j}".encode() * (j + 1))
        paths.append(p)
    return paths


class _Interleave:  # the JAX pipeline's interleave reads these two alone
    def __init__(self, cycle, reader):
        self.cycle_length, self.record_iter_fn = cycle, reader


def _port_interleave(cycle, paths):
    """(records, reader) of the port's interleave over ``paths``."""
    pipe = tpipe._Pipeline(paths, tnative.read_tfrecord_file, None, 1, shuffle=False,
                           cycle_length=cycle)
    return list(pipe._interleaved(paths)), pipe.reader


@pytest.mark.parametrize("cycle", [1, 2, 4])
def test_interleaved_order_matches_jax(lib, tmp_path, cycle, monkeypatch):
    paths = _shards(tmp_path)
    want = list(jpipe._Pipeline._interleaved(_Interleave(cycle, jtfr.read_tfrecord_file), paths))
    assert len(want) == sum(7 + i for i in range(5))
    g = tnative.read_interleaved(paths, cycle=cycle, verify_crc=True)
    if g is None:
        pytest.skip("io_uring is refused here")
    assert list(g) == want
    assert _port_interleave(cycle, paths) == (want, "io_uring")
    # without io_uring: the native single-file reader, then pure Python
    monkeypatch.setattr(tnative, "read_interleaved", lambda *a, **k: None)
    assert _port_interleave(cycle, paths) == (want, "native")
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    assert _port_interleave(cycle, paths) == (want, "python")


def test_interleave_refuses_remote_and_missing_shards(lib, tmp_path):
    assert tnative.read_interleaved(["memory://bucket/x.tfrecords"]) is None
    assert tnative.read_interleaved([]) is None
    with pytest.raises(FileNotFoundError):
        tnative.read_interleaved([str(tmp_path / "absent.tfrecords")])


# --------------------------------------- the pipelines on the native path

def _image_records(root, files=3, per_file=7, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for f in range(files):
        with ttfr.TFRecordWriter(os.path.join(root, f"imgs_{f}.tfrecords")) as w:
            for _ in range(per_file):
                arr = rng.integers(0, 256, (int(rng.integers(12, 40)), int(rng.integers(12, 40)),
                                            3), dtype=np.uint8)
                caption = rng.integers(0, 48, int(rng.integers(0, 13))).tolist()
                w.write(ttfr.serialize_example({"image": _jpeg(arr), "caption": caption}))
    return os.path.join(root, "*.tfrecords")


def _params(pattern, **ds):
    return {"dataset": {"train_path": pattern, "eval_path": pattern, "image_size": 12,
                        "tfrecords": True, **ds},
            "train_batch_size": 4, "eval_batch_size": 3, "text_seq_len": 6, "padding_id": 47}


@pytest.mark.parametrize("fn", ["vae_input_fn", "dalle_input_fn"])
@pytest.mark.parametrize("uint8", [False, True])
@pytest.mark.parametrize("skip_steps", [0, 3])
def test_pipelines_match_jax_native_path(lib, tmp_path, monkeypatch, fn, uint8, skip_steps):
    """The JAX package's default path (io_uring, its pool, its decode) and
    the port's give the same batches, on one library."""
    monkeypatch.setattr(jnative, "get_lib", tnative.get_lib)
    params = _params(_image_records(str(tmp_path)), uint8_images=uint8)
    for eval_, n in ((False, 8), (True, 5)):
        skip = 0 if eval_ else skip_steps
        pipeline = getattr(tpipe, fn)(params, eval=eval_, skip_steps=skip)
        want = iter(getattr(jpipe, fn)(params, eval=eval_, shard=(0, 1), skip_steps=skip))
        got = iter(pipeline)
        for _ in range(n):
            w, g = next(want), next(got)
            assert set(g) == set(w) == ({"image", "caption"} if fn == "dalle_input_fn"
                                        else {"image"})
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
        want.close()
        got.close()
        assert pipeline.decoder == "native pool"
        assert pipeline.reader in ("io_uring", "native")


# ------------------------------------------------------------------ build

def test_the_port_never_builds_into_the_jax_file(tmp_path, monkeypatch, fresh_load):
    """Every compiler run and every load of the port's loader names a file
    under the port's build directory, never native/libdalle_data.so."""
    reason = tnative.missing_toolchain()
    if reason is not None:
        pytest.skip(f"the native library cannot be built here: {reason}")
    jax_file = os.path.join(ROOT, "native", "libdalle_data.so")
    assert os.path.dirname(tnative.library_path()) == tnative.BUILD_DIR
    assert tnative.BUILD_DIR == os.path.join(ROOT, "dalle_mtf_tpu_torch", "_build")
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    runs, loads = [], []
    real_run, real_cdll = subprocess.run, ctypes.CDLL

    def run(cmd, *a, **k):
        runs.append(list(cmd))
        return real_run(cmd, *a, **k)

    def cdll(name, *a, **k):
        loads.append(name)
        return real_cdll(name, *a, **k)

    monkeypatch.setattr(tnative.subprocess, "run", run)
    monkeypatch.setattr(tnative.ctypes, "CDLL", cdll)
    assert tnative.get_lib() is not None
    assert loads == [tnative.library_path()]
    assert loads[0].startswith(str(tmp_path / "build") + os.sep)
    built = [c for c in runs if "-o" in c]
    assert len(built) == 1 and built[0][built[0].index("-o") + 1].startswith(
        str(tmp_path / "build") + os.sep)
    assert tnative.SOURCE == os.path.join(ROOT, "native", "dataloader.cpp")
    assert not any(jax_file in arg or arg.endswith("libdalle_data.so")
                   for cmd in runs for arg in cmd)


def test_racing_builders_share_one_library(tmp_path, monkeypatch):
    reason = tnative.missing_toolchain()
    if reason is not None:
        pytest.skip(f"the native library cannot be built here: {reason}")
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    got, errors = [], []

    def build():
        try:
            got.append(tnative.build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors and len(got) == 4 and len(set(got)) == 1
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        ["libdalle_data.lock", os.path.basename(got[0])])


def test_a_failed_build_raises_and_the_loader_falls_back(tmp_path, monkeypatch, fresh_load):
    reason = tnative.missing_toolchain()
    if reason is not None:
        pytest.skip(f"the native library cannot be built here: {reason}")
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ("-DDMT_PROBE", "-xnone-such"))
    with pytest.raises(RuntimeError, match="build failed"):
        tnative.build()
    assert os.listdir(tmp_path / "build") == ["libdalle_data.lock"]  # nothing half-written
    assert tnative.get_lib() is None and not tnative.available()


def test_without_a_toolchain_python_and_pil(tmp_path, monkeypatch, fresh_load):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert "compiler" in tnative.missing_toolchain()
    assert tnative.get_lib() is None
    arr = np.random.RandomState(1).randint(0, 255, (30, 20, 3), np.uint8)
    assert tnative.decode_img(_jpeg(arr), 16) is None
    assert tnative.read_interleaved(_shards(tmp_path, 2, 2)) is None
    assert tnative.decode_pool_samples(iter([]), 16, 3, 0, 0, workers=2) is None
    assert tnative.crc32c(b"123456789") == 0xE3069283
    pipeline = tpipe.vae_input_fn(_params(_image_records(str(tmp_path / "d"))), repeat=False)
    assert len(list(pipeline)) == 21 // 4
    assert (pipeline.reader, pipeline.decoder) == ("python", "threads")
