"""ctypes bindings for the native data-path library (port of
``dalle_mtf_tpu/data/native.py``): hardware crc32c, a TFRecord reader, the
fused JPEG decode + centre crop + bilinear resize + normalize, a C++ pool that
parses and decodes records off the GIL, and an io_uring reader that
interleaves local shards.

The library is built from the repo's one source, ``native/dataloader.cpp``,
with ``native/Makefile``'s flags, into ``dalle_mtf_tpu_torch/_build/``
(git-ignored), named by the hash of the source and the flags, at first use,
under a file lock, and moved into place with an atomic ``os.replace``. It
never writes or loads ``native/libdalle_data.so``, the JAX package's build.
Without ``g++`` or libjpeg's headers (or where the build fails, logged) every
entry point falls back as the JAX package's does: the Python record reader
and PIL. ``available()`` says which path runs.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from collections import deque

import numpy as np

from dalle_mtf_tpu_torch.data import tfrecord
from dalle_mtf_tpu_torch.data.fs import is_remote

logger = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "dataloader.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-march=x86-64-v2", "-shared", "-fPIC", "-Wall")  # native/Makefile
LIBS = ("-ljpeg",)

_P, _I, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
_BYTES = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
_F32P, _I32P = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {  # name: (restype, argtypes)
    "dmt_crc32c": (ctypes.c_uint32, [ctypes.c_char_p, _U64]),
    "dmt_crc32c_masked": (ctypes.c_uint32, [ctypes.c_char_p, _U64]),
    "dmt_tfr_open": (_P, [ctypes.c_char_p]),
    "dmt_tfr_next": (ctypes.c_int64, [_P, _BYTES, _I]),  # handle, out, verify_crc
    "dmt_tfr_close": (None, [_P]),
    # data, len, size, channels, out
    "dmt_decode_jpeg": (_I, [ctypes.c_char_p, _U64, _I, _I, _F32P]),
    # paths, n_paths, cycle, verify_crc, chunk_kb
    "dmt_il_open": (_P, [ctypes.POINTER(ctypes.c_char_p), _I, _I, _I, _I]),
    "dmt_il_next": (ctypes.c_int64, [_P, _BYTES]),
    "dmt_il_close": (None, [_P]),
    "dmt_pool_open": (_P, [_I, _I, _I]),  # threads, size, channels
    # handle, record, len, seq, image out, caption out, caption length
    "dmt_pool_submit": (None, [_P, ctypes.c_char_p, _U64, _U64, _F32P, _I32P, _I]),
    "dmt_pool_wait": (_I, [_P, _U64, ctypes.POINTER(_I)]),  # handle, seq, caption n
    "dmt_pool_close": (None, [_P]),
}


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def missing_toolchain() -> str | None:
    """Why the library cannot be built here (no C++ compiler, or no
    ``jpeglib.h`` on its include path), or None where it can."""
    if shutil.which(_cxx()) is None:
        return f"no C++ compiler ({_cxx()}) on PATH"
    probe = subprocess.run([_cxx(), "-E", "-x", "c++", "-"], input="#include <jpeglib.h>\n",
                           capture_output=True, text=True, check=False)
    if probe.returncode != 0:
        return "libjpeg's header jpeglib.h is not on the compiler's include path"
    return None


def library_path() -> str:
    """Where the library for the current source and flags lives (built or
    not)."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return os.path.join(BUILD_DIR, f"libdalle_data_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``native/dataloader.cpp`` unless a library for it exists;
    return its path. Concurrent builders (test workers, ranks) take turns on
    a file lock, and the library appears whole or not at all. A failed build
    raises with the compiler's output."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libdalle_data.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(out):  # built while this process waited
            return out
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            cmd = [_cxx(), *CXX_FLAGS, SOURCE, "-o", tmp, *LIBS]
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"native dataloader build failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


_LOAD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _load():
    """The loaded library with its signatures declared, or None where it
    cannot be built (logged once)."""
    reason = missing_toolchain()
    if reason is not None:
        logger.info("native dataloader unavailable (%s): Python reader and PIL", reason)
        return None
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        logger.warning("native dataloader unavailable, Python reader and PIL: %s", e)
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    logger.info("native dataloader loaded from %s", lib._name)
    return lib


def get_lib():
    """The native library (built at the first call), or None where it is
    unavailable."""
    with _LOAD_LOCK:
        return _load()


def available() -> bool:
    return get_lib() is not None


def crc32c(data: bytes) -> int:
    lib = get_lib()
    if lib is None:
        return tfrecord.crc32c(data)
    return lib.dmt_crc32c(data, len(data))


def read_tfrecord_file(path, verify_crc: bool = False):
    """Yield the records of a TFRecord file: a local file through the native
    reader (mapped, hardware crc32c); a URL or an open file object through
    the Python reader (over fsspec)."""
    lib = None if (hasattr(path, "read") or is_remote(path)) else get_lib()
    if lib is None:
        yield from tfrecord.read_tfrecord_file(path, verify_crc)
        return
    h = lib.dmt_tfr_open(path.encode())
    if not h:
        raise IOError(f"cannot open {path}")
    try:
        buf = ctypes.POINTER(ctypes.c_uint8)()
        while True:
            n = lib.dmt_tfr_next(h, ctypes.byref(buf), 1 if verify_crc else 0)
            if n == -1:
                return
            if n < 0:
                raise IOError(f"corrupt tfrecord in {path}")
            yield ctypes.string_at(buf, n)
    finally:
        lib.dmt_tfr_close(h)


def decode_img(data: bytes, size: int, channels: int = 3) -> np.ndarray | None:
    """The fused decode: f32 [size, size, channels] in [-1, 1] (centre
    square, plain bilinear, (x - 127.5) / 127.5); None where the library is
    unavailable or ``data`` is not a JPEG it decodes (the caller uses PIL)."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((size, size, channels), np.float32)
    if lib.dmt_decode_jpeg(data, len(data), size, channels, out.ctypes.data_as(_F32P)) != 0:
        return None
    return out


def decode_pool_samples(records, size: int, channels: int, text_len: int, padding_id: int,
                        workers: int, window: int | None = None, uint8_out: bool = False):
    """Parse and decode the Example payloads of ``records`` on ``workers``
    C++ threads: yields {"image": f32[size, size, channels]} (uint8 pixels,
    ``to_uint8`` of it, with ``uint8_out``) and, with ``text_len`` > 0,
    "caption": i32[text_len] padded with ``padding_id``, in record order,
    with up to ``window`` records in flight. A record the pool cannot decode
    (not a JPEG) is parsed and decoded in Python. None where the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if window is None:
        window = max(4, workers * 2)

    def gen():
        from dalle_mtf_tpu_torch.data.pipeline import decode_img as py_decode  # noqa: PLC0415
        from dalle_mtf_tpu_torch.data.pipeline import to_uint8  # noqa: PLC0415

        handle = lib.dmt_pool_open(int(workers), int(size), int(channels))
        if not handle:  # pragma: no cover - allocation failure
            raise MemoryError("dmt_pool_open failed")
        inflight: deque = deque()  # (seq, record, image, caption): kept alive for the pool
        seq = 0

        def submit(rec: bytes):
            nonlocal seq
            img = np.empty((size, size, channels), np.float32)
            cap = np.full((max(text_len, 1),), padding_id, np.int32)
            lib.dmt_pool_submit(handle, rec, len(rec), seq, img.ctypes.data_as(_F32P),
                                cap.ctypes.data_as(_I32P), int(text_len))
            inflight.append((seq, rec, img, cap))
            seq += 1

        def collect():
            s, rec, img, cap = inflight[0]
            n = ctypes.c_int(0)
            rc = lib.dmt_pool_wait(handle, s, ctypes.byref(n))
            inflight.popleft()
            if rc != 0:
                ex = tfrecord.parse_example(rec)
                sample = {"image": py_decode(ex["image"][0], size, channels,
                                             normalize=not uint8_out)}
                if text_len > 0:
                    caption = (list(ex.get("caption", [])) + [padding_id] * text_len)[:text_len]
                    sample["caption"] = np.asarray(caption, np.int32)
                return sample
            sample = {"image": to_uint8(img) if uint8_out else img}
            if text_len > 0:
                sample["caption"] = cap
            return sample

        try:
            for rec in records:
                submit(rec)
                if len(inflight) >= window:
                    yield collect()
            while inflight:
                yield collect()
        finally:
            # wait for the jobs still out before the pool is freed; each
            # job's record and buffers stay referenced until its wait returns
            while inflight:
                job = inflight[0]
                lib.dmt_pool_wait(handle, job[0], ctypes.byref(ctypes.c_int(0)))
                inflight.popleft()
            lib.dmt_pool_close(handle)

    return gen()


def read_interleaved(paths, cycle: int = 4, verify_crc: bool = False, chunk_kb: int = 1024):
    """Records of local shard files round-robin, one at a time across
    ``cycle`` open files (an exhausted file replaced by the next unopened
    one; the order of ``_Pipeline._interleaved``), every stream's reads in
    flight at once on one io_uring. None where the library or io_uring is
    unavailable, or a path is remote."""
    lib = get_lib()
    if lib is None:
        return None
    paths = list(paths)
    if not paths or any(hasattr(p, "read") or is_remote(p) for p in paths):
        return None
    for p in paths:
        # fail as the Python reader's open() would: the native refill skips
        # a shard it cannot open
        if not os.path.isfile(p):
            raise FileNotFoundError(f"tfrecord shard not found: {p}")
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    handle = lib.dmt_il_open(arr, len(paths), int(cycle), 1 if verify_crc else 0, int(chunk_kb))
    if not handle:
        logger.info("io_uring unavailable: the records are read in Python")
        return None

    def gen():
        try:
            buf = ctypes.POINTER(ctypes.c_uint8)()
            while True:
                n = lib.dmt_il_next(handle, ctypes.byref(buf))
                if n == -1:
                    return
                if n < 0:
                    raise IOError("corrupt tfrecord in interleaved read")
                yield ctypes.string_at(buf, n)
        finally:
            lib.dmt_il_close(handle)

    return gen()
