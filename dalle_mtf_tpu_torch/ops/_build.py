"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into one shared library
with a plain C interface, loaded with ``ctypes``. The library goes into
``dalle_mtf_tpu_torch/_build/`` (git-ignored), named by the hash of the
sources and headers, so it is built at first use and again whenever one of
them changes. A missing ``nvcc`` is an error: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U, _F = ctypes.c_uint, ctypes.c_float
# argument types of each C entry point: every pointer and the stream are
# c_void_p and the strides c_longlong, so no 64-bit value is cut to 32 bits
_SIGNATURES = {
    # q, k, v, o, lse; batch, heads, seq_len, head_dim; strides b, h, row;
    # dtype, window, dropout, seed, keep_threshold, keep_scale, heads_total,
    # head0; stream
    "causal_attention_fwd": [_P] * 5 + [_I] * 4 + [_LL] * 3
    + [_I, _I, _I, _U, _U, _F, _I, _I, _P],
    # q, k, v, dout, lse, dsum, dq, dk, dv; then as the forward
    "causal_attention_bwd": [_P] * 9 + [_I] * 4 + [_LL] * 3
    + [_I, _I, _I, _U, _U, _F, _I, _I, _P],
    # as causal_attention_fwd, then the q tile's rows (64 or 128)
    "causal_attention_fwd_tiled": [_P] * 5 + [_I] * 4 + [_LL] * 3
    + [_I, _I, _I, _U, _U, _F, _I, _I, _P, _I],
    # head_dim, batch * heads, seq_len -> the q tile's rows (not an error code)
    "causal_attention_fwd_tile_rows": [_I, _I, _I],
    # head_dim, tile_rows, dtype, out[4]
    "causal_attention_fwd_info": [_I, _I, _I, _P],
    # pass (0 dQ, 1 dK/dV), head_dim, dtype, out[4]
    "causal_attention_bwd_info": [_I, _I, _I, _P],
    # x, w, scale, out; M, K, N, k_slice, splits; stream
    "int8_matmul": [_P] * 4 + [_I] * 5 + [_P],
    # x_lo, x_hi, packed, scale, out; then as int8_matmul
    "int4_matmul": [_P] * 5 + [_I] * 5 + [_P],
    # int4, vec, k_slice, cluster, out[6]
    "decode_matmul_info": [_I] * 4 + [_P],
    # x, g, b, y; rows, e, dtype; eps; stream
    "layer_norm_fwd": [_P] * 4 + [_I] * 3 + [_F, _P],
    # x, dy, g, dx, partial, barrier, dg, db; rows, e, rows a tile, n_ctas,
    # dtype; eps; stream
    "layer_norm_bwd": [_P] * 8 + [_I] * 5 + [_F, _P],
    # kind (0 forward, 1 backward), e, dtype, rows a tile, out[5]
    "layer_norm_info": [_I] * 4 + [_P],
    # q, k, v, num, m, l; bh, s_q, s_k, head_dim, dtype, diff, row0, col0,
    # window, dropout; seed, keep_threshold, keep_scale; heads, heads_total,
    # head0; stream
    "ring_partial": [_P] * 6 + [_I] * 10 + [_U, _U, _F] + [_I] * 3 + [_P],
    # q, k, v, dout, lse, dsum, dq, dk_acc, dv_acc; then as ring_partial
    "ring_block_grads": [_P] * 9 + [_I] * 10 + [_U, _U, _F] + [_I] * 3 + [_P],
    # kind (0 forward, 1 dQ, 2 dK/dV), head_dim, tile_rows, dtype, out[4]
    "ring_attention_info": [_I, _I, _I, _I, _P],
}


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    raise RuntimeError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin or "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libdalle_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless a library for them exists; return its path."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(lib, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed, with each C entry
    point's argument types declared."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
