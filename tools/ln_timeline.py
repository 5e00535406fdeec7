#!/usr/bin/env python3
"""The LayerNorm backward's timeline on one GPU: where its time goes.

    python3 tools/ln_timeline.py

Builds ``dalle_mtf_tpu_torch/csrc/layer_norm.cu`` alone with
``-DDALLE_LN_TIMELINE`` (nvcc, into a temporary directory), so that thread 0
of each CTA stamps the card's clock (``%globaltimer``) on entry, when its
first tile has arrived, after its last tile, with its partial written, past
the grid barrier and at the end. Runs the backward at the shapes of
``chip_smoke.py``'s LN phase (inputs from a seed, the CTA count the
instrumented build holds resident, the module's rows a tile), and prints one JSON
line a shape: for each stamp the min, median and max over the CTAs of µs
since the first CTA's entry, and the medians of the phases between them.
Prints the card's name and power limit last. Needs one CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = ("entry", "first_tile", "last_tile_done", "partial_written", "barrier_passed", "end")
CASES = [("dalle_4k", 17408, 1024, "bfloat16"), ("dalle_12B", 8192, 5120, "bfloat16"),
         ("ragged_fp32", 1001, 768, "float32")]


def build(tmp: str) -> ctypes.CDLL:
    from dalle_mtf_tpu_torch.ops import _build  # noqa: PLC0415

    lib = os.path.join(tmp, "libln_timeline.so")
    src = os.path.join(_build.CSRC, "layer_norm.cu")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DDALLE_LN_TIMELINE", "-shared",
                    "-o", lib, src], check=True, capture_output=True, text=True)
    cdll = ctypes.CDLL(lib)
    for name in ("layer_norm_bwd", "layer_norm_info"):
        getattr(cdll, name).argtypes = _build._SIGNATURES[name]
        getattr(cdll, name).restype = ctypes.c_int
    cdll.layer_norm_timeline.argtypes = [ctypes.c_void_p]
    cdll.layer_norm_timeline.restype = ctypes.c_int
    return cdll


def timeline(torch, lnm, lib, rows: int, e: int, dtype) -> dict:
    import numpy as np  # noqa: PLC0415

    gen = torch.Generator().manual_seed(3)
    x = (torch.randn((rows, e), generator=gen) * 2 + 0.5).to("cuda", dtype)
    dy = torch.randn((rows, e), generator=gen).to("cuda", dtype)
    g = (1 + 0.3 * torch.randn(e, generator=gen)).cuda()
    tile_rows = lnm.bwd_tile_rows(e, dtype)
    code = lnm.KERNEL_DTYPES[dtype]
    info = (ctypes.c_int * 5)()
    if lib.layer_norm_info(1, e, code, tile_rows, info) != 0:
        raise RuntimeError("layer_norm_info failed")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_ctas = min(sms * info[4], -(-rows // tile_rows))
    dx = torch.empty_like(x)
    partial = torch.empty((n_ctas, 2, e), device="cuda")
    sums = torch.empty((2, e), device="cuda")
    barrier = torch.zeros(2, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream()
    args = (x.data_ptr(), dy.data_ptr(), g.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            barrier.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(), rows, e, tile_rows,
            n_ctas, code, 1e-5, stream.cuda_stream)
    for _ in range(4):  # the last launch's stamps are read
        if lib.layer_norm_bwd(*args) != 0:
            raise RuntimeError("layer_norm_bwd launch failed")
    torch.cuda.synchronize()
    want = lnm.layer_norm_backward_reference(x, g, dy)
    if (sums[0] - want[1]).abs().max().item() > 1e-4 * want[1].abs().max().item():
        raise AssertionError("the instrumented backward's dg disagrees with the plain one")
    stamps = np.zeros((4096, len(STAMPS)), np.uint64)
    if lib.layer_norm_timeline(stamps.ctypes.data) != 0:
        raise RuntimeError("layer_norm_timeline failed")
    us = (stamps[:n_ctas].astype(np.int64) - int(stamps[:n_ctas, 0].min())) / 1e3
    res = dict(R=rows, E=e, dtype=str(dtype), n_ctas=n_ctas, rows_a_tile=tile_rows,
               ctas_per_sm=info[4],
               stamps_us={name: dict(min=float(us[:, k].min()), median=float(np.median(us[:, k])),
                                     max=float(us[:, k].max()))
                          for k, name in enumerate(STAMPS)})
    phases = np.diff(us, axis=1)
    res["phase_median_us"] = {f"{a}->{b}": float(np.median(phases[:, k]))
                              for k, (a, b) in enumerate(zip(STAMPS, STAMPS[1:]))}
    # the barrier's own wait, from the last CTA's arrival to the median release
    res["barrier_after_last_arrival_us"] = float(np.median(us[:, 4]) - us[:, 3].max())
    return res


def main() -> int:
    sys.path.insert(0, HERE)
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from dalle_mtf_tpu_torch.ops import layer_norm as lnm  # noqa: PLC0415

    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for name, rows, e, dt in CASES:
            print("ln_timeline", json.dumps(dict(shape=name, **timeline(
                torch, lnm, lib, rows, e, getattr(torch, dt)))), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(out.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
