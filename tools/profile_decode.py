#!/usr/bin/env python3
"""Profile the eager decode loop of the quantized serving forms of one or
more checkouts on one GPU, in one call, for a comparison of two versions.

    python3 tools/profile_decode.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository; its ``dalle_mtf_tpu_torch``
package is imported from there (in a process of its own) and its kernels are
built there. For each ROOT and each of ``--quantize int8`` and ``int4``
served through ``serve_dalle.build_server`` with a ``decode_kernels: true``
copy of configs/dalle_coco.json (weights from a seed, batch 4), it runs
``chip_smoke.decode_profile``: a window of 16 decode steps under
torch.profiler, giving the device ops a step, the decode matmul kernels' device ms a step (a
checkout that adds a split-K reduce kernel has it counted in), the device's
busy share and the wall ms a step. Prints
chip_smoke's "decode_profile" JSON lines and, last, the card's name and
power limit. Needs one CUDA device; fails without one.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: str) -> None:
    """decode_profile of both quantized forms of one checkout (in a process
    of its own)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch  # noqa: PLC0415

    cs = _chip_smoke()
    from dalle_mtf_tpu_torch import serve_dalle  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import _build  # noqa: PLC0415

    if not os.path.abspath(serve_dalle.__file__).startswith(os.path.abspath(root)):
        raise AssertionError(f"imported {serve_dalle.__file__}, not the package under {root}")
    _build.build()
    card = cs.gpu_line()
    tmp = tempfile.mkdtemp(prefix="profile_decode_")
    try:
        config = cs.serve_config(tmp)
        for mode in ("int8", "int4"):
            sampler, server, thread, _, _ = cs.start_server(
                serve_dalle, ["--model", config, "--quantize", mode])
            try:
                dalle, params = sampler.dalle, sampler._params[0]
                text4 = torch.randint(0, dalle.cfg.text_vocab_size,
                                      (cs.BATCH, dalle.cfg.text_seq_len), device="cuda")
                # no whole-batch timing here: the unprofiled wall time a step is
                # chip_smoke.py's to read
                split = dict(decode_loop_s=float("nan"), decode_steps=1)
                cs.decode_profile(torch, card, f"{mode}_kernels ({root})", dalle, params, text4,
                                  split, names=("decode_matmul", "splitk_reduce"))
            finally:
                cs.stop_server(sampler, server, thread)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        measure(sys.argv[2])
        return 0
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              cwd=HERE, check=False)
        if proc.returncode != 0:
            return proc.returncode
    print(_chip_smoke().gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
