#!/usr/bin/env python3
"""Time the dalle_coco_synth training step of one or more checkouts on one
GPU, in one call, for a comparison of two versions of the training path.

    python3 tools/time_train.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository; in a process of its own, its
kernels are built there and its ``chip_smoke.phase_train`` runs: configs/
dalle_coco_synth.json in tokens mode through ``train_dalle.main`` for 8
steps (steps 3-8 timed by the host clock, a metrics fetch every step), a
resume for 2, then two steps under torch.profiler (device ms by bucket,
busy share). Give parent, change, change, parent to compare two versions in
turns on one card. Prints, per ROOT, one JSON line with the timed steps,
their median, the profiled steps' device ms and wall ms, and the busy
share; last, the card's name and power limit. Needs one CUDA device; fails
without one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKED = ("causal_attention_packed_fwd", "causal_attention_packed_bwd")


def _chip_smoke(root: str):
    """``chip_smoke.py`` of ``root`` as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: str) -> dict:
    """One root's training phase, read back from the "train" line it prints."""
    import contextlib  # noqa: PLC0415
    import io  # noqa: PLC0415

    import torch  # noqa: PLC0415

    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _chip_smoke(root)
    from dalle_mtf_tpu_torch.ops import _build  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415

    _build.build()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        # the kernels' own times enter only the line's attention share
        cs.phase_train(torch, attn, cs.gpu_line(), {n: {"ms": 0.0} for n in PACKED})
    line = next(x for x in out.getvalue().splitlines() if x.startswith("train {"))
    d = json.loads(line[len("train "):])
    return dict(step_s=d["step_s"], step_s_median=d["step_s_median"],
                device_ms_per_step=sum(d["device_ms_per_step"].values()),
                profiled_wall_ms_per_step=d["profiled_wall_ms_per_step"],
                device_busy_share=d["device_busy_share"], peak_mem_gb=d["peak_mem_gb"])


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        print("train", json.dumps(dict(root=args[1], **measure(args[1]))), flush=True)
        return 0
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available() or not args:
        print(__doc__, file=sys.stderr)
        return 1
    for root in args:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              cwd=HERE, check=False)
        if proc.returncode != 0:
            return proc.returncode
    print(_chip_smoke(HERE).gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
