"""Run chosen phases of ``chip_smoke.py`` on the card, from one or more
checkouts of the repo, one process per checkout in the order given: the way
to run a phase alone, or to compare two commits on one card (parent,
change, change, parent).

    python3 chip_phases.py --phases phase_train_vae \\
        --checkout scratch_chip/parent --checkout . --checkout . \\
        --checkout scratch_chip/parent
    python3 chip_phases.py --build --phases phase_train_vae_dp,phase_train_12b_tp

Each phase is called as ``chip_smoke.main`` calls it, ``phase(torch, card)``,
with TF32 off as there; ``--build`` builds the checkout's kernels first
(the phases that launch them need it). Prints the card's name and power
limit, then for each run its index and checkout, the phases' own lines and
each phase's seconds; exits with the first failing run's code. Imports
torch and the checkouts' packages only, never JAX.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time


def child(checkout: str, phases: list[str], build: bool) -> int:
    """One run: the checkout's chip_smoke phases in this process."""
    checkout = os.path.abspath(checkout)
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("chip_phases.py: no CUDA device", file=sys.stderr)
        return 1
    smoke = importlib.import_module("chip_smoke")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.gpu_line()
    seconds = {}
    if build:
        from dalle_mtf_tpu_torch.ops import _build  # noqa: PLC0415

        t = time.perf_counter()
        _build.build()
        seconds["build"] = time.perf_counter() - t
    for name in phases:
        t = time.perf_counter()
        getattr(smoke, name)(torch, card)
        seconds[name] = time.perf_counter() - t
        print(f"phase {name}: {seconds[name]:.1f}s", flush=True)
    print("phase_seconds", json.dumps(seconds), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", required=True, help="comma-separated chip_smoke phase names")
    ap.add_argument("--checkout", action="append", default=None,
                    help="a checkout of the repo (repeatable; default: this one)")
    ap.add_argument("--build", action="store_true", help="build the kernels first")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = args.phases.split(",")
    checkouts = args.checkout or [os.path.dirname(os.path.abspath(__file__))]
    if args.child:
        return child(checkouts[0], phases, args.build)
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout
    except OSError as e:
        card = f"nvidia-smi: {e}"
    print(card.strip(), flush=True)
    for i, checkout in enumerate(checkouts):
        print(f"run {i}: {checkout}", flush=True)
        cmd = [sys.executable, os.path.abspath(__file__), "--child", "--phases", args.phases,
               "--checkout", checkout, *(["--build"] if args.build else [])]
        rc = subprocess.run(cmd).returncode
        if rc:
            print(f"run {i} ({checkout}) failed with code {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
