#!/usr/bin/env python3
"""Time what a decode step of ranks sharing one GPU over gloo is made of.

    python3 tools/time_gloo_collectives.py [--ranks 2] [--iters 300]

Starts ``--ranks`` ranks on card 0 under ``torch.distributed.run`` (gloo,
as ``utils/distributed.py`` picks it for ranks that share a card), and on
each times, per call:

- ``all_reduce`` of a CUDA tensor of the decode shapes (dalle_coco's
  [4, 1, 1024] bf16 and dalle_12B's [64, 1, 5120] bf16) through
  ``parallel.tensor.all_reduce`` (gloo stages CUDA tensors through host
  memory itself);
- the same sum staged by hand: the tensor copied to the host, summed there,
  copied back;
- ``all_reduce`` of a host tensor of the same size (no card in the way);
- a burst of 64 small kernels (``add_`` on [4, 1024]) and a sync, the
  ranks' bursts interleaved on the one card, against one rank's bursts
  alone (the others wait at a barrier).

Prints one JSON line (ms a call, medians over the ranks), then the card's
name and power limit. Imports torch and the port only; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"dalle_coco_decode": (4, 1, 1024), "dalle_12B_decode": (64, 1, 5120)}
BURST = 64  # small kernels a burst


def rank_main(iters: int, out: str) -> None:
    import torch  # noqa: PLC0415
    import torch.distributed as dist  # noqa: PLC0415

    sys.path.insert(0, HERE)
    from dalle_mtf_tpu_torch.parallel.tensor import all_reduce  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.distributed import init_distributed  # noqa: PLC0415

    proc = init_distributed(["0"], "cuda")
    rank = proc.rank

    def timed(fn) -> float:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    res = {}
    for name, shape in SHAPES.items():
        x = torch.ones(shape, dtype=torch.bfloat16, device="cuda")
        host = torch.ones(shape, dtype=torch.bfloat16)

        def staged():
            h = x.cpu()
            dist.all_reduce(h)
            x.copy_(h)

        res[name] = dict(gloo_cuda_ms=timed(lambda: all_reduce(x)), staged_ms=timed(staged),
                         host_ms=timed(lambda: dist.all_reduce(host)))
    y = torch.zeros((4, 1024), device="cuda")

    def burst():
        for _ in range(BURST):
            y.add_(1.0)
        torch.cuda.synchronize()

    shared = timed(burst)
    alone = None
    for r in range(proc.world):  # one rank at a time
        dist.barrier()
        if r == rank:
            for _ in range(10):
                burst()
            t0 = time.perf_counter()
            for _ in range(iters):
                burst()
            alone = (time.perf_counter() - t0) / iters * 1e3
    dist.barrier()
    res["burst_of_64_kernels"] = dict(interleaved_ms=shared, alone_ms=alone)
    everyone = [None] * proc.world
    dist.all_gather_object(everyone, res)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(everyone, f)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--rank-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_out:
        rank_main(args.iters, args.rank_out)
        return 0
    import tempfile  # noqa: PLC0415

    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("time_gloo_collectives.py: no CUDA device", file=sys.stderr)
        return 1
    out = os.path.join(tempfile.mkdtemp(), "ranks.json")
    subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc_per_node", str(args.ranks), os.path.abspath(__file__),
                    "--iters", str(args.iters), "--rank-out", out], check=True, cwd=HERE)
    with open(out) as f:
        ranks = json.load(f)
    line = {"ranks": args.ranks, "iters": args.iters,
            "label": f"{args.ranks} ranks sharing one card over gloo: not a multi-GPU number"}
    for key in ranks[0]:
        line[key] = {k: statistics.median(r[key][k] for r in ranks) for k in ranks[0][key]}
    print(json.dumps(line))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
