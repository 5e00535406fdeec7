#!/usr/bin/env python3
"""Count the kernel events torch.profiler keeps from CUDA graph replays at
the edges of its recording window.

    python3 tools/profiler_window_edges.py [--trials 12] [--replays 16]

Captures one CUDA graph of ``--kernels`` small kernels that opens with a
``sqrt`` and ends with an ``exp`` (so each replay's first and last kernel
can be told apart by name), then, in each trial, replays it as
``chip_smoke.profile_replays`` does: a schedule of wait 1, warm-up 1,
active 1; two replays before the active step; ``--replays`` replays back
to back, a synchronize, the closing step. Two arms alternate:

- ``edge``: the replays start as soon as the active step begins and the
  step closes as soon as the card is idle (``profile_replays`` before its
  margins);
- ``margin``: the host sleeps ``--margin-ms`` after the active step
  begins and again before it closes.

Prints one JSON line per trial (events kept against the graph's count,
sqrt and exp events kept, events of the first and last replay), one line
of totals per arm, then the card's name and power limit. Needs a CUDA
device; imports torch only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def trial(torch, graph, per_replay: int, replays: int, margin_s: float) -> dict:
    from torch.profiler import ProfilerActivity, profile, schedule  # noqa: PLC0415

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            prof.step()
        time.sleep(margin_s)
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
        time.sleep(margin_s)
        prof.step()
    device = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.name.startswith("ProfilerStep")),
                    key=lambda e: e.time_range.start)
    first = [i for i, e in enumerate(device) if "sqrt" in e.name]
    last = [i for i, e in enumerate(device) if "exp" in e.name]
    return dict(events=len(device), want=per_replay * replays,
                sqrt=len(first), exp=len(last),
                first_replay=first[1] if len(first) > 1 else None,
                last_replay=len(device) - first[-1] if first else None,
                per_replay=per_replay)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--replays", type=int, default=16)
    ap.add_argument("--kernels", type=int, default=648)
    ap.add_argument("--margin-ms", type=float, default=5.0)
    args = ap.parse_args()
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    x = torch.ones((4, 1024), device="cuda")
    w = torch.randn((1024, 1024), device="cuda") / 32

    def body():
        y = torch.sqrt(x)
        for i in range(args.kernels - 2):
            y = y @ w if i % 9 == 0 else y * 1.0001 if i % 2 else y + 1e-4
        return torch.exp(y * 1e-6)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        body()  # warm-up: cuBLAS handles and workspaces before capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    totals = {}
    for t in range(2 * args.trials):
        arm, margin = ("edge", 0.0) if t % 2 == 0 else ("margin", args.margin_ms / 1e3)
        row = dict(arm=arm, trial=t // 2, **trial(torch, graph, args.kernels, args.replays,
                                                   margin))
        print(json.dumps(row), flush=True)
        tot = totals.setdefault(arm, dict(trials=0, short=0, lost=0, extra=0))
        tot["trials"] += 1
        tot["short"] += row["events"] != row["want"]
        tot["lost"] += max(0, row["want"] - row["events"])
        tot["extra"] += max(0, row["events"] - row["want"])
    print(json.dumps(dict(totals=totals, kernels=args.kernels, replays=args.replays,
                          margin_ms=args.margin_ms, torch=torch.__version__)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.stdout.strip() else "nvidia-smi: none")
    return 0


if __name__ == "__main__":
    sys.exit(main())
