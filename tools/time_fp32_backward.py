#!/usr/bin/env python3
"""Time the fp32 attention backward kernels of one or more checkouts on one
GPU, in one call, for a comparison of two versions of the kernels.

    python3 tools/time_fp32_backward.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository; its ``dalle_mtf_tpu_torch``
package is imported from there (in a process of its own) and its kernels are
built there. Give parent, change, change, parent to compare two versions in
turns on one card. For each ROOT it measures, at the shapes the fp32 rows of
``chip_smoke.py``'s kernels line take:

- ``loop_fp32``: the causal backward ``ops.attention._backward`` (its dsum
  reduction, the dQ and the dK/dV launch) at B=1, H=8, S=4352, D=128, fp32;
- ``ring_past``: ``ops.ring_attention.ring_block_grads`` at the ring slice's
  past hop, B=4, H=8, S_local=1088, D=128, fp32 (the dQ and dK/dV launch);
- each timed between CUDA events (``ms``) and on the card under
  torch.profiler (``device_ms``), with what the profiler saw by kernel name
  (events and µs) beside the launches made, and SDPA's fp32 backward on the
  same inputs (``library_ms``); at the ring hop also the profiler's reading
  of the fp32 forward and backward over 1 and 3 calls;
- the errors against the plain versions: each 64-long tile within 1e-5 of
  its own max |plain|.

Prints one "fp32_backward" JSON line per ROOT and, last, the card's name and
power limit. Needs one CUDA device; fails without one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 10  # timed calls (a call is 1-13 ms)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: str) -> dict:
    """The measurements of one checkout (run in a process of its own)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch  # noqa: PLC0415

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dalle_mtf_tpu_torch.ops import _build  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import ring_attention as ring  # noqa: PLC0415

    if not os.path.abspath(attn.__file__).startswith(os.path.abspath(root)):
        raise AssertionError(f"imported {attn.__file__}, not the package under {root}")
    _build.build()
    res = {"root": root}
    gen = torch.Generator().manual_seed(2)

    # the causal pair's loop_fp32 shape
    b, h, s, d = 1, 8, 4352, 128
    q, k, v, g = ((torch.rand((b, h, s, d), generator=gen) * 2 - 1).cuda() for _ in range(4))
    out, lse = attn.attention_reference(q, k, v, True, None, True)
    before = attn.KERNEL_LAUNCHES["causal_attention_bwd"]
    grads = attn._backward(q, k, v, out, lse, g, None, 0.0, None)
    torch.cuda.synchronize()
    if attn.KERNEL_LAUNCHES["causal_attention_bwd"] != before + 1:
        raise AssertionError("causal_attention_bwd did not count its launch")
    want = attn.attention_backward_reference(q, k, v, out, lse, g)
    tiles = {n: cs.tile_rel_err(t, w) for n, t, w in zip(("dq", "dk", "dv"), grads, want)}
    sets = cs.past_l2((q, k, v, g, out, lse))
    ms = cs.rotating_ms(lambda q, k, v, g, out, lse: attn._backward(
        q, k, v, out, lse, g, None, 0.0, None), sets, ITERS)
    dev_ms, seen = cs.device_profile(torch, lambda i: attn._backward(
        *sets[i][:3], sets[i][4], sets[i][5], sets[i][3], None, 0.0, None), len(sets), ITERS)
    _, lib_ms = cs.sdpa_bhsd_ms(torch, sets, ITERS)
    res["loop_fp32"] = dict(ms=ms, device_ms=dev_ms, library_ms=lib_ms,
                            launched_per_call=2, calls=ITERS, profiler_saw=seen,
                            tile_rel_errs=tiles, input_copies=len(sets))
    del q, k, v, g, out, lse, grads, want, sets
    torch.cuda.empty_cache()

    # the ring slice's past hop
    b, h, s, d = 4, 8, 1088, 128
    q, k, v, g = ((torch.rand((b, h, s, d), generator=gen) * 2 - 1).cuda() for _ in range(4))
    row0 = 3 * s
    args = (s, row0, row0 - s, None, 0.0, 0)
    _, m, l = ring.ring_partial_reference(q, k, v, *args)
    lse = (m + torch.log(l.clamp_min(1e-30))).contiguous()
    dsum = torch.rand((b * h, s), generator=gen).cuda()
    dk, dv = (torch.zeros((b, h, s, d), device="cuda") for _ in range(2))
    dq = ring.ring_block_grads(q, g, lse, dsum, k, v, dk, dv, *args)
    want = ring.ring_block_grads_reference(q, g, lse, dsum, k, v, *args)
    torch.cuda.synchronize()
    tiles = {n: cs.tile_rel_err(t, w) for n, t, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    ms = cs.cuda_ms(lambda: ring.ring_block_grads(q, g, lse, dsum, k, v, dk, dv, *args), ITERS)
    dev_ms, seen = cs.device_profile(
        torch, lambda _: ring.ring_block_grads(q, g, lse, dsum, k, v, dk, dv, *args), 1, ITERS)
    _, lib_ms = cs.sdpa_bhsd_ms(torch, [(q, k, v, g)], ITERS, causal=False)
    # the profiler's reading at fewer calls, forward and backward (the fp32
    # ring rows were once read at 3 calls)
    by_calls = {}
    for calls in (1, 3):
        for what, fn in (("ring_partial", lambda _: ring.ring_partial(q, k, v, *args)),
                         ("ring_block_grads", lambda _: ring.ring_block_grads(
                             q, g, lse, dsum, k, v, dk, dv, *args))):
            dms, saw = cs.device_profile(torch, fn, 1, calls)
            by_calls[f"{what}_{calls}"] = dict(device_ms=dms, events=sum(
                c for c, _ in saw.values()))
    res["ring_past"] = dict(ms=ms, device_ms=dev_ms, library_ms=lib_ms,
                            launched_per_call=2, calls=ITERS, profiler_saw=seen,
                            tile_rel_errs=tiles, profiler_at_fewer_calls=by_calls)
    return res


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print("fp32_backward", json.dumps(measure(sys.argv[2])), flush=True)
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
