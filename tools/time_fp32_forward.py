#!/usr/bin/env python3
"""Time the fp32 attention forward kernels of one or more checkouts on one
GPU, in one call, for a comparison of two versions of the kernels.

    python3 tools/time_fp32_forward.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository; its ``dalle_mtf_tpu_torch``
package is imported from there (in a process of its own) and its kernels are
built there. Give parent, change, change, parent to compare two versions in
turns on one card. For each ROOT it measures, at the shapes the fp32 rows of
``chip_smoke.py``'s kernels line take:

- ``loop_fp32``: the causal forward ``ops.attention._forward`` (one launch,
  out and lse) at B=1, H=8, S=4352, D=128, fp32, on input copies that
  together exceed the 50 MB L2;
- ``ring_past``: ``ops.ring_attention.ring_partial`` at the ring slice's
  past hop, B=4, H=8, S_local=1088, D=128, fp32 (one launch);
- each timed between CUDA events (``ms``) and on the card under
  torch.profiler (``device_ms``, from a trace with one kernel event a
  launch), with SDPA's fp32 forward on the same inputs (``library_ms``:
  causal, and non-causal at the past hop, where every key is live) and the
  least time the card could take (``bound_ms``: three TF32 products for
  each product at the TF32 peak, or the bytes; ``bound_ms_fp32_peak`` beside
  it);
- the errors against the plain versions: each 64-long tile of out (num at
  the hop) within 1e-5 of its own max |plain|; lse, and m and l on the hop,
  as max abs and max relative errors.

Prints one "fp32_forward" JSON line per ROOT and, last, the card's name and
power limit. Needs one CUDA device; fails without one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 20  # timed calls (a call is 0.5-3 ms)


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
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {"root": root}
    gen = torch.Generator().manual_seed(2)

    # the causal pair's loop_fp32 shape
    b, h, s, d = 1, 8, 4352, 128
    q, k, v = ((torch.rand((b, h, s, d), generator=gen) * 2 - 1).cuda() for _ in range(3))
    before = attn.KERNEL_LAUNCHES["causal_attention_fwd"]
    out, lse = attn._forward(q, k, v, None, 0.0, None, with_lse=True)
    torch.cuda.synchronize()
    if attn.KERNEL_LAUNCHES["causal_attention_fwd"] != before + 1:
        raise AssertionError("causal_attention_fwd did not count its launch")
    ref, ref_lse = attn.attention_reference(q, k, v, True, None, True)
    errs = dict(out_tile=cs.tile_rel_err(out, ref), out_abs=cs.max_err(out, ref)[0],
                lse_abs=(lse - ref_lse).abs().max().item())
    del ref, ref_lse
    sets = cs.past_l2((q, k, v))
    ms = cs.rotating_ms(lambda q, k, v: attn._forward(q, k, v, None, 0.0, None, True), sets,
                        ITERS)
    dev_ms, seen = cs.device_profile(
        torch, lambda i: attn._forward(*sets[i], None, 0.0, None, True), len(sets), ITERS,
        ("attention_fwd",), 1)
    with torch.no_grad():
        lib_ms = cs.rotating_ms(lambda q, k, v: sdpa(q, k, v, is_causal=True), sets, ITERS)
    res["loop_fp32"] = dict(
        ms=ms, device_ms=dev_ms, library_ms=lib_ms, calls=ITERS, profiler_saw=seen, errs=errs,
        input_copies=len(sets), **cs.attention_roofline(b, h, s, d, 4, 4, 1, 2))
    del q, k, v, out, lse, sets
    torch.cuda.empty_cache()

    # the ring slice's past hop
    b, h, s, d = 4, 8, 1088, 128
    q, k, v = ((torch.rand((b, h, s, d), generator=gen) * 2 - 1).cuda() for _ in range(3))
    row0 = 3 * s
    args = (s, row0, row0 - s, None, 0.0, 0)
    num, m, l = ring.ring_partial(q, k, v, *args)
    ref_num, ref_m, ref_l = ring.ring_partial_reference(q, k, v, *args)
    torch.cuda.synchronize()
    errs = dict(num_tile=cs.tile_rel_err(num, ref_num), num_abs=cs.max_err(num, ref_num)[0])
    errs.update({n: ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
                 for n, got, want in (("m_rel", m, ref_m), ("l_rel", l, ref_l))})
    ms = cs.cuda_ms(lambda: ring.ring_partial(q, k, v, *args), ITERS)
    dev_ms, seen = cs.device_profile(torch, lambda _: ring.ring_partial(q, k, v, *args), 1,
                                     ITERS, ("ring_partial",), 1)
    with torch.no_grad():
        lib_ms = cs.cuda_ms(lambda: sdpa(q, k, v), ITERS)
    bh, pairs = b * h, s * s  # a past hop: every pair is live
    res["ring_past"] = dict(
        ms=ms, device_ms=dev_ms, library_ms=lib_ms, calls=ITERS, profiler_saw=seen, errs=errs,
        **cs.attention_bound(2 * 2 * d * bh * pairs,
                             3 * bh * s * d * 4 + bh * s * d * 4 + 2 * bh * s * 4, 4))
    return res


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print("fp32_forward", json.dumps(measure(sys.argv[2])), flush=True)
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
