#!/usr/bin/env python3
"""Time kernels of one or more checkouts on one GPU, in one call, for a
comparison of two versions of the kernels.

    python3 tools/time_kernels.py [--sections S[,S...]] [--all-plans] ROOT [ROOT ...]

Each ROOT is a checkout of this repository; its ``dalle_mtf_tpu_torch``
package is imported from there (in a process of its own) and its kernels are
built there. Give parent, change, change, parent to compare two versions in
turns on one card. The sections (all by default), at the shapes of
``chip_smoke.py``'s kernels line:

- ``fp32_forward``: the causal forward ``ops.attention._forward`` (one
  launch, out and lse) at ``loop_fp32``, B=1, H=8, S=4352, D=128, fp32, on
  input copies that together exceed the 50 MB L2, and
  ``ops.ring_attention.ring_partial`` at the ring slice's past hop, B=4,
  H=8, S_local=1088, D=128, fp32 (one launch); SDPA's fp32 forward on the
  same inputs (``library_ms``: causal, and non-causal at the past hop, where
  every key is live); the bound (three TF32 products for each product at
  the TF32 peak, or the bytes; ``bound_ms_fp32_peak`` beside it); each
  64-long tile of out (num at the hop) within 1e-5 of its own max |plain|,
  lse, and m and l on the hop, as max abs and relative errors;
- ``fp32_backward``: ``ops.attention._backward`` (its dsum reduction, the dQ
  and the dK/dV launch) at ``loop_fp32`` and ``ring_block_grads`` at the
  past hop (the dQ and dK/dV launch), with SDPA's fp32 backward and the
  tiles' errors; at the hop also the profiler's reading of the fp32 forward
  and backward over 1 and 3 calls;
- ``decode``: ``int8_matmul`` and ``int4_matmul`` at every shape of
  ``chip_smoke.DECODE_SHAPES``, on weight copies past the L2, with the plain
  version, ``torch.matmul`` on the bf16 dequantized weight (``library``),
  the byte bound, the kernels a call that the profiler saw by name, and the
  error against plain; with ``--all-plans``, also every other split of K
  (``ops.decode_matmul.candidates``) at the M = 4 shapes, for the roots
  that have them;
- ``layer_norm``: ``ops.layer_norm._forward`` and ``_backward`` at
  dalle_4k's rows (R = 17,408, E = 1024, bf16), at dalle_12B's width
  (R = 8192, E = 5120, bf16; for the roots whose kernels take it) and at a
  ragged fp32 shape (R = 1001, E = 768), on input copies past the 50 MB L2:
  the device time split by kernel name under torch.profiler, the plain
  pair, the library call (``F.layer_norm`` and its autograd backward), the
  byte bound, the errors against plain, and the kernels' resources where
  the root reports them.

Every time is read twice: between CUDA events (``ms``) and on the card under
torch.profiler (``device_ms``, from a trace that saw every launch where the
launches a call are known). Prints one JSON line per ROOT and section and,
last, the card's name and power limit. Needs one CUDA device; fails without
one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = ("fp32_forward", "fp32_backward", "decode", "layer_norm")
FORWARD_ITERS = 20   # timed calls (a call is 0.5-3 ms)
BACKWARD_ITERS = 10  # a call is 1-13 ms
DECODE_ITERS = 200   # a call is a few µs
LN_ITERS = 50        # a call is 20-100 µs
LN_CASES = [  # (name, R, E, dtype)
    ("dalle_4k", 17408, 1024, "bfloat16"), ("dalle_12B", 8192, 5120, "bfloat16"),
    ("ragged_fp32", 1001, 768, "float32"),
]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fp32_forward(torch, cs) -> dict:
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import ring_attention as ring  # noqa: PLC0415

    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {}
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
                        FORWARD_ITERS)
    dev_ms, seen = cs.device_profile(
        torch, lambda i: attn._forward(*sets[i], None, 0.0, None, True), len(sets),
        FORWARD_ITERS, ("attention_fwd",), 1)
    with torch.no_grad():
        lib_ms = cs.rotating_ms(lambda q, k, v: sdpa(q, k, v, is_causal=True), sets,
                                FORWARD_ITERS)
    res["loop_fp32"] = dict(
        ms=ms, device_ms=dev_ms, library_ms=lib_ms, calls=FORWARD_ITERS, profiler_saw=seen,
        errs=errs, input_copies=len(sets), **cs.attention_roofline(b, h, s, d, 4, 4, 1, 2))
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
    ms = cs.cuda_ms(lambda: ring.ring_partial(q, k, v, *args), FORWARD_ITERS)
    dev_ms, seen = cs.device_profile(torch, lambda _: ring.ring_partial(q, k, v, *args), 1,
                                     FORWARD_ITERS, ("ring_partial",), 1)
    with torch.no_grad():
        lib_ms = cs.cuda_ms(lambda: sdpa(q, k, v), FORWARD_ITERS)
    bh, pairs = b * h, s * s  # a past hop: every pair is live
    res["ring_past"] = dict(
        ms=ms, device_ms=dev_ms, library_ms=lib_ms, calls=FORWARD_ITERS, profiler_saw=seen,
        errs=errs, **cs.attention_bound(2 * 2 * d * bh * pairs,
                                        3 * bh * s * d * 4 + bh * s * d * 4 + 2 * bh * s * 4, 4))
    return res


def fp32_backward(torch, cs) -> dict:
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import ring_attention as ring  # noqa: PLC0415

    res = {}
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
        q, k, v, out, lse, g, None, 0.0, None), sets, BACKWARD_ITERS)
    dev_ms, seen = cs.device_profile(torch, lambda i: attn._backward(
        *sets[i][:3], sets[i][4], sets[i][5], sets[i][3], None, 0.0, None), len(sets),
        BACKWARD_ITERS)
    _, lib_ms = cs.sdpa_bhsd_ms(torch, sets, BACKWARD_ITERS)
    res["loop_fp32"] = dict(ms=ms, device_ms=dev_ms, library_ms=lib_ms,
                            launched_per_call=2, calls=BACKWARD_ITERS, profiler_saw=seen,
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

    def grads_call(_=None):
        return ring.ring_block_grads(q, g, lse, dsum, k, v, dk, dv, *args)

    ms = cs.cuda_ms(grads_call, BACKWARD_ITERS)
    dev_ms, seen = cs.device_profile(torch, grads_call, 1, BACKWARD_ITERS)
    _, lib_ms = cs.sdpa_bhsd_ms(torch, [(q, k, v, g)], BACKWARD_ITERS, causal=False)
    # the profiler's reading at fewer calls, forward and backward (the fp32
    # ring rows were once read at 3 calls)
    by_calls = {}
    for calls in (1, 3):
        for what, fn in (("ring_partial", lambda _: ring.ring_partial(q, k, v, *args)),
                         ("ring_block_grads", grads_call)):
            dms, saw = cs.device_profile(torch, fn, 1, calls)
            by_calls[f"{what}_{calls}"] = dict(device_ms=dms, events=sum(
                c for c, _ in saw.values()))
    res["ring_past"] = dict(ms=ms, device_ms=dev_ms, library_ms=lib_ms,
                            launched_per_call=2, calls=BACKWARD_ITERS, profiler_saw=seen,
                            tile_rel_errs=tiles, profiler_at_fewer_calls=by_calls)
    return res


def _decode_times(torch, cs, call, copies, per_call) -> dict:
    """Events and profiler time of ``call(i)``, which launches ``per_call``
    kernels, and what the profiler saw."""
    dev_ms, seen = cs.device_profile(torch, call, copies, DECODE_ITERS,
                                     ("decode_matmul", "splitk_reduce"), per_call)
    return dict(ms=cs.cuda_ms_rotating(call, copies, DECODE_ITERS), device_ms=dev_ms,
                kernels_a_call={n: c / DECODE_ITERS for n, (c, _) in seen.items()})


def decode(torch, cs, all_plans: bool) -> dict:
    import math  # noqa: PLC0415

    from dalle_mtf_tpu_torch.ops import decode_matmul as dmm  # noqa: PLC0415

    res = {}
    gen = torch.Generator(device="cuda").manual_seed(11)
    per_call = 1 if hasattr(dmm, "plan") else 2  # the parent adds a split-K reduce kernel
    for name, m, k, n in cs.DECODE_SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
        for kind in ("int8_matmul", "int4_matmul"):
            fn, ref, xs, packed, scale, deq = cs.decode_case(torch, dmm, name, kind, x, w)
            got, want = fn(*xs, packed, scale), ref(*xs, packed, scale)
            err = (got - want).abs().max().item()
            copies = max(1, math.ceil(2 * cs.L2_BYTES / packed.numel()))
            ws = [(packed.clone(), scale.clone()) for _ in range(copies)]
            lib_copies = max(1, math.ceil(2 * cs.L2_BYTES / (2 * deq.numel())))
            ds = [deq.clone() for _ in range(lib_copies)]
            nbytes = packed.numel() + x.numel() * 2 + scale.numel() * 4 + m * n * 4
            row = dict(max_abs_err=err, atol=1e-5 * want.abs().max().item(),
                       **_decode_times(torch, cs, lambda i: fn(*xs, *ws[i]), copies, per_call),
                       plain_device_ms=cs.device_ms_rotating(
                           torch, lambda i: ref(*xs, *ws[i]), copies, 20),
                       library_device_ms=cs.device_ms_rotating(
                           torch, lambda i: torch.matmul(x, ds[i % lib_copies]), copies,
                           DECODE_ITERS),
                       **cs.roofline(2 * m * k * n, nbytes))
            if hasattr(dmm, "plan"):
                kp = packed.shape[0]
                walk = dmm.plan(kp, kind == "int4_matmul")
                row["plan"] = walk._asdict()
                if all_plans and m == 4 and n % 16 == 0:
                    row["plans"] = [
                        dict(plan=p._asdict(), ctas=dmm.ctas(p, m, n), **_decode_times(
                            torch, cs, lambda i, p=p: dmm._launch(kind, xs, *ws[i], p),
                            copies, 1))
                        for p in dmm.candidates(kp)]
            res[f"{kind}:{name}"] = row
            del ws, ds
        torch.cuda.empty_cache()
    return res


def _span_and_host_ms(torch, fn, copies) -> tuple[float, float]:
    """(the card's timeline a call: first kernel start to last kernel end
    over LN_ITERS back-to-back calls under torch.profiler, gaps included;
    the host's time to enqueue a call, no synchronisation inside)."""
    import time  # noqa: PLC0415

    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    for i in range(3):
        fn(i % copies)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LN_ITERS):
        fn(i % copies)
    host = (time.perf_counter() - t0) * 1e3 / LN_ITERS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(LN_ITERS):
            fn(i % copies)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return float("nan"), host
    span = max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)
    return span / 1e3 / LN_ITERS, host


def _ln_times(torch, cs, fn, copies) -> dict:
    """Events and profiler time of ``fn(i)``, with the device time split by
    kernel name, from a trace that saw every LN kernel of every call (the
    kernels a call are counted on a first trace); the card's timeline a call
    and the host's enqueue time a call."""
    seen = cs.device_profile(torch, fn, copies, 10)[1]
    per_call = round(sum(c for n, (c, _) in seen.items() if "layer_norm" in n) / 10)
    dev_ms, seen = cs.device_profile(torch, fn, copies, LN_ITERS, ("layer_norm",), per_call)
    span, host = _span_and_host_ms(torch, fn, copies)
    return dict(ms=cs.cuda_ms_rotating(fn, copies, LN_ITERS), device_ms=dev_ms,
                span_ms=span, host_ms=host, kernels_a_call=per_call,
                device_ms_by_kernel={n: us / 1e3 / LN_ITERS for n, (_, us) in seen.items()})


def _bwd_launch_host_ms(torch, lnm, x, g, dy) -> float:
    """The host's time a call of the C entry point ``layer_norm_bwd`` alone
    (the cooperative launch, its checks and its occupancy query), on
    buffers made once."""
    import time  # noqa: PLC0415

    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    rows, e = x.shape
    n_ctas = lnm.bwd_ctas(0, rows, e, x.dtype)
    dx = torch.empty_like(x)
    partial = torch.empty((n_ctas, 2, e), device="cuda")
    sums = torch.empty((2, e), device="cuda")
    stream = torch.cuda.current_stream()
    args = (x.data_ptr(), dy.data_ptr(), g.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            lnm._barrier(x.device, stream).data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
            rows, e, lnm.bwd_tile_rows(e, x.dtype), n_ctas, lnm.KERNEL_DTYPES[x.dtype], 1e-5,
            stream.cuda_stream)
    lib = library()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LN_ITERS):
        if lib.layer_norm_bwd(*args) != 0:
            raise RuntimeError("layer_norm_bwd launch failed")
    host = (time.perf_counter() - t0) * 1e3 / LN_ITERS
    torch.cuda.synchronize()
    return host


def layer_norm(torch, cs) -> dict:
    import math  # noqa: PLC0415

    from dalle_mtf_tpu_torch.ops import layer_norm as lnm  # noqa: PLC0415

    res = {}
    gen = torch.Generator().manual_seed(3)
    for name, r, e, dt in LN_CASES:
        if e > lnm.MAX_E:
            res[name] = f"not taken: E = {e} > MAX_E = {lnm.MAX_E}"
            continue
        dtype = getattr(torch, dt)
        elem = torch.finfo(dtype).bits // 8
        copies = max(1, math.ceil(2 * cs.L2_BYTES / (2 * r * e * elem)))
        xs = [(torch.randn((r, e), generator=gen) * 2 + 0.5).to("cuda", dtype)
              for _ in range(copies)]
        dys = [torch.randn((r, e), generator=gen).to("cuda", dtype) for _ in range(copies)]
        g = (1 + 0.3 * torch.randn(e, generator=gen)).cuda()
        b = (0.2 * torch.randn(e, generator=gen)).cuda()
        x, dy = xs[0], dys[0]
        y = lnm._forward(x, g, b, 1e-5)
        dx, dg, db = lnm._backward(x, g, dy, 1e-5)
        again = lnm._backward(x, g, dy, 1e-5)
        want_dx, want_dg, want_db = lnm.layer_norm_backward_reference(x, g, dy)
        errs = dict(y=cs.max_err(y, lnm.layer_norm_reference(x, g, b))[0],
                    dx=cs.max_err(dx, want_dx)[0],
                    dg_rel=((dg - want_dg).abs().max() / want_dg.abs().max()).item(),
                    db_rel=((db - want_db).abs().max() / want_db.abs().max()).item(),
                    dg_db_bit_equal=bool(torch.equal(again[1], dg) and torch.equal(again[2], db)))
        g_lib, b_lib = g.to(dtype), b.to(dtype)
        leaves = [[t.clone().requires_grad_(True) for t in (xs[i], g_lib, b_lib)]
                  for i in range(copies)]
        y_lib = [torch.nn.functional.layer_norm(lv[0], (e,), lv[1], lv[2], 1e-5) for lv in leaves]
        row = dict(R=r, E=e, dtype=dt, input_copies=copies, errs=errs)
        for kind, kern, plain, lib, n in (
            ("fwd", lambda i: lnm._forward(xs[i], g, b, 1e-5),
             lambda i: lnm.layer_norm_reference(xs[i], g, b),
             lambda i: torch.nn.functional.layer_norm(xs[i], (e,), g_lib, b_lib, 1e-5), 2),
            ("bwd", lambda i: lnm._backward(xs[i], g, dys[i], 1e-5),
             lambda i: lnm.layer_norm_backward_reference(xs[i], g, dys[i]),
             lambda i: torch.autograd.grad(y_lib[i], leaves[i], dys[i], retain_graph=True), 3),
        ):
            row[kind] = dict(**_ln_times(torch, cs, kern, copies),
                             plain_device_ms=cs.device_ms_rotating(torch, plain, copies, 10),
                             library_device_ms=cs.device_ms_rotating(torch, lib, copies, LN_ITERS),
                             **cs.roofline((9 if kind == "fwd" else 16) * r * e,
                                           n * r * e * elem + n * e * 4, cs.PEAK_FP32_TFLOPS))
        if hasattr(lnm, "kernel_resources"):
            row["resources"] = lnm.kernel_resources(e, dtype)
        if hasattr(lnm, "bwd_tile_rows"):
            # the fixed cost of the grid: one tile a CTA, every CTA resident
            rows = lnm.bwd_tile_rows(e, dtype) * lnm.bwd_resident_ctas(0, e, dtype)
            row["bwd"]["one_tile_a_cta"] = dict(R=rows, device_ms=cs.device_ms_rotating(
                torch, lambda i: lnm._backward(xs[i][:rows], g, dys[i][:rows], 1e-5), copies,
                LN_ITERS))
            row["bwd"]["launch_host_ms"] = _bwd_launch_host_ms(torch, lnm, x, g, dy)
        res[name] = row
        del xs, dys, leaves, y_lib
        torch.cuda.empty_cache()
    return res


def measure(root: str, sections, all_plans: bool) -> dict:
    """The measurements of one checkout (run in a process of its own)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch  # noqa: PLC0415

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dalle_mtf_tpu_torch.ops import _build  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415

    if not os.path.abspath(attn.__file__).startswith(os.path.abspath(root)):
        raise AssertionError(f"imported {attn.__file__}, not the package under {root}")
    _build.build()
    res = {}
    for section in sections:
        res[section] = (decode(torch, cs, all_plans) if section == "decode"
                        else globals()[section](torch, cs))
    return res


def main() -> int:
    args = sys.argv[1:]
    sections, all_plans = SECTIONS, "--all-plans" in args
    args = [a for a in args if a != "--all-plans"]
    if args[:1] == ["--sections"]:
        sections = tuple(args[1].split(","))
        args = args[2:]
    if args[:1] == ["--one"]:
        for section, res in measure(args[1], sections, all_plans).items():
            print(section, json.dumps(dict(root=args[1], **res)), flush=True)
        return 0
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available() or not args or not set(sections) <= set(SECTIONS):
        print(__doc__, file=sys.stderr)
        return 1
    for root in args:
        cmd = [sys.executable, os.path.abspath(__file__), "--sections", ",".join(sections),
               *(["--all-plans"] if all_plans else []), "--one", root]
        proc = subprocess.run(cmd, cwd=HERE, check=False)
        if proc.returncode != 0:
            return proc.returncode
    print(_chip_smoke().gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
