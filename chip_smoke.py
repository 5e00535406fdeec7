#!/usr/bin/env python3
"""Drive the PyTorch port (dalle_mtf_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, none of them optional:

1. Device and build: the card's name and power limit, then the CUDA kernels
   built from the repository's csrc/ sources (timed).
2. Kernel against plain: ``causal_attention`` (the hand-written kernel)
   against ``attention_reference`` on the card at the serving prefill shape
   and two others, with both times from CUDA events. Tolerance: fp32 atol
   1e-5; bf16 max-abs-err <= 1e-2 on unit-scale inputs (uniform in [-1, 1),
   so |out| <= 1 and one bf16 rounding of the output is <= 2^-9).
3. Slice: configs/dalle_coco.json at full width and depth with weights from a
   seed. Banded prefill logits on the card against the port's plain path on
   the CPU in fp32 (same weights); then the HTTP server (BatchingSampler,
   batch 4) answers mixed requests, with every kernel launch counted, and
   the per-batch latency is split into prefill, decode loop and VAE.

Prints the kernel report as one JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failed check raises, so the
exit code is non-zero and no result is printed. fp32 matmuls and convs run
in full fp32 here (TF32 off), so fp32 comparisons are like for like.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "dalle_mtf_tpu_torch/csrc/causal_attention_fwd.cu"
KERNEL_REPLACES = "dalle_mtf_tpu/ops/attention.py:572"  # _wedge_fwd_kernel
BATCH = 4


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch  # noqa: PLC0415

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel(torch, attn, card):
    """Kernel vs plain at three shapes; returns the serving shape's row."""
    shapes = [  # (name, B, H, S, D, dtype, window, atol)
        ("prefill", 4, 8, 256, 128, torch.bfloat16, None, 1e-2),
        ("ragged_window", 2, 4, 200, 64, torch.float32, 64, 1e-5),
        ("multi_tile", 2, 8, 1280, 128, torch.bfloat16, None, 1e-2),
    ]
    rows = []
    gen = torch.Generator().manual_seed(0)
    for name, b, h, s, d, dtype, window, atol in shapes:
        q, k, v = (
            (torch.rand((b, h, s, d), generator=gen) * 2 - 1).to("cuda", dtype)
            for _ in range(3)
        )
        before = attn.KERNEL_LAUNCHES["causal_attention_fwd"]
        out, lse = attn.causal_attention(q, k, v, window=window, with_lse=True)
        ref, ref_lse = attn.attention_reference(q, k, v, True, window, with_lse=True)
        torch.cuda.synchronize()
        if attn.KERNEL_LAUNCHES["causal_attention_fwd"] != before + 1:
            raise AssertionError("causal_attention did not count its launch")
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if not (err <= atol and lse_err <= 1e-4):
            raise AssertionError(
                f"{name}: kernel disagrees with attention_reference: "
                f"max_abs_err {err} (atol {atol}), lse err {lse_err}"
            )
        ms = cuda_ms(lambda: attn.causal_attention(q, k, v, window=window), 50)
        plain_ms = cuda_ms(
            lambda: attn.attention_reference(q, k, v, True, window), 50
        )
        row = dict(card=card, shape=name, B=b, H=h, S=s, D=d, dtype=str(dtype),
                   window=window, max_abs_err=err, lse_err=lse_err, atol=atol,
                   ms=ms, plain_ms=plain_ms)
        print("kernel", json.dumps(row), flush=True)
        rows.append(row)
    return rows[0]


def png_shape(b64: str) -> tuple[int, int, int]:
    """Decode a PNG with the standard library; return (H, W, C)."""
    data = base64.b64decode(b64)
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
            ">I", data[pos + 8 + n:pos + 12 + n]
        )[0]:
            raise AssertionError(f"bad CRC in PNG chunk {kind!r}")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = ihdr[:4]
    if (depth, color) != (8, 2):
        raise AssertionError(f"expected 8-bit RGB, got depth {depth} color {color}")
    raw = zlib.decompress(idat)
    if len(raw) != h * (1 + 3 * w):
        raise AssertionError("PNG pixel data has the wrong size")
    return h, w, 3


def post(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.load(r)


def get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.load(r)


def phase_slice(torch, attn, card):
    from dalle_mtf_tpu_torch.data.tokenizer import get_tokenizer, pad_or_truncate
    from dalle_mtf_tpu_torch.models.dalle import DALLE
    from dalle_mtf_tpu_torch.quantize import cast_decode_weights
    from dalle_mtf_tpu_torch.sample import generate_images
    from dalle_mtf_tpu_torch.serve import BatchingSampler, make_server
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params

    params = fetch_model_params("dalle_coco")
    dalle, vae = make_dalle_models(params, "cuda")
    cfg = dalle.cfg
    side = vae.cfg.image_size
    t0 = time.perf_counter()
    master = dalle.init(torch.Generator().manual_seed(0))
    vae_params = vae.init(torch.Generator().manual_seed(1))
    serve_params = cast_decode_weights(master, cfg.policy.compute_dtype)
    torch.cuda.synchronize()
    print(f"slice: {params['config_name']} n_embd={cfg.n_embd} layers={cfg.n_layers} "
          f"heads={cfg.n_heads} S={cfg.total_seq_len} vocab={cfg.total_tokens} "
          f"image_vocab={cfg.image_vocab_size} bf16={cfg.bf_16}; weights from "
          f"seed in {time.perf_counter() - t0:.1f}s", flush=True)

    # --- banded prefill logits on the card vs the plain path on the CPU, fp32
    tokenizer = get_tokenizer()
    texts = ["a red cube on a table", "two dogs playing in the snow"]
    tokens = torch.tensor([
        pad_or_truncate(tokenizer.encode(t), cfg.text_seq_len, tokenizer.pad_token_id)
        for t in texts
    ])
    band = (cfg.text_vocab_size, cfg.text_vocab_size + cfg.image_vocab_size)
    cpu32 = DALLE(dataclasses.replace(cfg, bf_16=False), "cpu")
    gpu32 = DALLE(dataclasses.replace(cfg, bf_16=False), "cuda")
    master_cpu = {k: (v.cpu() if not isinstance(v, dict)
                      else {n: t.cpu() for n, t in v.items()})
                  for k, v in master.items()}
    with torch.inference_mode():
        want = cpu32.prefill(master_cpu, tokens, cpu32.init_cache(2), band=band)
        got32 = gpu32.prefill(master, tokens.cuda(), gpu32.init_cache(2), band=band)
        got16 = dalle.prefill(serve_params, tokens.cuda(), dalle.init_cache(2), band=band)
    err32 = (got32.cpu() - want).abs().max().item()
    err16 = (got16.cpu() - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"prefill logits [2, {band[1] - band[0]}] vs CPU fp32 plain path: "
          f"card fp32 max_abs_err {err32:.3g} (atol 1e-3), card bf16 serving "
          f"weights max_abs_err {err16:.3g} (atol 0.1; |logits| max {scale:.3g})",
          flush=True)
    if not (err32 <= 1e-3 and err16 <= 0.1 and torch.isfinite(got16).all()):
        raise AssertionError("prefill logits disagree with the CPU fp32 plain path")

    # --- the server: BatchingSampler + HTTP, every kernel launch counted
    sampler = BatchingSampler(
        dalle, serve_params, vae, vae_params, batch_size=BATCH, top_k=64,
        linger_ms=100.0, seed=0,
    )
    server = make_server(sampler, tokenizer, cfg.text_seq_len,
                         host="127.0.0.1", port=0, timeout_s=600)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        batches_before = sampler.stats()["batches_done"]
        attn.KERNEL_LAUNCHES["causal_attention_fwd"] = 0
        t0 = time.perf_counter()
        greedy = {"text": texts[0], "n": 2, "temperature": 0.0, "top_k": 0}
        mixed = [
            greedy,
            {"text": texts[1], "n": 2, "temperature": 1.0, "top_k": 64},
            {"text": texts[1], "n": 2, "temperature": 0.7, "top_k": 40},
            {"text": "a bowl of fruit", "n": 2, "temperature": 0.8, "top_k": 16,
             "top_p": 0.9},
        ]
        replies = [None] * len(mixed)

        def send(i):
            replies[i] = post(port, mixed[i])

        senders = [threading.Thread(target=send, args=(i,)) for i in range(len(mixed))]
        for s in senders:
            s.start()
        for s in senders:
            s.join(timeout=900)
        again = post(port, greedy)  # a later batch: greedy must repeat exactly
        wall = time.perf_counter() - t0
        launches = attn.KERNEL_LAUNCHES["causal_attention_fwd"]
        batches = sampler.stats()["batches_done"] - batches_before
        if any(r is None for r in replies):
            raise AssertionError("a request got no reply")
        pngs = [im for r in replies + [again] for im in r["images"]]
        for im in pngs:
            if png_shape(im) != (side, side, 3):
                raise AssertionError(f"an image is not {side}x{side}x3")
        if again["images"] != replies[0]["images"]:
            raise AssertionError("two identical greedy requests differ")
        if launches != cfg.n_layers * batches or batches == 0:
            raise AssertionError(
                f"kernel launches {launches} != n_layers {cfg.n_layers} x "
                f"batches {batches}"
            )
        if get(port, "/healthz")["status"] != "ok":
            raise AssertionError("/healthz")
        stats = get(port, "/stats")
        if stats["batches_done"] != batches_before + batches:
            raise AssertionError(f"/stats: {stats}")
        print(f"served {len(pngs)} images in {len(replies) + 1} requests, "
              f"{batches} batches, {wall:.2f}s; kernel launches {launches} = "
              f"{cfg.n_layers} layers x {batches} batches; latencies "
              f"{[r['latency_s'] for r in replies + [again]]}; stats {stats}",
              flush=True)
    finally:
        server.shutdown()
        server.server_close()
        sampler.drain(timeout=600)
    if sampler._worker.is_alive():
        raise AssertionError("sampler worker did not stop")

    # --- per-batch latency at batch 4, split prefill / decode loop / VAE
    gen = torch.Generator(device="cuda").manual_seed(0)
    text4 = tokens.repeat(2, 1).cuda()
    temps = torch.full((BATCH,), 1.0, device="cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    with torch.inference_mode():
        imgs, total = timed(lambda: generate_images(
            dalle, serve_params, vae, vae_params, text4, gen,
            temperature=temps, top_k=64))
        head = dalle.logits_head(serve_params, band)
        _, t_prefill = timed(lambda: dalle.prefill(
            serve_params, text4, dalle.init_cache(BATCH), head=head))
        img_tokens = torch.randint(0, cfg.image_vocab_size,
                                   (BATCH, cfg.image_seq_len), device="cuda")
        _, t_vae = timed(lambda: vae.decode_tokens(vae_params, img_tokens))
    if imgs.shape != (BATCH, side, side, 3) or not torch.isfinite(imgs).all():
        raise AssertionError(f"generate_images gave {tuple(imgs.shape)}")
    split = dict(card=card, batch=BATCH, latency_s=total, images_per_s=BATCH / total,
                 prefill_s=t_prefill, vae_s=t_vae,
                 decode_loop_s=total - t_prefill - t_vae,
                 decode_steps=cfg.image_seq_len - 1)
    print("batch", json.dumps(split), flush=True)

    # --- a window of decode steps under torch.profiler: kernels per step and
    # the device's busy share (null when the profiler saw no device work)
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    steps = 16
    with torch.inference_mode():
        cache = dalle.init_cache(BATCH)
        logits = dalle.prefill(serve_params, text4, cache, head=head)
        tok = logits.argmax(-1) + cfg.text_vocab_size
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                dalle.decode_step(serve_params, cache, tok, cfg.text_seq_len + i,
                                  head=head)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e6
    print("decode_profile", json.dumps(dict(
        card=card, steps=steps, device_ops_per_step=len(device) / steps,
        device_busy_ms_per_step=busy / steps * 1e3,
        profiled_wall_ms_per_step=wall / steps * 1e3,
        unprofiled_wall_ms_per_step=split["decode_loop_s"] / split["decode_steps"] * 1e3,
        device_busy_share=busy / wall if device else None,
    )), flush=True)
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "dalle_mtf_tpu_torch")):
        print("chip_smoke.py: the dalle_mtf_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(card, flush=True)

    from dalle_mtf_tpu_torch.ops import _build  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415

    t0 = time.perf_counter()
    lib = _build.build()
    print(f"built {os.path.relpath(lib, HERE)} in {time.perf_counter() - t0:.1f}s",
          flush=True)

    serving = phase_kernel(torch, attn, card)
    launches = phase_slice(torch, attn, card)

    print(json.dumps({"kernels": [{
        "name": "causal_attention_fwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": serving["max_abs_err"],
        "ms": serving["ms"],
        "plain_ms": serving["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
