#!/usr/bin/env python3
"""Drive the PyTorch port (dalle_mtf_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, none of them optional:

1. Device and build: the card's name and power limit, then the CUDA kernels
   built from the repository's csrc/ sources (one nvcc per source, timed).
2. Kernels against plain, on the card, both times from CUDA events:
   - the [B, H, S, D] forward ``causal_attention`` against
     ``attention_reference`` at the serving prefill shape and two others;
   - the packed training pair (forward ``causal_attention_fwd`` by strides,
     backward ``causal_attention_bwd``) against ``attention_packed_reference``
     and ``backward_reference``: out, lse, dq, dk, dv at the training shape
     (B=16, S=1280, H=8, D=128, bf16), a ragged fp32 shape with window 64,
     and the training shape with hash dropout 0.1 (one seed on both sides);
   - the [B, H, S, D] forward with hash dropout.
   Tolerance: max |kernel - plain| <= atol * max(1, max|plain|), atol 1e-5
   in fp32 and 1e-2 in bf16 on unit-scale inputs (uniform in [-1, 1); one
   bf16 rounding is 2^-8 relative); lse atol 1e-4.
3. Training values: a full-width configs/dalle_coco_synth.json model cut to
   2 layers, fp32, batch 2: loss and every parameter grad on the card
   (through the kernels) against the port's plain path on the CPU, same
   weights and tokens. Tolerance: loss atol 1e-4; each grad leaf within
   relative L2 error 1e-2. fp32 sums run in another order on each side, and
   a ReLU gate whose input is within rounding of 0 may flip between the two:
   a flip moves single elements of the MLP grads by ~1% of the leaf's
   largest and spreads into the LN grads (~1e-3 in L2), so there is no
   per-element bound.
4. Training slice, the main path: a copy of configs/dalle_coco_synth.json
   (full width and depth, batch 16, bf16) in tokens mode on tfrecords
   written from a seed, through ``train_dalle.main`` for 8 steps with a
   checkpoint and an eval, then a second ``main`` that resumes there for 2
   more. Checks the first loss within 0.1 of its expectation at init,
   ln(vocab) + n_embd * 0.02^2 / 2 (the logits' variance over 2), finite
   losses and grad norms, and the kernels' launch counts; times the steady steps (tokens/s,
   MFU against 989 TFLOP/s dense bf16 with bench.py's FLOP formula, peak
   memory), then profiles two more steps for the split of device time.
5. Serving slice: configs/dalle_coco.json at full width and depth with
   weights from a seed. Banded prefill logits on the card against the port's
   plain path on the CPU in fp32 (same weights); then the HTTP server
   (BatchingSampler, batch 4) answers mixed requests, with every kernel
   launch counted, and the per-batch latency is split into prefill, decode
   loop and VAE.

Prints "kernel", "train" and "batch" JSON lines, then the kernel report as one
JSON line, the card's name and power limit, and last ``{"ok": true,
"device": {...}}``. Any failed check raises, so the exit code is non-zero and
no result is printed. fp32 matmuls and convs run in full fp32 here (TF32
off), so fp32 comparisons are like for like.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import math
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
FWD_SOURCE = "dalle_mtf_tpu_torch/csrc/causal_attention_fwd.cu"
BWD_SOURCE = "dalle_mtf_tpu_torch/csrc/causal_attention_bwd.cu"
REPLACES = {
    "causal_attention_packed_fwd": "dalle_mtf_tpu/ops/attention_packed.py:160",  # _fused_fwd_kernel
    "causal_attention_packed_bwd": "dalle_mtf_tpu/ops/attention_packed.py:205",  # _fused_bwd_kernel
    "causal_attention_fwd": "dalle_mtf_tpu/ops/attention.py:572",  # _wedge_fwd_kernel
}
BATCH = 4
TRAIN_CONFIG = "dalle_coco_synth"
TRAIN_STEPS, RESUME_STEPS, TIMED_FROM = 8, 2, 3  # steps 3..8 are timed
PEAK_BF16_TFLOPS = 989.0  # H100 SXM dense bf16 (NVIDIA data sheet)


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


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max(1, max |want|))."""
    return ((got.float() - want.float()).abs().max().item(),
            max(1.0, want.float().abs().max().item()))


def phase_kernel(torch, attn, card):
    """[B, H, S, D] kernel vs plain at three shapes; returns the serving
    shape's row."""
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
        row = dict(card=card, kernel="causal_attention_fwd", shape=name, B=b, H=h, S=s,
                   D=d, dtype=str(dtype), window=window, max_abs_err=err,
                   lse_err=lse_err, atol=atol, ms=ms, plain_ms=plain_ms)
        print("kernel", json.dumps(row), flush=True)
        rows.append(row)
    return rows[0]


def phase_train_kernels(torch, attn, card):
    """The packed forward/backward pair and the [B, H, S, D] forward with
    dropout against their plain versions. Returns {kernel name: row at the
    training shape (without dropout)}."""
    from dalle_mtf_tpu_torch.ops import attention_packed as ap  # noqa: PLC0415

    cases = [  # (name, B, H, S, D, dtype, window, dropout, timing iters)
        ("train", 16, 8, 1280, 128, torch.bfloat16, None, 0.0, 10),
        ("ragged_window", 2, 4, 200, 64, torch.float32, 64, 0.0, 20),
        ("train_dropout", 16, 8, 1280, 128, torch.bfloat16, None, 0.1, 5),
    ]
    seed = 2**31 - 7  # near the top of the range: the uint32 add wraps
    gen = torch.Generator().manual_seed(1)
    best = {}
    for name, b, h, s, d, dtype, window, rate, iters in cases:
        atol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        q, k, v, g = ((torch.rand((b, s, h * d), generator=gen) * 2 - 1).to("cuda", dtype)
                      for _ in range(4))
        before = dict(attn.KERNEL_LAUNCHES)
        out, lse = ap._forward(q, k, v, h, window, rate, seed)
        grads = ap._backward(q, k, v, out, lse, g, h, window, rate, seed)
        ref, ref_lse = ap.attention_packed_reference(q, k, v, h, window, rate, seed,
                                                     with_lse=True)
        # the plain backward from the kernel's out and lse: only the backward differs
        ref_grads = ap.backward_reference(q, k, v, out, lse, g, h, window, rate, seed)
        torch.cuda.synchronize()
        for key in ("causal_attention_packed_fwd", "causal_attention_packed_bwd"):
            if attn.KERNEL_LAUNCHES[key] != before[key] + 1:
                raise AssertionError(f"{key} did not count its launch")
        errs = {"out": max_err(out, ref)}
        errs.update({n: max_err(t, r) for n, t, r in zip(("dq", "dk", "dv"), grads, ref_grads)})
        lse_err = (lse - ref_lse).abs().max().item()
        bad = {n: e for n, (e, scale) in errs.items() if not e <= atol * scale}
        if bad or not lse_err <= 1e-4:
            raise AssertionError(
                f"packed {name}: kernels disagree with the plain versions: {bad} "
                f"(atol {atol} x max(1, |plain|)), lse err {lse_err}; all {errs}")
        fwd_ms = cuda_ms(lambda: ap._forward(q, k, v, h, window, rate, seed), iters)
        fwd_plain = cuda_ms(lambda: ap.attention_packed_reference(
            q, k, v, h, window, rate, seed, with_lse=True), iters)
        bwd_ms = cuda_ms(lambda: ap._backward(q, k, v, out, lse, g, h, window, rate, seed), iters)
        bwd_plain = cuda_ms(lambda: ap.backward_reference(
            q, k, v, out, lse, g, h, window, rate, seed), iters)
        common = dict(card=card, shape=name, B=b, H=h, S=s, D=d, dtype=str(dtype),
                      window=window, dropout=rate, atol=atol)
        rows = {
            "causal_attention_packed_fwd": dict(
                kernel="causal_attention_packed_fwd", **common,
                max_abs_err=errs["out"][0], lse_err=lse_err, ms=fwd_ms, plain_ms=fwd_plain),
            "causal_attention_packed_bwd": dict(
                kernel="causal_attention_packed_bwd", **common,
                max_abs_err=max(errs[n][0] for n in ("dq", "dk", "dv")),
                errs={n: errs[n][0] for n in ("dq", "dk", "dv")},
                ms=bwd_ms, plain_ms=bwd_plain, ms_includes="dsum reduction + dQ and dK/dV launches"),
        }
        for row in rows.values():
            print("kernel", json.dumps(row), flush=True)
        if name == "train":
            best = rows
        del q, k, v, g, out, lse, grads, ref, ref_lse, ref_grads
        torch.cuda.empty_cache()

    # the [B, H, S, D] forward (serving layout) with hash dropout
    for b, h, s, d, window in ((4, 8, 256, 128, None), (2, 4, 200, 64, 64)):
        q, k, v = ((torch.rand((b, h, s, d), generator=gen) * 2 - 1).to("cuda") for _ in range(3))
        before = attn.KERNEL_LAUNCHES["causal_attention_fwd"]
        out, lse = attn.causal_attention(q, k, v, window, 0.1, True, dropout_seed=seed)
        ref, ref_lse = attn.attention_reference(q, k, v, True, window, True, 0.1, seed)
        torch.cuda.synchronize()
        err, scale = max_err(out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        if attn.KERNEL_LAUNCHES["causal_attention_fwd"] != before + 1:
            raise AssertionError("causal_attention did not count its launch")
        if not (err <= 1e-5 * scale and lse_err <= 1e-4):
            raise AssertionError(f"[B, H, S, D] dropout: err {err}, lse err {lse_err}")
        print("kernel", json.dumps(dict(
            card=card, kernel="causal_attention_fwd", shape="dropout", B=b, H=h, S=s, D=d,
            dtype="torch.float32", window=window, dropout=0.1, max_abs_err=err,
            lse_err=lse_err, atol=1e-5,
            ms=cuda_ms(lambda: attn.causal_attention(q, k, v, window, 0.1, dropout_seed=seed), 20),
            plain_ms=cuda_ms(lambda: attn.attention_reference(
                q, k, v, True, window, False, 0.1, seed), 20),
        )), flush=True)
    return best


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.detach().to(device)
            for k, v in tree.items()}


def phase_train_values(torch, card):
    """Loss and every grad of a full-width, 2-layer fp32 model: card (through
    the kernels) against the port's plain path on the CPU."""
    from dalle_mtf_tpu_torch.models.dalle import DALLE  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415

    base, _ = make_dalle_models(fetch_model_params(TRAIN_CONFIG), "cpu")
    cfg = dataclasses.replace(base.cfg, n_layers=2, bf_16=False)
    params = DALLE(cfg, "cpu").init(torch.Generator().manual_seed(5))
    tokens = torch.randint(0, cfg.total_tokens, (2, cfg.total_seq_len),
                           generator=torch.Generator().manual_seed(6))
    results = {}
    for device in ("cuda", "cpu"):
        tree = _to(params, device)
        for _, t in named_leaves(tree):
            t.requires_grad_(True)
        before = attn.KERNEL_LAUNCHES["causal_attention_packed_bwd"]
        loss, _ = DALLE(cfg, device).loss(tree, tokens.to(device))
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            if attn.KERNEL_LAUNCHES["causal_attention_packed_bwd"] != before + cfg.n_layers:
                raise AssertionError("the card's loss did not run the backward kernel")
        results[device] = (loss.item(), {"/".join(p): t.grad.cpu() for p, t in named_leaves(tree)})
    (gl, gg), (cl, cg) = results["cuda"], results["cpu"]
    l2 = max((((gg[n] - cg[n]).norm() / cg[n].norm().clamp_min(1e-30)).item(), n) for n in cg)
    elem = max(((gg[n] - cg[n]).abs().max().item() / max(cg[n].abs().max().item(), 1e-30), n)
               for n in cg)
    print(f"train values: {cfg.n_embd} wide, {cfg.n_layers} layers, fp32, batch 2, S "
          f"{cfg.total_seq_len}: loss card {gl:.6f} cpu {cl:.6f} (atol 1e-4); worst grad "
          f"relative L2 error {l2[0]:.3g} ({l2[1]}, bound 1e-2); worst single element "
          f"{elem[0]:.3g} of its leaf's max |grad| ({elem[1]}); {card}", flush=True)
    if not (abs(gl - cl) <= 1e-4 and l2[0] <= 1e-2):
        raise AssertionError("the card's loss or grads disagree with the CPU plain path")
    return dict(loss_card=gl, loss_cpu=cl, worst_grad_rel_l2=l2, worst_grad_elem=elem)


def write_tokens_dataset(root: str, seed: int, image_len: int, image_vocab: int,
                         files: int = 4, per_file: int = 48) -> str:
    """Tokens-mode tfrecords (tokens + caption ids) drawn from ``seed``."""
    import numpy as np  # noqa: PLC0415

    from dalle_mtf_tpu_torch.data.tfrecord import TFRecordWriter, serialize_example  # noqa: PLC0415

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for f in range(files):
        with TFRecordWriter(os.path.join(root, f"synth_{f}.tfrecords")) as w:
            for _ in range(per_file):
                w.write(serialize_example({
                    "tokens": rng.integers(0, image_vocab, image_len).tolist(),
                    "caption": rng.integers(0, 50257, rng.integers(5, 64)).tolist(),
                }))
    return os.path.join(root, "*.tfrecords")


def train_config(tmp: str, train_steps: int) -> str:
    """A copy of configs/dalle_coco_synth.json in tokens mode over a seeded
    dataset in ``tmp``; returns its path."""
    from dalle_mtf_tpu_torch.utils.config import _resolve_config_path  # noqa: PLC0415

    with open(_resolve_config_path(TRAIN_CONFIG)) as f:
        cfg = json.load(f)
    pattern = os.path.join(tmp, "data", "*.tfrecords")
    cfg.update(
        dataset={**cfg["dataset"], "train_path": pattern, "eval_path": pattern, "tokens": True},
        train_steps=train_steps, steps_per_checkpoint=TRAIN_STEPS, eval_steps=1,
        log_every=1, max_to_keep=1, model_path=os.path.join(tmp, "run"),
    )
    path = os.path.join(tmp, f"{TRAIN_CONFIG}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def phase_train(torch, attn, card, kernel_rows):
    """The training main path through train_dalle.main, then a profiled
    window of steps. Returns the launch counts of the main path's run."""
    from dalle_mtf_tpu_torch import train_dalle  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        dalle, _ = make_dalle_models(fetch_model_params(TRAIN_CONFIG), "cpu")
        cfg = dalle.cfg
        t0 = time.perf_counter()
        write_tokens_dataset(os.path.join(tmp, "data"), 0, cfg.image_seq_len, cfg.image_vocab_size)
        path = train_config(tmp, TRAIN_STEPS)
        print(f"train: tokens dataset + config in {time.perf_counter() - t0:.1f}s", flush=True)
        names = ("causal_attention_packed_fwd", "causal_attention_packed_bwd")

        torch.cuda.reset_peak_memory_stats()
        for key in attn.KERNEL_LAUNCHES:
            attn.KERNEL_LAUNCHES[key] = 0
        t0 = time.perf_counter()
        first = train_dalle.main(["--model", path, "--new", "--yes", "--gpu_ids", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(attn.KERNEL_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        evals = first.eval_history
        want = {names[0]: cfg.n_layers * (TRAIN_STEPS + len(evals)),
                names[1]: cfg.n_layers * TRAIN_STEPS}
        losses = [h["loss"] for h in first.history]
        if [h["step"] for h in first.history] != list(range(1, TRAIN_STEPS + 1)):
            raise AssertionError(f"logged steps {[h['step'] for h in first.history]}")
        # at init the logits are ~N(0, n_embd * 0.02^2) (unit-variance LN
        # output times w_out of std 0.02), so E[loss] = ln(vocab) + var / 2
        init_loss = math.log(cfg.total_tokens) + cfg.n_embd * 0.02**2 / 2
        if abs(losses[0] - init_loss) > 0.1:
            raise AssertionError(f"first loss {losses[0]} vs ln(vocab) + var/2 = {init_loss}")
        if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                   for h in first.history):
            raise AssertionError(f"non-finite loss or grad_norm: {first.history}")
        if [e["step"] for e in evals] != [TRAIN_STEPS] or not math.isfinite(evals[0]["eval_loss"]):
            raise AssertionError(f"eval: {evals}")
        if first.checkpoint_steps() != [TRAIN_STEPS]:
            raise AssertionError(f"checkpoints {first.checkpoint_steps()}")
        if {n: launches[n] for n in names} != want or launches["causal_attention_fwd"]:
            raise AssertionError(f"kernel launches {launches}, expected {want}")
        step_s = [1.0 / h["steps_per_sec"] for h in first.history[TIMED_FROM - 1:]]
        med = statistics.median(step_s)
        tokens_per_step = first.batch_size * cfg.total_seq_len

        # resume: a second main continues from the checkpoint
        path = train_config(tmp, TRAIN_STEPS + RESUME_STEPS)
        for key in attn.KERNEL_LAUNCHES:
            attn.KERNEL_LAUNCHES[key] = 0
        second = train_dalle.main(["--model", path, "--gpu_ids", "0"])
        resumed = [h["step"] for h in second.history]
        if resumed != list(range(TRAIN_STEPS + 1, TRAIN_STEPS + RESUME_STEPS + 1)):
            raise AssertionError(f"resume logged steps {resumed}")
        if attn.KERNEL_LAUNCHES[names[1]] != cfg.n_layers * RESUME_STEPS:
            raise AssertionError(f"resume launches {attn.KERNEL_LAUNCHES}")
        print(f"train: {TRAIN_STEPS} steps + eval + checkpoint in {wall:.1f}s; losses "
              f"{[round(x, 4) for x in losses]}; eval {evals[0]}; resumed at step "
              f"{TRAIN_STEPS}: losses {[round(h['loss'], 4) for h in second.history]}; "
              f"launches {launches}", flush=True)

        split = profile_steps(torch, path, cfg)
        # bench.py's analytic FLOPs per token (6 N_matmul + 12 L E S)
        e, L, v, s = cfg.n_embd, cfg.n_layers, cfg.total_tokens, cfg.total_seq_len
        flops_per_token = 6 * (L * 12 * e * e + e * v) + 12 * L * e * s
        tflops = tokens_per_step / med * flops_per_token / 1e12
        attn_ms = cfg.n_layers * (kernel_rows[names[0]]["ms"] + kernel_rows[names[1]]["ms"])
        print("train", json.dumps(dict(
            card=card, config=TRAIN_CONFIG, batch=first.batch_size, seq_len=s,
            n_layers=L, n_embd=e, vocab=v, bf16=cfg.bf_16, steps_timed=len(step_s),
            step_s=step_s, step_s_median=med, tokens_per_s=tokens_per_step / med,
            tflops_per_s=tflops, mfu=tflops / PEAK_BF16_TFLOPS,
            peak_mem_gb=peak / 1e9, first_loss=losses[0], ln_vocab=math.log(v),
            expected_init_loss=init_loss,
            attn_kernels_ms_per_step_from_events=attn_ms,
            attn_kernels_share_from_events=attn_ms / (med * 1e3),
            **split,
        )), flush=True)
        return {n: launches[n] for n in names}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def profile_steps(torch, path, cfg, steps: int = 2) -> dict:
    """Device time of ``steps`` training steps under torch.profiler, split
    into the attention kernels, matmuls and the rest (with the rest's
    largest kernels by name)."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    from dalle_mtf_tpu_torch.data.pipeline import dalle_input_fn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_task  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.trainer import Trainer, step_generator  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    params = fetch_model_params(path)
    params["padding_id"] = 50257
    _, init_fn, loss_fn, _ = make_dalle_task(params, "cuda")
    trainer = Trainer(params, init_fn, loss_fn, params["model_path"] + "_profile",
                      cfg.total_seq_len, "cuda")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    data = iter(dalle_input_fn(params))
    state, _ = trainer.train_step(state, next(data), step_generator(0, 1, 0))
    batches = [next(data) for _ in range(steps)]
    data.close()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            state, metrics = trainer.train_step(state, batch, step_generator(0, 1, i + 1))
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    buckets = {"attn_fwd": 0.0, "attn_bwd": 0.0, "matmul": 0.0, "other": 0.0}
    others: dict[str, float] = {}
    # kernels and copies only: user-annotation ranges (Optimizer.step#...)
    # also show on the device timeline and would count their kernels twice
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    for e in device:
        name = e.name.lower()
        if "causal_attention_fwd_kernel" in name:
            key = "attn_fwd"
        elif "attention_bwd" in name:
            key = "attn_bwd"
        elif any(w in name for w in ("gemm", "cutlass", "xmma", "sm90_", "nvjet")):
            key = "matmul"
        else:
            key = "other"
            others[e.name[:90]] = others.get(e.name[:90], 0.0) + e.time_range.elapsed_us() / 1e3
        buckets[key] += e.time_range.elapsed_us() / 1e3
    busy = sum(buckets.values())
    top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        profiled_steps=steps,
        profiled_wall_ms_per_step=wall * 1e3 / steps,
        device_ms_per_step={k: v / steps for k, v in buckets.items()},
        other_top_ms_per_step={k: v / steps for k, v in top},
        device_busy_share=busy / (wall * 1e3) if device else None,
        device_ops_per_step=len(device) / steps,
    )


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
        for key in attn.KERNEL_LAUNCHES:
            attn.KERNEL_LAUNCHES[key] = 0
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
    os.chdir(HERE)  # configs/ and logs/ resolve inside the checkout
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
    training = phase_train_kernels(torch, attn, card)
    phase_train_values(torch, card)
    torch.cuda.empty_cache()
    train_launches = phase_train(torch, attn, card, training)
    torch.cuda.empty_cache()
    serve_launches = phase_slice(torch, attn, card)

    rows = [
        dict(name=name, route="cuda", source=FWD_SOURCE if "fwd" in name else BWD_SOURCE,
             replaces=REPLACES[name], launches=train_launches[name],
             max_abs_err=training[name]["max_abs_err"], ms=training[name]["ms"],
             plain_ms=training[name]["plain_ms"])
        for name in ("causal_attention_packed_fwd", "causal_attention_packed_bwd")
    ]
    rows.append(dict(
        name="causal_attention_fwd", route="cuda", source=FWD_SOURCE,
        replaces=REPLACES["causal_attention_fwd"], launches=serve_launches,
        max_abs_err=serving["max_abs_err"], ms=serving["ms"], plain_ms=serving["plain_ms"],
    ))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
