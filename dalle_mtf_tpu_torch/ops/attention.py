"""Causal attention (port of ``dalle_mtf_tpu/ops/attention.py``, the parts
the serving and training paths run).

- ``dropout_keep`` / ``dropout_keep_numpy``: the attention-weight dropout
  mask, a counter hash of (query row, key col, seed), bit for bit the JAX
  package's ``_dropout_keep``.
- ``attention_reference``: the plain PyTorch version, with the TPU kernels'
  semantics (masked scores replaced by -1e10, fp32 scores and softmax,
  optional hash dropout).
- ``causal_attention``: attention over [B, H, S, D], with gradients. A CUDA
  tensor goes to the hand-written kernels ``csrc/causal_attention_fwd.cu``
  (the port of the TPU kernels ``_wedge_fwd_kernel``, ``_wr_fwd_kernel`` and
  ``_flash_kernel``) and ``csrc/causal_attention_bwd.cu`` (the port of
  ``_wedge_bwd_kernel``, ``_wr_bwd_kernel``, ``_bwd_dq_kernel`` +
  ``_bwd_dkv_kernel`` and ``_hybrid_bwd_kernel``); a CPU tensor goes to the
  plain versions (``attention_reference``, ``attention_backward_reference``);
  anything else raises. The kernels are built for D in ``KERNEL_HEAD_DIMS``.
- ``kernel_takes_head_dim``: the head dims at which the model sends
  attention to the kernels, the JAX package's own rule; at any other D the
  model calls the plain versions itself, on the card too.
- The tile walk of the bf16 tensor-core kernels is written once in Python in
  ``ops/attention_tiles.py``, which nothing on this path imports.
- ``decode_attention``: one query position (one per row, or a shared one)
  against the KV cache. Plain torch, as the JAX package leaves it to XLA.

The TPU's four attention families (wedge, whole-row, online-softmax loop,
hybrid) existed because of its 16 MB VMEM; here one tiled kernel pair covers
every length, so none of that dispatch is carried over. The packed
[B, S, H*D] layout the training path uses by default is
``ops/attention_packed.py``, on the same kernel sources (``launch_forward``
and ``launch_backward`` take either layout by strides).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e10  # matches the reference's additive mask value (models.py:227)

# Launches of each hand-written kernel, counted by its wrapper where (and
# only where) the kernel is launched; chip_smoke.py reads and resets them to
# show that a path went through the kernels. "causal_attention_fwd" and
# "causal_attention_bwd" are the [B, H, S, D] pair (serving, unpacked and
# long-sequence training); the packed pair is counted by
# ops/attention_packed.py.
KERNEL_LAUNCHES = {
    "causal_attention_fwd": 0,
    "causal_attention_bwd": 0,
    "causal_attention_packed_fwd": 0,
    "causal_attention_packed_bwd": 0,
}

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)
_M32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """The 24-bit fixed-point keep threshold, as the JAX hash computes it."""
    return int((1.0 - rate) * float(1 << 24))


def dropout_keep_numpy(rows, cols, seed, rate: float) -> np.ndarray:
    """``_dropout_keep`` in numpy: wrapping uint32 arithmetic on
    (rows, cols, seed), broadcast; True where the weight is kept."""
    x = (np.asarray(rows).astype(np.uint32) * np.uint32(2654435761)
         + np.asarray(cols).astype(np.uint32) * np.uint32(97929647)
         + np.asarray(seed).astype(np.uint32))
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0x5BD1E995)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x27D4EB2F)
    x = x ^ (x >> np.uint32(16))
    return (x >> np.uint32(8)) < np.uint32(keep_threshold(rate))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without leaving int64:
    the low and high 16 bits of x are multiplied separately."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def dropout_keep(rows: torch.Tensor, cols: torch.Tensor, seed, rate: float) -> torch.Tensor:
    """``_dropout_keep`` in torch (int64 arithmetic masked to 32 bits, which
    every device supports): rows, cols and seed broadcast; returns bool."""
    x = (_mul32(rows.long() & _M32, 2654435761)
         + _mul32(cols.long() & _M32, 97929647)
         + (torch.as_tensor(seed, device=rows.device).long() & _M32)) & _M32
    x = x ^ (x >> 13)
    x = _mul32(x, 0x5BD1E995)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x27D4EB2F)
    x = x ^ (x >> 16)
    return (x >> 8) < keep_threshold(rate)


def program_seeds(seed: int, batch: int, heads: int, device, head0: int = 0,
                  heads_total: int | None = None) -> torch.Tensor:
    """The dropout hash's seed of each program (b, h) of a [B, H, ...] launch,
    [B, H, 1, 1]: ``seed`` plus the program's index in one launch over all
    ``heads_total`` heads (default ``heads``), of which this launch holds
    heads [head0, head0 + heads): seed + b * heads_total + head0 + h. A
    tensor-parallel rank with a block of the heads so draws the mask one
    process draws on them."""
    total = heads if heads_total is None else heads_total
    b = torch.arange(batch, device=device).reshape(batch, 1, 1, 1)
    h = torch.arange(heads, device=device).reshape(1, heads, 1, 1)
    return int(seed) + b * total + head0 + h


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int | None = None,
    with_lse: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed: int | None = None,
    head0: int = 0,
    heads_total: int | None = None,
):
    """Plain attention. q, k, v: [B, H, S, D] -> [B, H, S, D] in q's dtype.

    The TPU kernels' math in one shot: scores in fp32 scaled by D^-0.5,
    masked scores replaced by NEG_INF (the mtf additive -1e10 mask,
    models.py:221-227, gives the same weights), p = exp(s - rowmax),
    l = sum(p), then (p_v cast to v's dtype) @ v accumulated in fp32 and
    divided by max(l, 1e-30). With ``dropout_rate`` > 0, p_v is p where
    ``dropout_keep(row, col, dropout_seed + b*H + h)`` keeps it, scaled by
    1/(1 - rate), else 0; l is the undropped sum (with ``head0`` and
    ``heads_total``, the seed of ``program_seeds``). ``with_lse`` also
    returns the fp32 per-row log-sum-exp [B*H, S] (what the kernel's lse
    holds).
    """
    b, h, s_q, d = q.shape
    s_k = k.shape[-2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(d)
    )
    i = torch.arange(s_q, device=q.device)[:, None] + (s_k - s_q)
    j = torch.arange(s_k, device=q.device)[None, :]
    mask = torch.zeros((s_q, s_k), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask | (j > i)
    if window is not None:
        mask = mask | (i - j >= window)
    scores = scores.masked_fill(mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p_v = p
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 needs a dropout_seed")
        seeds = program_seeds(dropout_seed, b, h, q.device, head0, heads_total)
        keep = dropout_keep(i, j, seeds, dropout_rate)
        p_v = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    out = (torch.matmul(p_v.to(v.dtype).float(), v.float()) / l_safe).to(q.dtype)
    if with_lse:
        return out, (m + torch.log(l_safe)).reshape(-1, s_q)
    return out


def attention_backward_reference(q, k, v, out, lse, g, window=None,
                                 dropout_rate=0.0, dropout_seed=None, head0=0,
                                 heads_total=None):
    """The plain version of the backward, q, k, v, out, g [B, H, S, D] and
    the forward's fp32 lse [B*H, S]: the TPU kernels' math
    (``_wedge_bwd_kernel``, ``_hybrid_bwd_kernel``) in one shot.

    p = exp(s - lse) with masked p exactly 0; dp = dO v^T, masked and scaled
    by the dropout keep; dsum = rowsum(dO * O) in fp32; ds = p (dp - dsum)
    cast to k's dtype; dq = ds k and dk = ds^T q, each times D^-0.5 in fp32;
    dv = p_v^T dO with p_v cast to dO's dtype. Returns dq, dk, dv in q's
    dtype."""
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = j > i
    if window is not None:
        mask = mask | (i - j >= window)
    p = torch.where(mask, 0.0, torch.exp(scores - lse.reshape(b, h, s, 1)))
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    p_v = p
    if dropout_rate > 0.0:
        seeds = program_seeds(dropout_seed, b, h, q.device, head0, heads_total)
        keep = dropout_keep(i, j, seeds, dropout_rate)
        inv = 1.0 / (1.0 - dropout_rate)
        dp = torch.where(keep, dp * inv, 0.0)
        p_v = torch.where(keep, p * inv, 0.0)
    dsum = (g.float() * out.float()).sum(-1, keepdim=True)
    ds = (p * (dp - dsum)).to(k.dtype).float()
    dq = (torch.matmul(ds, k.float()) * scale).to(q.dtype)
    dk = (torch.matmul(ds.transpose(-1, -2), q.float()) * scale).to(q.dtype)
    dv = torch.matmul(p_v.to(g.dtype).float().transpose(-1, -2), g.float()).to(q.dtype)
    return dq, dk, dv


# q-tile rows the bf16 forward kernel is built for, by head size (the backward
# always takes 64); the rule that picks one is csrc/attention_mma.cuh's
# forward_tile_rows
FORWARD_TILES = {64: (64,), 128: (64, 128)}
# the fp32 forwards' q tile (csrc/causal_attention_fwd.cu's and
# csrc/ring_attention.cu's tc32 kernels), at either D: one CTA of two warp
# groups, not chosen by shape
FP32_FORWARD_TILES = (64,)
# the bf16 ring forward's q tile (csrc/ring_attention.cu): 64 rows at either
# D (128 measured slower at every hop of the ring shard, so it is not built)
RING_FORWARD_TILES = (64,)


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def kernel_takes_head_dim(head_dim: int) -> bool:
    """Whether the model sends attention at head dim ``head_dim`` to the
    kernels (the causal, packed and ring pairs): at the D they are built for
    (``KERNEL_HEAD_DIMS``), and wherever the JAX package takes its Pallas
    kernels (D % 128 == 0), where a D with no kernel yet (256) raises.
    Elsewhere the JAX package takes its dense reference, and the model the
    plain versions."""
    return head_dim in KERNEL_HEAD_DIMS or head_dim % 128 == 0


def _keeps_16_bytes(t: torch.Tensor) -> bool:
    chunk = max(1, 16 // t.element_size())
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(st % chunk == 0 for st in t.stride()[:-1]))


def dense_for_kernels(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The inputs of one launch as the kernels take them: unchanged when
    every one keeps the 16-byte rule (``check_kernel_inputs``); otherwise
    each that is not already dense and 16-byte aligned is copied once into a
    new dense tensor (a fresh allocation, so aligned), so that all of them
    still share one layout."""
    if all(_keeps_16_bytes(t) for t in tensors):
        return tensors
    return tuple(t if t.is_contiguous() and t.data_ptr() % 16 == 0
                 else t.clone(memory_format=torch.contiguous_format) for t in tensors)


def _forward(q, k, v, window, rate, seed, with_lse, tile_rows=None, head0=0, heads_total=None):
    """(out, lse or None): the kernel on CUDA tensors, plain on CPU ones.
    ``tile_rows`` as in ``launch_forward``."""
    if _on_cpu(q, k, v):
        res = attention_reference(q, k, v, True, window, with_lse, rate, seed, head0,
                                  heads_total)
        return res if with_lse else (res, None)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention: unsupported device {q.device}")
    q, k, v = dense_for_kernels(q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one [B, H, S, D] shape: {q.shape}, "
            f"{k.shape}, {v.shape}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("causal_attention_fwd needs contiguous q, k, v")
    b, h, s, d = q.shape
    out, lse = launch_forward(q, k, v, b, h, s, d, q.stride()[:3], window,
                              rate, seed, with_lse, tile_rows, head0, heads_total)
    KERNEL_LAUNCHES["causal_attention_fwd"] += 1
    return out, lse


def dsum_rows(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dsum = rowsum(dO * O) in fp32, [B*H, S], of [B, H, S, D] tensors: one
    torch reduction outside the kernels (the multiply reads O in its own
    dtype: a product of an fp32 and a bf16 value is taken in fp32)."""
    b, h, s, _ = out.shape
    return (g.float() * out).sum(-1).reshape(b * h, s)


def _backward(q, k, v, out, lse, g, window, rate, seed, head0=0, heads_total=None):
    """dq, dk, dv: the kernel on CUDA tensors, plain on CPU ones."""
    if _on_cpu(q, k, v, out, lse, g):
        return attention_backward_reference(q, k, v, out, lse, g, window, rate, seed, head0,
                                            heads_total)
    q, k, v, out, g = dense_for_kernels(q, k, v, out, g.contiguous())
    b, h, s, d = q.shape
    with torch.cuda.device(q.device):
        grads = launch_backward(q, k, v, out, lse, g, dsum_rows(out, g), b, h, s, d,
                                q.stride()[:3], window, rate, seed, head0, heads_total)
    KERNEL_LAUNCHES["causal_attention_bwd"] += 1
    return grads


@torch.library.custom_op("dalle_mtf_tpu_torch::causal_attention_fwd", mutates_args=())
def causal_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: Optional[int], rate: float, seed: Optional[int],
                         head0: int = 0,
                         heads_total: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``_forward`` with its lse as one dispatcher op, so that a
    selective-checkpoint policy (``models/dalle.py``) can keep both outputs
    or let the recompute re-run the kernel (ops/attention_packed.py)."""
    return _forward(q, k, v, window, rate, seed, True, None, head0, heads_total)


@causal_attention_fwd.register_fake
def _(q, k, v, window, rate, seed, head0=0, heads_total=None):
    b, h, s, _ = q.shape
    return torch.empty_like(q), q.new_empty((b * h, s), dtype=torch.float32)


class _Attention(torch.autograd.Function):
    """(out, lse) = attention(q, k, v); saves q, k, v, out and the fp32 lse,
    what the JAX ``dots_and_attn`` remat policy keeps, so the backward never
    re-runs the forward. lse carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window, rate, seed, head0, heads_total):
        out, lse = causal_attention_fwd(q, k, v, window, rate, seed, head0, heads_total)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (window, rate, seed, head0, heads_total)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, g, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int | None = None,
    dropout_rate: float = 0.0,
    with_lse: bool = False,
    dropout_seed: int | None = None,
    head0: int = 0,
    heads_total: int | None = None,
):
    """Causal (optionally local-window) attention, q, k, v [B, H, S, D].

    On CUDA tensors this launches ``causal_attention_fwd`` (one launch for
    all heads and rows), and in the backward ``causal_attention_bwd``, or
    raises; it never falls back (a view off 16 bytes is copied first:
    ``dense_for_kernels``; a head dim with no kernel raises). On CPU tensors
    it runs the plain forward and the plain backward. ``with_lse`` also returns the fp32 log-sum-exp
    [B*H, S]. ``dropout_rate`` > 0 applies the hash dropout keyed on
    ``dropout_seed``, the same bits in the forward and the backward; q's H
    heads are heads [head0, head0 + H) of ``heads_total`` (default H) for the
    hash (``program_seeds``: a tensor-parallel rank's heads draw the single
    process's mask).
    """
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs a dropout_seed")
    rate = float(dropout_rate)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _Attention.apply(q, k, v, window, rate,
                                    int(dropout_seed) if rate > 0 else None, head0, heads_total)
    else:
        out, lse = _forward(q, k, v, window, rate, dropout_seed, with_lse, None, head0,
                            heads_total)
    return (out, lse) if with_lse else out


def check_kernel_inputs(name: str, tensors, head_dim: int) -> None:
    """The checks every attention kernel's wrapper makes before a launch:
    one CUDA device, one dtype the kernels take, one layout, unit stride on
    D and, since every kernel stages its tiles by 16-byte copies (bf16 and
    fp32 alike), 16-byte-aligned pointers and strides of whole 16-byte
    chunks. The wrappers copy a view that breaks the 16-byte rule first
    (``dense_for_kernels``), so a kernel never sees a bad pointer; what
    reaches this check still broken raises."""
    first = tensors[0]
    if first.dtype not in KERNEL_DTYPES or any(t.dtype != first.dtype for t in tensors):
        raise ValueError(
            f"{name} takes float32 or bfloat16 alike, got {[t.dtype for t in tensors]}"
        )
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} takes D in {KERNEL_HEAD_DIMS}, got {head_dim}")
    if any(t.device != first.device for t in tensors):
        raise ValueError(f"{name}: inputs must lie on one device")
    if any(t.stride() != first.stride() or t.shape != first.shape for t in tensors):
        raise ValueError(f"{name}: inputs must share one shape and layout")
    if first.stride(-1) != 1:
        raise ValueError(f"{name}: the head dimension must be contiguous")
    chunk = 16 // first.element_size()  # elements of a 16-byte copy
    for t in tensors:
        if t.data_ptr() % 16 or any(st % chunk for st in t.stride()[:-1]):
            raise ValueError(
                f"{name}: {str(first.dtype).removeprefix('torch.')} inputs must be 16-byte "
                f"aligned (data_ptr {t.data_ptr():#x}, strides {t.stride()}, storage "
                f"offset {t.storage_offset()}); make the view contiguous first")


def dropout_args(rate: float, seed: int | None) -> tuple[int, int, int, float]:
    """(enabled, seed as uint32, keep threshold, keep scale) for a kernel."""
    if rate <= 0.0:
        return 0, 0, 0, 1.0
    return 1, int(seed) & _M32, keep_threshold(rate), 1.0 / (1.0 - rate)


def _head_args(heads: int, head0: int, heads_total: int | None) -> tuple[int, int]:
    """(heads_total, head0) for the causal kernels' dropout hash."""
    total = heads if heads_total is None else int(heads_total)
    if not 0 <= head0 <= total - heads:
        raise ValueError(f"heads [{head0}, {head0 + heads}) do not lie in {total} heads")
    return total, int(head0)


def launch_forward(q, k, v, batch, heads, seq_len, head_dim, strides, window,
                   dropout_rate, dropout_seed, with_lse, tile_rows=None, head0=0,
                   heads_total=None):
    """Launch ``causal_attention_fwd`` on q, k, v of one strided layout
    (``strides`` = elements between batches, heads and rows). Returns
    (out in q's layout, fp32 lse [batch*heads, seq_len] or None).
    ``tile_rows`` (tests and measurements only) gives the bf16 kernel's q
    tile, one of ``FORWARD_TILES[head_dim]``, instead of leaving the choice
    to the kernel's rule. The dropout hash takes the ``heads`` as heads
    [head0, head0 + heads) of ``heads_total`` (``program_seeds``)."""
    check_kernel_inputs("causal_attention_fwd", (q, k, v), head_dim)
    if tile_rows is not None and (q.dtype != torch.bfloat16
                                  or tile_rows not in FORWARD_TILES[head_dim]):
        raise ValueError(f"tile_rows {tile_rows}: the bf16 forward at D = {head_dim} is built "
                         f"for {FORWARD_TILES[head_dim]}")
    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    lib = library()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = (torch.empty((batch * heads, seq_len), dtype=torch.float32, device=q.device)
               if with_lse else None)
        if out.stride() != q.stride():
            raise ValueError("causal_attention_fwd: q is not dense")
        args = (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            batch, heads, seq_len, head_dim, *strides, KERNEL_DTYPES[q.dtype],
            -1 if window is None else int(window),
            *dropout_args(dropout_rate, dropout_seed),
            *_head_args(heads, head0, heads_total),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        err = (lib.causal_attention_fwd(*args) if tile_rows is None
               else lib.causal_attention_fwd_tiled(*args, int(tile_rows)))
    if err != 0:
        raise RuntimeError(f"causal_attention_fwd launch failed: cudaError {err}")
    return out, lse


def launch_backward(q, k, v, out, lse, g, dsum, batch, heads, seq_len, head_dim,
                    strides, window, dropout_rate, dropout_seed, head0=0, heads_total=None):
    """Launch ``causal_attention_bwd`` (a dQ launch and a dK/dV launch) on
    q, k, v, out and dO of one strided layout, with the forward's fp32 lse
    and dsum = rowsum(dO * O), both contiguous [batch*heads, seq_len].
    Returns dq, dk, dv in q's layout."""
    check_kernel_inputs("causal_attention_bwd", (q, k, v, out, g), head_dim)
    for name, t in (("lse", lse), ("dsum", dsum)):
        if (t.shape != (batch * heads, seq_len) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"causal_attention_bwd: {name} must be contiguous fp32 "
                             f"[{batch * heads}, {seq_len}] on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    lib = library()
    with torch.cuda.device(q.device):
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        if dq.stride() != q.stride():
            raise ValueError("causal_attention_bwd: q is not dense")
        err = lib.causal_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), batch, heads, seq_len, head_dim, *strides,
            KERNEL_DTYPES[q.dtype], -1 if window is None else int(window),
            *dropout_args(dropout_rate, dropout_seed),
            *_head_args(heads, head0, heads_total),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"causal_attention_bwd launch failed: cudaError {err}")
    return dq, dk, dv


def kernel_tile_rows(head_dim: int, programs: int, seq_len: int) -> int:
    """The q tile's rows the built bf16 forward kernel takes for ``programs``
    = B*H heads of ``seq_len`` rows, asked of the library itself."""
    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    return library().causal_attention_fwd_tile_rows(head_dim, programs, seq_len)


def kernel_resources(head_dim: int, kind: str = "causal",
                     dtype: torch.dtype = torch.bfloat16) -> dict[str, dict[str, int]]:
    """What the built tensor-core kernels of ``kind`` ("causal": the causal
    pair; "ring": ring attention's per-hop pair) take at ``head_dim`` and
    ``dtype``: {"fwd_64" | "fwd_128" (the forward by q tile; 128 for the
    causal pair's bf16 kernel at D = 128 only, the fp32 forwards 64 rows) |
    "bwd_dq" | "bwd_dkv": {"registers", "local_bytes" (spills),
    "smem_bytes", "ctas_per_sm"}}, read from the card's runtime."""
    import ctypes  # noqa: PLC0415

    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    lib = library()
    out = (ctypes.c_int * 4)()
    code = KERNEL_DTYPES[dtype]
    bf16 = dtype == torch.bfloat16
    tiles, fwd, bwd = {  # (forward q tiles, forward by tile, backward pass 0 dQ / 1 dK/dV)
        "causal": (FORWARD_TILES[head_dim] if bf16 else FP32_FORWARD_TILES,
                   lambda rows: lib.causal_attention_fwd_info(head_dim, rows, code, out),
                   lambda p: lib.causal_attention_bwd_info(p, head_dim, code, out)),
        "ring": (RING_FORWARD_TILES if bf16 else FP32_FORWARD_TILES,
                 lambda rows: lib.ring_attention_info(0, head_dim, rows, code, out),
                 lambda p: lib.ring_attention_info(1 + p, head_dim, 64, code, out)),
    }[kind]
    calls = {f"fwd_{rows}": (lambda rows=rows: fwd(rows)) for rows in tiles}
    calls["bwd_dq"] = lambda: bwd(0)
    calls["bwd_dkv"] = lambda: bwd(1)
    res = {}
    for name, call in calls.items():
        err = call()
        if err != 0:
            raise RuntimeError(f"kernel_resources({kind} {name}, D={head_dim}, {dtype}): "
                               f"cudaError {err}")
        res[name] = dict(zip(("registers", "local_bytes", "smem_bytes", "ctas_per_sm"),
                             (int(x) for x in out)))
    return res


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    position: int | torch.Tensor,
    window: int | None = None,
) -> torch.Tensor:
    """Single-position attention against a KV cache.

    q: [B, H, 1, D]; k_cache/v_cache: [B, H, S, D] with valid entries in
    [0, position]. ``position`` is an int (every row) or a long [B] (row b
    at ``position[b]``: continuous batching). ``window`` applies the same
    local band as prefill. Plain torch, as in the JAX package (no kernel
    there either).
    """
    d = q.shape[-1]
    scores = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(d)
    )
    j = torch.arange(k_cache.shape[-2], device=q.device)
    if isinstance(position, torch.Tensor):
        position = position.reshape(-1, 1, 1, 1)  # over [B, H, 1, S]
    mask = j > position
    if window is not None:
        mask = mask | (position - j >= window)
    scores = scores.masked_fill(mask, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights.to(v_cache.dtype).float(), v_cache.float()).to(
        q.dtype
    )
