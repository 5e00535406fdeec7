"""Packed-layout causal attention: [B, S, H*D] in, [B, S, H*D] out (port of
``dalle_mtf_tpu/ops/attention_packed.py``, the training path's attention).

q, k, v stay in the QKV projections' natural layout; head h is the column
block [h*D, (h+1)*D) of each row, so no transpose is ever made. The kernels
take the layout by strides (batch S*H*D, head D, row H*D):

- forward: ``csrc/causal_attention_fwd.cu``, the port of the TPU kernel
  ``_fused_fwd_kernel`` (the same source serves the [B, H, S, D] layout);
- backward: ``csrc/causal_attention_bwd.cu``, the port of
  ``_fused_bwd_kernel`` (a dQ launch and a dK/dV launch).

``_PackedAttention`` (a ``torch.autograd.Function``) wraps the pair. Its
forward saves q, k, v, out and the fp32 lse, exactly the residuals the JAX
``dots_and_attn`` remat policy keeps, so the backward never re-runs the
forward. A CUDA tensor launches the kernels or raises; a CPU tensor takes
the plain versions (``attention_packed_reference`` and ``backward_reference``).
"""

from __future__ import annotations

import math

import torch

from dalle_mtf_tpu_torch.ops.attention import (
    KERNEL_DTYPES,
    KERNEL_LAUNCHES,
    attention_reference,
    check_kernel_inputs,
    dropout_args,
    dropout_keep,
    launch_forward,
)


def _unpack(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, e = t.shape
    return t.reshape(b, s, n_heads, e // n_heads).transpose(1, 2)


def _pack(t: torch.Tensor) -> torch.Tensor:
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def attention_packed_reference(q, k, v, n_heads, window=None, dropout_rate=0.0,
                               dropout_seed=None, with_lse=False):
    """The plain version of the packed forward: unpack to [B, H, S, D], run
    ``attention_reference`` with the same hash mask, pack. Returns out
    [B, S, H*D] (and the fp32 lse [B*H, S] with ``with_lse``)."""
    res = attention_reference(
        _unpack(q, n_heads), _unpack(k, n_heads), _unpack(v, n_heads), True,
        window, with_lse, dropout_rate, dropout_seed,
    )
    if with_lse:
        return _pack(res[0]), res[1]
    return _pack(res)


def dsum_rows(out: torch.Tensor, g: torch.Tensor, n_heads: int) -> torch.Tensor:
    """dsum = rowsum(dO * O) per head, fp32 [B*H, S]: products of the
    input-dtype values accumulated in fp32 (the JAX einsum's
    preferred_element_type), one torch reduction outside the kernels."""
    b, s, e = out.shape
    prod = (g.float() * out.float()).reshape(b, s, n_heads, e // n_heads).sum(-1)
    # contiguous: at b == 1 the reshape would otherwise stay a strided view
    return prod.transpose(1, 2).reshape(b * n_heads, s).contiguous()


def backward_reference(q, k, v, out, lse, g, n_heads, window=None,
                       dropout_rate=0.0, dropout_seed=None):
    """The plain version of the packed backward: the TPU kernel's math
    (``_fused_bwd_kernel``) on [B, H, S, D] views, one shot.

    p = exp(s - lse) with masked p exactly 0; dp = dO v^T, masked and scaled
    by the dropout keep; ds = p (dp - dsum) cast to k's dtype; dq = ds k and
    dk = ds^T q, each times D^-0.5 in fp32; dv = p_v^T dO with p_v cast to
    dO's dtype. Returns dq, dk, dv packed, in q's dtype."""
    b, s, e = q.shape
    h = n_heads
    d = e // h
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, gh = (_unpack(t, h) for t in (q, k, v, g))
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = j > i
    if window is not None:
        mask = mask | (i - j >= window)
    p = torch.where(mask, 0.0, torch.exp(scores - lse.reshape(b, h, s, 1)))
    dp = torch.matmul(gh.float(), vh.float().transpose(-1, -2))
    p_v = p
    if dropout_rate > 0.0:
        seeds = (int(dropout_seed) + torch.arange(b * h, device=q.device)).reshape(b, h, 1, 1)
        keep = dropout_keep(i, j, seeds, dropout_rate)
        inv = 1.0 / (1.0 - dropout_rate)
        dp = torch.where(keep, dp * inv, 0.0)
        p_v = torch.where(keep, p * inv, 0.0)
    dsum = dsum_rows(out, g, h).reshape(b, h, s, 1)
    ds = (p * (dp - dsum)).to(k.dtype).float()
    dq = (torch.matmul(ds, kh.float()) * scale).to(q.dtype)
    dk = (torch.matmul(ds.transpose(-1, -2), qh.float()) * scale).to(q.dtype)
    dv = torch.matmul(p_v.to(g.dtype).float().transpose(-1, -2), gh.float()).to(q.dtype)
    return _pack(dq), _pack(dk), _pack(dv)


def _packed_strides(q: torch.Tensor, n_heads: int):
    """(batch, heads, seq_len, head_dim, (stride_b, stride_h, stride_r))."""
    b, s, e = q.shape
    d = e // n_heads
    return b, n_heads, s, d, (q.stride(0), d, q.stride(1))


def _forward(q, k, v, n_heads, window, rate, seed):
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, n_heads, window, rate, seed,
                                          with_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention_packed: unsupported device {q.device}")
    b, h, s, d, strides = _packed_strides(q, n_heads)
    out, lse = launch_forward(q, k, v, b, h, s, d, strides, window, rate, seed,
                              with_lse=True)
    KERNEL_LAUNCHES["causal_attention_packed_fwd"] += 1
    return out, lse


def _backward(q, k, v, out, lse, g, n_heads, window, rate, seed):
    if q.device.type == "cpu":
        return backward_reference(q, k, v, out, lse, g, n_heads, window, rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention_packed: unsupported device {q.device}")
    g = g.contiguous()
    b, h, s, d, strides = _packed_strides(q, n_heads)
    check_kernel_inputs("causal_attention_bwd", (q, k, v, out, g), d)
    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    lib = library()
    with torch.cuda.device(q.device):
        dsum = dsum_rows(out, g, h)
        for name, t in (("lse", lse), ("dsum", dsum)):
            if t.shape != (b * h, s) or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"causal_attention_bwd: {name} must be contiguous fp32 "
                                 f"[{b * h}, {s}], got {t.dtype} {tuple(t.shape)}")
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        err = lib.causal_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, s, d, *strides, KERNEL_DTYPES[q.dtype],
            -1 if window is None else int(window), *dropout_args(rate, seed),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"causal_attention_bwd launch failed: cudaError {err}")
    KERNEL_LAUNCHES["causal_attention_packed_bwd"] += 1
    return dq, dk, dv


class _PackedAttention(torch.autograd.Function):
    """out = attention(q, k, v); saves q, k, v, out, lse for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads, window, rate, seed):
        out, lse = _forward(q, k, v, n_heads, window, rate, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (n_heads, window, rate, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, g, *ctx.args)
        return dq, dk, dv, None, None, None, None


def packed_attention(q, k, v, n_heads, window=None, dropout_rate=0.0, seed=0):
    """``causal_attention_packed`` with an explicit dropout seed (an int in
    [0, 2^31), as the JAX package draws it): the same seed gives the same
    mask in both packages."""
    if q.dim() != 3 or q.shape[-1] % n_heads:
        raise ValueError(f"q must be [B, S, H*D] with H={n_heads}: {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    rate = float(dropout_rate)
    return _PackedAttention.apply(q, k, v, n_heads, window, rate, int(seed) if rate > 0 else 0)


def causal_attention_packed(q, k, v, n_heads, window=None, dropout_rate=0.0,
                            generator: torch.Generator | None = None):
    """Causal multi-head attention over packed [B, S, H*D] tensors, with
    gradients. Same semantics as ``causal_attention`` with heads folded into
    the last axis. With ``dropout_rate`` > 0 the dropout seed is drawn from
    ``generator`` (a CPU generator, so drawing it never waits on the card);
    the JAX package draws it with jax.random, so the two agree given a seed,
    not given a generator."""
    seed = 0
    if dropout_rate > 0.0:
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    return packed_attention(q, k, v, n_heads, window, dropout_rate, seed)
