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
forward. The forward is the dispatcher op ``packed_attention_fwd``
(``torch.library.custom_op``), one op with both outputs, so that a
selective-checkpoint policy (``models/dalle.py``) can keep them, as the JAX
policies keep the kernel's named ``attn_out`` and ``attn_lse``, or let the
recompute re-run the kernel. A CUDA tensor launches the kernels or raises (a view off 16 bytes
is copied first: ``ops/attention.py``); a CPU tensor takes the plain
versions (``attention_packed_reference`` and ``backward_reference``).
"""

from __future__ import annotations

from typing import Optional

import torch

from dalle_mtf_tpu_torch.ops.attention import (
    KERNEL_LAUNCHES,
    attention_backward_reference,
    attention_reference,
    dense_for_kernels,
    launch_backward,
    launch_forward,
)


def _unpack(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, e = t.shape
    return t.reshape(b, s, n_heads, e // n_heads).transpose(1, 2)


def _pack(t: torch.Tensor) -> torch.Tensor:
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def attention_packed_reference(q, k, v, n_heads, window=None, dropout_rate=0.0,
                               dropout_seed=None, with_lse=False, head0=0, heads_total=None):
    """The plain version of the packed forward: unpack to [B, H, S, D], run
    ``attention_reference`` with the same hash mask, pack. Returns out
    [B, S, H*D] (and the fp32 lse [B*H, S] with ``with_lse``)."""
    res = attention_reference(
        _unpack(q, n_heads), _unpack(k, n_heads), _unpack(v, n_heads), True,
        window, with_lse, dropout_rate, dropout_seed, head0, heads_total,
    )
    if with_lse:
        return _pack(res[0]), res[1]
    return _pack(res)


def dsum_rows(out: torch.Tensor, g: torch.Tensor, n_heads: int) -> torch.Tensor:
    """dsum = rowsum(dO * O) per head, fp32 [B*H, S]: products of the
    input-dtype values accumulated in fp32 (the JAX einsum's
    preferred_element_type), one torch reduction outside the kernels."""
    b, s, e = out.shape
    prod = (g.float() * out).reshape(b, s, n_heads, e // n_heads).sum(-1)
    # contiguous: at b == 1 the reshape would otherwise stay a strided view
    return prod.transpose(1, 2).reshape(b * n_heads, s).contiguous()


def backward_reference(q, k, v, out, lse, g, n_heads, window=None,
                       dropout_rate=0.0, dropout_seed=None, head0=0, heads_total=None):
    """The plain version of the packed backward (the TPU kernel
    ``_fused_bwd_kernel``): ``attention_backward_reference`` on the
    [B, H, S, D] views, packed again. Returns dq, dk, dv in q's dtype."""
    grads = attention_backward_reference(
        *(_unpack(t, n_heads) for t in (q, k, v, out)), lse, _unpack(g, n_heads),
        window, dropout_rate, dropout_seed, head0, heads_total)
    return tuple(_pack(t) for t in grads)


def _packed_strides(q: torch.Tensor, n_heads: int):
    """(batch, heads, seq_len, head_dim, (stride_b, stride_h, stride_r))."""
    b, s, e = q.shape
    d = e // n_heads
    return b, n_heads, s, d, (q.stride(0), d, q.stride(1))


def _forward(q, k, v, n_heads, window, rate, seed, tile_rows=None, head0=0, heads_total=None):
    """(out, lse); ``tile_rows`` as in ``launch_forward``."""
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, n_heads, window, rate, seed,
                                          True, head0, heads_total)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention_packed: unsupported device {q.device}")
    q, k, v = dense_for_kernels(q, k, v)
    b, h, s, d, strides = _packed_strides(q, n_heads)
    out, lse = launch_forward(q, k, v, b, h, s, d, strides, window, rate, seed,
                              True, tile_rows, head0, heads_total)
    KERNEL_LAUNCHES["causal_attention_packed_fwd"] += 1
    return out, lse


def _backward(q, k, v, out, lse, g, n_heads, window, rate, seed, head0=0, heads_total=None):
    if q.device.type == "cpu":
        return backward_reference(q, k, v, out, lse, g, n_heads, window, rate, seed, head0,
                                  heads_total)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention_packed: unsupported device {q.device}")
    q, k, v, out, g = dense_for_kernels(q, k, v, out, g.contiguous())
    b, h, s, d, strides = _packed_strides(q, n_heads)
    with torch.cuda.device(q.device):
        grads = launch_backward(q, k, v, out, lse, g, dsum_rows(out, g, h), b, h, s, d,
                                strides, window, rate, seed, head0, heads_total)
    KERNEL_LAUNCHES["causal_attention_packed_bwd"] += 1
    return grads


@torch.library.custom_op("dalle_mtf_tpu_torch::packed_attention_fwd", mutates_args=())
def packed_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int,
                         window: Optional[int], rate: float, seed: int, head0: int = 0,
                         heads_total: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``_forward`` as one dispatcher op: (out [B, S, H*D], lse fp32 [B*H, S])."""
    return _forward(q, k, v, n_heads, window, rate, seed, None, head0, heads_total)


@packed_attention_fwd.register_fake
def _(q, k, v, n_heads, window, rate, seed, head0=0, heads_total=None):
    b, s, _ = q.shape
    return torch.empty_like(q), q.new_empty((b * n_heads, s), dtype=torch.float32)


class _PackedAttention(torch.autograd.Function):
    """out = attention(q, k, v); saves q, k, v, out, lse for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads, window, rate, seed, head0, heads_total):
        out, lse = packed_attention_fwd(q, k, v, n_heads, window, rate, seed, head0, heads_total)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (n_heads, window, rate, seed, head0, heads_total)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, g, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def packed_attention(q, k, v, n_heads, window=None, dropout_rate=0.0, seed=0, head0=0,
                     heads_total=None):
    """``causal_attention_packed`` with an explicit dropout seed (an int in
    [0, 2^31), as the JAX package draws it): the same seed gives the same
    mask in both packages. q's ``n_heads`` heads are heads
    [head0, head0 + n_heads) of ``heads_total`` (default ``n_heads``) for
    the hash: a tensor-parallel rank's block of the heads draws the mask one
    process draws on them (``ops/attention.py::program_seeds``)."""
    if q.dim() != 3 or q.shape[-1] % n_heads:
        raise ValueError(f"q must be [B, S, H*D] with H={n_heads}: {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type not in ("cpu", "cuda"):  # the op's fake would take a meta tensor
        raise ValueError(f"causal_attention_packed: unsupported device {q.device}")
    rate = float(dropout_rate)
    return _PackedAttention.apply(q, k, v, n_heads, window, rate, int(seed) if rate > 0 else 0,
                                  int(head0), heads_total)


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
