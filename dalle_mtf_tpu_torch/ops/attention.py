"""Causal attention (port of ``dalle_mtf_tpu/ops/attention.py``, the parts
the serving path runs).

- ``attention_reference``: the plain PyTorch version, with the JAX
  reference's semantics (additive -1e10 mask, fp32 scores and softmax).
- ``causal_attention``: prefill attention. A CUDA tensor goes to the
  hand-written kernel ``csrc/causal_attention_fwd.cu`` (the port of the TPU
  kernel ``_wedge_fwd_kernel``); a CPU tensor goes to the plain version;
  anything else raises.
- ``decode_attention``: one query position against the KV cache. Plain
  torch, as the JAX package leaves it to XLA.

The TPU's four attention families (wedge, whole-row, online-softmax loop,
hybrid) existed because of its 16 MB VMEM; here one tiled kernel covers
every length, so none of that dispatch is carried over.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e10  # matches the reference's additive mask value (models.py:227)

# Launches of each hand-written kernel, counted by its wrapper where (and
# only where) the kernel is launched; chip_smoke.py reads and resets it to
# show that the serving path went through the kernel.
KERNEL_LAUNCHES = {"causal_attention_fwd": 0}

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int | None = None,
    with_lse: bool = False,
):
    """Plain attention. q, k, v: [B, H, S, D] -> [B, H, S, D] in q's dtype.

    Semantics match mtf attention with the additive causal mask
    (models.py:221-227): scores in fp32 scaled by D^-0.5, the mask adds
    -1e10, fp32 softmax, weights cast to v's dtype before the fp32-accumulated
    product with v. ``with_lse`` also returns the fp32 per-row log-sum-exp
    [B*H, S] of the masked, scaled scores (what the kernel's lse holds).
    The JAX reference's ``jax.random`` weight dropout is not ported: serving
    never drops.
    """
    s_q, d = q.shape[-2], q.shape[-1]
    s_k = k.shape[-2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(d)
    )
    i = torch.arange(s_q, device=q.device)[:, None] + (s_k - s_q)
    j = torch.arange(s_k, device=q.device)[None, :]
    mask = torch.zeros((s_q, s_k), dtype=torch.float32, device=q.device)
    if causal:
        mask = torch.where(j > i, NEG_INF, mask)
    if window is not None:
        mask = torch.where(i - j >= window, NEG_INF, mask)
    scores = scores + mask
    weights = torch.softmax(scores, dim=-1)
    out = torch.matmul(weights.to(v.dtype).float(), v.float()).to(q.dtype)
    if with_lse:
        return out, torch.logsumexp(scores, dim=-1).reshape(-1, s_q)
    return out


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int | None = None,
    dropout_rate: float = 0.0,
    with_lse: bool = False,
):
    """Causal (optionally local-window) attention, q, k, v [B, H, S, D].

    On CUDA tensors this launches ``causal_attention_fwd`` (one launch for
    all heads and rows) or raises; it never falls back. On CPU tensors it
    runs ``attention_reference``. ``with_lse`` also returns the fp32
    log-sum-exp [B*H, S], which the backward kernel will read.

    Attention-weight dropout runs inside the TPU kernel as a coordinate
    hash; it is not on the serving path and is not ported yet, so
    ``dropout_rate > 0`` raises.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention-weight dropout is not ported to the CUDA kernel yet"
        )
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_reference(q, k, v, True, window, with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention: unsupported device {q.device}")
    return _causal_attention_cuda(q, k, v, window, with_lse)


def _causal_attention_cuda(q, k, v, window, with_lse):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one [B, H, S, D] shape: {q.shape}, "
            f"{k.shape}, {v.shape}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise ValueError(
            f"causal_attention_fwd takes float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    b, h, s, d = q.shape
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"causal_attention_fwd takes D in {_KERNEL_HEAD_DIMS}, got {d}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("causal_attention_fwd needs contiguous q, k, v")
    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    lib = library()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = (
            torch.empty((b * h, s), dtype=torch.float32, device=q.device)
            if with_lse else None
        )
        err = lib.causal_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            b * h, s, d, _KERNEL_DTYPES[q.dtype],
            -1 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"causal_attention_fwd launch failed: cudaError {err}")
    KERNEL_LAUNCHES["causal_attention_fwd"] += 1
    return (out, lse) if with_lse else out


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    position: int,
    window: int | None = None,
) -> torch.Tensor:
    """Single-position attention against a KV cache.

    q: [B, H, 1, D]; k_cache/v_cache: [B, H, S, D] with valid entries in
    [0, position]. ``window`` applies the same local band as prefill. Plain
    torch, as in the JAX package (no kernel there either).
    """
    d = q.shape[-1]
    scores = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(d)
    )
    j = torch.arange(k_cache.shape[-2], device=q.device)
    mask = j > position
    if window is not None:
        mask = mask | (position - j >= window)
    scores = scores.masked_fill(mask, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights.to(v_cache.dtype).float(), v_cache.float()).to(
        q.dtype
    )
