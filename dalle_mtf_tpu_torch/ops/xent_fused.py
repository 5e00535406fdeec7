"""Chunked softmax cross-entropy over a large vocabulary (port of
``dalle_mtf_tpu/ops/xent_fused.py``).

The loss is computed from the final hidden states and the output
projection, streaming over row chunks, so only [chunk, V] fp32 logits ever
exist; the backward recomputes each chunk's logits instead of saving them.
At dalle_12B's shape (20,480 rows a microbatch, V = 52,307) a chunk's logits
are 0.54 GB where the dense head holds [N, V] in bf16 and in fp32.

Semantics are those of ``ops/losses.py::softmax_cross_entropy_with_logits``
on logits = x @ w + b with fp32 accumulation and an fp32 result (z-loss
supported), in the JAX dtypes:

- logits: the product of x and w (the compute dtype) accumulated and
  returned in fp32, plus the fp32 bias (``f32_matmul``). The dense head of
  ``models/dalle.py`` rounds its logits and bias to the compute dtype
  instead;
- backward: dlogits = p * (1 + 2 z lse) - onehot, times the loss's
  cotangent; dx = dlogits cast to w's dtype times wᵀ, accumulated in fp32 and
  rounded to x's dtype; dw = fp32(x)ᵀ · dlogits in fp32, accumulated over the
  chunks in chunk order and cast to w's dtype; db = the fp32 column sums of
  dlogits.

No TPU kernel is behind this module (the JAX version is plain jnp under a
custom_vjp); the products are cuBLAS calls through torch.

The tensor-parallel variant (a vocabulary sharded over a ``vocab_dim`` mesh
axis) is not ported: the ``*_auto`` entry points raise on such an axis.
"""

from __future__ import annotations

import torch


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D) accumulated and returned in fp32: the JAX einsum's
    ``preferred_element_type=jnp.float32``. bf16 operands on the card take
    cuBLAS's bf16 GEMM with an fp32 output (``torch.mm(a, b,
    out_dtype=torch.float32)``, on the tensor cores); elsewhere the fp32
    product of the operands cast to fp32 (a bf16 value is exact in fp32, so
    both are the exact products summed in fp32)."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_logits(x_c, w, b):
    return f32_matmul(x_c, w) + b


def _chunk_loss(logits, t_c, z_loss):
    """(loss, lse) of one chunk's fp32 logits."""
    lse = torch.logsumexp(logits, dim=-1)
    loss = lse - logits.gather(1, t_c[:, None])[:, 0]
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss, lse


def _chunks(n: int, num_chunks: int) -> list[slice]:
    if n % num_chunks:
        raise ValueError(f"rows {n} not divisible by num_chunks {num_chunks}")
    c = n // num_chunks
    return [slice(i * c, (i + 1) * c) for i in range(num_chunks)]


class _ChunkedXent(torch.autograd.Function):
    """loss [N] fp32; saves (x, w, b, targets, lse) and nothing of [N, V]."""

    @staticmethod
    def forward(ctx, x, w, b, targets, z_loss, num_chunks):
        loss = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        lse = torch.empty_like(loss)
        for rows in _chunks(x.shape[0], num_chunks):
            loss[rows], lse[rows] = _chunk_loss(_chunk_logits(x[rows], w, b), targets[rows],
                                                z_loss)
        ctx.save_for_backward(x, w, b, targets, lse)
        ctx.z_loss, ctx.num_chunks = z_loss, num_chunks
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, b, targets, lse = ctx.saved_tensors
        z_loss = ctx.z_loss
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
        for rows in _chunks(x.shape[0], ctx.num_chunks):
            lse_c = lse[rows, None]
            # in place on the chunk's logits: one [chunk, V] fp32 buffer
            d = _chunk_logits(x[rows], w, b).sub_(lse_c).exp_()  # p
            if z_loss:
                # d/dlogits [lse - tgt + z lse^2] = p (1 + 2 z lse) - onehot
                d.mul_(1.0 + 2.0 * z_loss * lse_c)
            t_c = targets[rows]
            d[torch.arange(d.shape[0], device=d.device), t_c] -= 1.0
            d.mul_(g[rows, None])
            dx[rows] = f32_matmul(d.to(w.dtype), w.t()).to(x.dtype)
            dw.addmm_(x[rows].float().t(), d)
            db += d.sum(0)
        return dx, dw.to(w.dtype), db, None, None, None


def chunked_softmax_xent(x, w, b, targets, z_loss: float = 0.0, num_chunks: int = 8):
    """x [N, E] (compute dtype), w [E, V], b [V] fp32, targets [N] int ->
    per-row loss [N] fp32, with gradients for x, w and b. N must be
    divisible by ``num_chunks``."""
    return _ChunkedXent.apply(x, w, b, targets.long(), float(z_loss), int(num_chunks))


@torch.no_grad()
def chunked_xent_eval(x, w, b, targets, z_loss: float = 0.0, num_chunks: int = 8):
    """Per-row loss and argmax correctness (1.0 where argmax(logits) equals
    the target; the first maximum wins, as ``jnp.argmax``), both fp32 [N],
    in one pass over the chunks. No gradients: eval only."""
    targets = targets.long()
    loss = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    correct = torch.empty_like(loss)
    for rows in _chunks(x.shape[0], num_chunks):
        logits = _chunk_logits(x[rows], w, b)
        loss[rows] = _chunk_loss(logits, targets[rows], z_loss)[0]
        correct[rows] = (logits.argmax(dim=-1) == targets[rows]).float()
    return loss, correct


def _refuse_vocab_axis(vocab_axis: str | None, mesh) -> None:
    if vocab_axis is not None and mesh is not None and mesh.size(vocab_axis) > 1:
        raise NotImplementedError(
            f"the vocabulary sharded over mesh axis {vocab_axis!r} (tensor-parallel xent) "
            "is not ported yet: ROADMAP queue 1 item 5")


def chunked_softmax_xent_auto(x, w, b, targets, z_loss: float = 0.0, num_chunks: int = 8,
                              vocab_axis: str | None = None, mesh=None):
    """``chunked_softmax_xent``; a ``vocab_axis`` of size > 1 on ``mesh``
    (the JAX tensor-parallel branch) raises NotImplementedError."""
    _refuse_vocab_axis(vocab_axis, mesh)
    return chunked_softmax_xent(x, w, b, targets, z_loss, num_chunks)


def chunked_xent_eval_auto(x, w, b, targets, z_loss: float = 0.0, num_chunks: int = 8,
                           vocab_axis: str | None = None, mesh=None):
    """``chunked_xent_eval`` with ``chunked_softmax_xent_auto``'s refusal."""
    _refuse_vocab_axis(vocab_axis, mesh)
    return chunked_xent_eval(x, w, b, targets, z_loss, num_chunks)
