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

With the vocabulary split over a ``vocab_dim`` mesh axis of size m > 1,
the ``*_auto`` entry points take this rank's stored block of w [E, V_l] and
b [V_l] (``parallel.mesh.split_bounds``: rank i's rows start at i *
V_pad / m) and run the JAX ``tp_chunked_softmax_xent`` /
``_tp_chunked_xent_eval``: the local block is padded to V_pad / m columns
(zero weights, a -1e10 bias: such a column never wins the max, adds ~0 to
the sum-exp and gets ~0 gradient; the pad's backward slices dw/db back);
each chunk's max is all_reduced with MAX and its sum-exp and target logit
with SUM over the model group, so every rank holds the whole loss; dx is
summed over the group, dw and db stay local. Only per-row scalars and the
[N, E] dx cross the group, never a [*, V] tensor. The eval's argmax keeps
``jnp.argmax``'s first-occurrence rule across the blocks: MAX of the local
maxima, then MIN of the global index where a rank's local max equals it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dalle_mtf_tpu_torch.ops.pad import pad
from dalle_mtf_tpu_torch.parallel.mesh import padded_vocab
from dalle_mtf_tpu_torch.parallel.tensor import all_reduce

NEG_INF = -1e10  # the padded columns' bias (the JAX xent's pad value)


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


def _mine(t_c, v0: int, n: int):
    """(rows whose target lies in the local columns [v0, v0 + n), their
    local column, clamped elsewhere)."""
    rel = t_c - v0
    mine = (rel >= 0) & (rel < n)
    return mine, rel.clamp(0, n - 1)


def tp_chunk_loss(logits, t_c, z_loss, v0, group):
    """(loss, lse, local max) of one chunk's local fp32 logits [c, n] over
    columns [v0, v0 + n) of the vocabulary, the same on every rank of
    ``group``: the max all_reduced with MAX, sum-exp and target logit with
    SUM (one collective)."""
    m_loc = logits.amax(dim=-1)
    m = all_reduce(m_loc.clone(), group, dist.ReduceOp.MAX)
    mine, col = _mine(t_c, v0, logits.shape[1])
    tgt = torch.where(mine, logits.gather(1, col[:, None])[:, 0], 0.0)
    sums = all_reduce(torch.stack([torch.exp(logits - m[:, None]).sum(-1), tgt]), group)
    lse = m + torch.log(sums[0])
    loss = lse - sums[1]
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss, lse, m_loc, m


def tp_correct(logits, m_loc, m, t_c, v0, group):
    """Argmax correctness of the vocabulary's rows under local logits [c, n]
    over columns [v0, v0 + n): the global argmax is the least global index
    among the ranks whose local max equals the global max (``jnp.argmax``'s
    first-occurrence rule)."""
    idx = logits.argmax(dim=-1) + v0
    big = torch.iinfo(torch.int64).max
    pred = all_reduce(torch.where(m_loc == m, idx, big), group, dist.ReduceOp.MIN)
    return (pred == t_c).float()


class _TPChunkedXent(torch.autograd.Function):
    """``_ChunkedXent`` on this rank's padded vocabulary block (columns
    [v0, v0 + V_pad / m)) over the model group: loss [N] fp32, the same on
    every rank."""

    @staticmethod
    def forward(ctx, x, w, b, targets, z_loss, num_chunks, v0, group):
        loss = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        lse = torch.empty_like(loss)
        for rows in _chunks(x.shape[0], num_chunks):
            loss[rows], lse[rows], _, _ = tp_chunk_loss(
                _chunk_logits(x[rows], w, b), targets[rows], z_loss, v0, group)
        ctx.save_for_backward(x, w, b, targets, lse)
        ctx.args = (z_loss, num_chunks, v0, group)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, b, targets, lse = ctx.saved_tensors
        z_loss, num_chunks, v0, group = ctx.args
        dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
        for rows in _chunks(x.shape[0], num_chunks):
            lse_c = lse[rows, None]
            # the local block of the global softmax: lse holds every block
            d = _chunk_logits(x[rows], w, b).sub_(lse_c).exp_()
            if z_loss:
                d.mul_(1.0 + 2.0 * z_loss * lse_c)
            mine, col = _mine(targets[rows], v0, d.shape[1])
            r = torch.arange(d.shape[0], device=d.device)
            d[r[mine], col[mine]] -= 1.0
            d.mul_(g[rows, None])
            dx[rows] = f32_matmul(d.to(w.dtype), w.t())
            dw.addmm_(x[rows].float().t(), d)
            db += d.sum(0)
        # dx sums the contributions of every vocabulary block
        return (all_reduce(dx, group).to(x.dtype), dw.to(w.dtype), db,
                None, None, None, None, None)


def _tp_block(w, b, vocab_size: int, mesh, vocab_axis: str):
    """(w, b padded to the rank's V_pad / m columns, v0, group)."""
    if vocab_size is None:
        raise ValueError("a vocabulary split over the mesh needs the whole vocab_size")
    m = mesh.size(vocab_axis)
    block = padded_vocab(vocab_size, m) // m
    short = block - w.shape[1]
    if short:
        w = pad(w, (0, short), 1)
        b = pad(b, (0, short), 0, NEG_INF)
    return w, b, mesh.index(vocab_axis) * block, mesh.group(vocab_axis)


def _vocab_split(vocab_axis: str | None, mesh) -> bool:
    return vocab_axis is not None and mesh is not None and mesh.size(vocab_axis) > 1


def chunked_softmax_xent_auto(x, w, b, targets, z_loss: float = 0.0, num_chunks: int = 8,
                              vocab_axis: str | None = None, mesh=None,
                              vocab_size: int | None = None):
    """``chunked_softmax_xent``, or, where ``vocab_axis`` has size > 1 on
    ``mesh``, the vocab-parallel op on this rank's stored block of w and b
    (``vocab_size`` the whole V); see the module docstring."""
    if not _vocab_split(vocab_axis, mesh):
        return chunked_softmax_xent(x, w, b, targets, z_loss, num_chunks)
    w, b, v0, group = _tp_block(w, b, vocab_size, mesh, vocab_axis)
    return _TPChunkedXent.apply(x, w, b, targets.long(), float(z_loss), int(num_chunks),
                                v0, group)


@torch.no_grad()
def chunked_xent_eval_auto(x, w, b, targets, z_loss: float = 0.0, num_chunks: int = 8,
                           vocab_axis: str | None = None, mesh=None,
                           vocab_size: int | None = None):
    """``chunked_xent_eval``, or its vocab-parallel form as
    ``chunked_softmax_xent_auto`` dispatches."""
    if not _vocab_split(vocab_axis, mesh):
        return chunked_xent_eval(x, w, b, targets, z_loss, num_chunks)
    w, b, v0, group = _tp_block(w, b, vocab_size, mesh, vocab_axis)
    targets = targets.long()
    loss = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    correct = torch.empty_like(loss)
    for rows in _chunks(x.shape[0], num_chunks):
        logits = _chunk_logits(x[rows], w, b)
        loss[rows], _, m_loc, m = tp_chunk_loss(logits, targets[rows], z_loss, v0, group)
        correct[rows] = tp_correct(logits, m_loc, m, targets[rows], v0, group)
    return loss, correct
