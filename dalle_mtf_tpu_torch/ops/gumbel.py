"""Gumbel-softmax with the straight-through estimator (port of
``dalle_mtf_tpu/ops/gumbel.py``).

Logits are cast to fp32, the Gumbel noise is ``-log(-log(u))`` with u
uniform in [1e-9, 1), the softmax is taken over ``(logits + g) /
temperature``, and the hard path is the straight-through
``(one_hot - soft).detach() + soft``. The uniform draw is its own function,
``gumbel_uniform``, from the caller's generator.

The draw does not depend on the layout: each value is a hash of a seed
drawn from the caller's generator and the value's global coordinates (row,
position, column), computed elementwise, so a rank holding some rows of the
batch (data parallelism) or a block of the columns (the VAE codebook's
split over ``tokens_dim``) draws the single process's values there. Over a
column split (``group``), the softmax takes its max and sum across the
blocks and the hard path the argmax across them (``model_argmax``: the
lowest global index on a tie, as ``jnp.argmax``); without one, each of
these is the block's own.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from dalle_mtf_tpu_torch.parallel.tensor import max_over_model, model_argmax, sum_over_model
from dalle_mtf_tpu_torch.utils.seeds import base_seed

SMOL = 1e-9  # the draw's lower end: log(0) never occurs
_M32 = 0xFFFFFFFF
# the multiplier of the integer hash's rounds: below 2^31, so the product of
# a 32-bit value stays inside int64
_MIX = 0x45D9F3B


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijection of [0, 2^32) on int64 ``x``, in place: two xorshift-
    multiply rounds and a last xorshift, every product masked to 32 bits."""
    for _ in range(2):
        x ^= x >> 16
        x.mul_(_MIX).bitwise_and_(_M32)
    x ^= x >> 16
    return x


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """fp32 in [1e-9, 1) from 24-bit integers: k * 2^-24 in [0, 1), then the
    affine map that keeps it below 1 and lifts 0 to 1e-9."""
    return SMOL + (1.0 - SMOL) * (bits.float() * 2.0 ** -24)


def gumbel_uniform(shape, generator: torch.Generator, device, block=None) -> torch.Tensor:
    """fp32 uniform in [1e-9, 1) of ``shape`` [rows, ..., cols] on ``device``.
    ``block`` = (row0, col0, cols): this tensor holds global rows from
    ``row0`` and columns [col0, col0 + shape[-1]) of ``cols``; None: the
    whole tensor (0, 0, shape[-1]). A 1-dim shape is one row.

    Counter-based: one 62-bit seed is drawn from ``generator``; each global
    row gets a key, the hash of its index under that seed, and each value
    the top 24 bits of the hash of (the hash of its index in the row) xor
    (its row's key). The values at a global coordinate are so the same under
    any split of the rows and columns, and each call is a few elementwise
    passes over the block."""
    device = torch.device(device)
    shape = tuple(shape)
    grid = shape if len(shape) > 1 else (1,) + shape
    row0, col0, cols = block if block is not None else (0, 0, grid[-1])
    mid = math.prod(grid[1:-1])
    if mid * cols > 2**32:
        raise ValueError(f"a row of {mid} x {cols} values exceeds the hash's 2^32 counter")
    seed = base_seed(generator)
    rows = torch.arange(row0, row0 + grid[0], device=device) ^ (seed & _M32)
    row_key = mix32(mix32(rows) ^ (seed >> 32))
    cell = (torch.arange(mid, device=device)[:, None] * cols
            + torch.arange(col0, col0 + grid[-1], device=device))
    x = mix32(mix32(cell)[None] ^ row_key[:, None, None])
    return uniform_from_bits(x >> 8).reshape(shape)


def gumbel_softmax(
    generator: torch.Generator,
    logits: torch.Tensor,
    temperature: float | torch.Tensor = 1.0,
    hard: bool = True,
    dim: int = -1,
    block=None,
    group=None,
) -> torch.Tensor:
    """A Gumbel-softmax sample over ``dim`` of ``logits`` (fp32); with
    ``hard`` the one-hot of its argmax carrying the soft sample's gradient.
    ``block`` (``gumbel_uniform``) places the logits' rows and columns in
    the whole batch; ``group``: the process group the columns (the last
    dim) are split over, or None."""
    logits = logits.float()
    if block is None:
        u = gumbel_uniform(logits.shape, generator, logits.device)
    else:
        if dim not in (-1, logits.dim() - 1):
            raise ValueError("a Gumbel-softmax over a block takes its softmax over the last dim")
        u = gumbel_uniform(logits.shape, generator, logits.device, block)
    g = -torch.log(-torch.log(u))
    z = ((logits + g) / temperature).movedim(dim, -1)
    top = max_over_model(z.detach().amax(-1, keepdim=True), group)
    e = torch.exp(z - top)
    sample = e / sum_over_model(e.sum(-1, keepdim=True), group)
    if hard:
        col0, n = (block[1] if block is not None else 0), sample.shape[-1]
        idx = model_argmax(sample.detach(), col0, group) - col0
        mine = (idx >= 0) & (idx < n)
        one_hot = (F.one_hot(idx.clamp(0, n - 1), n) * mine[..., None]).to(sample.dtype)
        sample = (one_hot - sample).detach() + sample
    return sample.movedim(-1, dim)
