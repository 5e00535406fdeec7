"""Constant pad with an explicit gradient (port of
``dalle_mtf_tpu/ops/pad.py``).

The reference's one custom op, ``CustomPadOperation`` (src/dalle_mtf/ops.py:
13-68), pads one named dimension with a constant and defines its gradient
as the inverse slice. Here it is a ``torch.autograd.Function``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _Pad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, before: int, after: int, axis: int, pad_value):
        ctx.before, ctx.size, ctx.axis = before, x.shape[axis], axis
        # F.pad lists (before, after) pairs from the last axis backwards
        cfg = [0, 0] * (x.dim() - 1 - axis) + [before, after]
        return F.pad(x, cfg, value=pad_value)

    @staticmethod
    def backward(ctx, g):
        # gradient of pad = slice back to the original extent (ops.py:33-37)
        return g.narrow(ctx.axis, ctx.before, ctx.size), None, None, None, None


def pad(x: torch.Tensor, paddings: tuple[int, int], axis: int, pad_value=0.0) -> torch.Tensor:
    """Pad ``axis`` of ``x`` by (before, after) with ``pad_value``."""
    before, after = (int(p) for p in paddings)
    return _Pad.apply(x, before, after, axis % x.dim(), pad_value)


def exists(x) -> bool:
    """reference ops.py:72-73."""
    return x is not None
