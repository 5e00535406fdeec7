"""Tensor parallelism over the mesh's model axis (the Megatron split).

The JAX package shards its parameters over logical axes and lets GSPMD
place the collectives (``DALLE.logical_axes``, ``make_constrain``). The port
writes them out. Every rank of a model group holds the same activations
between the blocks and its shard of each split weight (``mesh.leaf_split``):
the heads of ``wq``/``wk``/``wv``/``wo``, the columns of ``w_mlp1``/
``b_mlp1`` and rows of ``w_mlp2``, and a block of the vocabulary in ``wte``,
``w_out`` and ``b_out``. Two operators join the shards:

- ``copy_to_model``: identity forward, gradient summed over the group
  backward; before each column-split product (q/k/v, the MLP's first
  product, the vocabulary head);
- ``reduce_from_model``: summed over the group forward, identity backward;
  after each row-split product (``wo``, ``w_mlp2``) and the vocab-parallel
  embedding.

Each rank of a group then holds the same loss and, for every leaf, the
gradient of its shard (a replicated leaf's whole gradient). On one process,
or without a group, every function here is the identity.

``all_reduce`` is the one entry to the collectives of the tensor-parallel
path and the trainer's sums; it counts the calls and bytes it moves in
``COLLECTIVES``, which ``chip_smoke.py`` reads and resets.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.distributed as dist

from dalle_mtf_tpu_torch.parallel.mesh import Split

COLLECTIVES = {"calls": 0, "bytes": 0}


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``group`` (None: the
    world), counted in ``COLLECTIVES``; returns ``t``."""
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=op, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x unchanged; its gradient summed over ``group`` (None: identity)."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group``; its gradient passed through (None:
    identity)."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def vocab_parallel_embedding(wte: torch.Tensor, tokens: torch.Tensor, split: Split | None,
                             group, dtype: torch.dtype) -> torch.Tensor:
    """``wte[tokens].to(dtype)`` with ``wte`` this rank's rows
    [split.start, split.stop) of the table: a token outside them reads a
    zero row, and the rows are summed over ``group``. Exact, since each
    position has one non-zero term."""
    if split is None:
        return wte[tokens].to(dtype)
    rel = tokens - split.start
    mine = (rel >= 0) & (rel < wte.shape[0])
    rows = torch.where(mine[..., None], wte[rel.clamp(0, wte.shape[0] - 1)], 0.0)
    return reduce_from_model(rows.to(dtype), group)


def shard(t: torch.Tensor, split: Split | None) -> torch.Tensor:
    """This rank's block of a whole leaf (``t`` itself when replicated)."""
    if split is None:
        return t
    return t.narrow(split.dim, split.start, split.stop - split.start)


def gather(t: torch.Tensor, split: Split | None, group) -> torch.Tensor:
    """The whole leaf from every rank's block ``t`` (a collective over
    ``group``; ``t`` itself when replicated). Blocks are padded to the
    longest for the all_gather and cut back after."""
    if split is None or group is None:
        return t
    t = t.detach().contiguous()
    short = split.block - t.shape[split.dim]
    if short:
        t = torch.cat([t, t.new_zeros(t.shape[:split.dim] + (short,) + t.shape[split.dim + 1:])],
                      split.dim)
    parts = [torch.empty_like(t) for _ in split.bounds]
    dist.all_gather(parts, t, group=group)
    return torch.cat([p.narrow(split.dim, 0, b - a) for p, (a, b) in zip(parts, split.bounds)],
                     split.dim)


class Sharding:
    """The split of every leaf of a parameter tree over the model axis:
    ``splits`` maps a leaf's path (a tuple of names) to its ``Split`` or
    None, ``group`` is the model axis's process group."""

    def __init__(self, splits: Mapping[tuple[str, ...], Split | None], group):
        self.splits = dict(splits)
        self.group = group

    def of(self, path: tuple[str, ...]) -> Split | None:
        return self.splits.get(tuple(path))

    def whole_shape(self, path, shape) -> tuple[int, ...]:
        split = self.of(path)
        shape = tuple(shape)
        if split is None:
            return shape
        return shape[:split.dim] + (split.size,) + shape[split.dim + 1:]

    def local_shape(self, path, shape) -> tuple[int, ...]:
        split = self.of(path)
        shape = tuple(shape)
        if split is None:
            return shape
        return shape[:split.dim] + (split.stop - split.start,) + shape[split.dim + 1:]

    def shard_tree(self, tree: Mapping[str, Any], prefix: tuple[str, ...] = ()) -> dict:
        """This rank's blocks of a whole tree of tensors (views)."""
        return {k: (self.shard_tree(v, prefix + (k,)) if isinstance(v, Mapping)
                    else shard(v, self.of(prefix + (k,))))
                for k, v in tree.items()}

    def gather_tree(self, tree: Mapping[str, Any], prefix: tuple[str, ...] = ()) -> dict:
        """The whole tree from every rank's blocks (collective)."""
        return {k: (self.gather_tree(v, prefix + (k,)) if isinstance(v, Mapping)
                    else gather(v, self.of(prefix + (k,)), self.group))
                for k, v in tree.items()}


def moment_split(split: Split | None, dropped: int) -> Split | None:
    """The split of a statistic of a leaf split by ``split`` that dropped
    (reduced) dim ``dropped``: None where it reduced the split dim itself,
    else the split dim renumbered."""
    if split is None or split.dim == dropped:
        return None
    return split._replace(dim=split.dim - (split.dim > dropped))
