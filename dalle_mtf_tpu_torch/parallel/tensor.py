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

The VAE's codebook split over ``tokens_dim`` (models/vae.py) uses the same
two around its column-split products, ``sum_over_model`` (summed both ways)
for the softmax's sum across the blocks, ``max_over_model`` for its max,
and ``model_argmax`` for the argmax across them. Its convs split over their
channels also pass activations between a whole tensor and a rank's block
of one dim:

- ``gather_from_model``: the blocks all-gathered into the whole forward,
  the rank's block of the gradient backward (the whole tensor's consumer
  runs the same on every rank);
- ``scatter_to_model``: the rank's block forward, the blocks' gradients
  all-gathered backward.

Each rank of a group then holds the same loss and, for every leaf, the
gradient of its shard (a replicated leaf's whole gradient). On one process,
or without a group, every function here is the identity.

Beside a pipe axis (PP x TP) a stacked leaf carries two splits: its stage's
layers over the pipe group (dim 0) and its block over the model group. A
leaf's ``placement`` is then a tuple of ``Placed`` (each split with its
group and mesh axis), the pipe's first; ``shard``, ``block_to``,
and ``gather`` take either one ``Split`` or a placement,
``gather_to_host`` and ``moment_split`` a placement, and
``Sharding.placed`` gives a leaf's.

``all_reduce`` is the one entry to the collectives of the tensor-parallel
path and the trainer's sums, ``all_gather`` to the gathers of the two
operators above, ``broadcast`` to the trainer's copies of a replicated
leaf's gradient; each counts the calls and bytes it moves in
``COLLECTIVES`` (an all_reduce or a broadcast its tensor's bytes, an
all_gather the whole gathered tensor's), which ``chip_smoke.py`` reads and
resets.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np
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


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``dist.broadcast`` of ``t`` in place from global rank ``src`` over
    ``group`` (None: the world), counted in ``COLLECTIVES``; returns ``t``."""
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += t.numel() * t.element_size()
    dist.broadcast(t, src, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's equal block ``t`` of ``group`` concatenated along
    ``dim`` in the group's rank order, counted in ``COLLECTIVES`` (the
    whole tensor's bytes)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += t.numel() * t.element_size() * len(parts)
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def _block_of(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal block of ``t`` along ``dim`` over ``group``."""
    n = t.shape[dim] // dist.get_world_size(group)
    return t.narrow(dim, dist.get_rank(group) * n, n)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block_of(g, ctx.dim, ctx.group).contiguous(), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block_of(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


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


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x unchanged; its gradient summed over ``group`` (None: identity)."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group``; its gradient passed through (None:
    identity)."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor from every rank's equal block ``x`` along ``dim``
    of ``group``; its gradient's block of this rank passed back (None:
    identity). For a consumer every rank runs on the same whole tensor."""
    return x if group is None else _GatherFromModel.apply(x, dim, group)


def scatter_to_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal block along ``dim`` of ``x``, whole and the same on
    every rank of ``group``; the blocks' gradients gathered into the whole
    one (None: identity)."""
    return x if group is None else _ScatterToModel.apply(x, dim, group)


def sum_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group``, and its gradient summed over it too: for a
    sum whose every rank uses the result only on its own block of columns
    (a softmax's denominator), so each rank's gradient is a share (None:
    identity)."""
    return x if group is None else _SumOverModel.apply(x, group)


def max_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of x over ``group``, without a gradient (None:
    x itself)."""
    return x if group is None else all_reduce(x.detach().contiguous().clone(), group,
                                              dist.ReduceOp.MAX)


def model_argmax(values: torch.Tensor, col0: int, group) -> torch.Tensor:
    """The argmax over the last dim of values split by columns over
    ``group``, this rank's block starting at global column ``col0``: the
    global index (int64) of the largest value, the lowest where several tie
    (``jnp.argmax``'s rule). Two collectives: MAX of the values, MIN of the
    candidates' indices."""
    local = values.argmax(dim=-1)
    if group is None:
        return local + col0
    best = values.gather(-1, local[..., None])[..., 0].detach().clone()
    top = all_reduce(best.clone(), group, dist.ReduceOp.MAX)
    cand = torch.where(best == top, local + col0, torch.iinfo(torch.int64).max)
    return all_reduce(cand, group, dist.ReduceOp.MIN)


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


class Placed(NamedTuple):
    """One split of a leaf, with the process group and the name of the mesh
    axis it is split over."""

    split: Split
    group: Any
    axis: str | None = None


def _splits_of(split) -> tuple[Split, ...]:
    """The splits of a ``Split``, a placement (a tuple of ``Placed``) or
    None (none)."""
    if split is None:
        return ()
    if isinstance(split, Split):
        return (split,)
    return tuple(p.split for p in split)


def shard(t: torch.Tensor, split) -> torch.Tensor:
    """This rank's block of a whole leaf (``t`` itself when replicated);
    ``split``: a ``Split``, a placement or None."""
    for sp in _splits_of(split):
        t = t.narrow(sp.dim, sp.start, sp.stop - sp.start)
    return t


def block_to(t: torch.Tensor, split, device) -> torch.Tensor:
    """This rank's block of a whole leaf ``t`` copied to ``device``: of a
    leaf mapped from a checkpoint file, only the block's pages are read."""
    block = shard(t, split)
    return torch.empty(block.shape, dtype=block.dtype, device=device).copy_(block)


def gather(t: torch.Tensor, split, group) -> torch.Tensor:
    """The whole leaf from every rank's block ``t`` (a collective over
    ``group``; ``t`` itself when replicated). Blocks are padded to the
    longest for the all_gather and cut back after. Of a placement, over
    each split's own group in turn, the innermost first (``group`` is not
    read)."""
    if split is not None and not isinstance(split, Split):
        for p in reversed(split):
            t = gather(t, p.split, p.group)
        return t
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


def gather_to_host(t: torch.Tensor, placed, ranks) -> torch.Tensor | None:
    """The whole leaf on the host of the first of ``ranks`` (None on the
    other ranks), from every rank's block ``t`` of the leaf's placement
    ``placed``: the blocks go to it one at a time, point to point, so no
    device holds a block it does not own and the host holds the one leaf.
    ``ranks``: nested lists, one level a split of ``placed`` in its order,
    of the global rank holding each block (``Mesh.plane``); a rank not in
    them takes no part. Over gloo each block is staged through its rank's
    host (gloo sends CPU tensors); over nccl it is received on the card,
    one block at a time."""
    splits = _splits_of(placed)
    grid = np.asarray(ranks, dtype=np.int64).reshape([len(sp.bounds) for sp in splits])
    root, me = int(grid.flat[0]), dist.get_rank()
    t = t.detach()
    gloo = dist.get_backend() == "gloo"
    if me != root:
        if (grid == me).any():
            dist.send(t.cpu() if gloo else t.contiguous(), root)
        return None
    shape = list(t.shape)
    for sp in splits:
        shape[sp.dim] = sp.size
    whole = torch.empty(shape, dtype=t.dtype)
    mine = tuple(sp.index for sp in splits)
    for idx in np.ndindex(grid.shape):
        view = whole
        for sp, j in zip(splits, idx):
            a, b = sp.bounds[j]
            view = view.narrow(sp.dim, a, b - a)
        if idx == mine:
            view.copy_(t)
            continue
        buf = torch.empty(view.shape, dtype=t.dtype, device="cpu" if gloo else t.device)
        dist.recv(buf, int(grid[idx]))
        view.copy_(buf)
    return whole


class Sharding:
    """The split of every leaf of a parameter tree over the model axis (or,
    under pipeline parallelism, of every stacked leaf's layers over the pipe
    axis): ``splits`` maps a leaf's path (a tuple of names) to its ``Split``
    or None, ``group`` is that axis's process group and ``axis`` its name.
    Under both (PP x TP) the model axis's ``Sharding`` holds the pipe axis's
    as ``pipe``, the outer split of the stacked leaves."""

    def __init__(self, splits: Mapping[tuple[str, ...], Split | None], group,
                 axis: str | None = None, pipe: "Sharding | None" = None):
        self.splits = dict(splits)
        self.group, self.axis, self.pipe = group, axis, pipe

    def of(self, path: tuple[str, ...]) -> Split | None:
        """The leaf's split over this ``Sharding``'s own axis."""
        return self.splits.get(tuple(path))

    def placed(self, path) -> tuple[Placed, ...]:
        """The leaf's placement: each of its splits with its group and axis,
        the pipe's first (empty for a replicated leaf)."""
        outer = self.pipe.placed(path) if self.pipe is not None else ()
        split = self.of(path)
        return outer + ((Placed(split, self.group, self.axis),) if split is not None else ())

    def whole_shape(self, path, shape) -> tuple[int, ...]:
        shape = list(shape)
        for p in self.placed(path):
            shape[p.split.dim] = p.split.size
        return tuple(shape)

    def local_shape(self, path, shape) -> tuple[int, ...]:
        shape = list(shape)
        for p in self.placed(path):
            shape[p.split.dim] = p.split.stop - p.split.start
        return tuple(shape)

    def shard_tree(self, tree: Mapping[str, Any], prefix: tuple[str, ...] = ()) -> dict:
        """This rank's blocks of a whole tree of tensors (views)."""
        return {k: (self.shard_tree(v, prefix + (k,)) if isinstance(v, Mapping)
                    else shard(v, self.placed(prefix + (k,))))
                for k, v in tree.items()}

    def gather_tree(self, tree: Mapping[str, Any], prefix: tuple[str, ...] = ()) -> dict:
        """The whole tree from every rank's blocks (collective)."""
        return {k: (self.gather_tree(v, prefix + (k,)) if isinstance(v, Mapping)
                    else gather(v, self.placed(prefix + (k,)), None))
                for k, v in tree.items()}


def moment_split(placed, dropped: int):
    """The placement of a statistic of a leaf placed by ``placed`` (or
    None) that dropped (reduced) dim ``dropped``: its splits of the other
    dims, renumbered (None where none is left)."""
    left = tuple(p._replace(split=p.split._replace(dim=p.split.dim - (p.split.dim > dropped)))
                 for p in placed or () if p.split.dim != dropped)
    return left or None
