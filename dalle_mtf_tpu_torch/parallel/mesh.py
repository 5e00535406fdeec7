"""The mesh grammar over ``torch.distributed`` (port of
``dalle_mtf_tpu/parallel/mesh.py``).

The configs shard with two strings, as the reference did:
``"mesh_shape": "data:2,seq:4"`` names the mesh axes and their sizes, and
``"layout": "batch_dim:data,total_seq_dim:seq"`` says which logical tensor
dimension is split over which axis. ``parse_mesh_shape``, ``parse_layout``
and ``resize_axes`` (the resize rule of the JAX ``build_mesh``) are copied as
pure functions. ``Mesh`` lays the world's ranks out on the resized axes in
row-major order (the last axis varies fastest) and makes one process group
per axis slice, created in the same order on every rank.

Of the layouts the JAX package honours, the port runs data parallelism over
the ``batch_dim`` axis and sequence parallelism (ring attention) over the
``total_seq_dim`` axis; ``check_layout`` refuses the rest at world size > 1.
"""

from __future__ import annotations

import logging
import math
from typing import Sequence

logger = logging.getLogger(__name__)

# logical dimension names of the layout rules (dalle_mtf_tpu/models/dalle.py)
BATCH = "batch_dim"
SEQ = "total_seq_dim"
HEADS = "heads_dim"
INTERMEDIATE = "intermediate_expanded"
VOCAB = "vocab_dim"
LAYERS = "layers"


def parse_mesh_shape(mesh_shape: str | None) -> list[tuple[str, int]]:
    """``"data:16,model:2"`` -> ``[("data", 16), ("model", 2)]``; a missing
    or empty string is a 1-axis data mesh."""
    if not mesh_shape:
        return [("data", 1)]
    out = []
    for part in mesh_shape.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition(":")
        out.append((name.strip(), int(size)))
    return out or [("data", 1)]


def parse_layout(layout: str | None) -> dict[str, str]:
    """``"batch_dim:data,heads_dim:model"`` -> logical dim -> mesh axis.
    Unlisted logical dims are replicated."""
    if not layout:
        return {}
    rules: dict[str, str] = {}
    for part in layout.split(","):
        part = part.strip()
        if not part:
            continue
        logical, _, axis = part.partition(":")
        rules[logical.strip()] = axis.strip()
    return rules


def resize_axes(axes: Sequence[tuple[str, int]], n: int) -> list[tuple[str, int]]:
    """The resize rule of the JAX ``build_mesh``: when the axes' product is
    not ``n``, every later axis is clamped to what fits (down to a divisor),
    and the first axis takes the rest."""
    axes = list(axes)
    if math.prod(s for _, s in axes) == n:
        return axes
    tail = 1
    new_axes = [(axes[0][0], 1)]
    for name, size in axes[1:]:
        size = min(size, max(1, n // tail))
        while size > 1 and (n % (tail * size)) != 0:
            size -= 1
        tail *= size
        new_axes.append((name, size))
    new_axes[0] = (axes[0][0], n // tail)
    if new_axes != axes:
        logger.warning("resized mesh %s -> %s for %d processes", axes, new_axes, n)
    return new_axes


def check_layout(axes: Sequence[tuple[str, int]], rules: dict[str, str],
                 attention_type: str = "global") -> None:
    """Raise NotImplementedError for a layout the port cannot honour on
    these (resized) axes: every axis of size > 1 must carry the batch
    (``batch_dim``) or, under ring attention, the sequence
    (``total_seq_dim``). Tensor parallelism (``heads_dim``,
    ``intermediate_expanded``, ``vocab_dim``), pipeline parallelism
    (``layers``) and a replicated axis are refused."""
    batch_axis = rules.get(BATCH) or "data"
    seq_axis = rules.get(SEQ) or "seq"
    ring = attention_type in ("ring", "local_ring")
    refused = []
    for name, size in axes:
        if size == 1 or name == batch_axis or (ring and name == seq_axis):
            continue
        dims = sorted(d for d, a in rules.items() if a == name)
        what = {HEADS: "tensor", INTERMEDIATE: "tensor", VOCAB: "tensor",
                LAYERS: "pipeline", SEQ: "sequence (without ring attention)"}
        kinds = sorted({what.get(d, "unknown") for d in dims}) or ["replicated"]
        refused.append(f"mesh axis {name!r} of size {size} ({', '.join(kinds)} "
                       f"parallelism, layout dims {dims})")
    if refused:
        raise NotImplementedError(
            "not ported to dalle_mtf_tpu_torch yet: " + "; ".join(refused)
            + ": the port shards the batch (batch_dim) and, under ring attention, "
            "the sequence (total_seq_dim)")


class Mesh:
    """The world's ranks on named axes, with a process group per axis slice.

    ``axes``: the resized (name, size) pairs; ``rank``/``world``: this
    process; ``coords``: its index on each axis. ``group(name)`` and
    ``ranks(name)`` give the process group and the global ranks (in axis
    order) of the slice through this rank along ``name``; both are None on
    an axis of size 1 or without a process group. Every rank must construct
    the Mesh, because ``torch.distributed.new_group`` is collective.
    """

    def __init__(self, axes: Sequence[tuple[str, int]], rank: int = 0, world: int = 1):
        self.axes = list(axes)
        if math.prod(s for _, s in self.axes) != world:
            raise ValueError(f"mesh {self.axes} does not hold {world} ranks")
        self.rank, self.world = rank, world
        self.names = [n for n, _ in self.axes]
        self.shape = dict(self.axes)
        self.coords = dict(zip(self.names, _unravel(rank, [s for _, s in self.axes])))
        self._groups: dict[str, object] = {}
        self._ranks: dict[str, list[int]] = {}
        if world == 1:
            return
        import torch.distributed as dist  # noqa: PLC0415

        backend = dist.get_backend()
        for axis, (name, size) in enumerate(self.axes):
            if size == 1:
                continue
            # every slice along this axis, in one order on every rank
            for ranks in _slices([s for _, s in self.axes], axis):
                group = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    self._groups[name], self._ranks[name] = group, ranks
            if dist.get_backend(self._groups[name]) != backend:
                raise RuntimeError(f"the {name!r} process group runs "
                                   f"{dist.get_backend(self._groups[name])}, not {backend}")

    def size(self, name: str | None) -> int:
        return self.shape.get(name, 1) if name else 1

    def index(self, name: str | None) -> int:
        return self.coords.get(name, 0) if name else 0

    def group(self, name: str):
        return self._groups.get(name)

    def ranks(self, name: str) -> list[int] | None:
        return self._ranks.get(name)

    def __repr__(self) -> str:
        return f"Mesh({self.axes}, rank={self.rank}, coords={self.coords})"


def _unravel(rank: int, shape: list[int]) -> list[int]:
    out = []
    for size in reversed(shape):
        out.append(rank % size)
        rank //= size
    return out[::-1]


def _slices(shape: list[int], axis: int) -> list[list[int]]:
    """The global ranks of every line along ``axis`` of a row-major grid."""
    stride = math.prod(shape[axis + 1:])
    out = []
    for base in range(math.prod(shape)):
        if (base // stride) % shape[axis] == 0:
            out.append([base + i * stride for i in range(shape[axis])])
    return out


def build_mesh(mesh_shape: str | None, layout: str | None, attention_type: str = "global",
               rank: int = 0, world: int = 1) -> Mesh:
    """The config's mesh resized to ``world`` ranks, its layout checked
    (``check_layout``), with this rank's process groups."""
    axes = resize_axes(parse_mesh_shape(mesh_shape), world)
    if world > 1:
        check_layout(axes, parse_layout(layout), attention_type)
    return Mesh(axes, rank, world)
