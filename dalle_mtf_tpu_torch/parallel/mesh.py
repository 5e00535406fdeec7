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
the ``batch_dim`` axis, sequence parallelism (ring attention) over the
``total_seq_dim`` axis and tensor parallelism over one axis that carries any
of ``heads_dim``, ``intermediate_expanded`` and ``vocab_dim`` (the Megatron
split: parallel/tensor.py). ``check_layout`` refuses the rest at world size
> 1. ``leaf_split`` says which dim of a parameter the tensor-parallel axis
splits and where this rank's block lies.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Sequence

logger = logging.getLogger(__name__)

# logical dimension names of the layout rules (dalle_mtf_tpu/models/dalle.py)
BATCH = "batch_dim"
SEQ = "total_seq_dim"
HEADS = "heads_dim"
INTERMEDIATE = "intermediate_expanded"
VOCAB = "vocab_dim"
LAYERS = "layers"
EMBED = "embed_dim"
EMBED_SEQ = "embed_seq_dim"
KV = "kv_dim"
# the logical dims a tensor-parallel axis may carry
TENSOR_DIMS = (HEADS, INTERMEDIATE, VOCAB)
# columns of a vocabulary block: each rank's block is a multiple of this, as
# the JAX xent pads V (dalle_mtf_tpu/ops/xent_fused.py)
VOCAB_LANES = 128


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


def tensor_axis(axes: Sequence[tuple[str, int]], rules: dict[str, str]) -> str | None:
    """The mesh axis of size > 1 that the layout's ``heads_dim``,
    ``intermediate_expanded`` or ``vocab_dim`` rule names (the first such),
    or None."""
    for name, size in axes:
        if size > 1 and any(rules.get(d) == name for d in TENSOR_DIMS):
            return name
    return None


def check_layout(axes: Sequence[tuple[str, int]], rules: dict[str, str],
                 attention_type: str = "global") -> None:
    """Raise NotImplementedError for a layout the port cannot honour on
    these (resized) axes. Every axis of size > 1 must carry the batch
    (``batch_dim``), under ring attention the sequence (``total_seq_dim``),
    or tensor parallelism: a non-empty set of ``heads_dim``,
    ``intermediate_expanded`` and ``vocab_dim`` and nothing else, on one
    axis only. Pipeline parallelism (``layers``, ROADMAP queue 1 item 5c), a
    replicate-only axis and tensor parallelism under ring attention
    ("TP x SP") are refused."""
    batch_axis = rules.get(BATCH) or "data"
    seq_axis = rules.get(SEQ) or "seq"
    ring = attention_type in ("ring", "local_ring")
    refused, tensor = [], []
    for name, size in axes:
        if size == 1 or name == batch_axis or (ring and name == seq_axis):
            continue
        dims = sorted(d for d, a in rules.items() if a == name)
        if dims and set(dims) <= set(TENSOR_DIMS):
            tensor.append(name)
            continue
        what = {HEADS: "tensor", INTERMEDIATE: "tensor", VOCAB: "tensor",
                LAYERS: "pipeline", SEQ: "sequence (without ring attention)"}
        kinds = sorted({what.get(d, "unknown") for d in dims}) or ["replicated"]
        refused.append(f"mesh axis {name!r} of size {size} ({', '.join(kinds)} "
                       f"parallelism, layout dims {dims})")
    if len(tensor) > 1:
        refused.append(f"tensor parallelism over more than one mesh axis {tensor}")
    if tensor and ring:
        refused.append(f"TP x SP: not ported (tensor parallelism over {tensor[0]!r} with "
                       f"attention_type {attention_type!r}; ROADMAP queue 1)")
    if refused:
        raise NotImplementedError(
            "not ported to dalle_mtf_tpu_torch yet: " + "; ".join(refused)
            + ": the port shards the batch (batch_dim), under ring attention the "
            "sequence (total_seq_dim), and the heads, the MLP width and the "
            "vocabulary (heads_dim, intermediate_expanded, vocab_dim) over one axis")


def padded_vocab(v: int, m: int) -> int:
    """V padded to a multiple of 128 * m (the JAX xent's ``v_pad``): every
    rank's vocabulary block is ``padded_vocab(v, m) // m`` columns."""
    lanes = VOCAB_LANES * m
    return -(-v // lanes) * lanes


def split_bounds(logical: str, size: int, m: int) -> tuple[tuple[int, int], ...] | None:
    """Every model-axis index's [start, stop) along a dim of ``size`` with
    logical name ``logical`` split ``m`` ways, or None where it does not
    divide. A vocabulary dim is split into contiguous blocks of
    ``padded_vocab(size, m) // m`` rows, of which a rank stores only the
    real ones (the last ranks hold fewer); any other dim into m equal
    blocks."""
    if logical == VOCAB:
        block = padded_vocab(size, m) // m
        bounds = tuple((min(i * block, size), min((i + 1) * block, size)) for i in range(m))
        if any(a == b for a, b in bounds):
            raise ValueError(f"a vocabulary of {size} leaves a rank of {m} no rows in blocks "
                             f"of {block}: use fewer ranks on the vocab_dim axis")
        return bounds
    if size % m:
        return None
    block = size // m
    return tuple((i * block, (i + 1) * block) for i in range(m))


class Split(NamedTuple):
    """Where a tensor-parallel leaf lies: the whole leaf is split along
    ``dim``; ``bounds`` holds every model-axis index's [start, stop) and
    ``index`` is this rank's."""

    dim: int
    bounds: tuple[tuple[int, int], ...]
    index: int

    @property
    def start(self) -> int:
        return self.bounds[self.index][0]

    @property
    def stop(self) -> int:
        return self.bounds[self.index][1]

    @property
    def size(self) -> int:
        """The whole leaf's length along ``dim``."""
        return self.bounds[-1][1]

    @property
    def block(self) -> int:
        """The longest shard (the length a gather pads each shard to)."""
        return max(b - a for a, b in self.bounds)


def leaf_split(logical_axes: Sequence[str | None], shape: Sequence[int], mesh,
               name: str = "") -> Split | None:
    """Which dim of a leaf of whole ``shape`` with JAX ``logical_axes`` the
    mesh's tensor-parallel axis splits (by the mesh's layout rules), and
    this rank's block along it; None for a replicated leaf. A dim that does
    not divide is replicated with a warning (the JAX package silently leaves
    it to GSPMD's dense path)."""
    axis = mesh.tp_axis if mesh is not None else None
    if axis is None:
        return None
    m = mesh.size(axis)
    for dim, (logical, size) in enumerate(zip(logical_axes, shape)):
        if logical not in TENSOR_DIMS or mesh.rules.get(logical) != axis:
            continue
        bounds = split_bounds(logical, size, m)
        if bounds is None:
            logger.warning("%s: %s of size %d does not divide over mesh axis %r of size %d: "
                           "replicated on every rank", name or "leaf", logical, size, axis, m)
            return None
        return Split(dim, bounds, mesh.index(axis))
    return None


class Mesh:
    """The world's ranks on named axes, with a process group per axis slice.

    ``axes``: the resized (name, size) pairs; ``rank``/``world``: this
    process; ``coords``: its index on each axis. ``group(name)`` and
    ``ranks(name)`` give the process group and the global ranks (in axis
    order) of the slice through this rank along ``name``; both are None on
    an axis of size 1 or without a process group. Every rank must construct
    the Mesh, because ``torch.distributed.new_group`` is collective.

    ``rules``: the layout (logical dim -> mesh axis). ``tp_axis`` (the axis
    its tensor-parallel rules name, ``tensor_axis``; None where there is none)
    splits the model; the ranks that share this rank's index on it (every
    other axis) hold the same blocks of different data, and gradients and
    metrics are summed over them: ``replica_group`` (None for the whole
    world), ``replicas`` of them.
    """

    def __init__(self, axes: Sequence[tuple[str, int]], rank: int = 0, world: int = 1,
                 rules: dict[str, str] | None = None):
        self.axes = list(axes)
        if math.prod(s for _, s in self.axes) != world:
            raise ValueError(f"mesh {self.axes} does not hold {world} ranks")
        self.rank, self.world = rank, world
        self.names = [n for n, _ in self.axes]
        self.shape = dict(self.axes)
        self.coords = dict(zip(self.names, _unravel(rank, [s for _, s in self.axes])))
        self.rules = dict(rules or {})
        self.tp_axis = tensor_axis(self.axes, self.rules)
        self.replicas = world // self.size(self.tp_axis)
        self.replica_group = None
        self._groups: dict[str, object] = {}
        self._ranks: dict[str, list[int]] = {}
        if world == 1:
            return
        import torch.distributed as dist  # noqa: PLC0415

        backend = dist.get_backend()
        sizes = [s for _, s in self.axes]
        for axis, (name, size) in enumerate(self.axes):
            if size == 1:
                continue
            # every slice along this axis, in one order on every rank
            for ranks in _slices(sizes, axis):
                group = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    self._groups[name], self._ranks[name] = group, ranks
            if dist.get_backend(self._groups[name]) != backend:
                raise RuntimeError(f"the {name!r} process group runs "
                                   f"{dist.get_backend(self._groups[name])}, not {backend}")
        if self.tp_axis is not None and self.replicas > 1:
            tp = self.names.index(self.tp_axis)
            for j in range(sizes[tp]):
                ranks = [r for r in range(world) if _unravel(r, sizes)[tp] == j]
                group = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    self.replica_group = group

    def size(self, name: str | None) -> int:
        return self.shape.get(name, 1) if name else 1

    def index(self, name: str | None) -> int:
        return self.coords.get(name, 0) if name else 0

    def group(self, name: str):
        return self._groups.get(name)

    def ranks(self, name: str) -> list[int] | None:
        return self._ranks.get(name)

    @property
    def model_group(self):
        """The process group of this rank's slice along ``tp_axis`` (None
        without one)."""
        return self._groups.get(self.tp_axis) if self.tp_axis else None

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
    (``check_layout``), with this rank's process groups and its
    tensor-parallel axis (``tensor_axis``)."""
    axes = resize_axes(parse_mesh_shape(mesh_shape), world)
    rules = parse_layout(layout)
    if world > 1:
        check_layout(axes, rules, attention_type)
    return Mesh(axes, rank, world, rules)
