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
``total_seq_dim`` axis, tensor parallelism over one axis that carries any
of ``heads_dim``, ``intermediate_expanded`` and ``vocab_dim`` (the Megatron
split: parallel/tensor.py) or the VAE's ``tokens_dim`` and ``vae_hid_dim``
(its codebook's columns and rows) and conv dims (``conv_cout``,
``conv_cin``, ``conv_kh``, ``conv_kw``: models/vae.py), pipeline
parallelism over one axis that carries ``layers`` alone
(the GPipe schedule: parallel/pipeline.py), and axes that carry no layout
dim at all: such an axis only replicates, as under GSPMD. Its ranks read
the same rows, draw the same noise and hold the same values, so nothing is
summed over it. Data, sequence and tensor parallelism compose in one step
(``data:2,seq:2,model:2``): the ring runs over a rank's block of the heads,
the gradients are summed over the batch and sequence axes, and the ranks of
a model group hold one loss. Pipeline and tensor parallelism compose too
(``data:2,pipe:2,model:2``, "PP x TP"): a stacked leaf then carries two
splits, its stage's layers over the pipe axis and its block over the model
axis. ``check_layout`` refuses the rest at world size > 1, and a layout
under which one leaf would carry a mesh axis twice (two conv dims,
``vae_hid_dim`` beside ``tokens_dim``, or ``layers`` beside ``heads_dim``
or ``intermediate_expanded``, on one axis: JAX's ``PartitionSpec`` raises
``DuplicateSpecError`` there).
``leaf_split`` says which dim of a parameter the tensor-parallel axis splits
and where this rank's block lies.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Sequence

import numpy as np

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
# the VAE's (dalle_mtf_tpu/models/vae.py): the codebook is (HID, TOKENS)
TOKENS = "tokens_dim"
VAE_HID = "vae_hid_dim"
CONV_DIMS = ("conv_kh", "conv_kw", "conv_cin", "conv_cout")
# the logical dims a tensor-parallel axis may carry
TENSOR_DIMS = (HEADS, INTERMEDIATE, VOCAB, TOKENS, VAE_HID, *CONV_DIMS)
# the dims that lie on one leaf (a conv kernel, the codebook, a stacked
# attention or MLP weight): a mesh axis may split at most one of each group
LEAF_DIMS = (CONV_DIMS, (VAE_HID, TOKENS), (LAYERS, HEADS), (LAYERS, INTERMEDIATE))
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
    """The mesh axis of size > 1 that a rule on one of ``TENSOR_DIMS``
    names (the first such), or None."""
    for name, size in axes:
        if size > 1 and any(rules.get(d) == name for d in TENSOR_DIMS):
            return name
    return None


def pipe_axis(axes: Sequence[tuple[str, int]], rules: dict[str, str]) -> str | None:
    """The mesh axis of size > 1 that the layout's ``layers`` rule names, or
    None."""
    axis = rules.get(LAYERS)
    return axis if axis and dict(axes).get(axis, 1) > 1 else None


def refuse_layers(axes: Sequence[tuple[str, int]], rules: dict[str, str], what: str,
                  item: str | None = None) -> None:
    """Raise NotImplementedError where a ``layers`` rule names an axis of
    size > 1 for ``what``, a path that does not run a pipeline (ROADMAP
    queue 1 ``item``, where one would port it)."""
    axis = pipe_axis(axes, rules)
    if axis is not None:
        where = f"; ROADMAP queue 1 item {item}" if item else ""
        raise NotImplementedError(
            f"not ported to dalle_mtf_tpu_torch yet: {what} on a 'layers' layout rule "
            f"(pipeline parallelism over mesh axis {axis!r} of size {dict(axes)[axis]}"
            f"{where})")


def data_axes(rules: dict[str, str], attention_type: str = "global") -> tuple[str, ...]:
    """The axes whose ranks hold different data: the batch axis and, under
    ring attention, the sequence axis. Losses, gradients and metrics are
    shares summed over these axes only."""
    batch = rules.get(BATCH) or "data"
    if attention_type in ("ring", "local_ring"):
        return (batch, rules.get(SEQ) or "seq")
    return (batch,)


# what check_layout says of a dim it refuses, with the ROADMAP item that
# would port it
_REFUSED = {SEQ: "sequence parallelism without ring attention"}


def duplicate_axes(axes: Sequence[tuple[str, int]], rules: dict[str, str]) -> list[str]:
    """What would put one mesh axis on two dims of a leaf: for each group of
    ``LEAF_DIMS`` and each axis of ``axes`` that two or more of its dims
    name, a description naming them. JAX refuses such a layout whatever the
    axis's size (``PartitionSpec`` raises ``DuplicateSpecError``)."""
    out = []
    for group in LEAF_DIMS:
        for name, _size in axes:
            dims = [d for d in group if rules.get(d) == name]
            if len(dims) > 1:
                out.append(f"mesh axis {name!r} on {' and '.join(dims)} (one leaf would carry "
                           f"the axis twice)")
    return out


def check_layout(axes: Sequence[tuple[str, int]], rules: dict[str, str],
                 attention_type: str = "global") -> None:
    """Raise NotImplementedError for a layout the port cannot honour on
    these (resized) axes. Every axis of size > 1 must carry the batch
    (``batch_dim``), under ring attention the sequence (``total_seq_dim``),
    tensor parallelism (a non-empty set of ``TENSOR_DIMS`` and nothing
    else, on one axis only), the layer stack (``layers`` and nothing else:
    pipeline parallelism), or no layout dim at all (an axis that only
    replicates). A tensor-parallel axis may sit beside the ring's sequence
    axis ("TP x SP") or beside the pipe axis ("PP x TP"). Refused: one axis
    on two dims of a leaf (``duplicate_axes``, on an axis of any size, as
    JAX refuses it: ``layers`` beside ``heads_dim`` or
    ``intermediate_expanded`` among them), ``layers`` beside ``vocab_dim``
    alone on one axis (JAX runs it; ROADMAP queue 1 item 5c-vi), ``layers``
    beside another dim on its axis, and pipeline parallelism under ring
    attention ("PP x SP", item 5c-iii)."""
    batch_axis = rules.get(BATCH) or "data"
    seq_axis = rules.get(SEQ) or "seq"
    ring = attention_type in ("ring", "local_ring")
    refused, tensor, pipe = duplicate_axes(axes, rules), [], []
    for name, size in axes:
        if size == 1:
            continue
        dims = sorted(d for d, a in rules.items() if a == name)
        if LAYERS in dims and len(dims) > 1:
            others = set(dims) - {LAYERS}
            if others == {VOCAB}:
                refused.append(f"mesh axis {name!r} of size {size} on layers and vocab_dim (PP "
                               f"x TP over one axis: each stage's head rows would meet a "
                               f"vocabulary split over its own pipeline's ranks; ROADMAP queue "
                               f"1 item 5c-vi)")
            else:  # beside heads_dim or intermediate_expanded, duplicate_axes names them too
                refused.append(f"mesh axis {name!r} of size {size} (pipeline parallelism with "
                               f"another layout dim on its axis; layout dims {dims})")
            continue
        if dims == [LAYERS]:
            pipe.append(name)
            continue
        if name == batch_axis or (ring and name == seq_axis) or not dims:
            continue  # data, sequence, or replicates: its ranks compute the same values
        if set(dims) <= set(TENSOR_DIMS):
            tensor.append(name)
            continue
        kinds = sorted({_REFUSED.get(d, f"an unknown layout dim {d!r}") for d in dims
                        if d not in TENSOR_DIMS})
        refused.append(f"mesh axis {name!r} of size {size} ({'; '.join(kinds)}; layout dims "
                       f"{dims})")
    if len(tensor) > 1:
        refused.append(f"tensor parallelism over more than one mesh axis {tensor}")
    if pipe and ring:
        refused.append(f"PP x SP: not ported (pipeline parallelism over {pipe[0]!r} with "
                       f"attention_type {attention_type!r}; ROADMAP queue 1 item 5c-iii)")
    if refused:
        raise NotImplementedError(
            "not ported to dalle_mtf_tpu_torch yet: " + "; ".join(refused)
            + ": the port shards the batch (batch_dim), under ring attention the "
            "sequence (total_seq_dim), the heads, the MLP width and the vocabulary "
            "(heads_dim, intermediate_expanded, vocab_dim) or the VAE's codebook and conv "
            "kernels (tokens_dim, vae_hid_dim, conv_cout, conv_cin, conv_kh, conv_kw; one of "
            "them a leaf) over one axis, or the layer stack (layers) over one axis beside "
            "the batch and the tensor-parallel axis, and replicates over an axis no rule "
            "names")


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
    not divide is replicated with a warning (the JAX package's
    ``shard_params`` replicates it too). A leaf two of whose dims the axis
    would split raises ValueError (``check_layout`` refuses such a layout
    before a group is joined)."""
    axis = mesh.tp_axis if mesh is not None else None
    if axis is None:
        return None
    m = mesh.size(axis)
    dims = [(dim, logical, size) for dim, (logical, size) in enumerate(zip(logical_axes, shape))
            if logical in TENSOR_DIMS and mesh.rules.get(logical) == axis]
    if len(dims) > 1:
        raise ValueError(f"{name or 'leaf'}: mesh axis {axis!r} would split "
                         f"{' and '.join(d[1] for d in dims)} of one leaf")
    for dim, logical, size in dims:
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
    splits the model. ``pipe_axis`` (the axis its ``layers`` rule names,
    ``pipe_axis``; None where there is none) splits the layer stack into
    ``stages`` stages: this rank runs stage ``stage``, and ``pipe_group`` and
    ``pipe_ranks`` are its pipeline's ranks in stage order. The ranks that
    differ from this one only on the data axes (``data_axes``: the batch
    axis and, under ring attention, the sequence axis) hold different data of
    the same model, and gradients are summed over them: ``replica_group``
    (None for the whole world), ``replicas`` of them. Under pipeline
    parallelism the stages of one pipeline also hold parts of the replicated
    leaves' gradients (the embedding on the first stage, the loss head on
    each stage's rows) and of the metrics: those are summed over the data
    axes and the pipe axis, ``share_group`` (None for the whole world),
    ``shares`` ranks; without a pipe axis ``share_group`` is
    ``replica_group``. The ranks that differ from this one only on the
    other axes (a tensor-parallel axis, an axis that only replicates) hold
    copies of the replicated leaves, and are never summed over:
    ``copy_group`` and ``copy_ranks`` (None where this rank holds the only
    copy), ``copies`` of them; with a ``tp_axis``, ``block_copy_group`` and
    ``block_copy_ranks`` the same without it, the copies of this rank's
    blocks of the split leaves (with a ``pipe_axis`` alone, the copies of its
    stage's layers: ``copy_group`` itself). The trainer makes each set of
    copies one (``Trainer._agree``). Under ring attention beside a
    ``tp_axis`` (``data:1,seq:2,model:2``) the sequence axis is a data axis:
    the copies of a replicated leaf are this rank's model group, and a block
    of a split leaf has no copy (``block_copy_group`` None). With a
    ``pipe_axis`` beside a ``tp_axis`` (``data:2,pipe:2,model:2``) a rank
    holds its stage's block of each stacked split leaf: ``pipe_group`` is
    its pipeline (the ranks of its model index on every stage),
    ``model_group`` its stage's model group, ``share_group`` the ranks of
    its model index over the data and pipe axes, ``copy_group`` its model
    group (the copies of the replicated leaves and of its stage's
    unsplit layers), and ``block_copy_group`` the ranks that differ from it
    only on an axis that only replicates. ``plane`` gives the ranks of
    rank 0's slice over some axes (the checkpoint's writers).
    """

    def __init__(self, axes: Sequence[tuple[str, int]], rank: int = 0, world: int = 1,
                 rules: dict[str, str] | None = None, attention_type: str = "global"):
        self.axes = list(axes)
        if math.prod(s for _, s in self.axes) != world:
            raise ValueError(f"mesh {self.axes} does not hold {world} ranks")
        self.rank, self.world = rank, world
        self.names = [n for n, _ in self.axes]
        self.shape = dict(self.axes)
        self.coords = dict(zip(self.names, _unravel(rank, [s for _, s in self.axes])))
        self.rules = dict(rules or {})
        self.tp_axis = tensor_axis(self.axes, self.rules)
        self.pipe_axis = pipe_axis(self.axes, self.rules)
        self.stage, self.stages = self.index(self.pipe_axis), self.size(self.pipe_axis)
        summed = [n for n in data_axes(self.rules, attention_type) if n in self.shape]
        shared = summed + ([self.pipe_axis] if self.pipe_axis else [])
        self.replicas = math.prod(self.size(n) for n in summed)
        self.shares = self.replicas * self.stages
        copied = [n for n in self.names if n not in shared and self.size(n) > 1]
        self.copies = math.prod(self.size(n) for n in copied)
        self.replica_group = self.share_group = self.copy_group = self.block_copy_group = None
        self.copy_ranks = self.block_copy_ranks = None
        self.pipe_group = self.pipe_ranks = None
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
        self.replica_group, _ = self._group_over(summed, backend)
        self.share_group = self.replica_group
        if self.pipe_axis:
            self.pipe_group, self.pipe_ranks = self.group(self.pipe_axis), self.ranks(
                self.pipe_axis)
            self.share_group, _ = self._group_over(shared, backend)
        self.copy_group, self.copy_ranks = self._group_over(copied, backend)
        if self.tp_axis:
            self.block_copy_group, self.block_copy_ranks = self._group_over(
                [n for n in copied if n != self.tp_axis], backend)
        elif self.pipe_axis:
            self.block_copy_group, self.block_copy_ranks = self.copy_group, self.copy_ranks

    def _group_over(self, names, backend) -> tuple[object, list[int] | None]:
        """(process group, global ranks in order) of the ranks that differ
        from this one only on the axes ``names``: (None, None) where that is
        this rank alone, (None, every rank) where it is the world. Every rank
        makes every such group, in one order (``new_group`` is collective)."""
        import torch.distributed as dist  # noqa: PLC0415

        n = math.prod(self.size(a) for a in names)
        if n == 1:
            return None, None
        if n == self.world:
            return None, list(range(self.world))
        wide = [a for a in names if self.size(a) > 1]
        if len(wide) == 1:  # one axis: its slice's group
            return self._groups[wide[0]], self._ranks[wide[0]]
        sizes = [s for _, s in self.axes]
        fixed = [i for i, a in enumerate(self.names) if a not in names]
        mine = None, None
        for key in sorted({tuple(_unravel(r, sizes)[i] for i in fixed)
                           for r in range(self.world)}):
            ranks = [r for r in range(self.world)
                     if tuple(_unravel(r, sizes)[i] for i in fixed) == key]
            group = dist.new_group(ranks, backend=backend)
            if self.rank in ranks:
                mine = group, ranks
        return mine

    def plane(self, names: Sequence[str]) -> list:
        """The global ranks whose index is 0 on every axis but ``names``, as
        nested lists indexed by their indices on ``names`` in that order
        (rank 0's slice over those axes)."""
        sizes = [s for _, s in self.axes]
        grid = np.zeros([self.size(n) for n in names], dtype=np.int64)
        for idx in np.ndindex(grid.shape):
            at = dict(zip(names, idx))
            grid[idx] = _ravel([at.get(n, 0) for n in self.names], sizes)
        return grid.tolist()

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


def _ravel(coords: list[int], shape: list[int]) -> int:
    rank = 0
    for c, size in zip(coords, shape):
        rank = rank * size + c
    return rank


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
    (``check_layout``), with this rank's process groups, its
    tensor-parallel axis (``tensor_axis``) and its pipe axis
    (``pipe_axis``)."""
    axes = resize_axes(parse_mesh_shape(mesh_shape), world)
    rules = parse_layout(layout)
    if world > 1:
        check_layout(axes, rules, attention_type)
    return Mesh(axes, rank, world, rules, attention_type)
