"""DALL-E decoder-only transformer over [text ; image] tokens: the serving
and training halves of ``dalle_mtf_tpu/models/dalle.py``, in PyTorch.

Parameters are a plain nested dict of tensors with the JAX tree's names and
shapes (stacked on a leading [n_layers] axis: ``layers.wq [L,E,H,D]``,
``layers.wo [L,H,D,E]``, ``w_out [E,V]``), so weights cross between the two
packages as a plain mapping (utils/convert.py). Transposes and reshapes
happen only inside the ops.

Unlike the JAX package, whose KV cache is a functional pytree updated with
dynamic_update_slice, ``prefill``/``decode_step`` write the cache IN PLACE.

Serving weights may be quantized (quantize.py: int8, or split-half packed
int4, with ``<name>_scale`` leaves). The weight access dequantizes them as
the JAX model does: at decode geometry (``decode_kernels`` on, at most 32
rows, K a multiple of 256) through the streaming kernels of
ops/decode_matmul.py, else in the compute dtype before a plain matmul.

Training (``hidden``/``forward``/``loss``) runs through autograd,
with the packed attention (ops/attention_packed.py) by default or, with
``attn_packed: false``, the [B, H, S, D] attention (ops/attention.py), and
with ``ln_impl: "pallas"`` the fused LayerNorm kernels (ops/layer_norm.py).
``loss(fused_xent=True)`` and ``fused_eval`` stream the loss head over row
chunks (ops/xent_fused.py), so the [B, S, vocab] logits never exist.

Across processes (a ``parallel.mesh.Mesh``), each rank holds its rows of the
batch (data parallelism over the ``batch_dim`` axis) and, under
``attention_type`` "ring"/"local_ring", its shard of the sequence (sequence
parallelism over the ``total_seq_dim`` axis): ``hidden``, ``forward`` and
``loss`` take the rank's rows of the whole sequence and compute on its shard,
attention runs around the ring (ops/ring_attention.py), and the loss is the
rank's share of the global mean, so that the sum over the ranks of the losses
and of the gradients is the single-process value.

On a mesh with a tensor-parallel axis (the layout's ``heads_dim``,
``intermediate_expanded`` and ``vocab_dim`` rules, parallel/tensor.py) each
rank of a model group holds its block of the split leaves (``sharding``;
``param_shapes``/``init`` give the blocks): q/k/v and the attention over its
heads, the MLP over its columns, joined by ``copy_to_model`` and
``reduce_from_model``; the embedding and both loss heads over its block of
the vocabulary. The ranks of a group hold the same loss, and the trainer
sums over the other axes only (``Mesh.replica_group``). Under ring
attention the tensor-parallel axis composes with the sequence axis
(``data:1,seq:2,model:2``): each rank runs the ring on its heads over its
shard of the sequence, embeds and scores its shard's positions over its
block of the vocabulary, and the trainer sums over the batch and sequence
axes. Every dropout draws
the single process's mask: the residual and embedding masks from the
generator every rank shares, the attention hash with the rank's heads at
their single-process program index (``head0``, ``heads_total``), and both at
the rows' global index. The KV-cache
path runs on the same blocks: a rank's cache holds its heads, and the head's
banded logits are joined over the group (``_head_logits``), so every rank of
a group samples the same tokens from the same logits.

On a mesh with a pipe axis (a ``layers`` rule, parallel/pipeline.py) each
rank holds its stage's ``L/P`` layers of every stacked leaf (``sharding``
splits them on the layer dim) and the whole of the others. ``hidden`` runs
the GPipe schedule: the first stage embeds, the stages run their layers on
``pipeline_microbatches`` contiguous microbatches (default: the pipe size),
and the last stage's output rows are split over the stages, so that each
stage runs the final LN and the loss head on its own rows (JAX
``_shard_head_rows``); ``forward``, ``loss``, ``dense_eval`` and
``fused_eval`` return those rows' values, and ``global_mean`` is the rank's
share of the global mean, which the trainer sums over the data and pipe
axes (``Mesh.share_group``). Every rank draws the embedding's and all ``L``
blocks' dropout seeds in order and uses its stage's, each at its
microbatch's global rows, so a pipelined pass draws the single process's
masks (JAX folds each layer's key with the microbatch id, so its pipelined
dropout differs from its own sequential run). The KV-cache path does not
run on a pipe mesh.

Beside a tensor-parallel axis (PP x TP, ``data:2,pipe:2,model:2``) both
compose: ``sharding`` splits a stacked leaf twice (its stage's layers over
the pipe group, outermost, and its block over the model group:
``Sharding.placed``), each rank runs its stage's layers on its heads and
MLP columns with the collectives over its stage's model group, its hops
carry its whole ``[b/M, S, E]`` microbatch to the rank of its model index
on the next stage, and each stage's head rows run the vocab-parallel head
over the model group. The attention dropout hash sees the microbatch's
global rows and the rank's heads (``head0``, ``heads_total``), so every
mask is the single process's.

Remat (``recompute_grad`` in training): each block is one
``torch.utils.checkpoint`` region, as each step of the JAX layer scan is one
``jax.checkpoint``, under a selective-checkpoint policy with the JAX
policy's choice of what to keep (``REMAT_POLICIES``):

- ``nothing_saveable`` keeps nothing; ``dots_saveable`` (``checkpoint_dots``)
  keeps every matmul output, ``dots_with_no_batch_dims_saveable``
  (``checkpoint_dots_with_no_batch_dims``) those without batch dims (mm, not
  bmm); the attention kernel is no matmul to them, so it re-runs in the
  backward, as the JAX kernel does inside a pallas_call;
- ``dots_except_mlp1``, ``save_attn`` and ``save_attn_lean`` keep the
  outputs JAX names with ``checkpoint_name``: ``qkv``, ``attn_proj`` and
  ``mlp2`` (the matmuls run inside ``checkpoint_name``) and ``attn_out`` /
  ``attn_lse`` (the attention forward's dispatcher op, whose two outputs
  are kept together, so the kernel does not re-run);
- ``dots_and_attn`` (the dalle_coco configs') and ``everything_saveable``
  keep what plain autograd keeps, a superset with the same values, so they
  run with no checkpoint.

Torch keeps every output a policy names, also one the backward never reads
(attn_proj, mlp2), where JAX keeps only the named residuals its backward
reads. A block's dropout seeds are drawn before the region runs, so a
recompute draws the same masks and leaves the generator where one pass
leaves it. Policies that take arguments raise ValueError.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import logging
import math
from typing import Any, Mapping, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from dalle_mtf_tpu_torch.ops.attention import (
    attention_reference,
    causal_attention,
    decode_attention,
    kernel_takes_head_dim,
)
from dalle_mtf_tpu_torch.ops.attention_packed import attention_packed_reference, packed_attention
from dalle_mtf_tpu_torch.ops.decode_matmul import int4_matmul, int8_matmul
from dalle_mtf_tpu_torch.ops.layer_norm import kernel_takes, layer_norm, layer_norm_reference
from dalle_mtf_tpu_torch.ops.losses import (
    softmax_cross_entropy_with_logits,
    vocab_parallel_cross_entropy,
)
from dalle_mtf_tpu_torch.ops.ring_attention import ring_attention_auto
from dalle_mtf_tpu_torch.ops.xent_fused import (
    chunked_softmax_xent_auto,
    chunked_xent_eval_auto,
    tp_chunk_loss,
    tp_correct,
)
from dalle_mtf_tpu_torch.parallel.mesh import (
    BATCH,
    EMBED,
    EMBED_SEQ,
    HEADS,
    INTERMEDIATE,
    KV,
    LAYERS,
    SEQ,
    VOCAB,
    VOCAB_LANES,
    Split,
    leaf_split,
    parse_layout,
)
from dalle_mtf_tpu_torch.parallel.pipeline import (
    Pipe,
    head_bounds,
    microbatch_rows,
    pipeline_apply,
    stage_layers,
)
from dalle_mtf_tpu_torch.parallel.tensor import (
    Sharding,
    all_reduce,
    copy_to_model,
    reduce_from_model,
    vocab_parallel_embedding,
)
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.quantize import nibble_views, quantized_shapes
from dalle_mtf_tpu_torch.utils.distributed import model_device
from dalle_mtf_tpu_torch.utils.precision import Policy, get_policy
from dalle_mtf_tpu_torch.utils.seeds import base_seed, key_seed, units

# the units of the init's keyed draws (utils/seeds.py), by the logical dim a
# tensor-parallel axis may split: one head, 128 columns of the MLP's width,
# 128 rows of the vocabulary (a vocabulary block is a multiple of 128 rows)
INIT_UNITS = {HEADS: 1, INTERMEDIATE: 128, VOCAB: VOCAB_LANES}

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "swish": F.silu,
}


# what the named remat policies keep (JAX dalle.py:848-866)
_NAMED_SAVES = {
    "dots_except_mlp1": ("qkv", "attn_proj", "mlp2"),
    "save_attn": ("qkv", "attn_out", "attn_lse", "attn_proj", "mlp2"),
    "save_attn_lean": ("attn_out", "attn_lse", "mlp2"),
}
# policies under which plain autograd keeps what JAX keeps, or more
_NO_CHECKPOINT = ("dots_and_attn", "everything_saveable")
# every remat policy the model takes: the jax.checkpoint_policies that take
# no arguments and the named ones (see the module docstring)
REMAT_POLICIES = (
    *_NO_CHECKPOINT, "nothing_saveable", "dots_saveable", "checkpoint_dots",
    "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims", *_NAMED_SAVES,
)


@dataclasses.dataclass(frozen=True)
class DalleConfig:
    """The fields serving and training read
    (``dalle_mtf_tpu.models.dalle.DalleConfig``). A remat policy that takes
    arguments raises ValueError here. The ring's batch, sequence and heads
    axes and the pipe axis (``layers``) are read from the layout as in JAX;
    the tensor-parallel split and the pipeline come from the mesh's own
    rules (``DALLE.sharding``, ``Mesh.pipe_axis``); under ring attention a
    tensor-parallel rank runs the ring on its block of the heads
    (``ring_heads_axis`` names that axis, as in JAX; the block itself is
    ``DALLE.heads``). A layout the port cannot honour on more than one
    process (pipeline parallelism under ring attention, ``layers`` on the
    axis of a tensor-parallel dim) raises when the mesh is built
    (``parallel.mesh.check_layout``). ``scan_unroll`` (no torch meaning) is
    accepted and ignored."""

    n_embd: int
    text_vocab_size: int = 12800
    image_vocab_size: int = 512
    text_seq_len: int = 256
    image_seq_len: int = 1024
    n_layers: int = 6
    n_heads: int = 8
    bf_16: bool = False
    attention_type: str = "global"  # | "local" | "ring" | "local_ring"
    local_attention_radius: int = 256
    # mesh axes of ring attention, from the layout rules (total_seq_dim,
    # batch_dim, heads_dim), as in JAX
    ring_seq_axis: str = "seq"
    ring_batch_axis: str | None = "data"
    ring_heads_axis: str | None = None
    # the pipe axis (the ``layers`` rule) and the pipeline's microbatches
    # (None: the pipe axis's size), as in JAX
    pipe_axis: str | None = None
    pipeline_microbatches: int | None = None
    scale_type: str = "scale_by_depth"
    activation: str = "relu"
    ln_dtype: str = "float32"  # | "activation"; not read under ln_impl "pallas"
    ln_impl: str = "xla"  # | "pallas": the fused LN kernels, fp32 inside
    recompute_grad: bool = False
    remat_policy: str = "dots_saveable"
    attn_packed: bool = True
    # fused-xent row chunks (ops/xent_fused.py)
    xent_chunks: int = 8
    embed_dropout: float = 0.0
    attention_dropout: float = 0.0
    residual_dropout: float = 0.0
    eos_token_id: int | None = None
    # quantized decode matmuls through the streaming kernels (off by default,
    # as in the JAX package)
    decode_kernels: bool = False

    def __post_init__(self):
        if self.ln_impl not in ("xla", "pallas"):
            raise ValueError(f"ln_impl must be 'xla' or 'pallas', got {self.ln_impl!r}")
        if self.recompute_grad and self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy {self.remat_policy!r} is not a policy that takes no "
                f"arguments: use one of {', '.join(REMAT_POLICIES)}")

    @classmethod
    def from_params(
        cls, params: Mapping[str, Any], image_seq_len: int
    ) -> "DalleConfig":
        rules = parse_layout(params.get("layout"))
        return cls(
            ring_seq_axis=rules.get(SEQ) or "seq",
            ring_batch_axis=rules.get(BATCH) or "data",
            ring_heads_axis=rules.get(HEADS),
            pipe_axis=rules.get(LAYERS),
            pipeline_microbatches=params.get("pipeline_microbatches"),
            n_embd=params["n_embd"],
            text_vocab_size=params["text_vocab_size"],
            image_vocab_size=params["image_vocab_size"],
            text_seq_len=params["text_seq_len"],
            image_seq_len=image_seq_len,
            n_layers=params["n_layers"],
            n_heads=params["n_heads"],
            bf_16=bool(params.get("bf_16")),
            attention_type=params.get("attention_type") or "global",
            local_attention_radius=params.get("local_attention_radius") or 256,
            scale_type=params.get("scale_type") or "scale_by_depth",
            activation=params.get("activation") or "relu",
            ln_dtype=params.get("ln_dtype") or "float32",
            ln_impl=params.get("ln_impl") or "xla",
            recompute_grad=bool(params.get("recompute_grad")),
            remat_policy=params.get("remat_policy") or "dots_saveable",
            attn_packed=bool(params.get("attn_packed", True)),
            xent_chunks=int(params.get("xent_chunks") or 8),
            embed_dropout=params.get("embed_dropout") or 0.0,
            attention_dropout=params.get("attention_dropout") or 0.0,
            residual_dropout=params.get("residual_dropout") or 0.0,
            eos_token_id=params.get("eos_token_id"),
            decode_kernels=bool(params.get("decode_kernels", False)),
        )

    @property
    def total_tokens(self) -> int:
        # text + image vocab + 1 EOS (reference models.py:157-158)
        return self.text_vocab_size + self.image_vocab_size + 1

    @property
    def eos(self) -> int:
        return self.total_tokens - 1 if self.eos_token_id is None else self.eos_token_id

    @property
    def total_seq_len(self) -> int:
        return self.text_seq_len + self.image_seq_len

    @property
    def head_dim(self) -> int:
        assert self.n_embd % self.n_heads == 0, "n_embd must divide n_heads"
        return self.n_embd // self.n_heads

    @property
    def policy(self) -> Policy:
        return get_policy(self.bf_16)


_CHECKPOINT_NAME = contextvars.ContextVar("checkpoint_name", default=None)
_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm, torch.ops.aten.baddbmm)
_NO_BATCH_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm)
# the attention forwards as dispatcher ops (ops/attention*.py): their two
# outputs are JAX's ``attn_out`` and ``attn_lse``
_ATTENTION_FORWARDS = (torch.ops.dalle_mtf_tpu_torch.packed_attention_fwd,
                       torch.ops.dalle_mtf_tpu_torch.causal_attention_fwd)


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Name the matmuls run inside, as JAX's ``checkpoint_name`` names their
    output, for the named remat policies."""
    token = _CHECKPOINT_NAME.set(name)
    try:
        yield
    finally:
        _CHECKPOINT_NAME.reset(token)


def remat_context(policy: str):
    """``context_fn`` for ``torch.utils.checkpoint`` under ``policy`` (one of
    ``REMAT_POLICIES`` that checkpoints): keep an op's outputs where the JAX
    policy keeps them, recompute the rest."""
    from torch.utils.checkpoint import (  # noqa: PLC0415
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )

    if policy in _NAMED_SAVES:
        names = _NAMED_SAVES[policy]
        attention = _ATTENTION_FORWARDS if "attn_out" in names else ()

        def keep(op):
            return op in attention or (op in _DOTS and _CHECKPOINT_NAME.get() in names)
    elif policy == "nothing_saveable":
        def keep(op):
            return False
    elif policy in ("dots_saveable", "checkpoint_dots"):
        def keep(op):
            return op in _DOTS
    else:  # dots_with_no_batch_dims_saveable, checkpoint_dots_with_no_batch_dims
        def keep(op):
            return op in _NO_BATCH_DOTS

    def policy_fn(_ctx, func, *_args, **_kwargs):
        return (CheckpointPolicy.MUST_SAVE if keep(func.overloadpacket)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


class Head(NamedTuple):
    """The output projection's columns one generation reads, built once by
    ``DALLE.logits_head``: ``w`` fp32 [E, n] (unquantized), or contiguous
    int8 [E, n] / packed int4 [E/2, n] with ``scale`` fp32 [1, n]; ``b`` fp32
    [n]. On a mesh that splits the vocabulary the n columns are this rank's
    part of the head's span of ``width`` columns, starting at ``col0`` in it
    (n may be 0); else ``col0`` is 0 and n the whole span."""

    w: torch.Tensor
    scale: torch.Tensor | None
    b: torch.Tensor
    int4: bool
    col0: int = 0
    width: int = 0


class DALLE(nn.Module):
    """The model's computation over an explicit parameter tree.

    The module holds the config, the device and the mesh (None: one
    process); the parameters are the nested dict ``init`` returns (or
    ``utils.convert`` loads), passed to every method, as in the JAX package.
    On a tensor-parallel or a pipe mesh, or both, ``sharding`` (a
    ``parallel.tensor.Sharding``, else None) says which dims of each leaf are
    split and where this rank's block lies; ``heads`` is (this rank's first
    head, its head count). On a pipe mesh ``pipe`` is this rank's place in
    its pipeline (a ``parallel.pipeline.Pipe``, else None) and ``layers``
    the [start, stop) of its stage's layers (else all of them); a layer
    count the pipe axis does not divide raises ValueError.
    """

    def __init__(self, config: DalleConfig, device: torch.device | str = "cuda", mesh=None):
        super().__init__()
        self.cfg = config
        self.device = model_device(device)
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.pipe = None
        self.layers = (0, config.n_layers)
        if self.mesh is not None and self.mesh.pipe_axis is not None:
            self.layers = stage_layers(config.n_layers, self.mesh.stages, self.mesh.stage)
            self.pipe = Pipe(self.mesh.pipe_group, self.mesh.pipe_ranks, self.mesh.stage)
        self.sharding = self._sharding()
        # the model group where a tensor-parallel axis splits a leaf
        self._tp = (self.sharding.group if self.sharding is not None
                    and self.sharding.axis == self.mesh.tp_axis else None)
        split = self._split(("layers", "wq"))
        self.heads = ((0, config.n_heads) if split is None
                      else (split.start, split.stop - split.start))
        if config.ln_impl == "pallas" and config.ln_dtype == "activation":
            logging.getLogger(__name__).warning(
                "ln_impl='pallas' always computes the normalize in fp32 "
                "internally; ln_dtype='activation' (the reference-exact bf16 "
                "norm semantics) is ignored on that path; set ln_impl='xla' "
                "if you need activation-dtype LN math.")

    # ------------------------------------------------------------------ init

    @staticmethod
    def logical_axes() -> dict:
        """Each leaf's logical dim names (``DALLE.logical_axes`` of the JAX
        package), what the layout rules map onto mesh axes."""
        return {
            "wte": (VOCAB, EMBED),
            "wpe": (EMBED_SEQ, EMBED),
            "layers": {
                "ln1_g": (LAYERS, EMBED), "ln1_b": (LAYERS, EMBED),
                "wq": (LAYERS, EMBED, HEADS, KV), "wk": (LAYERS, EMBED, HEADS, KV),
                "wv": (LAYERS, EMBED, HEADS, KV), "wo": (LAYERS, HEADS, KV, EMBED),
                "o_b": (LAYERS, EMBED),
                "ln2_g": (LAYERS, EMBED), "ln2_b": (LAYERS, EMBED),
                "w_mlp1": (LAYERS, EMBED, INTERMEDIATE), "b_mlp1": (LAYERS, INTERMEDIATE),
                "w_mlp2": (LAYERS, INTERMEDIATE, EMBED), "b_mlp2": (LAYERS, EMBED),
            },
            "lnf_g": (EMBED,), "lnf_b": (EMBED,),
            "w_out": (EMBED, VOCAB), "b_out": (VOCAB,),
        }

    def _sharding(self) -> Sharding | None:
        """The leaves' splits over the mesh's tensor-parallel axis, by the
        mesh's layout rules, and over its pipe axis, every stacked leaf on
        its layer dim (the pipe's ``Sharding`` outermost: ``pipe`` of the
        tensor-parallel one, where there are both; None without either)."""
        pipe = tp = None
        if self.pipe is not None:
            bounds = tuple(stage_layers(self.cfg.n_layers, self.pipe.n, j)
                           for j in range(self.pipe.n))
            pipe = Sharding({path: Split(0, bounds, self.pipe.stage) if path[0] == "layers"
                             else None
                             for path, _ in named_leaves(self.logical_axes())},
                            self.pipe.group, self.mesh.pipe_axis)
        if self.mesh is not None and self.mesh.tp_axis is not None:
            axes = dict(named_leaves(self.logical_axes()))
            splits = {path: leaf_split(axes[path], shape, self.mesh, "/".join(path))
                      for path, shape in named_leaves(self.param_shapes(whole=True))}
            if any(splits.values()):
                tp = Sharding(splits, self.mesh.model_group, self.mesh.tp_axis, pipe)
        return tp or pipe

    def _split(self, path):
        """The tensor-parallel split of the leaf at ``path`` (None where it is
        replicated, and without a tensor-parallel axis)."""
        return self.sharding.of(path) if self._tp is not None else None

    def param_shapes(self, quantize: str = "none", whole: bool = False) -> dict:
        """The parameter tree's shapes, keyed like the JAX tree: this rank's
        blocks on a tensor-parallel mesh, the whole leaves with ``whole`` (or
        without one); with ``quantize`` "int8" or "int4", the tree
        quantize.py makes (packed int4 axes halved, ``<name>_scale`` and int4
        marker leaves added)."""
        cfg = self.cfg
        e, h, d, L = cfg.n_embd, cfg.n_heads, cfg.head_dim, cfg.n_layers
        inter = 4 * e
        shapes = {
            "wte": (cfg.total_tokens, e),
            "wpe": (cfg.total_seq_len, e),
            "layers": {
                "ln1_g": (L, e), "ln1_b": (L, e),
                "wq": (L, e, h, d), "wk": (L, e, h, d), "wv": (L, e, h, d),
                "wo": (L, h, d, e), "o_b": (L, e),
                "ln2_g": (L, e), "ln2_b": (L, e),
                "w_mlp1": (L, e, inter), "b_mlp1": (L, inter),
                "w_mlp2": (L, inter, e), "b_mlp2": (L, e),
            },
            "lnf_g": (e,), "lnf_b": (e,),
            "w_out": (e, cfg.total_tokens), "b_out": (cfg.total_tokens,),
        }
        if not whole and self.sharding is not None:
            local = self.sharding.local_shape
            shapes = {k: ({n: local((k, n), s) for n, s in v.items()} if isinstance(v, dict)
                          else local((k,), v)) for k, v in shapes.items()}
        return shapes if quantize == "none" else quantized_shapes(shapes, quantize)

    def init(self, generator: torch.Generator) -> dict:
        """Random fp32 parameters with the JAX init's shapes and stddevs
        (dalle.py:358-407; the reference's linear() scaling, models.py:
        361-371), drawn on ``generator``'s device (a CPU generator gives the
        same weights on every device) and moved to ``self.device``.

        The draw does not depend on the layout: each random leaf is drawn
        layer by layer (a stacked ``[L, ...]`` leaf) and, along the dim a
        tensor-parallel axis may split (``INIT_UNITS``), unit by unit, each
        unit from a generator keyed on (a seed drawn from ``generator``, the
        leaf's path, the layer, the unit). A rank draws only the units of
        its blocks (on a pipe mesh, the layers of its stage), one at a time
        into its block on the device, so the whole tree is the single
        process's under any layout and a rank never holds more than its
        blocks and one unit. ``drawn_elements`` counts what this call
        drew."""
        cfg = self.cfg
        e = cfg.n_embd
        mlp1_std = logits_std = 0.02
        if cfg.scale_type == "scale_by_depth":
            mlp2_std = 0.02 / math.sqrt(cfg.n_layers)
        elif cfg.scale_type == "scale_by_in":
            mlp1_std = 0.02 / math.sqrt(e)
            mlp2_std = 0.02 / math.sqrt(4 * e)
            logits_std = 0.02 / math.sqrt(e)
        else:
            mlp2_std = 0.02
        std = {
            "wq": 0.02, "wk": 0.02, "wv": 0.02, "wo": 0.02,
            "w_mlp1": mlp1_std, "w_mlp2": mlp2_std,
            "wte": 0.02, "wpe": 0.01, "w_out": logits_std,
        }
        seed = base_seed(generator)
        unit_gen = torch.Generator(device=generator.device)
        axes = dict(named_leaves(self.logical_axes()))
        self.drawn_elements = 0

        def draw(key, shape, scale):
            unit_gen.manual_seed(key_seed(seed, *key))
            self.drawn_elements += math.prod(shape)
            return torch.randn(shape, generator=unit_gen, device=generator.device) * scale

        def make(path, whole):
            name = path[-1]
            placed = self.sharding.placed(path) if self.sharding else ()
            local = self.sharding.local_shape(path, whole) if placed else whole
            if name not in std:
                fill = torch.ones if name.endswith("_g") else torch.zeros
                return fill(local, device=self.device, dtype=torch.float32)
            out = torch.empty(local, device=self.device, dtype=torch.float32)
            logical = axes[path]
            stacked = logical[0] == LAYERS
            layer0, layer1, split = 0, whole[0], None
            for p in placed:
                if stacked and p.split.dim == 0:  # a stage's layers
                    layer0, layer1 = p.split.start, p.split.stop
                else:
                    split = p.split
            udim = next((i for i, a in enumerate(logical) if a in INIT_UNITS), None)
            if split is not None and split.dim != udim:
                raise AssertionError(f"{path}: split on dim {split.dim}, units on {udim}")
            lo, hi = (split.start, split.stop) if split else (0, 0 if udim is None else whole[udim])
            key = "/".join(path)
            for layer in range(layer0, layer1) if stacked else (None,):
                dst = out[layer - layer0] if stacked else out
                shape = whole[1:] if stacked else whole
                if udim is None:
                    dst.copy_(draw((key, layer, 0), shape, std[name]))
                    continue
                d = udim - stacked
                for j, a, b in units(lo, hi, whole[udim], INIT_UNITS[logical[udim]]):
                    unit = draw((key, layer, j), shape[:d] + (b - a,) + shape[d + 1:], std[name])
                    a0, b0 = max(a, lo), min(b, hi)
                    dst.narrow(d, a0 - lo, b0 - a0).copy_(unit.narrow(d, a0 - a, b0 - a0))
            return out

        shapes = self.param_shapes(whole=True)
        return {
            k: ({n: make((k, n), s) for n, s in v.items()} if isinstance(v, dict)
                else make((k,), v))
            for k, v in shapes.items()
        }

    # --------------------------------------------------------------- helpers

    @property
    def _window(self):
        return (
            self.cfg.local_attention_radius
            if self.cfg.attention_type in ("local", "local_ring")
            else None
        )

    def _layer_norm(self, x, g, b, eps=1e-5):
        # reference layer_norm (models.py:373-389): normalize then affine.
        # ln_impl "pallas": the fused kernels, fp32 inside (ops/layer_norm.py),
        # at the widths the JAX package takes its Pallas pair (kernel_takes);
        # elsewhere its plain forward under autograd, as JAX takes its XLA
        # reference there. ln_dtype "activation" runs the chain in x.dtype
        # like the reference's norm; "float32" upcasts around the normalize.
        if self.cfg.ln_impl == "pallas":
            if kernel_takes(x.shape[-1]):
                return layer_norm(x, g, b, eps)
            return layer_norm_reference(x, g, b, eps)
        ct = torch.float32 if self.cfg.ln_dtype == "float32" else x.dtype
        xc = x.to(ct)
        mean = xc.mean(dim=-1, keepdim=True)
        var = xc.var(dim=-1, keepdim=True, unbiased=False)
        out = (xc - mean) * torch.rsqrt(var + eps)
        out = out * g.to(ct) + b.to(ct)
        return out.to(x.dtype)

    def _w(self, p, name):
        """A layer weight in the compute dtype; int8 weights dequantize as
        ``w.to(dtype) * scale.to(dtype)`` (int4 never reaches here)."""
        dtype = self.cfg.policy.compute_dtype
        w = p[name].to(dtype)
        scale = p.get(name + "_scale")
        return w if scale is None else w * scale.to(dtype)

    def _streaming_eligible(self, m: int, k: int) -> bool:
        """Whether a quantized [m, k] product goes through the streaming
        dequant kernels: decode geometry and a K the kernels were sized for.
        The device does not enter: a CUDA tensor launches the kernel, a CPU
        tensor runs its plain version. A model split over a tensor-parallel
        axis keeps the dequant einsum forms, as the JAX CLIs turn
        ``decode_kernels`` off on a mesh of more than one device."""
        return (self.cfg.decode_kernels and self.sharding is None and m <= 32
                and k % 256 == 0)

    def _matmul_w(self, p, name, x, heads: int | None = None):
        """x [..., K] times layer weight ``name`` viewed as [K, N] -> [..., N]
        in the compute dtype (the JAX ``_einsum_w``). For int4 the packed
        contraction rows pair with halves of x: the two halves of K, or with
        ``heads`` (wo) the halves of each head's D."""
        dtype = self.cfg.policy.compute_dtype
        scale = p.get(name + "_scale")
        if scale is None:
            return x @ p[name].to(dtype).reshape(x.shape[-1], -1)
        lead, k = x.shape[:-1], x.shape[-1]
        m = math.prod(lead)
        w2, s2 = p[name].reshape(-1, scale.numel()), scale.reshape(1, -1)
        int4 = name + "_int4" in p
        if int4:
            if heads:
                xh = x.reshape(*lead, heads, -1)
                half = xh.shape[-1] // 2
                x_lo = xh[..., :half].reshape(*lead, -1)
                x_hi = xh[..., half:].reshape(*lead, -1)
            else:
                x_lo, x_hi = x[..., : k // 2], x[..., k // 2:]
        if self._streaming_eligible(m, k):
            def rows(t):
                return t.reshape(m, -1).to(torch.bfloat16).contiguous()

            out = (int4_matmul(rows(x_lo), rows(x_hi), w2, s2) if int4
                   else int8_matmul(rows(x), w2, s2))
            return out.to(dtype).reshape(*lead, -1)
        if not int4:
            return x @ self._w(p, name).reshape(k, -1)
        lo, hi = nibble_views(w2)
        sc = s2.to(dtype)
        return x_lo @ (lo.to(dtype) * sc) + x_hi @ (hi.to(dtype) * sc)

    def _qkv(self, p, a_in):
        """[B, S, E] -> contiguous q, k, v [B, H, S, D] (H this rank's
        heads)."""
        b, s, _ = a_in.shape
        h, d = self.heads[1], self.cfg.head_dim
        a_in = copy_to_model(a_in, self._heads_group)

        def proj(name):
            y = self._matmul_w(p, name, a_in)
            return y.reshape(b, s, h, d).transpose(1, 2).contiguous()

        return proj("wq"), proj("wk"), proj("wv")

    def _attn_out(self, p, a):
        """[B, H, S, D] -> [B, S, E] (the bhsd,hde->bse einsum) + o_b."""
        b, h, s, d = a.shape
        y = self._matmul_w(p, "wo", a.transpose(1, 2).reshape(b, s, h * d), heads=h)
        return reduce_from_model(y, self._heads_group) + p["o_b"].to(y.dtype)

    def _mlp(self, p, m_in):
        """The MLP; on a tensor-parallel mesh over this rank's columns of
        the intermediate width, b_mlp2 added once after the sum."""
        dtype = self.cfg.policy.compute_dtype
        act = _ACTIVATIONS[self.cfg.activation]
        group = self._tp if self._split(("layers", "w_mlp1")) else None
        m_in = copy_to_model(m_in, group)
        hdn = act(self._matmul_w(p, "w_mlp1", m_in) + p["b_mlp1"].to(dtype))
        with checkpoint_name("mlp2"):
            y = reduce_from_model(self._matmul_w(p, "w_mlp2", hdn), group)
            return y + p["b_mlp2"].to(dtype)

    @property
    def _heads_group(self):
        """The model group where the heads are split, else None."""
        return self._tp if self.heads[1] != self.cfg.n_heads else None

    def _w_out(self, params):
        """The output projection [E, V] in the compute dtype, dequantized
        (int4 unpacked whole: for one-shot use, not per token)."""
        dtype = self.cfg.policy.compute_dtype
        w = params["w_out"]
        if "w_out_int4" in params:
            w = torch.cat(nibble_views(w), dim=0)
        w = w.to(dtype)
        scale = params.get("w_out_scale")
        return w if scale is None else w * scale.to(dtype)

    def logits_head(self, params, band: tuple[int, int] | None = None) -> Head:
        """w_out's columns [lo, hi) (all when ``band`` is None) for
        ``_last_logits``, built once per generation, not per token.
        Unquantized: rounded through the compute dtype as the JAX head reads
        them, held as fp32. Quantized: the int8 or packed bytes and their
        scales, sliced and made contiguous here, because a column slice of
        [E, V] has V's row stride and the kernels read dense rows. Where the
        vocabulary is split, the columns of [lo, hi) that this rank's block
        of w_out holds (none, some or all of them)."""
        lo, hi = band if band is not None else (0, self.cfg.total_tokens)
        split = self._split(("w_out",))
        c0, c1 = (split.start, split.stop) if split else (0, self.cfg.total_tokens)
        a = min(max(lo, c0), c1)
        cols = slice(a - c0, max(min(hi, c1), a) - c0)
        b = params["b_out"][cols].float()
        scale = params.get("w_out_scale")
        if scale is None:
            w = params["w_out"][:, cols].to(self.cfg.policy.compute_dtype)
            return Head(w.float().contiguous(), None, b, False, a - lo, hi - lo)
        return Head(params["w_out"][:, cols].contiguous(),
                    scale[:, cols].float().contiguous(), b, "w_out_int4" in params, a - lo,
                    hi - lo)

    def _last_logits(self, head: Head, x_last):
        """[B, E] final-LN'd hidden -> fp32 logits [B, n] over the head's
        columns. The product takes compute-dtype operands and accumulates
        in fp32 (the JAX head's preferred_element_type): bf16 operands are
        exact in fp32, so an fp32 matmul of them is that product. Quantized
        heads stream through the kernels at decode geometry, else dequantize
        in the compute dtype first (JAX ``_last_logits``). With a band only
        the image-token columns exist; every other column would be masked
        out by sampling anyway, so the banded head is exact."""
        dtype = self.cfg.policy.compute_dtype
        if head.scale is None:
            return x_last.to(dtype).float() @ head.w + head.b
        m, e = x_last.shape
        if self._streaming_eligible(m, e):
            x16 = x_last.to(torch.bfloat16)
            if head.int4:
                logits = int4_matmul(x16[:, : e // 2].contiguous(),
                                     x16[:, e // 2:].contiguous(), head.w, head.scale)
            else:
                logits = int8_matmul(x16.contiguous(), head.w, head.scale)
            return logits + head.b
        x = x_last.to(dtype)
        sc = head.scale.to(dtype)
        if head.int4:
            lo, hi = nibble_views(head.w)
            return (x[:, : e // 2].float() @ (lo.to(dtype) * sc).float()
                    + x[:, e // 2:].float() @ (hi.to(dtype) * sc).float() + head.b)
        return x.float() @ (head.w.to(dtype) * sc).float() + head.b

    def _head_logits(self, head: Head, x_last):
        """``_last_logits`` over the head's whole span on every rank: where
        the vocabulary is split, each rank's part is placed in zeros [B,
        width] and the parts are summed over the model group. Exact, since
        each column has one non-zero term, so every rank holds the same
        logits bit for bit and the same sampling draws the same token."""
        part = self._last_logits(head, x_last)
        group = self._vocab_group
        if group is None:
            return part
        out = part.new_zeros((part.shape[0], head.width))
        out[:, head.col0:head.col0 + part.shape[1]] = part
        return all_reduce(out, group)

    def _layers(self, params) -> list[dict]:
        """Per-layer views of the stacked [L, ...] parameters (on a pipe
        mesh, its stage's L/P). ``unbind`` makes all the views at once, so
        the backward stacks their gradients of a weight in one pass instead
        of adding full-size zeros for each."""
        names = list(params["layers"])
        views = [params["layers"][n].unbind(0) for n in names]
        return [{n: v[i] for n, v in zip(names, views)} for i in range(len(views[0]))]

    # -------------------------------------------------------------- training

    def _dropout(self, seed, x, rate, rows):
        """Inverted dropout with a mask from a generator on x's device seeded
        with ``seed`` (None: no dropout; mtf dropout; the JAX package draws
        it with jax.random, so the two masks differ). On a mesh, x
        [B, S_local, E] is this rank's block: the mask is drawn for the
        whole batch and sequence, as one process would, and sliced at its
        global rows ``rows`` = (the first, the whole batch's)."""
        if seed is None:
            return x
        keep = 1.0 - rate
        b, s, e = x.shape
        row0, total = rows
        seq = self._seq_slice(s * self._sp())
        gen = torch.Generator(device=x.device).manual_seed(seed)
        mask = torch.rand((total, s * self._sp(), e), generator=gen,
                          device=x.device)[row0:row0 + b, seq] < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def _block_seeds(self, gen, train: bool) -> tuple:
        """One block's dropout seeds from ``gen``, in the order the block
        uses them (attention, then the two residual dropouts; None where
        that dropout is off). Drawn before the block runs, so that a remat
        recompute of the block draws the same masks."""
        cfg = self.cfg
        return (_seed(gen, cfg.attention_dropout, train),
                _seed(gen, cfg.residual_dropout, train),
                _seed(gen, cfg.residual_dropout, train))

    # ------------------------------------------------------------------ mesh

    def _sp(self) -> int:
        """Ranks the sequence is split over: the ring's seq axis, else 1."""
        if self.mesh is None or self.cfg.attention_type not in ("ring", "local_ring"):
            return 1
        return self.mesh.size(self.cfg.ring_seq_axis)

    def _dp(self) -> tuple[int, int]:
        """(this rank's index, size) on the batch axis."""
        if self.mesh is None:
            return 0, 1
        return self.mesh.index(self.cfg.ring_batch_axis), self.mesh.size(self.cfg.ring_batch_axis)

    def _seq_slice(self, s: int) -> slice:
        """This rank's positions of a sequence of ``s``."""
        n = self._sp()
        if s % n:
            raise ValueError(f"ring attention: sequence length {s} not divisible by the "
                             f"{self.cfg.ring_seq_axis!r} axis of size {n}")
        i = self.mesh.index(self.cfg.ring_seq_axis) if n > 1 else 0
        return slice(i * (s // n), (i + 1) * (s // n))

    def local_labels(self, tokens):
        """This rank's slice of the next-token targets of ``tokens`` [B, S]
        (all of them on one process): the globally shifted labels, so the
        last position of a shard predicts the next shard's first token."""
        return self.shifted_labels(tokens)[:, self._seq_slice(tokens.shape[1])]

    def global_mean(self, values, lo: int = 0, hi: int | None = None,
                    rows: int | None = None):
        """The mean of per-position ``values`` [B, S_local] over global
        positions [lo, hi) of the whole batch, as this rank's share: the
        sum of its values there over the global count, so the sum over the
        mesh's shares (``Mesh.share_group``: the data axes, and the pipe
        axis, whose stages hold their own rows of the head's values; the
        ranks of a tensor-parallel or replicate-only axis hold the same
        values) is the mean. ``rows``: the data rank's rows of the batch
        the values came from (``tokens.shape[0]``); a pipe mesh needs it,
        since a stage holds only its head rows of them.
        On one process, ``values[:, lo:hi].mean()``."""
        if self.mesh is None:
            return values[:, lo:hi].mean()
        if rows is None:
            if self.pipe is not None:
                raise ValueError("global_mean on a pipe mesh needs the data rank's rows")
            rows = values.shape[0]
        s = values.shape[1] * self._sp()
        hi = s if hi is None else hi
        seq = self._seq_slice(s)
        a, b = max(lo, seq.start) - seq.start, min(hi, seq.stop) - seq.start
        return values[:, a:max(a, b)].sum() / (rows * self._dp()[1] * (hi - lo))

    def _qkv_packed(self, p, a_in):
        """[B, S, E] -> packed q, k, v [B, S, H*D] (H this rank's heads):
        the matmuls' natural output layout; the kernels slice head columns
        by strides."""
        e = a_in.shape[-1]
        a_in = copy_to_model(a_in, self._heads_group)
        return tuple(a_in @ self._w(p, n).reshape(e, -1) for n in ("wq", "wk", "wv"))

    def _attn_out_packed(self, p, a):
        """Packed attention output [B, S, H*D] -> [B, S, E] (summed over the
        heads' ranks) + o_b."""
        w = self._w(p, "wo")
        y = reduce_from_model(a @ w.reshape(-1, w.shape[-1]), self._heads_group)
        return y + p["o_b"].to(self.cfg.policy.compute_dtype)

    def _attention(self, q, k, v, drop=0.0, seed=None):
        """Causal attention over [B, H, S, D]: the kernels (on the card) at
        the head dims ``kernel_takes_head_dim`` names, the JAX package's
        rule; its plain version under autograd at any other D, as JAX takes
        its dense reference there. q holds this rank's heads."""
        head0, heads_total = self.heads[0], self.cfg.n_heads
        if kernel_takes_head_dim(self.cfg.head_dim):
            return causal_attention(q, k, v, window=self._window, dropout_rate=drop,
                                    dropout_seed=seed, head0=head0, heads_total=heads_total)
        return attention_reference(q, k, v, True, self._window, False, drop, seed, head0,
                                   heads_total)

    def _block(self, p, x, seeds, rows):
        """One pre-LN transformer block (reference models.py:326-335);
        ``seeds`` from ``_block_seeds``, ``rows`` = (x's first global row,
        the whole batch's rows), where the dropouts draw."""
        cfg = self.cfg
        seed, res_seeds = seeds[0], seeds[1:]
        a_in = self._layer_norm(x, p["ln1_g"], p["ln1_b"])
        drop = cfg.attention_dropout if seed is not None else 0.0
        if cfg.attention_type in ("ring", "local_ring"):
            # sequence parallel over the mesh's seq axis (one process: the
            # [B, H, S, D] attention) on this rank's heads; offsets the seed
            # to the rank's rows, and the hash to its heads' place
            with checkpoint_name("qkv"):
                q, k, v = self._qkv(p, a_in)
            a = ring_attention_auto(
                q, k, v, self.mesh, cfg.ring_seq_axis, cfg.ring_batch_axis, self._window,
                drop, seed, plain=not kernel_takes_head_dim(cfg.head_dim),
                head0=self.heads[0], heads_total=cfg.n_heads)
            with checkpoint_name("attn_proj"):
                a = self._attn_out(p, a)
            return self._block_tail(p, x, a, res_seeds, rows)
        if seed is not None:  # program (b, h) of this rank's rows: global row b0 + b
            seed += rows[0] * cfg.n_heads
        # quantized weights take the [B, H, S, D] arm (JAX ``use_packed``)
        if cfg.attn_packed and "wq_scale" not in p and "wq_int4" not in p:
            with checkpoint_name("qkv"):
                q, k, v = self._qkv_packed(p, a_in)
            head0, heads = self.heads
            if kernel_takes_head_dim(cfg.head_dim):
                a = packed_attention(q, k, v, heads, self._window, drop, seed, head0,
                                     cfg.n_heads)
            else:  # as ``_attention``
                a = attention_packed_reference(q, k, v, heads, self._window, drop, seed,
                                               False, head0, cfg.n_heads)
            with checkpoint_name("attn_proj"):
                a = self._attn_out_packed(p, a)
        else:
            with checkpoint_name("qkv"):
                q, k, v = self._qkv(p, a_in)
            a = self._attention(q, k, v, drop, seed)
            with checkpoint_name("attn_proj"):
                a = self._attn_out(p, a)
        return self._block_tail(p, x, a, res_seeds, rows)

    def _block_tail(self, p, x, a, res_seeds, rows):
        """Residual add + LN2 + MLP + residual dropouts."""
        rate = self.cfg.residual_dropout
        x = x + self._dropout(res_seeds[0], a, rate, rows)
        m = self._mlp(p, self._layer_norm(x, p["ln2_g"], p["ln2_b"]))
        return x + self._dropout(res_seeds[1], m, rate, rows)

    def _remat(self, train: bool):
        """The checkpoint ``context_fn`` of a training pass under
        ``recompute_grad``, or None where the blocks run without one."""
        cfg = self.cfg
        if (not (cfg.recompute_grad and train and torch.is_grad_enabled())
                or cfg.remat_policy in _NO_CHECKPOINT):
            return None
        return remat_context(cfg.remat_policy)

    def hidden(self, params, tokens, generator: torch.Generator | None = None,
               train: bool = False):
        """tokens [B, S] int -> final-LN hidden states [B, S, E] (compute
        dtype); on a sequence-parallel mesh, of this rank's positions
        [row0, row0 + S_local) only; on a pipe mesh, of this rank's rows of
        the batch (``parallel.pipeline.head_bounds``). ``generator`` (CPU)
        feeds every dropout of the pass (the same draws on every rank).
        Under ``recompute_grad`` each block is a checkpoint region (see the
        module docstring)."""
        cfg = self.cfg
        rows = tokens.shape[0]
        row0, total = self._dp()[0] * rows, rows * self._dp()[1]
        embed_seed = _seed(generator, cfg.embed_dropout, train)
        seeds = [self._block_seeds(generator, train) for _ in range(cfg.n_layers)]
        seeds = seeds[self.layers[0]:self.layers[1]]
        context_fn = self._remat(train)
        layers = self._layers(params)
        if self.pipe is None:
            x = self._embedded(params, tokens, embed_seed, (row0, total))
            x = self._stage(layers, x, seeds, (row0, total), context_fn)
        else:
            mb = microbatch_rows(rows, self._microbatches)
            x = None
            if self.pipe.first:
                x = self._embedded(params, tokens, embed_seed, (row0, total))
            x = pipeline_apply(
                lambda h, i: self._stage(layers, h, seeds, (row0 + i * mb, total), context_fn),
                x, self.pipe, rows, self._microbatches, (tokens.shape[1], cfg.n_embd),
                cfg.policy.compute_dtype, tokens.device)
        return self._layer_norm(x, params["lnf_g"], params["lnf_b"])

    def _embedded(self, params, tokens, seed, rows):
        """The embedded tokens of this rank's positions, embedding dropout
        drawn at ``rows``."""
        seq = self._seq_slice(tokens.shape[1])
        dtype = self.cfg.policy.compute_dtype
        x = self._embed(params, tokens[:, seq]) + params["wpe"][seq].to(dtype)
        return self._dropout(seed, x, self.cfg.embed_dropout, rows)

    def _stage(self, layers, x, seeds, rows, context_fn):
        """The blocks ``layers`` in turn on x (its global ``rows``)."""
        for p, block_seeds in zip(layers, seeds):
            if context_fn is None:
                x = self._block(p, x, block_seeds, rows)
            else:
                # no global RNG inside a block: the seeds are its arguments
                x = torch.utils.checkpoint.checkpoint(
                    self._block, p, x, block_seeds, rows, use_reentrant=False,
                    preserve_rng_state=False, context_fn=context_fn)
        return x

    @property
    def _microbatches(self) -> int:
        """The pipeline's microbatches: the config's, else the pipe size."""
        return self.cfg.pipeline_microbatches or self.pipe.n

    def _head_labels(self, tokens):
        """The next-token targets of the positions ``hidden`` returns: this
        rank's slice of the sequence (``local_labels``) and, on a pipe mesh,
        its head rows of the batch (``head_bounds``)."""
        labels = self.local_labels(tokens)
        if self.pipe is None:
            return labels
        a, b = head_bounds(labels.shape[0], self.pipe.n, warn=False)[self.pipe.stage]
        return labels[a:b]

    def forward(self, params, tokens, generator=None, train: bool = False):
        """tokens [B, S] -> logits [B, S, total_tokens] fp32 (of this rank's
        positions on a sequence-parallel mesh; of its rows on a pipe mesh;
        of its block of the vocabulary where that is split): compute-dtype
        operands, fp32
        accumulation and output (bf16 values are exact in fp32, so the fp32
        product of the cast operands is that matmul)."""
        x = copy_to_model(self.hidden(params, tokens, generator, train), self._vocab_group)
        return x.float() @ self._w_out(params).float() + params["b_out"]

    @property
    def _vocab_group(self):
        """The model group where the vocabulary is split, else None."""
        return self._tp if self._split(("w_out",)) else None

    @torch.no_grad()
    def dense_eval(self, params, tokens, generator=None, z_loss: float = 0.0):
        """Eval with the dense head: per-position loss and argmax
        correctness (fp32 [B, S]) of ``forward``'s fp32 logits, the
        vocabulary's blocks joined by collectives where it is split (the
        argmax with ``jnp.argmax``'s first-occurrence rule)."""
        logits = self.forward(params, tokens, generator, train=False)
        labels = self._head_labels(tokens)
        split = self._split(("w_out",))
        if split is None:
            loss = softmax_cross_entropy_with_logits(logits, labels, z_loss)
            return loss, (logits.argmax(dim=-1) == labels).float()
        flat, t = logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long()
        loss, _, m_loc, m = tp_chunk_loss(flat, t, z_loss, split.start, self._tp)
        correct = tp_correct(flat, m_loc, m, t, split.start, self._tp)
        return loss.reshape(labels.shape), correct.reshape(labels.shape)

    def loss(self, params, tokens, generator=None, train: bool = True,
             z_loss: float = 0.0, fused_xent: bool = False):
        """Next-token xent, labels = shift-left(tokens) + EOS (reference
        models.py:397-416). Returns (mean loss fp32, per-position [B, S]);
        on a mesh, (this rank's share of the global mean, its positions; on
        a pipe mesh, of its rows).

        The dense head runs in the compute dtype: bf16 logits, the bias cast
        to bf16 before the add, as the JAX loss head (its custom backward is
        a fusion; plain autograd gives the same dw and db). ``fused_xent``
        streams the head over row chunks instead (ops/xent_fused.py: fp32
        logits, never [B, S, vocab] at once), for memory-bound models."""
        x = self.hidden(params, tokens, generator, train)
        labels = self._head_labels(tokens)
        split = self._split(("w_out",))
        if fused_xent:
            b, s, e = x.shape
            loss_batch = chunked_softmax_xent_auto(
                x.reshape(b * s, e), self._w_out(params), params["b_out"], labels.reshape(-1),
                z_loss, self._xent_chunks(b * s), self._vocab_axis, self.mesh,
                self.cfg.total_tokens,
            ).reshape(b, s)
        else:
            dtype = self.cfg.policy.compute_dtype
            x = copy_to_model(x, self._vocab_group)
            logits = x @ self._w_out(params) + params["b_out"].to(dtype)
            if split is None:
                loss_batch = softmax_cross_entropy_with_logits(logits, labels, z_loss)
            else:
                loss_batch = vocab_parallel_cross_entropy(logits, labels, split.start,
                                                          self._tp, z_loss)
        return self.global_mean(loss_batch, rows=tokens.shape[0]), loss_batch

    @property
    def _vocab_axis(self) -> str | None:
        """The axis the fused head splits the vocabulary over (None where
        the leaves are not split)."""
        return self.mesh.tp_axis if self._vocab_group is not None else None

    def _xent_chunks(self, n: int) -> int:
        """The fused head's chunk count for n rows: the JAX rule, the first
        of (xent_chunks, 8, 4, 2, 1) that divides n."""
        return next(c for c in (self.cfg.xent_chunks, 8, 4, 2, 1) if n % c == 0)

    @torch.no_grad()
    def fused_eval(self, params, tokens, generator=None, z_loss: float = 0.0):
        """Eval under ``fused_xent``: per-position loss and argmax
        correctness (fp32 [B, S], of this rank's positions on a mesh),
        streamed over row chunks (ops/xent_fused.py::chunked_xent_eval_auto)
        so the [B, S, vocab] logits never exist. No gradients."""
        x = self.hidden(params, tokens, generator, train=False)
        b, s, e = x.shape
        loss, correct = chunked_xent_eval_auto(
            x.reshape(b * s, e), self._w_out(params), params["b_out"],
            self._head_labels(tokens).reshape(-1), z_loss, self._xent_chunks(b * s),
            self._vocab_axis, self.mesh, self.cfg.total_tokens)
        return loss.reshape(b, s), correct.reshape(b, s)

    def shifted_labels(self, tokens):
        """Next-token targets: tokens shifted left with EOS appended."""
        eos = torch.full((tokens.shape[0], 1), self.cfg.eos, dtype=tokens.dtype,
                         device=tokens.device)
        return torch.cat([tokens[:, 1:], eos], dim=1)

    # --------------------------------------------------------- KV-cache path

    def init_cache(self, batch: int, max_len: int | None = None) -> dict:
        """The KV cache [L, B, H, S, D] of this rank's heads, zeroed."""
        cfg = self.cfg
        s = max_len or cfg.total_seq_len
        shape = (cfg.n_layers, batch, self.heads[1], s, cfg.head_dim)
        dtype = cfg.policy.compute_dtype
        return {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device),
        }

    def prefill(self, params, tokens, cache: dict, band=None, head=None):
        """Run the prompt through the model, writing cache[:, :, :, :S] in
        place. Returns fp32 logits at the last position, [B, vocab] or
        [B, hi-lo] with ``band=(lo, hi)`` (``head`` from ``logits_head``
        takes the band's place when the caller already built it), the same
        on every rank of a model group. On a tensor-parallel mesh each rank
        attends over its heads (the kernel with ``head0``/``heads_total``,
        JAX's ``causal_attention_tp``) and fills its heads' cache."""
        return self.prefill_rows(params, tokens, cache, None, band, head)

    def prefill_rows(self, params, tokens, cache: dict, row_mask,
                     band=None, head=None):
        """``prefill`` that writes the cache only on ``row_mask`` rows
        (bool [B]; None = every row). Returns the last-position logits of
        every row; only the masked rows' are meaningful."""
        cfg = self.cfg
        dtype = cfg.policy.compute_dtype
        t = tokens.shape[1]
        # embeddings rounded to the compute dtype BEFORE the add
        # (dalle.py:1249), so bf16 rounds where JAX rounds (gathering
        # first and casting the rows is the same elementwise cast)
        x = self._embed(params, tokens) + params["wpe"][:t].to(dtype)
        for layer, p in enumerate(self._layers(params)):
            a_in = self._layer_norm(x, p["ln1_g"], p["ln1_b"])
            q, k, v = self._qkv(p, a_in)
            x = x + self._attn_out(p, self._attention(q, k, v))
            m_in = self._layer_norm(x, p["ln2_g"], p["ln2_b"])
            x = x + self._mlp(p, m_in)
            for name, new in (("k", k), ("v", v)):
                dst = cache[name][layer, :, :, :t]
                if row_mask is None:
                    dst.copy_(new)
                else:
                    dst.copy_(torch.where(row_mask[:, None, None, None], new, dst))
        x = self._layer_norm(x[:, -1], params["lnf_g"], params["lnf_b"])
        return self._head_logits(head or self.logits_head(params, band), x)

    def decode_step(self, params, cache: dict, token, position: int,
                    band=None, head=None):
        """One incremental step: token [B] at ``position`` -> fp32 logits
        [B, vocab] ([B, hi-lo] with ``band``). Each layer writes its k/v at
        ``position`` into the cache in place (the JAX step returns a new
        cache instead)."""
        return self._decode(params, cache, token, int(position),
                            head or self.logits_head(params, band))

    def decode_step_rows(self, params, cache: dict, token, positions,
                         band=None, head=None):
        """``decode_step`` with a per-row position: token [B] where row b sits
        at ``positions[b]`` (long [B]) -> logits [B, vocab]. Each row writes
        its k/v at its own position, and its attention mask reads it. What
        continuous batching needs: slots of one batch decode at different
        depths. The same math as ``decode_step`` when all positions agree."""
        return self._decode(params, cache, token, positions,
                            head or self.logits_head(params, band))

    def _decode(self, params, cache, token, pos, head):
        """The decode body: ``pos`` an int (every row) or a long [B]."""
        dtype = self.cfg.policy.compute_dtype
        x = self._embed(params, token) + params["wpe"][pos].to(dtype)
        x = x[:, None, :]  # [B, 1, E]
        rows = None if isinstance(pos, int) else torch.arange(x.shape[0], device=x.device)
        for layer, p in enumerate(self._layers(params)):
            a_in = self._layer_norm(x, p["ln1_g"], p["ln1_b"])
            q, k_new, v_new = self._qkv(p, a_in)
            k_all, v_all = cache["k"][layer], cache["v"][layer]
            if rows is None:
                k_all[:, :, pos] = k_new[:, :, 0]
                v_all[:, :, pos] = v_new[:, :, 0]
            else:
                k_all[rows, :, pos] = k_new[:, :, 0]
                v_all[rows, :, pos] = v_new[:, :, 0]
            a = decode_attention(q, k_all, v_all, pos, window=self._window)
            x = x + self._attn_out(p, a)
            m_in = self._layer_norm(x, p["ln2_g"], p["ln2_b"])
            x = x + self._mlp(p, m_in)
        x = self._layer_norm(x[:, 0], params["lnf_g"], params["lnf_b"])
        return self._head_logits(head, x)

    def _embed(self, params, tokens):
        """``wte[tokens]`` in the compute dtype, this rank's block of the
        table joined over the model group where the vocabulary is split."""
        return vocab_parallel_embedding(params["wte"], tokens, self._split(("wte",)), self._tp,
                                        self.cfg.policy.compute_dtype)


def _draw_seed(gen: torch.Generator | None) -> int:
    return int(torch.randint(0, 2**31 - 1, (), generator=gen))


def _seed(gen: torch.Generator | None, rate: float, train: bool) -> int | None:
    """A dropout seed from ``gen`` (None: the default generator) where a
    dropout of ``rate`` runs, else None (nothing drawn)."""
    return _draw_seed(gen) if train and rate > 0.0 else None
