"""Discrete (Gumbel-softmax) VAE, stage 1 of the two-stage system (port of
``dalle_mtf_tpu/models/vae.py``): the encoder, the shared codebook, the
decoder, the training forward and the token API.

Public functions take and return NHWC, and parameters keep the JAX tree's
names and HWIO conv kernels (``encoder/block_0/down/w [kh, kw, cin, cout]``);
inside, activations run NCHW and kernels are permuted per call.

Precision. Under the fp32 policy the convolutions run in IEEE fp32 on the
card: cuDNN's TF32 switch (``torch.backends.cudnn.allow_tf32``, on by
default) is turned off around every conv, forward and backward
(``_Conv``), whatever the process has set, so an fp32 VAE computes what its
name says and agrees with the CPU to fp32 rounding. Under bf16 the switch
does not apply. The codebook products (encoder logits, decoder input) are
fp32 einsums at torch's default matmul precision, which is IEEE fp32.

Across processes (a ``parallel.mesh.Mesh``) each rank holds its rows of the
batch (the ``batch_dim`` axis) and draws the single process's Gumbel noise
for them (ops/gumbel.py keys the draw on global rows). The layout may put
the JAX VAE's logical dims on a tensor-parallel axis: a conv kernel is
``(conv_kh, conv_kw, conv_cin, conv_cout)`` and its bias ``(conv_cout,)``,
the codebook ``(vae_hid_dim, tokens_dim)`` (``logical_axes``). Each rank
then holds its block of every leaf a rule splits (``sharding``; a dim that
does not divide, such as the first conv's 3 input channels, stays whole, as
JAX's ``shard_params`` leaves it) and computes with it, by the split the
leaf has (``_tp_conv``):

- ``conv_cout``: the rank's output channels from the whole input
  (``copy_to_model`` before the conv), with its bias block; the output is
  split by channels;
- ``conv_cin``: the rank's input channels (``scatter_to_model`` of a whole
  input), giving a partial sum that is reduced over the group
  (``reduce_from_model``), the bias added once after the sum;
- ``conv_kh`` / ``conv_kw``: the kernel is gathered whole before the conv
  (``gather_from_model``). A split of the kernel's rows saves no compute
  worth a design of its own, so every rank runs the conv whole.

Between the convs an activation is whole or split by channels in equal
blocks, and is gathered (``gather_from_model``) or cut
(``scatter_to_model``) where the next consumer needs the other; the
residual add sees matching blocks. The codebook split by columns
(``tokens_dim``) takes the rank's block of the logits in fp32, the Gumbel
softmax its max and sum across the blocks, the hard sample and
``encode_tokens`` the argmax across them (the lowest global index on a
tie), and the decoder's ``one_hot @ codebookᵀ`` is a partial sum reduced
over the group. Split by rows (``vae_hid_dim``), the encoder's product is a
partial sum over the rank's channels, reduced, and the decoder's gives the
rank's block of channels, which the first ``up`` conv takes as it is where
its ``conv_cin`` is split on the same axis and gathers otherwise. A layout
may not put one axis on two dims of a leaf (``parallel/mesh.py::
check_layout``). The eval's statistics (the reconstruction, the tokens, the
pooled features) come out whole on every rank of the group. A VAE built
without a mesh (the frozen VAE of DALLE image mode, which JAX also leaves
whole) holds every leaf whole.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dalle_mtf_tpu_torch.ops.gumbel import gumbel_softmax, mix32
from dalle_mtf_tpu_torch.ops.losses import mse_loss
from dalle_mtf_tpu_torch.parallel.mesh import BATCH, CONV_DIMS, TOKENS, VAE_HID, leaf_split
from dalle_mtf_tpu_torch.parallel.tensor import (
    Sharding,
    copy_to_model,
    gather_from_model,
    model_argmax,
    reduce_from_model,
    scatter_to_model,
)
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.utils.distributed import model_device
from dalle_mtf_tpu_torch.utils.precision import Policy, get_policy
from dalle_mtf_tpu_torch.utils.seeds import base_seed, key_seed

KH, KW, CIN, COUT = CONV_DIMS


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    num_tokens: int
    image_size: int
    convblocks: tuple[tuple[int, int], ...]
    n_channels: int = 3
    stack_factor: int = 1
    recompute_grad: bool = False
    use_bf16: bool = False

    @classmethod
    def from_params(cls, params: Mapping[str, Any]) -> "VAEConfig":
        """Build from a reference-schema JSON config (configs/vae_*.json)."""
        convblocks = params.get("convblocks")
        if convblocks:
            convblocks = tuple((int(s), int(c)) for s, c in convblocks)
        else:
            # mtf-variant schema: num_layers stride-2 convs at hidden_dim
            # (reference dalle_mtf/models.py:54-65).
            n = params.get("num_layers") or 3
            hid = params.get("hidden_dim") or 64
            convblocks = tuple((1, hid) for _ in range(n))
        return cls(
            num_tokens=params.get("num_tokens"),
            image_size=params["dataset"]["image_size"],
            convblocks=convblocks,
            n_channels=params.get("n_channels") or 3,
            stack_factor=params.get("stack_factor") or 1,
            recompute_grad=bool(params.get("recompute_grad")),
            use_bf16=bool(params.get("use_bf16") or params.get("bf_16")),
        )

    @property
    def n_hid(self) -> int:
        return self.convblocks[-1][1]

    @property
    def grid_size(self) -> int:
        """Side length of the latent token grid."""
        return self.image_size // (2 ** len(self.convblocks)) // self.stack_factor

    @property
    def image_seq_len(self) -> int:
        """Tokens per image (reference model_fns.py:68)."""
        return self.grid_size ** 2

    @property
    def policy(self) -> Policy:
        return get_policy(self.use_bf16)


@contextlib.contextmanager
def _conv_precision(dtype: torch.dtype):
    """cuDNN's TF32 off for fp32 convs (the module's precision rule)."""
    if dtype != torch.float32:
        yield
        return
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class _Conv(torch.autograd.Function):
    """``aten.convolution`` of NCHW ``x`` (no bias, dilation 1, one group)
    with the forward and the backward both under ``_conv_precision``:
    autograd would run the backward outside any context the forward set."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: tuple[int, int], transposed: bool):
        ctx.save_for_backward(x, w)
        ctx.conf = ([stride, stride], list(padding), transposed)
        stride_, padding_, _ = ctx.conf
        with _conv_precision(x.dtype):
            return torch.ops.aten.convolution(
                x, w, None, stride_, padding_, [1, 1], transposed, [0, 0], 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, transposed = ctx.conf
        with _conv_precision(x.dtype):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, [1, 1], transposed, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """TF/XLA "SAME" padding (low, high) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _bias(out, p, dtype):
    """``out`` plus the bias ``p["b"]`` over its channels, where ``p`` has
    one."""
    return out if p.get("b") is None else out + p["b"].to(dtype)[:, None, None]


def _conv(x, p, stride=1, compute_dtype=None):
    """NCHW x, HWIO kernel, "SAME" padding (jax.lax.conv_general_dilated):
    even pads go to the conv itself, uneven ones (an odd size at stride 2)
    through F.pad first; the bias where ``p`` has one."""
    dtype = compute_dtype or x.dtype
    w = p["w"].to(dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    kh, kw = w.shape[-2:]
    ph = _same_pads(x.shape[-2], kh, stride)
    pw = _same_pads(x.shape[-1], kw, stride)
    x = x.to(dtype)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        padding = (ph[0], pw[0])
    else:
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        padding = (0, 0)
    return _bias(_Conv.apply(x, w, stride, padding, False), p, dtype)


def _conv_transpose(x, p, stride=2, compute_dtype=None):
    """jax.lax.conv_transpose(..., padding="SAME") with the HWIO kernel and
    transpose_kernel=False, for the VAE's k=4, s=2: a correlation over the
    input dilated by 2 and padded (2, 2), kernel NOT flipped
    (jax._src.lax.convolution._conv_transpose_padding). torch's
    conv_transpose2d is the adjoint of a correlation, so the same map is
    its [cin, cout, kh, kw] kernel flipped in space, with padding 1. The
    bias where ``p`` has one."""
    dtype = compute_dtype or x.dtype
    kh = p["w"].shape[0]
    if (kh, stride) != (4, 2):
        raise NotImplementedError("only the VAE's k=4, stride=2 up-conv is ported")
    w = p["w"].to(dtype).permute(2, 3, 0, 1).flip(-1, -2)
    return _bias(_Conv.apply(x.to(dtype), w, 2, (1, 1), True), p, dtype)


def space_to_depth(x, factor: int):
    """NHWC [B, H, W, C] -> [B, H/f, W/f, C*f*f] (JAX layout)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // factor, w // factor, c * factor * factor)


def depth_to_space(x, factor: int):
    """NHWC [B, H, W, C*f*f] -> [B, H*f, W*f, C] (JAX layout)."""
    b, h, w, c = x.shape
    c_out = c // (factor * factor)
    x = x.reshape(b, h, w, factor, factor, c_out)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * factor, w * factor, c_out)


def _glorot_uniform(shape, key: int, device, split=None):
    """jax.nn.initializers.glorot_uniform of a leaf of whole ``shape`` (in
    axis -2, out axis -1, the rest the receptive field), drawn only on
    ``split``'s block (None: the whole leaf). Each value is a hash of
    ``key`` and its flat index in the whole leaf (``mix32``, as
    ops/gumbel.py draws its noise), so a block holds the whole leaf's values
    there under any split."""
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    if math.prod(shape) > 2**32:
        raise ValueError(f"a leaf of {math.prod(shape)} values exceeds the hash's 2^32 counter")
    index = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for dim in reversed(range(len(shape))):
        lo, hi = ((split.start, split.stop) if split is not None and split.dim == dim
                  else (0, shape[dim]))
        view = [1] * len(shape)
        view[dim] = hi - lo
        index = index + (torch.arange(lo, hi, device=device) * stride).reshape(view)
        stride *= shape[dim]
    bits = mix32(mix32(index ^ (key & 0xFFFFFFFF)) ^ (key >> 32))
    u = (bits >> 8).float() * 2.0 ** -24  # [0, 1)
    return (2.0 * u - 1.0) * limit


class DiscreteVAE(nn.Module):
    """The VAE's computation over an explicit parameter tree (see DALLE).
    On a ``mesh`` whose layout splits any of its leaves, ``sharding`` holds
    every leaf's split (else None) and ``init`` this rank's blocks."""

    def __init__(self, config: VAEConfig, device: torch.device | str = "cuda", mesh=None):
        super().__init__()
        self.cfg = config
        self.device = model_device(device)
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.sharding = None
        if self.mesh is not None and self.mesh.tp_axis is not None:
            axes = dict(named_leaves(self.logical_axes()))
            splits = {path: leaf_split(axes[path], shape, self.mesh, "/".join(path))
                      for path, shape in named_leaves(self.param_shapes())}
            if any(splits.values()):
                self.sharding = Sharding(splits, self.mesh.model_group, self.mesh.tp_axis)
        self._group = self.sharding.group if self.sharding else None
        codebook = self._split(("codebook",))
        # the group the codebook's columns (tokens) or rows (channels) split over
        self._tokens_group = self._group if codebook and codebook.dim == 1 else None
        self._hid_group = self._group if codebook and codebook.dim == 0 else None
        self._cols = ((codebook.start, codebook.stop) if self._tokens_group
                      else (0, config.num_tokens))

    def _split(self, path: tuple[str, ...]):
        """The ``Split`` of the leaf at ``path``, or None."""
        return self.sharding.of(path) if self.sharding is not None else None

    def _row0(self, rows: int) -> int:
        """The global row of this rank's first row of a batch of ``rows``."""
        if self.mesh is None:
            return 0
        return self.mesh.index(self.mesh.rules.get(BATCH) or "data") * rows

    def param_shapes(self) -> dict:
        """Shapes of the JAX tree: ``encoder``, ``codebook``, ``decoder``."""
        cfg = self.cfg

        def conv(k, cin, cout):
            return {"w": (k, k, cin, cout), "b": (cout,)}

        def stack(first, k, cin, blocks):
            tree: dict = {}
            for b, (n, channels) in enumerate(blocks):
                blk = {first: conv(k, cin, channels)}
                for i in range(1, n):
                    blk[f"res_{i}"] = {
                        "conv_in": conv(3, channels, channels),
                        "conv_out": conv(3, channels, channels),
                    }
                tree[f"block_{b}"] = blk
                cin = channels
            return tree, cin

        pixels = cfg.n_channels * cfg.stack_factor ** 2
        enc, _ = stack("down", 4, pixels, cfg.convblocks)
        dec, cin = stack("up", 4, cfg.n_hid, tuple(reversed(cfg.convblocks)))
        dec["final"] = conv(1, cin, pixels)
        return {"encoder": enc, "codebook": (cfg.n_hid, cfg.num_tokens), "decoder": dec}

    def logical_axes(self) -> dict:
        """The JAX tree's logical dim names (``dalle_mtf_tpu/models/vae.py::
        logical_axes``): every kernel ``(conv_kh, conv_kw, conv_cin,
        conv_cout)``, every bias ``(conv_cout,)``, the codebook
        ``(vae_hid_dim, tokens_dim)``."""
        names = {"w": CONV_DIMS, "b": (COUT,), "codebook": (VAE_HID, TOKENS)}

        def axes(name, v):
            return {k: axes(k, x) for k, x in v.items()} if isinstance(v, dict) else names[name]

        return {k: axes(k, v) for k, v in self.param_shapes().items()}

    def init(self, generator: torch.Generator) -> dict:
        """Glorot-uniform kernels and codebook, zero biases (vae.py:150-184,
        the TF1 conv2d defaults), on ``self.device``. The draw does not
        depend on the layout: one seed is drawn from ``generator``, and each
        leaf's values are hashed from it, the leaf's path and their indices
        (``_glorot_uniform``), so a rank draws only its blocks and the tree
        is the single process's under any layout."""
        seed = base_seed(generator)

        def make(path, shape):
            split = self._split(path)
            if path[-1] == "b":
                local = self.sharding.local_shape(path, shape) if split else shape
                return torch.zeros(local, device=self.device)
            return _glorot_uniform(shape, key_seed(seed, "/".join(path)), self.device, split)

        def tree(node, prefix=()):
            return {k: (tree(v, prefix + (k,)) if isinstance(v, dict) else make(prefix + (k,), v))
                    for k, v in node.items()}

        return tree(self.param_shapes())

    def _as(self, x, split: bool, want: bool):
        """NCHW ``x`` (split by channels over the model group where
        ``split``) as ``want`` asks: gathered whole or cut to this rank's
        block."""
        if split == want:
            return x
        return (gather_from_model if split else scatter_to_model)(x, 1, self._group)

    def _tp_conv(self, path, x, split: bool, p, stride: int, dtype, transpose: bool = False):
        """The conv (``_conv_transpose`` where ``transpose``) of the leaf at
        ``path`` on NCHW ``x`` (split by channels where ``split``), by the
        split its kernel has (the module docstring): (output, whether it is
        split by channels)."""
        w_split = self._split(path + ("w",))
        kind = CONV_DIMS[w_split.dim] if w_split is not None else None
        conv = _conv_transpose if transpose else _conv
        group = self._group
        if kind == CIN:  # a partial sum over this rank's input channels
            out = reduce_from_model(conv(self._as(x, split, True), {"w": p["w"]}, stride, dtype),
                                    group)
            return _bias(out, p, dtype), False
        x, w = self._as(x, split, False), p["w"]
        if kind in (KH, KW):
            w = gather_from_model(w, w_split.dim, group)
        if kind == COUT:
            x = copy_to_model(x, group)
        return conv(x, {"w": w, "b": p["b"]}, stride, dtype), kind == COUT

    def _res_block(self, path, p, x, split: bool, compute_dtype, train: bool = False):
        def fn(x_):
            h, s = self._tp_conv(path + ("conv_in",), x_, split, p["conv_in"], 1, compute_dtype)
            h = F.relu(h)  # the conv's output let go before the next conv runs
            out, s = self._tp_conv(path + ("conv_out",), h, s, p["conv_out"], 1, compute_dtype)
            return self._as(out, s, split)

        if self.cfg.recompute_grad and train and torch.is_grad_enabled():
            # the reference's per-block activation recompute (jax.checkpoint);
            # the recompute reruns the block's collectives, in one order on
            # every rank
            return x + checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)
        return x + fn(x)

    # --------------------------------------------------------------- encoder

    def _encode_conv(self, params, img, train: bool = False):
        """Conv trunk of the encoder: image [B, H, W, C] in [-1, 1] ->
        (pre-codebook features [B, h, w, n_hid] in the compute dtype,
        whether they are split by channels over the model group)."""
        cfg = self.cfg
        dtype = cfg.policy.compute_dtype
        x, split = img.to(dtype), False
        if cfg.stack_factor > 1:
            x = space_to_depth(x, cfg.stack_factor)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for b, (stack, _channels) in enumerate(cfg.convblocks):
            path = ("encoder", f"block_{b}")
            blk = params["encoder"][f"block_{b}"]
            x, split = self._tp_conv(path + ("down",), x, split, blk["down"], 2, dtype)
            for i in range(1, stack):
                x = self._res_block(path + (f"res_{i}",), blk[f"res_{i}"], x, split, dtype,
                                    train)
        return x.permute(0, 2, 3, 1), split  # NCHW -> NHWC

    def encoder(self, params, img, train: bool = False):
        """Image [B, H, W, C] in [-1, 1] -> logits [B, h, w, num_tokens],
        the codebook product in fp32 (vae_tf/models.py:81-120); under a
        codebook split by columns this rank's columns of them."""
        x, split = self._encode_conv(params, img, train)
        codebook = params["codebook"].float()
        if self._hid_group is not None:  # a partial sum over this rank's channels
            x = x if split else scatter_to_model(x, -1, self._group)
            return reduce_from_model(torch.einsum("bhwc,ct->bhwt", x.float(), codebook),
                                     self._group)
        x = gather_from_model(x, -1, self._group) if split else x
        x = copy_to_model(x.float(), self._tokens_group)
        return torch.einsum("bhwc,ct->bhwt", x, codebook)

    def encoder_features(self, params, img):
        """Pooled pre-codebook features [B, n_hid] (fp32, whole on every
        rank): the spatial mean over the token grid, the embedding the
        eval's Fréchet feature distance compares real and reconstructed
        images in."""
        x, split = self._encode_conv(params, img)
        x = x.float().mean(dim=(1, 2))
        return gather_from_model(x, -1, self._group) if split else x

    # --------------------------------------------------------------- decoder

    def decoder(self, params, one_hot, train: bool = False):
        """Token distribution [B, h, w, num_tokens] -> image [B, H, W, C]
        fp32, whole on every rank (vae_tf/models.py:123-163: codebook^T
        matmul in fp32, mirrored transpose-conv stacks, final 1x1 conv,
        depth_to_space)."""
        cfg = self.cfg
        dtype = cfg.policy.compute_dtype
        codebook = params["codebook"].float()
        if self._hid_group is not None:
            # this rank's channels of the product, from the whole distribution
            one_hot = copy_to_model(one_hot.float(), self._group)
            x, split = torch.einsum("bhwt,ct->bhwc", one_hot, codebook), True
        else:
            # under a codebook split by columns: this rank's columns of the
            # distribution, a partial sum over the tokens summed over the group
            x = torch.einsum("bhwt,ct->bhwc", one_hot.float(), codebook)
            x, split = reduce_from_model(x, self._tokens_group), False
        x = x.to(dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for b, (stack, _channels) in enumerate(reversed(cfg.convblocks)):
            path = ("decoder", f"block_{b}")
            blk = params["decoder"][f"block_{b}"]
            x, split = self._tp_conv(path + ("up",), x, split, blk["up"], 2, dtype,
                                     transpose=True)
            for i in range(1, stack):
                x = self._res_block(path + (f"res_{i}",), blk[f"res_{i}"], x, split, dtype,
                                    train)
        x, split = self._tp_conv(("decoder", "final"), x, split, params["decoder"]["final"], 1,
                                 dtype)
        x = self._as(x, split, False).float().permute(0, 2, 3, 1)  # NCHW -> NHWC
        if cfg.stack_factor > 1:
            x = depth_to_space(x, cfg.stack_factor)
        return x

    # --------------------------------------------------------------- forward

    def forward(self, params, img, generator: torch.Generator, temperature=1.0,
                hard_gumbel: bool = True, train: bool = False):
        """Full autoencode: (reconstruction MSE, reconstruction [B, H, W, C]
        fp32 on the input's [-1, 1] scale). The Gumbel noise is drawn from
        ``generator`` (``ops/gumbel.py``) for the batch's global rows (this
        rank's on the batch axis)."""
        logits = self.encoder(params, img, train)
        if self.mesh is None:
            soft_one_hot = gumbel_softmax(generator, logits, temperature, hard=hard_gumbel)
        else:
            block = (self._row0(logits.shape[0]), self._cols[0], self.cfg.num_tokens)
            soft_one_hot = gumbel_softmax(generator, logits, temperature, hard=hard_gumbel,
                                          block=block, group=self._tokens_group)
        out = self.decoder(params, soft_one_hot, train)
        return mse_loss(img.to(out.dtype), out), out

    # ------------------------------------------------------------- token API

    def encode_tokens(self, params, img):
        """Image -> hard token ids [B, image_seq_len] int32: the argmax over
        the encoder logits (reference model_fns.py:72-77), across the
        codebook's blocks under a split."""
        tokens = model_argmax(self.encoder(params, img), self._cols[0], self._tokens_group)
        return tokens.reshape(tokens.shape[0], -1).int()

    def decode_tokens(self, params, tokens):
        """Token ids [B, image_seq_len] -> images [B, H, W, C] in [0, 1]."""
        g = self.cfg.grid_size
        b = tokens.shape[0]
        lo, hi = self._cols
        rel = tokens.reshape(b, g, g).long() - lo
        mine = (rel >= 0) & (rel < hi - lo)
        one_hot = (F.one_hot(rel.clamp(0, hi - lo - 1), hi - lo) * mine[..., None]).float()
        return (self.decoder(params, one_hot) + 1.0) / 2.0


def temperature_schedule(params: Mapping[str, Any], step: int) -> float:
    """Gumbel temperature at ``step``, in float32 like the JAX schedule
    (model_fns_tf.py:40-45): linear from temp_start to temp over
    temp_anneal_steps, else the constant temp (default 1.0)."""
    f32 = np.float32
    anneal_steps = params.get("temp_anneal_steps")
    if anneal_steps:
        frac = min(f32(step) / f32(anneal_steps), f32(1.0))
        start = params["temp_start"]
        return float(f32(start) - frac * f32(start - params["temp"]))
    temp = params.get("temp")
    return float(f32(1.0 if temp is None else temp))
