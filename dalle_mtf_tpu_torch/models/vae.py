"""Discrete VAE, decoder half (port of ``dalle_mtf_tpu/models/vae.py``):
tokens -> pixels, the last stage of serving.

Public functions take and return NHWC, and parameters keep the JAX tree's
names and HWIO conv kernels (``decoder/block_0/up/w [kh, kw, cin, cout]``);
inside, activations run NCHW and kernels are permuted per call. The encoder
arrives with VAE training.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle_mtf_tpu_torch.utils.precision import Policy, get_policy


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    num_tokens: int
    image_size: int
    convblocks: tuple[tuple[int, int], ...]
    n_channels: int = 3
    stack_factor: int = 1
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


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """TF/XLA "SAME" padding (low, high) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, p, stride=1, compute_dtype=None):
    """NCHW x, HWIO kernel, "SAME" padding (jax.lax.conv_general_dilated)."""
    dtype = compute_dtype or x.dtype
    w = p["w"].to(dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    kh, kw = w.shape[-2:]
    ph = _same_pads(x.shape[-2], kh, stride)
    pw = _same_pads(x.shape[-1], kw, stride)
    x = F.pad(x.to(dtype), (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride) + p["b"].to(dtype)[:, None, None]


def _conv_transpose(x, p, stride=2, compute_dtype=None):
    """jax.lax.conv_transpose(..., padding="SAME") with the HWIO kernel and
    transpose_kernel=False, for the VAE's k=4, s=2: a correlation over the
    input dilated by 2 and padded (2, 2), kernel NOT flipped
    (jax._src.lax.convolution._conv_transpose_padding). torch's
    conv_transpose2d is the adjoint of a correlation, so the same map is
    its [cin, cout, kh, kw] kernel flipped in space, with padding 1."""
    dtype = compute_dtype or x.dtype
    kh = p["w"].shape[0]
    if (kh, stride) != (4, 2):
        raise NotImplementedError("only the VAE's k=4, stride=2 up-conv is ported")
    w = p["w"].to(dtype).permute(2, 3, 0, 1).flip(-1, -2)
    out = F.conv_transpose2d(x.to(dtype), w, stride=2, padding=1)
    return out + p["b"].to(dtype)[:, None, None]


def depth_to_space(x, factor: int):
    """NHWC [B, H, W, C*f*f] -> [B, H*f, W*f, C] (JAX layout)."""
    b, h, w, c = x.shape
    c_out = c // (factor * factor)
    x = x.reshape(b, h, w, factor, factor, c_out)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * factor, w * factor, c_out)


def _glorot_uniform(shape, generator):
    """jax.nn.initializers.glorot_uniform: in axis -2, out axis -1, the
    rest is the receptive field."""
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (2.0 * u - 1.0) * limit


class DiscreteVAE(nn.Module):
    """Decoder computation over an explicit parameter tree (see DALLE)."""

    def __init__(self, config: VAEConfig, device: torch.device | str = "cpu"):
        super().__init__()
        self.cfg = config
        self.device = torch.device(device)

    def param_shapes(self) -> dict:
        """Shapes of the tree the serving path reads: the codebook and the
        decoder (the JAX tree also holds ``encoder``)."""
        cfg = self.cfg

        def conv(k, cin, cout):
            return {"w": (k, k, cin, cout), "b": (cout,)}

        dec: dict = {}
        cin = cfg.n_hid
        for b, (stack, channels) in enumerate(reversed(cfg.convblocks)):
            blk = {"up": conv(4, cin, channels)}
            for i in range(1, stack):
                blk[f"res_{i}"] = {
                    "conv_in": conv(3, channels, channels),
                    "conv_out": conv(3, channels, channels),
                }
            dec[f"block_{b}"] = blk
            cin = channels
        dec["final"] = conv(1, cin, cfg.n_channels * cfg.stack_factor ** 2)
        return {"codebook": (cfg.n_hid, cfg.num_tokens), "decoder": dec}

    def init(self, generator: torch.Generator) -> dict:
        """Glorot-uniform kernels and codebook, zero biases (vae.py:150-184,
        the TF1 conv2d defaults), drawn on ``generator``'s device and moved
        to ``self.device``."""

        def make(tree):
            out = {}
            for name, v in tree.items():
                if isinstance(v, dict):
                    out[name] = make(v)
                elif name == "b":
                    out[name] = torch.zeros(v, device=self.device)
                else:
                    out[name] = _glorot_uniform(v, generator).to(self.device)
            return out

        return make(self.param_shapes())

    def _res_block(self, p, x, compute_dtype):
        out = F.relu(_conv(x, p["conv_in"], 1, compute_dtype))
        return x + _conv(out, p["conv_out"], 1, compute_dtype)

    def decoder(self, params, one_hot):
        """Token distribution [B, h, w, num_tokens] -> image [B, H, W, C]
        fp32 (vae_tf/models.py:123-163: codebook^T matmul in fp32, mirrored
        transpose-conv stacks, final 1x1 conv, depth_to_space)."""
        cfg = self.cfg
        dtype = cfg.policy.compute_dtype
        x = torch.einsum("bhwt,ct->bhwc", one_hot.float(), params["codebook"].float())
        x = x.to(dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for b, (stack, _channels) in enumerate(reversed(cfg.convblocks)):
            blk = params["decoder"][f"block_{b}"]
            x = _conv_transpose(x, blk["up"], 2, dtype)
            for i in range(1, stack):
                x = self._res_block(blk[f"res_{i}"], x, dtype)
        x = _conv(x, params["decoder"]["final"], 1, dtype)
        x = x.float().permute(0, 2, 3, 1)  # NCHW -> NHWC
        if cfg.stack_factor > 1:
            x = depth_to_space(x, cfg.stack_factor)
        return x

    def decode_tokens(self, params, tokens):
        """Token ids [B, image_seq_len] -> images [B, H, W, C] in [0, 1]."""
        g = self.cfg.grid_size
        b = tokens.shape[0]
        one_hot = F.one_hot(
            tokens.reshape(b, g, g).long(), self.cfg.num_tokens
        ).float()
        return (self.decoder(params, one_hot) + 1.0) / 2.0
