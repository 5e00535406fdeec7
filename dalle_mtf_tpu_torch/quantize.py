"""Decode-time weight transforms (port of ``dalle_mtf_tpu/quantize.py``).

- ``cast_decode_weights``: unquantized serving casts the fp32 masters to the
  compute dtype once.
- ``quantize_layers_int8`` / ``quantize_layers_int4``: the big per-layer
  matrices and the output projection as int8, or as int4 packed two per
  byte, with per-output-column fp32 scales (max-abs / qmax over the
  contraction axes). Decoding streams every weight once per token, so the
  weight bytes are what these cut: int8 halves the bf16 stream, int4 halves
  it again.

The quantized tree keeps the JAX tree's keys, so it crosses between the two
packages as it is (utils/convert.py): ``<name>_scale`` fp32 leaves with
keepdims shapes, ``<name>_int4`` int8 marker leaves of shape [L] for int4
layer weights, and ``w_out_int4`` a 0-d marker. Given the same fp32
parameters the int8/int4 values and scales equal the JAX package's bit for
bit: ``torch.round`` and ``jnp.round`` both round half to even, and the fp32
divisions are IEEE on both sides.

Int4 packing is split-half along the first contraction axis: byte r holds
(q[r], q[r + n/2]) in its (low, high) nibbles, so the consuming matmul is
two matmuls against same-shape nibble views (``nibble_views``), or one
streaming kernel that splits each byte in registers (ops/decode_matmul.py).

On a tensor-parallel mesh the quantizers take a rank's blocks and the
model's ``Sharding`` and quantize after sharding, as the JAX CLIs do: where
a leaf's contraction axis is split (``wo`` over the heads, ``w_mlp2`` over
the MLP's width), each column's max is taken over the whole axis (a MAX
all_reduce over the model group, GSPMD's reduction in JAX), so a rank's
scales are the single process's columns bit for bit. A rank packs int4
along its own block of the contraction axis, split-half, so the packed
rows pair the rank's own halves of x: the products stay exact, only the
order of the fp32 sum changes.
"""

from __future__ import annotations

import torch

from dalle_mtf_tpu_torch.parallel.tensor import all_reduce


def cast_decode_weights(params: dict, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Serving-path transform for unquantized decoding: cast the fp32 master
    matrices (ndim >= 2) to the compute dtype once, so the per-token decode
    loop streams bf16 weights and never converts. 1D params (biases, LN
    gains) stay fp32. Returns a new tree; the input is not modified."""
    out = {}
    for name, v in params.items():
        if isinstance(v, dict):
            out[name] = cast_decode_weights(v, dtype)
        elif v.dtype == torch.float32 and v.dim() >= 2:
            out[name] = v.to(dtype)
        else:
            out[name] = v
    return out


# contraction axes per weight (leading axis is the layer stack L)
_SPECS = {
    "wq": (1,),       # [L, E, H, D], contract E
    "wk": (1,),
    "wv": (1,),
    "wo": (1, 2),     # [L, H, D, E], contract H, D
    "w_mlp1": (1,),   # [L, E, I]
    "w_mlp2": (1,),   # [L, I, E]
}

# int4 packing axis per weight: the FIRST contraction axis (indices include
# the leading [L]); packing along a contraction axis keeps int8's
# per-output-column scale layout
_PACK_AXIS = {
    "wq": 1,       # [L, E, H, D]
    "wk": 1,
    "wv": 1,
    "wo": 2,       # [L, H, D, E]: D is even (head_dim), H may be odd
    "w_mlp1": 1,   # [L, E, I]
    "w_mlp2": 1,   # [L, I, E]
}


def _quantize_one(w: torch.Tensor, axes, qmax: float, group=None):
    """(int8 values, fp32 scale) with per-output-column scale = max-abs /
    qmax over the contraction ``axes`` (keepdims); with ``group``, the max
    over every rank's block of a split contraction axis."""
    w = w.float()
    amax = w.abs().amax(dim=axes, keepdim=True)
    if group is not None:
        amax = all_reduce(amax, group, torch.distributed.ReduceOp.MAX)
    scale = amax / qmax
    scale = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def _group(sharding, name: str, axes):
    """The model group where layer weight ``name``'s contraction ``axes``
    hold its split dim, else None."""
    split = sharding.of(("layers", name)) if sharding is not None else None
    return sharding.group if split is not None and split.dim in axes else None


def quantize_layers_int8(params: dict, sharding=None) -> dict:
    """A copy of ``params`` with the big layer weights and the output
    projection in int8, plus a per-output-column ``<name>_scale`` fp32; a
    rank's blocks with the model's ``sharding`` (see the module
    docstring)."""
    layers = dict(params["layers"])
    for name, axes in _SPECS.items():
        layers[name], layers[name + "_scale"] = _quantize_one(
            layers[name], axes, 127.0, _group(sharding, name, axes))
    out = dict(params)
    out["layers"] = layers
    out["w_out"], out["w_out_scale"] = _quantize_one(params["w_out"], (0,), 127.0)
    return out


def pack_int4(q: torch.Tensor, axis: int) -> torch.Tensor:
    """Pack int8 values in [-8, 7] two per byte along ``axis`` (even-sized),
    split-half: byte r holds (q[r], q[r + n/2]) as (low, high) nibbles."""
    n = q.shape[axis]
    if n % 2:
        raise ValueError(f"pack_int4: axis {axis} of {tuple(q.shape)} is odd")
    lo, hi = q.int().split(n // 2, dim=axis)
    byte = (lo & 0xF) | ((hi & 0xF) << 4)  # 0..255
    return torch.where(byte >= 128, byte - 256, byte).to(torch.int8)


def nibble_views(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) int8 nibbles of the packed bytes, sign-extended in 32-bit
    arithmetic: ``(p << 28) >> 28`` and ``p >> 4``, as the kernels do."""
    p = packed.int()
    return ((p << 28) >> 28).to(torch.int8), (p >> 4).to(torch.int8)


def unpack_int4(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of ``pack_int4``: the int8 values, materialized."""
    return torch.cat(nibble_views(packed), dim=axis)


def quantize_layers_int4(params: dict, sharding=None) -> dict:
    """A copy of ``params`` with the big layer weights and the output
    projection packed int4 (split-half along the contraction axis), scales
    max-abs / 7 under ``<name>_scale``, and ``<name>_int4`` markers; a
    rank's blocks with the model's ``sharding`` (see the module
    docstring)."""
    layers = dict(params["layers"])
    for name, axes in _SPECS.items():
        q, scale = _quantize_one(layers[name], axes, 7.0, _group(sharding, name, axes))
        layers[name] = pack_int4(q, _PACK_AXIS[name])
        layers[name + "_scale"] = scale
        # presence marker, stacked [L] like the layer weights
        layers[name + "_int4"] = torch.ones((q.shape[0],), dtype=torch.int8, device=q.device)
    out = dict(params)
    out["layers"] = layers
    q, out["w_out_scale"] = _quantize_one(params["w_out"], (0,), 7.0)
    out["w_out"] = pack_int4(q, 0)
    out["w_out_int4"] = torch.ones((), dtype=torch.int8, device=q.device)
    return out


def quantized_shapes(shapes: dict, mode: str) -> dict:
    """The shapes of the tree ``quantize_layers_<mode>`` makes from a tree
    of ``shapes`` (packed int4 axes halved, scale and marker leaves added)."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"quantize mode must be int8 or int4, got {mode!r}")
    int4 = mode == "int4"
    layers = dict(shapes["layers"])
    for name, axes in _SPECS.items():
        shape = layers[name]
        layers[name + "_scale"] = tuple(1 if i in axes else n for i, n in enumerate(shape))
        if int4:
            axis = _PACK_AXIS[name]
            layers[name] = shape[:axis] + (shape[axis] // 2,) + shape[axis + 1:]
            layers[name + "_int4"] = shape[:1]
    e, v = shapes["w_out"]
    out = dict(shapes, layers=layers, w_out_scale=(1, v))
    if int4:
        out.update(w_out=(e // 2, v), w_out_int4=())
    return out
