"""Decode-time weight transforms (port of ``dalle_mtf_tpu/quantize.py``).

Only the unquantized serving transform is ported so far; int8 and packed
int4 decode weights, and the streaming dequant kernels they feed, come later.
"""

from __future__ import annotations

import torch


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
