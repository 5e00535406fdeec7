"""Mixed-precision policy (port of ``dalle_mtf_tpu/utils/precision.py``).

Three roles, as in the JAX package: fp32 master weights, bf16 or fp32
activations and matmul inputs, fp32 logits and losses.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Three-dtype precision policy (master / compute / output)."""

    master_dtype: torch.dtype  # parameter storage + optimizer math
    compute_dtype: torch.dtype  # activations and matmul inputs
    output_dtype: torch.dtype  # logits / losses / gradients


def get_policy(bf_16: bool | None) -> Policy:
    """The reference's ``get_variable_dtype(bf_16)`` (src/dalle_mtf/ops.py:76-82)."""
    compute = torch.bfloat16 if bf_16 else torch.float32
    return Policy(
        master_dtype=torch.float32,
        compute_dtype=compute,
        output_dtype=torch.float32,
    )
