"""Gumbel-softmax with the straight-through estimator (port of
``dalle_mtf_tpu/ops/gumbel.py``).

Logits are cast to fp32, the Gumbel noise is ``-log(-log(u))`` with u
uniform in [1e-9, 1), the softmax is taken over ``(logits + g) /
temperature``, and the hard path is the straight-through
``(one_hot - soft).detach() + soft``. The uniform draw is its own function,
``gumbel_uniform``, from the caller's generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SMOL = 1e-9  # the draw's lower end: log(0) never occurs


def gumbel_uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """fp32 uniform in [1e-9, 1) of ``shape`` on ``device``, drawn from
    ``generator`` where it lives on that device, else from a generator of
    that device seeded from it (one draw, no host-to-device copy of the
    noise). ``torch.rand`` gives [0, 1); the affine map keeps it below 1
    and lifts 0 to 1e-9."""
    device = torch.device(device)
    if generator.device.type != device.type:
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
        generator = torch.Generator(device=device).manual_seed(seed)
    r = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return SMOL + (1.0 - SMOL) * r


def gumbel_softmax(
    generator: torch.Generator,
    logits: torch.Tensor,
    temperature: float | torch.Tensor = 1.0,
    hard: bool = True,
    dim: int = -1,
) -> torch.Tensor:
    """A Gumbel-softmax sample over ``dim`` of ``logits`` (fp32); with
    ``hard`` the one-hot of its argmax carrying the soft sample's gradient."""
    logits = logits.float()
    u = gumbel_uniform(logits.shape, generator, logits.device)
    g = -torch.log(-torch.log(u))
    sample = torch.softmax((logits + g) / temperature, dim=dim)
    if hard:
        idx = sample.argmax(dim=dim)
        one_hot = F.one_hot(idx, sample.shape[dim]).to(sample.dtype).movedim(-1, dim)
        sample = (one_hot - sample).detach() + sample
    return sample
