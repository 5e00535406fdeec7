"""Losses (port of ``dalle_mtf_tpu/ops/losses.py``, the DALLE loss)."""

from __future__ import annotations

import torch


def softmax_cross_entropy_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Per-position cross entropy of integer ``targets`` under ``logits``.

    logits: [..., vocab] in any float dtype; targets: integer [...]. Returns
    fp32 [...]. The target logit is gathered in the logits' own dtype and
    only the [...] result is upcast (conversion commutes with the gather, so
    the loss bits are those of upcast-then-gather); the log-partition runs
    in fp32. ``z_loss`` adds z_loss * log(Z)^2, as mtf's xent does.
    """
    target_logits = torch.gather(logits, -1, targets[..., None].long())[..., 0].float()
    log_z = torch.logsumexp(logits.float(), dim=-1)
    loss = log_z - target_logits
    if z_loss:
        loss = loss + z_loss * torch.square(log_z)
    return loss
