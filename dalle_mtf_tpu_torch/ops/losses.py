"""Losses (port of ``dalle_mtf_tpu/ops/losses.py``): the DALLE cross
entropy, the VAE's reconstruction MSE and its eval feature distance."""

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


def mse_loss(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error (reference src/vae_tf/layers.py:24-25)."""
    return torch.mean(torch.square(prediction - target))


def frechet_feature_distance(
    feats_a: torch.Tensor, feats_b: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Diagonal-covariance Fréchet distance between two [N, C] feature
    batches, in fp32: the FID recipe with a per-channel variance (well posed
    for one eval batch, N << C) in the VAE's own encoder feature space.

        d = |mu_a - mu_b|^2 + sum(var_a + var_b - 2*sqrt(max(var_a*var_b, eps^2)))

    with the population variance (ddof 0, as ``jnp.var``)."""
    fa, fb = feats_a.float(), feats_b.float()
    mu_a, mu_b = fa.mean(0), fb.mean(0)
    va, vb = fa.var(0, unbiased=False), fb.var(0, unbiased=False)
    cov_term = va + vb - 2.0 * torch.sqrt(torch.clamp_min(va * vb, eps * eps))
    return torch.sum(torch.square(mu_a - mu_b)) + torch.sum(cov_term)
