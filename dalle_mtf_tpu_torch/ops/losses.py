"""Losses (port of ``dalle_mtf_tpu/ops/losses.py``): the DALLE cross
entropy, the VAE's reconstruction MSE and its eval feature distance."""

from __future__ import annotations

import torch
import torch.distributed as dist

from dalle_mtf_tpu_torch.parallel.tensor import all_reduce, reduce_from_model


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


def vocab_parallel_cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    v0: int,
    group,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """``softmax_cross_entropy_with_logits`` with the vocabulary split over
    the process group ``group``: ``logits`` [..., n] are this rank's columns
    [v0, v0 + n). The max is all_reduced with MAX, the fp32 sum-exp and the
    target logit (this rank's where the target is its column, else 0) with
    SUM (one collective, identity backward), so every rank holds the whole
    loss and each backpropagates into its own columns. As one process: the
    target logit gathered in the logits' dtype, the log-partition in fp32."""
    rel = targets.long() - v0
    n = logits.shape[-1]
    mine = (rel >= 0) & (rel < n)
    tgt = torch.gather(logits, -1, rel.clamp(0, n - 1)[..., None])[..., 0].float()
    lf = logits.float()
    m = all_reduce(lf.detach().amax(dim=-1), group, dist.ReduceOp.MAX)
    sums = reduce_from_model(torch.stack([torch.exp(lf - m[..., None]).sum(-1),
                                          torch.where(mine, tgt, 0.0)]), group)
    log_z = m + torch.log(sums[0])
    loss = log_z - sums[1]
    if z_loss:
        loss = loss + z_loss * torch.square(log_z)
    return loss


def mse_loss(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error (reference src/vae_tf/layers.py:24-25)."""
    return torch.mean(torch.square(prediction - target))


def frechet_feature_distance(
    feats_a: torch.Tensor, feats_b: torch.Tensor, eps: float = 1e-6, group=None,
    replicas: int = 1,
) -> torch.Tensor:
    """Diagonal-covariance Fréchet distance between two [N, C] feature
    batches, in fp32: the FID recipe with a per-channel variance (well posed
    for one eval batch, N << C) in the VAE's own encoder feature space.

        d = |mu_a - mu_b|^2 + sum(var_a + var_b - 2*sqrt(max(var_a*var_b, eps^2)))

    with the population variance (ddof 0, as ``jnp.var``). With ``group``
    (``replicas`` ranks, each holding its rows of the batch) the means and
    variances are the whole batch's, in two passes as one process takes
    them: the sums over the rows all_reduced, then the squared deviations
    from the global means; every rank returns the same distance."""
    fa, fb = feats_a.float(), feats_b.float()
    if replicas > 1:
        n = fa.shape[0] * replicas
        mu_a, mu_b = all_reduce(torch.stack([fa.sum(0), fb.sum(0)]), group) / n
        va, vb = all_reduce(torch.stack([torch.square(fa - mu_a).sum(0),
                                         torch.square(fb - mu_b).sum(0)]), group) / n
    else:
        mu_a, mu_b = fa.mean(0), fb.mean(0)
        va, vb = fa.var(0, unbiased=False), fb.var(0, unbiased=False)
    cov_term = va + vb - 2.0 * torch.sqrt(torch.clamp_min(va * vb, eps * eps))
    return torch.sum(torch.square(mu_a - mu_b)) + torch.sum(cov_term)
