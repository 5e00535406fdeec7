"""The port's Gumbel-softmax (dalle_mtf_tpu_torch/ops/gumbel.py) against the
JAX package's, on the CPU: the same uniform draw ``u`` goes through both
(``jax.random.uniform`` and the port's ``gumbel_uniform`` patched to return
it), so the soft and hard samples and their straight-through gradients are
held at fp32 rounding (atol 1e-6, the gradients 1e-6 of max(1, max |grad|):
at temperature 0.2 they are 5x the softmax's). The port's own draw is held to its
distribution: the argmax frequencies of the Gumbel sample against
softmax(logits), a chi-square test at a fixed seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from dalle_mtf_tpu.ops import gumbel as jgumbel
from dalle_mtf_tpu_torch.ops import gumbel as tgumbel


def _inputs(shape=(2, 3, 4, 16), seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape).astype(np.float32) * 2.0
    u = rng.uniform(1e-9, 1.0, shape).astype(np.float32)
    weights = rng.standard_normal(shape).astype(np.float32)
    return logits, u, weights


def same_u(monkeypatch, u):
    """Both packages draw ``u``."""
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(u))
    monkeypatch.setattr(tgumbel, "gumbel_uniform",
                        lambda shape, generator, device: torch.from_numpy(u).to(device))


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("temperature", [1.0, 0.2])
def test_gumbel_softmax_value_and_grad_match_jax(monkeypatch, hard, temperature):
    logits, u, weights = _inputs()
    same_u(monkeypatch, u)

    def jloss(x):
        s = jgumbel.gumbel_softmax(jax.random.PRNGKey(0), x, temperature, hard=hard)
        return jnp.sum(s * weights), s

    (_, want), want_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tgumbel.gumbel_softmax(torch.Generator(), x, temperature, hard=hard)
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(x.grad.numpy(), want_grad,
                               atol=1e-6 * max(1.0, np.abs(want_grad).max()))
    if hard:  # one-hot values, the soft sample's gradient
        assert set(np.unique(got.detach().numpy())) <= {0.0, 1.0}
        assert (got.detach().sum(-1) == 1).all()


def test_gumbel_softmax_over_another_dim(monkeypatch):
    logits, u, weights = _inputs((3, 8, 5))
    same_u(monkeypatch, u)
    want = jgumbel.gumbel_softmax(jax.random.PRNGKey(0), jnp.asarray(logits), 0.5,
                                  hard=True, axis=1)
    got = tgumbel.gumbel_softmax(torch.Generator(), torch.from_numpy(logits), 0.5,
                                 hard=True, dim=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_uniform_stays_in_range():
    """The draw's 24-bit integers map onto [1e-9, 1): 0 -> 1e-9 (log(0)
    never occurs) and the largest, 2^24 - 1, stays below 1."""
    u = tgumbel.uniform_from_bits(torch.tensor([0, 2**24 - 1]))
    assert u.dtype == torch.float32
    assert u[0].item() == pytest.approx(1e-9, rel=1e-6) and u[1].item() < 1.0
    u = tgumbel.gumbel_uniform((100_000,), torch.Generator().manual_seed(1), "cpu")
    assert u.min().item() >= 1e-9 and u.max().item() < 1.0
    g = -torch.log(-torch.log(u))
    assert torch.isfinite(g).all()


def test_gumbel_argmax_frequencies_follow_softmax():
    """The Gumbel-max trick: argmax(logits + g) is distributed as
    softmax(logits). 40,000 draws at a fixed seed over 8 classes; the
    chi-square statistic stays under the 0.999 quantile (7 dof)."""
    logits = torch.tensor([1.5, 0.3, -0.7, 0.0, 2.0, -1.5, 0.8, -0.2])
    n = 40_000
    sample = tgumbel.gumbel_softmax(torch.Generator().manual_seed(1234),
                                    logits.expand(n, -1), 1.0, hard=True)
    counts = sample.sum(0).numpy()
    expected = torch.softmax(logits, -1).numpy() * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < scipy.stats.chi2.ppf(0.999, df=7), (chi2, counts, expected)
    # a draw that ignored the noise (always the argmax) fails the statistic
    greedy = np.zeros(8)
    greedy[int(logits.argmax())] = n
    assert float(((greedy - expected) ** 2 / expected).sum()) > 1e3


def test_a_generator_repeats_its_draw():
    logits = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    a = tgumbel.gumbel_softmax(torch.Generator().manual_seed(7), logits, 0.5, hard=False)
    b = tgumbel.gumbel_softmax(torch.Generator().manual_seed(7), logits, 0.5, hard=False)
    c = tgumbel.gumbel_softmax(torch.Generator().manual_seed(8), logits, 0.5, hard=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
