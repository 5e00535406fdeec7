"""The port's attention (dalle_mtf_tpu_torch/ops/attention.py) against the
JAX package: prefill attention against the Pallas wedge kernel in interpret
mode (output and lse) and against the XLA reference, decode attention against
JAX's. On the CPU the port runs its plain version; the CUDA kernel is held
against it on the card (the last test here, and chip_smoke.py).

Tolerance: fp32 atol 2e-5 — the same math summed in another order, on
unit-scale scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.ops import attention as jattn
from dalle_mtf_tpu_torch.ops import attention as tattn

ATOL = 2e-5


def _qkv(b, h, s, d, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal((b, h, s, d)) * scale).astype(np.float32)
        for _ in range(3)
    ]


@pytest.mark.parametrize("s", [200, 256])
@pytest.mark.parametrize("window", [None, 64])
def test_causal_attention_matches_jax_wedge_kernel(s, window):
    q, k, v = _qkv(1, 2, s, 128, seed=s + (window or 0))
    want, want_lse = jattn._wedge_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        interpret=True, with_lse=True,
    )
    want_lse = np.asarray(want_lse)[:, :s, 0]  # lane-replicated, padded
    ref = np.asarray(jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, window
    ))
    got, got_lse = tattn.causal_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), window=window, with_lse=True
    )
    assert got.shape == (1, 2, s, 128) and got_lse.shape == (2, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("position", [0, 7, 15])
def test_decode_attention_matches_jax(position, window):
    rng = np.random.default_rng(position)
    q = rng.standard_normal((2, 2, 1, 64)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 2, 16, 64)).astype(np.float32)
              for _ in range(2))
    want = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(position), window=window,
    )
    got = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        position, window=window,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_causal_attention_refuses_what_it_cannot_run():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 64, seed=0))
    with pytest.raises(NotImplementedError):
        tattn.causal_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError):
        tattn.causal_attention(q, k, v, window=0)
    meta = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        tattn.causal_attention(meta, meta, meta)


def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against attention_reference on the card:
    fp32 atol 1e-5; bf16 max-abs-err <= 1e-2 on unit-scale inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    before = tattn.KERNEL_LAUNCHES["causal_attention_fwd"]
    for (b, h, s, d, dtype, window, atol) in [
        (2, 2, 256, 128, torch.bfloat16, None, 1e-2),
        (1, 2, 200, 64, torch.float32, 64, 1e-5),
        (1, 1, 1280, 128, torch.bfloat16, None, 1e-2),
    ]:
        q, k, v = (torch.from_numpy(a).to("cuda", dtype)
                   for a in _qkv(b, h, s, d, seed=s))
        got, lse = tattn.causal_attention(q, k, v, window=window, with_lse=True)
        want, want_lse = tattn.attention_reference(
            q, k, v, True, window, with_lse=True
        )
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= atol
        assert (lse - want_lse).abs().max().item() <= 1e-4
    assert tattn.KERNEL_LAUNCHES["causal_attention_fwd"] == before + 3
