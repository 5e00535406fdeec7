"""The port's packed attention (dalle_mtf_tpu_torch/ops/attention_packed.py)
and hash dropout against the JAX package.

- The dropout bits (numpy and torch ``dropout_keep``) equal JAX's
  ``_dropout_keep`` bit for bit, seeds near 2^31 included.
- The plain packed forward and backward against the Pallas kernels
  ``_fused_forward``/``_fused_backward`` in interpret mode, given the same
  seed: out, lse, dq, dk, dv, with and without a window and dropout, in fp32
  and bf16.
- The autograd Function's CPU path against ``jax.grad`` of JAX's
  ``causal_attention_packed`` (interpret mode, the seed JAX draws).
- The [B, H, S, D] ``causal_attention`` with dropout against
  ``_wedge_forward`` in interpret mode.
On the card the CUDA kernels are held against the plain versions
(tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: fp32 atol 2e-6 (lse 4e-6): the same math summed in another
order on unit-scale inputs. bf16 atol 4e-3: one bf16 ulp of values below 1
(the two sides may round an output element to neighbouring bf16 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.ops import attention as jattn
from dalle_mtf_tpu.ops import attention_packed as jpacked
from dalle_mtf_tpu_torch.ops import attention as tattn
from dalle_mtf_tpu_torch.ops import attention_packed as tpacked

B, S, H, D = 1, 256, 2, 128
ATOL = {torch.float32: 2e-6, torch.bfloat16: 4e-3}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(dtype, seed, n=4, shape=(B, S, H * D)):
    """n unit-scale arrays made from a seed, rounded to ``dtype`` once and
    handed to both packages."""
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32)).astype(JDT[dtype])
            for _ in range(n)]
    return arrs, [torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("seed", [0, 1, 977, 2**31 - 2, 2**31 - 100])
def test_dropout_bits_match_jax(seed):
    rows = np.arange(0, 700, 3)[:, None]
    cols = np.arange(0, 1300, 7)[None, :]
    for rate in (0.1, 0.5):
        # the seed + program index wraps in int32 exactly as the kernels add it
        for prog in (0, 5, 127):
            s32 = np.array(seed + prog, np.int64).astype(np.uint32).astype(np.int32)
            want = np.asarray(jattn._dropout_keep(
                jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
                jnp.asarray(s32), rate))
            got_np = tattn.dropout_keep_numpy(rows, cols, seed + prog, rate)
            got_t = tattn.dropout_keep(torch.from_numpy(rows), torch.from_numpy(cols),
                                       seed + prog, rate).numpy()
            np.testing.assert_array_equal(got_np, want)
            np.testing.assert_array_equal(got_t, want)
            assert abs(want.mean() - (1 - rate)) < 0.02


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,rate", [(None, 0.0), (None, 0.1), (64, 0.0), (64, 0.1)])
def test_plain_packed_matches_pallas_interpret(dtype, window, rate):
    seed = 2**31 - 5
    (jq, jk, jv, jg), (q, k, v, g) = _inputs(dtype, seed=(window or 0) + int(rate * 10))
    jseed = jnp.full((1, 1), seed, jnp.int32)
    jout, jlse = jpacked._fused_forward(jq, jk, jv, H, window, True, with_lse=True,
                                        dropout_rate=rate, dropout_seed=jseed)
    jdq, jdk, jdv = jpacked._fused_backward(jq, jk, jv, jout, jlse, jg, H, window, True,
                                            dropout_rate=rate, dropout_seed=jseed)
    out, lse = tpacked.attention_packed_reference(q, k, v, H, window, rate, seed, with_lse=True)
    atol = ATOL[dtype]
    np.testing.assert_allclose(_np(out), _np(jout), atol=atol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0, :S], atol=4e-6)
    # the backward from JAX's own out and lse, so only the backward differs
    dq, dk, dv = tpacked.backward_reference(
        q, k, v, torch.from_numpy(_np(jout)).to(dtype),
        torch.from_numpy(np.asarray(jlse)[:, 0, :S].copy()), g, H, window, rate, seed)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        assert got.dtype == dtype and got.shape == (B, S, H * D)
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, err_msg=name)


@pytest.mark.parametrize("window", [None, 48])
def test_autograd_function_matches_jax_grad(window):
    """Function on the CPU (plain forward + plain backward) against jax.grad
    of causal_attention_packed running the Pallas kernels in interpret mode,
    bf16 with dropout 0.1 on the seed JAX draws from its key."""
    rate = 0.1
    key = jax.random.PRNGKey(11)
    (jq, jk, jv, jw), (q, k, v, w) = _inputs(torch.bfloat16, seed=5)
    jseed = int(jax.random.randint(key, (1, 1), 0, jnp.iinfo(jnp.int32).max,
                                   dtype=jnp.int32)[0, 0])

    def jloss(q_, k_, v_):
        out = jpacked.causal_attention_packed(q_, k_, v_, H, window=window, interpret=True,
                                              dropout_rate=rate, dropout_rng=key)
        return jnp.sum(out.astype(jnp.float32) * jw.astype(jnp.float32)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = tpacked.packed_attention(q, k, v, H, window, rate, jseed)
    (out.float() * w.float()).sum().backward()
    np.testing.assert_allclose(_np(out), _np(jout), atol=4e-3)
    for name, t, want in zip("qkv", (q, k, v), jgrads):
        np.testing.assert_allclose(_np(t.grad), _np(want), atol=4e-3, err_msg=f"d{name}")


def test_unpacked_causal_attention_dropout_matches_jax_wedge():
    (jq, jk, jv), (q, k, v) = _inputs(torch.float32, seed=3, n=3, shape=(1, 2, 200, 128))
    seed = 123456789
    want, want_lse = jattn._wedge_forward(
        jq, jk, jv, window=64, interpret=True, with_lse=True, dropout_rate=0.1,
        dropout_seed=jnp.full((1, 1), seed, jnp.int32))
    got, lse = tattn.causal_attention(q, k, v, window=64, dropout_rate=0.1, with_lse=True,
                                      dropout_seed=seed)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :200, 0], atol=4e-6)


def test_packed_attention_refuses_bad_inputs():
    q = torch.zeros((1, 8, 6))
    with pytest.raises(ValueError):
        tpacked.packed_attention(q, q, q, n_heads=4)  # 6 columns, 4 heads
    with pytest.raises(ValueError):
        tpacked.packed_attention(q, q, q, n_heads=2, window=0)
    meta = torch.empty((1, 8, 256), device="meta")
    with pytest.raises(ValueError, match="device"):
        tpacked.packed_attention(meta, meta, meta, n_heads=2)


def test_dsum_rows_is_contiguous_per_head_rowsum():
    """dsum = rowsum(dO * O) per head as contiguous fp32 [B*H, S] (the
    kernel reads it flat), at B=1 too, where a reshape would stay a view."""
    (_, _), (out, g) = _inputs(torch.bfloat16, seed=9, n=2)
    dsum = tpacked.dsum_rows(out, g, H)
    assert dsum.is_contiguous() and dsum.dtype == torch.float32 and dsum.shape == (B * H, S)
    want = (g.float() * out.float()).reshape(B, S, H, D).sum(-1).permute(0, 2, 1)
    torch.testing.assert_close(dsum, want.reshape(B * H, S), rtol=0, atol=0)
