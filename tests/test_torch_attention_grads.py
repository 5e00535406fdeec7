"""The port's [B, H, S, D] attention with gradients
(dalle_mtf_tpu_torch/ops/attention.py: ``causal_attention`` through its
autograd Function) against the JAX package's ``causal_attention`` running
the Pallas kernels in interpret mode, in each of the TPU's four regimes:

- wedge (``_wedge_fwd_kernel`` / ``_wedge_bwd_kernel``), with hash dropout
  on the seed JAX draws from its key;
- whole-row (``_wr_fwd_kernel`` / ``_wr_bwd_kernel``, ``SHORT_IMPL = "wr"``);
- the online-softmax loop (``_flash_kernel``, ``_bwd_dq_kernel`` +
  ``_bwd_dkv_kernel``, ``WHOLE_ROW_MAX_SEQ = 0``), fp32, ragged S included;
- the hybrid (the capped wedge forward and ``_hybrid_bwd_kernel``,
  ``WHOLE_ROW_MAX_SEQ = 128``, ``WEDGE_FWD_MAX_SEQ = 2560``, no tune table),
  bf16 at a ragged S.

The regimes are forced at small shapes by the dispatch thresholds, as
tests/test_ops.py does, and each test checks that JAX took the regime's
backward. On the CPU the port runs its plain forward and plain backward;
on the card the kernels are held against those (tests/test_torch_cuda.py,
chip_smoke.py).

Inputs are uniform in [-1, 1) from a numpy seed, rounded to the dtype once
and handed to both packages; the cotangent likewise. Tolerances: fp32
1e-5 of each output's largest |value| (the same math summed in another
order); bf16 one bf16 ulp of the largest |value| (the two sides may round
an element to neighbouring bf16 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.ops import attention as jattn
from dalle_mtf_tpu_torch.ops import attention as tattn

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
BACKWARDS = ("_wedge_backward", "_wr_backward", "_hybrid_backward", "_flash_backward")


@pytest.fixture
def regime(monkeypatch):
    """Set a regime's thresholds; returns the list of JAX backward wrappers
    that ran."""
    called = []
    for name in BACKWARDS:
        orig = getattr(jattn, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            called.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(jattn, name, spy)

    def setup(name):
        if name == "wr":
            monkeypatch.setattr(jattn, "SHORT_IMPL", "wr")
        elif name == "loop":
            monkeypatch.setattr(jattn, "WHOLE_ROW_MAX_SEQ", 0)
        elif name == "hybrid":
            monkeypatch.setattr(jattn, "WHOLE_ROW_MAX_SEQ", 128)
            monkeypatch.setattr(jattn, "WEDGE_FWD_MAX_SEQ", 2560)
            jattn.set_tune_table({})
        return called

    yield setup
    jattn.set_tune_table(None)


def _inputs(dtype, shape, seed, n=4):
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32)).astype(JDT[dtype])
            for _ in range(n)]
    return arrs, [torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _atol(dtype, want):
    top = float(np.abs(want).max())
    if dtype == torch.float32:
        return 1e-5 * top
    return 2.0 ** (np.floor(np.log2(top)) - 7)  # one bf16 ulp of the largest value


def _compare(dtype, b, h, s, window, rate, seed):
    """Value and q/k/v grads of both packages; returns nothing, asserts."""
    (jq, jk, jv, jg), (q, k, v, g) = _inputs(dtype, (b, h, s, 128), seed)
    key = jax.random.PRNGKey(seed)
    jseed = int(jax.random.randint(key, (1, 1), 0, jnp.iinfo(jnp.int32).max,
                                   dtype=jnp.int32)[0, 0])
    jout, vjp = jax.vjp(
        lambda q_, k_, v_: jattn.causal_attention(
            q_, k_, v_, window=window, use_pallas=True, interpret=True,
            dropout_rate=rate, dropout_rng=key if rate else None),
        jq, jk, jv)
    jgrads = vjp(jg)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = tattn.causal_attention(q, k, v, window=window, dropout_rate=rate,
                                 dropout_seed=jseed if rate else None)
    out.backward(g)
    assert out.dtype == dtype and out.shape == (b, h, s, 128)
    for name, got, want in (("out", out, jout), *zip(("dq", "dk", "dv"),
                                                     (q.grad, k.grad, v.grad), jgrads)):
        want = _np(want)
        assert got.dtype == dtype, name
        np.testing.assert_allclose(_np(got), want, atol=_atol(dtype, want), err_msg=name)


@pytest.mark.parametrize("dtype,window,rate", [
    (torch.float32, None, 0.0), (torch.float32, 64, 0.1),
    (torch.bfloat16, None, 0.1), (torch.bfloat16, 64, 0.0),
])
def test_wedge_regime_matches_jax(regime, dtype, window, rate):
    called = regime("wedge")
    _compare(dtype, 1, 2, 256, window, rate, seed=1 + (window or 0))
    assert called[-1] == "_wedge_backward"


@pytest.mark.parametrize("dtype,window", [(torch.float32, None), (torch.bfloat16, 64)])
def test_whole_row_regime_matches_jax(regime, dtype, window):
    called = regime("wr")
    _compare(dtype, 1, 2, 256, window, 0.0, seed=2)
    assert called == ["_flash_backward", "_wr_backward"]


@pytest.mark.parametrize("s,window", [(256, None), (320, 48)])
def test_loop_regime_matches_jax(regime, s, window):
    called = regime("loop")
    _compare(torch.float32, 1, 2, s, window, 0.0, seed=3)
    assert called == ["_flash_backward"]


@pytest.mark.parametrize("window", [None, 64])
def test_hybrid_regime_matches_jax(regime, window):
    called = regime("hybrid")
    _compare(torch.bfloat16, 2, 1, 320, window, 0.0, seed=4)
    assert called == ["_flash_backward", "_hybrid_backward"]


def test_cpu_backward_is_the_plain_backward():
    """On CPU tensors the Function's backward is
    ``attention_backward_reference`` on the forward's own out and lse, bit
    for bit, and that plain backward agrees with autograd through
    ``attention_reference``."""
    (_, _, _, _), (q, k, v, g) = _inputs(torch.float32, (1, 2, 96, 64), seed=5)
    out, lse = tattn.attention_reference(q, k, v, True, 40, with_lse=True)
    want = tattn.attention_backward_reference(q, k, v, out, lse, g, 40)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tattn.causal_attention(*leaves, window=40).backward(g)
    for got, w in zip(leaves, want):
        torch.testing.assert_close(got.grad, w, rtol=0, atol=0)
    auto = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tattn.attention_reference(*auto, True, 40).backward(g)
    for got, w in zip(auto, want):
        torch.testing.assert_close(got.grad, w, rtol=0, atol=2e-6)
