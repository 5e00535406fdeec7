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
    with pytest.raises(ValueError, match="dropout_seed"):
        tattn.causal_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError):
        tattn.causal_attention(q, k, v, window=0)
    meta = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        tattn.causal_attention(meta, meta, meta)


@pytest.mark.parametrize("d", [32, 64, 96, 128, 256, 384])
def test_kernel_takes_head_dim_is_the_references_rule(d):
    """``kernel_takes_head_dim`` names the head dims the model sends to the
    kernels: the dims they are built for (64, 128) and every D % 128 == 0,
    where the JAX package runs its Pallas kernels (a D there with no kernel
    yet raises on the card). At any other D the model takes the plain
    version, which computes what the JAX package's dense reference does."""
    assert tattn.kernel_takes_head_dim(d) == (d in (64, 128) or d % 128 == 0)
    if tattn.kernel_takes_head_dim(d):
        return
    q, k, v = _qkv(1, 2, 40, d, seed=d)
    want = np.asarray(jattn.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             window=16))
    got = tattn.attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), window=16)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _through(y, names) -> set[str]:
    """The names among ``names`` of the autograd Functions in y's graph."""
    todo, seen, found = [y.grad_fn], set(), set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        found |= {n for n in names if type(fn).__name__ == n + "Backward"}
        todo.extend(f for f, _ in fn.next_functions)
    return found


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("n_embd,heads", [(192, 2), (256, 4)])
def test_model_attention_follows_the_references_rule(packed, n_embd, heads):
    """A 2-layer fp32 DALLE on weights carried across by utils/convert.py:
    at head dim 96 (D % 128 != 0) its attention is the plain version under
    autograd, no kernel Function in its graph (on the card too); at 64 the
    kernels' Function (their plain pair here); either way, packed or not,
    its loss and every grad match the JAX model's (loss within 1e-5, grads
    within 1e-4 of each leaf's max)."""
    import jax

    from dalle_mtf_tpu.models import dalle as jdalle
    from dalle_mtf_tpu_torch.models import dalle as tdalle
    from dalle_mtf_tpu_torch.utils import convert

    kw = dict(n_embd=n_embd, text_vocab_size=40, image_vocab_size=32, text_seq_len=8,
              image_seq_len=16, n_layers=2, n_heads=heads, attn_packed=packed)
    jm = jdalle.DALLE(jdalle.DalleConfig(**kw))
    tm = tdalle.DALLE(tdalle.DalleConfig(**kw), "cpu")
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, jm.cfg.total_tokens,
                                               (2, jm.cfg.total_seq_len))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(tokens, jnp.int32), train=True),
        has_aux=True)(jparams)
    tparams = convert.dalle_params_from_numpy(jparams, tm)
    for _, t in convert._flatten(tparams, ""):
        t.requires_grad_(True)
    tloss, _ = tm.loss(tparams, torch.from_numpy(tokens), train=True)
    kernels = _through(tloss, ("_Attention", "_PackedAttention"))
    if tattn.kernel_takes_head_dim(n_embd // heads):
        assert kernels == {"_PackedAttention" if packed else "_Attention"}
    else:
        assert not kernels
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= 1e-5
    want = dict(convert._flatten(jax.device_get(jgrads), ""))
    got = dict(convert._flatten(convert.grads_to_numpy(tparams), ""))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-4 * np.abs(w).max() + 1e-9,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_for_kernels_copies_only_views_off_16_bytes(dtype):
    """Inputs that keep the 16-byte rule (dense and aligned, or strided
    views of one fused tensor with whole 16-byte strides) pass unchanged; a
    view that starts off 16 bytes is copied once into a fresh dense tensor,
    with the others made dense beside it so all share one layout; the
    values never change."""
    elem = torch.finfo(dtype).bits // 8
    dense = torch.rand(2, 8, 64).to(dtype)
    fused = torch.rand(2, 8, 3 * 64).to(dtype)
    q, k = fused[..., :64], fused[..., 64:128]
    assert not q.is_contiguous()
    assert all(a is b for a, b in zip(tattn.dense_for_kernels(dense, q, k), (dense, q, k)))
    off = torch.rand(2 * 8 * 64 + 1).to(dtype)[1:].view(2, 8, 64)
    assert off.data_ptr() % 16 and off.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.check_kernel_inputs("causal_attention_fwd", (off,), 64)
    out = tattn.dense_for_kernels(dense, off, q)
    assert out[0] is dense
    for got, want in zip(out, (dense, off, q)):
        assert got.is_contiguous() and got.data_ptr() % 16 == 0 and torch.equal(got, want)
    tattn.check_kernel_inputs("causal_attention_fwd", out, 64)
    aligned = torch.rand(2 * 8 * 64 + 16 // elem).to(dtype)[16 // elem:].view(2, 8, 64)
    assert tattn.dense_for_kernels(aligned)[0] is aligned


@pytest.mark.cuda
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
