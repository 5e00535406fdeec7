"""The port's fused LayerNorm (dalle_mtf_tpu_torch/ops/layer_norm.py)
against the JAX package's ``layer_norm`` running the Pallas kernels
``_ln_fwd_kernel``/``_ln_bwd_kernel`` in interpret mode: y, and dx, dg, db
through ``jax.vjp``, in fp32 and bf16, at 300 rows (not a multiple of the
TPU kernel's 256-row block) by 256. On the CPU the port runs its plain
forward and plain backward; on the card the kernels are held against those
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: fp32 y and dx rtol 1e-5 of the largest |value| (the same math
summed in another order); bf16 y and dx one bf16 ulp of the largest |value|
(one rounding may land on a neighbouring bf16 value); dg, db rtol 1e-4
(fp32 sums over the rows in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu.ops import layer_norm as jln
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.ops import layer_norm as tln
from dalle_mtf_tpu_torch.utils import convert

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _atol(dtype, want):
    top = float(np.abs(want).max())
    if dtype == torch.float32:
        return 1e-5 * top
    return 2.0 ** (np.floor(np.log2(top)) - 7)


def _through_function(y) -> bool:
    """Whether y's graph holds the kernels' autograd Function."""
    todo, seen = [y.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == "_LayerNormBackward":
            return True
        todo.extend(f for f, _ in fn.next_functions)
    return False


def _inputs(dtype, rows, e, seed):
    """x (offset and scaled, so the mean matters) and dy in ``dtype``; g, b
    fp32 [E] away from their init values."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, e)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal((rows, e)).astype(np.float32)
    g = (1 + 0.3 * rng.standard_normal(e)).astype(np.float32)
    b = (0.2 * rng.standard_normal(e)).astype(np.float32)
    jx, jdy = (jnp.asarray(a).astype(JDT[dtype]) for a in (x, dy))
    tx, tdy = (torch.from_numpy(np.array(_np(a))).to(dtype) for a in (jx, jdy))
    return (jx, jnp.asarray(g), jnp.asarray(b), jdy), (tx, torch.from_numpy(g),
                                                       torch.from_numpy(b), tdy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(300, 256), (2, 150, 128)])
def test_layer_norm_matches_pallas_interpret(dtype, shape):
    rows, e = int(np.prod(shape[:-1])), shape[-1]
    (jx, jg, jb, jdy), (x, g, b, dy) = _inputs(dtype, rows, e, seed=rows + e)
    jx, jdy = jx.reshape(shape), jdy.reshape(shape)
    x, dy = x.reshape(shape), dy.reshape(shape)
    jy, vjp = jax.vjp(lambda x_, g_, b_: jln.layer_norm(x_, g_, b_, use_pallas=True,
                                                         interpret=True), jx, jg, jb)
    jdx, jdg, jdb = vjp(jdy)
    leaves = [t.clone().requires_grad_(True) for t in (x, g, b)]
    y = tln.layer_norm(*leaves)
    assert _through_function(y)
    y.backward(dy)
    assert y.dtype == dtype and y.shape == shape
    for name, got, want in (("y", y, jy), ("dx", leaves[0].grad, jdx)):
        want = _np(want)
        assert got.dtype == dtype, name
        np.testing.assert_allclose(_np(got), want, atol=_atol(dtype, want), err_msg=name)
    for name, got, want in (("dg", leaves[1].grad, jdg), ("db", leaves[2].grad, jdb)):
        want = _np(want)
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(_np(got), want, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_plain_backward_is_the_kernel_formula():
    """``layer_norm_backward_reference`` (the TPU kernel's formula) agrees
    with autograd through ``layer_norm_reference`` in float64, and the
    Function's CPU backward is that plain backward bit for bit."""
    rng = np.random.default_rng(7)
    x, dy = (torch.from_numpy(rng.standard_normal((40, 128))) for _ in range(2))
    g = torch.from_numpy(1 + 0.3 * rng.standard_normal(128))
    b = torch.from_numpy(0.1 * rng.standard_normal(128))
    leaves = [t.clone().requires_grad_(True) for t in (x, g, b)]
    tln.layer_norm_reference(*leaves).to(torch.float64).backward(dy)
    dx, dg, db = tln.layer_norm_backward_reference(x, g, dy)
    for got, want in zip((dx, dg, db), leaves):
        torch.testing.assert_close(got.double(), want.grad, rtol=1e-5, atol=1e-5)
    x32, g32, b32, dy32 = (t.float() for t in (x, g, b, dy))
    leaves = [t.clone().requires_grad_(True) for t in (x32, g32, b32)]
    tln.layer_norm(*leaves).backward(dy32)
    want = tln.layer_norm_backward_reference(x32, g32, dy32)
    for got, w in zip(leaves, want):
        torch.testing.assert_close(got.grad, w, rtol=0, atol=0)


def test_unaligned_feature_dim_takes_the_plain_version():
    """At E % 128 != 0 the JAX ``layer_norm`` takes its XLA reference. On
    CPU tensors the port's Function runs its plain versions there, and they
    agree with it, grads included. The CUDA kernels' own bound is E % 8 == 0
    up to 8192: any other E is refused before a launch, never computed
    plain (the model takes the plain forward there: ``kernel_takes``)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((6, 96)).astype(np.float32)).requires_grad_(True)
    g, b = torch.ones(96, requires_grad=True), torch.zeros(96, requires_grad=True)
    y = tln.layer_norm(x, g, b)
    assert _through_function(y)
    jx = jnp.asarray(x.detach().numpy())
    want, vjp = jax.vjp(lambda x_: jln.layer_norm(x_, jnp.ones(96), jnp.zeros(96),
                                                   use_pallas=True, interpret=True), jx)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), atol=1e-5)
    dy = rng.standard_normal((6, 96)).astype(np.float32)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]), atol=1e-5)
    for e in (100, 8200):  # not a multiple of 8; past the kernels' 8192
        meta = torch.empty((4, e), device="meta")
        with pytest.raises(ValueError, match="multiple of 8 up to 8192"):
            tln.layer_norm(meta, torch.ones(e, device="meta"), torch.zeros(e, device="meta"))


def test_layer_norm_refuses_bad_inputs():
    x = torch.zeros((4, 128))
    with pytest.raises(ValueError, match=r"\[128\]"):
        tln.layer_norm(x, torch.ones(64), torch.zeros(128))
    meta = torch.empty((4, 128), device="meta")
    with pytest.raises(ValueError, match="device"):
        tln.layer_norm(meta, torch.ones(128, device="meta"), torch.zeros(128, device="meta"))


@pytest.mark.parametrize("e", [8, 64, 128, 136, 768, 776, 1024, 4096, 4104, 5120, 8192])
def test_kernel_takes_is_the_references_rule(e, monkeypatch):
    """``kernel_takes`` names the widths at which the JAX ``layer_norm``
    itself reaches its Pallas pair (asked by a spy on ``_ln_pallas``, with
    ``use_pallas=True``): E % 128 == 0, here up to the kernels' 8192, which
    take E = 5120 (dalle_12B) and 8192; 768 + 8 and 4096 + 8 take the plain
    version in both packages."""
    calls = []

    def spy(x2d, g2d, b2d, eps, interpret):
        calls.append(x2d.shape)
        return jln.layer_norm_reference(x2d, g2d[0], b2d[0], eps)

    monkeypatch.setattr(jln, "_ln_pallas", spy)
    jln.layer_norm(jnp.ones((2, e)), jnp.ones(e), jnp.zeros(e), use_pallas=True)
    assert tln.kernel_takes(e) == bool(calls)
    assert e <= tln.MAX_E


@pytest.mark.parametrize("n_embd,heads", [(136, 2), (192, 3), (256, 2)])
def test_model_ln_dispatch_matches_jax(n_embd, heads):
    """A 2-layer fp32 DALLE with ``ln_impl: "pallas"`` on weights carried
    across by utils/convert.py: where E % 128 != 0 (136, 192) it takes the
    plain forward under autograd, no kernel Function in its graph; at 256
    the Function (the kernels on the card, their plain pair here); either
    way its loss and every grad match the JAX model's (loss within 1e-5,
    grads within 1e-4 of each leaf's max)."""
    kw = dict(n_embd=n_embd, text_vocab_size=40, image_vocab_size=32, text_seq_len=8,
              image_seq_len=16, n_layers=2, n_heads=heads, ln_impl="pallas")
    jm = jdalle.DALLE(jdalle.DalleConfig(**kw))
    tm = tdalle.DALLE(tdalle.DalleConfig(**kw), "cpu")
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, jm.cfg.total_tokens,
                                               (2, jm.cfg.total_seq_len))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(tokens, jnp.int32), train=True),
        has_aux=True)(jparams)
    tparams = convert.dalle_params_from_numpy(jparams, tm)
    leaves = dict(convert._flatten(tparams, ""))
    for t in leaves.values():
        t.requires_grad_(True)
    tloss, _ = tm.loss(tparams, torch.from_numpy(tokens), train=True)
    assert _through_function(tloss) == tln.kernel_takes(n_embd)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= 1e-5
    want = dict(convert._flatten(jax.device_get(jgrads), ""))
    got = dict(convert._flatten(convert.grads_to_numpy(tparams), ""))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-4 * np.abs(w).max() + 1e-9,
                                   err_msg=name)
