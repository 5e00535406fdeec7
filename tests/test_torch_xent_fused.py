"""The port's fused loss head (dalle_mtf_tpu_torch/ops/xent_fused.py) and
pad (ops/pad.py) against the JAX package's, on the CPU at tiny shapes:
``pad`` value and grad; ``chunked_softmax_xent`` loss, dx, dw and db and
``chunked_xent_eval`` loss and correctness on the same inputs and
cotangent; ``DALLE.loss(fused_xent=True)`` and ``fused_eval`` on one
parameter tree; the chunk rule where the requested count does not divide
the rows; the ``*_auto`` dispatch on a vocab axis of size 1 and 2.

Tolerances: fp32 within 1e-5 of each tensor's largest |value| (the same
math, fp32 sums in another order); bf16 within 2e-2 of it (the products
of bf16 operands are exact in fp32 on both sides; the two round dlogits,
dx and dw to bf16 at the same points, and one bf16 rounding is 2^-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu.ops.pad import pad as jax_pad
from dalle_mtf_tpu.ops import xent_fused as jxent
from dalle_mtf_tpu_torch import ops as tops
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.ops import xent_fused as txent
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.utils import convert

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _close(got, want, tol, name):
    got = np.asarray(torch.as_tensor(got).float().numpy(), np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=tol * max(np.abs(want).max(), 1e-30), rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("paddings,axis,value", [((2, 1), 0, 0.0), ((0, 3), -1, -1e10),
                                                 ((1, 0), 1, 2.5)])
def test_pad_value_and_grad_match_jax(paddings, axis, value):
    x = np.random.default_rng(0).standard_normal((3, 4, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jax_pad(t, paddings, axis % 3, value), jnp.asarray(x))
    g = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tops.pad(tx, paddings, axis, value)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    assert tops.chunked_softmax_xent is txent.chunked_softmax_xent
    from dalle_mtf_tpu_torch.ops.pad import exists

    assert exists(0) and not exists(None)


def _xent_inputs(dtype, n=24, e=16, v=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, e)).astype(np.float32)
    w = (rng.standard_normal((e, v)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(v) * 0.1).astype(np.float32)
    t = rng.integers(0, v, n)
    g = rng.standard_normal(n).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    # the operands rounded once, identically for both packages
    x, w = (np.array(jnp.asarray(a).astype(jd).astype(jnp.float32)) for a in (x, w))
    return ((jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b), jnp.asarray(t, jnp.int32),
             jnp.asarray(g)),
            (torch.from_numpy(x).to(td), torch.from_numpy(w).to(td), torch.from_numpy(b),
             torch.from_numpy(t), torch.from_numpy(g)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("chunks", [1, 4])
def test_chunked_xent_loss_and_grads_match_jax(dtype, z_loss, chunks):
    (jx, jw, jb, jt, jg), (tx, tw, tb, tt, tg) = _xent_inputs(dtype)
    want, vjp = jax.vjp(lambda x, w, b: jxent.chunked_softmax_xent(x, w, b, jt, z_loss, chunks),
                        jx, jw, jb)
    jdx, jdw, jdb = vjp(jg)
    leaves = [t.clone().requires_grad_(True) for t in (tx, tw, tb)]
    got = txent.chunked_softmax_xent(*leaves, tt, z_loss, chunks)
    got.backward(tg)
    assert got.dtype == torch.float32
    tol = TOL[dtype]
    _close(got.detach(), want, tol, "loss")
    for name, leaf, w in zip(("dx", "dw", "db"), leaves, (jdx, jdw, jdb)):
        assert leaf.grad.dtype == leaf.dtype, name
        _close(leaf.grad, w, tol, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_xent_eval_matches_jax(dtype):
    (jx, jw, jb, jt, _), (tx, tw, tb, tt, _) = _xent_inputs(dtype, seed=3)
    # half the rows' targets are their argmax, so both outcomes are checked
    hits = jnp.argmax(jx.astype(jnp.float32) @ jw.astype(jnp.float32) + jb, -1)
    jt = jt.at[::2].set(hits[::2])
    tt = torch.from_numpy(np.array(jt)).long()
    jl, jc = jxent.chunked_xent_eval(jx, jw, jb, jt, 1e-4, 3)
    tl, tc = txent.chunked_xent_eval(tx, tw, tb, tt, 1e-4, 3)
    _close(tl, jl, TOL[dtype], "loss")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert 0 < float(tc.sum()) < len(tc)


def test_chunked_xent_refuses_what_it_cannot_run():
    (_, _, _, _, _), (tx, tw, tb, tt, _) = _xent_inputs("float32")
    with pytest.raises(ValueError, match="divisible"):
        txent.chunked_softmax_xent(tx, tw, tb, tt, 0.0, 5)

    class Mesh:
        def size(self, name):
            return {"model": 2}.get(name, 1)

    plain = (txent.chunked_softmax_xent, txent.chunked_xent_eval)
    for fn, want in zip((txent.chunked_softmax_xent_auto, txent.chunked_xent_eval_auto), plain):
        # a split vocabulary takes the tensor-parallel op (tests/test_torch_tp_xent.py),
        # which needs the whole vocabulary's size
        with pytest.raises(ValueError, match="vocab_size"):
            fn(tx, tw, tb, tt, 0.0, 4, vocab_axis="model", mesh=Mesh())
        # an axis of size 1: the plain op
        got = fn(tx, tw, tb, tt, 0.0, 4, vocab_axis="data", mesh=Mesh())
        for g, w in zip(*(((o,) if isinstance(o, torch.Tensor) else o)
                          for o in (got, want(tx, tw, tb, tt, 0.0, 4)))):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


KW = dict(n_embd=64, text_vocab_size=48, image_vocab_size=32, text_seq_len=8,
          image_seq_len=16, n_layers=2, n_heads=2)


def _model_pair(**over):
    jm = jdalle.DALLE(jdalle.DalleConfig(**KW, **over))
    tm = tdalle.DALLE(tdalle.DalleConfig(**KW, **over), "cpu")
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return jm, tm, jparams, convert.dalle_params_from_numpy(jparams, tm)


@pytest.mark.parametrize("xent_chunks,bf16", [(8, False), (5, False), (8, True)])
def test_dalle_fused_loss_and_eval_match_jax(xent_chunks, bf16):
    """B * S = 72 rows: 8 chunks divide them, a requested 5 does not (both
    packages then take 8), in fp32 and bf16."""
    jm, tm, jparams, tparams = _model_pair(xent_chunks=xent_chunks, bf_16=bf16)
    assert tm._xent_chunks(72) == 8
    tokens = np.random.default_rng(1).integers(0, jm.cfg.total_tokens,
                                               (3, jm.cfg.total_seq_len))
    (jl, jb), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(tokens, jnp.int32), train=True, z_loss=1e-4,
                          fused_xent=True), has_aux=True))(jparams)
    for _, t in named_leaves(tparams):
        t.requires_grad_(True)
    tl, tb = tm.loss(tparams, torch.from_numpy(tokens), train=True, z_loss=1e-4,
                     fused_xent=True)
    tl.backward()
    tol = TOL["bfloat16" if bf16 else "float32"]
    _close(tl.detach(), jl, tol, "loss")
    _close(tb.detach(), jb, tol, "loss_batch")
    want = dict(convert._flatten(jax.device_get(jg)))
    got = dict(convert._flatten(convert.grads_to_numpy(tparams)))
    assert set(got) == set(want)
    for name, w in want.items():
        if bf16:  # L2 over the leaf: bf16 activations round at other points (test_torch_train)
            assert np.linalg.norm(got[name] - w) <= 0.1 * np.linalg.norm(w), name
        else:
            _close(got[name], w, 1e-4, name)
    jloss, jcorrect = jax.jit(lambda p: jm.fused_eval(p, jnp.asarray(tokens, jnp.int32),
                                                      z_loss=1e-4))(jparams)
    with torch.no_grad():
        tloss, tcorrect = tm.fused_eval(tparams, torch.from_numpy(tokens), z_loss=1e-4)
    _close(tloss, jloss, tol, "eval loss")
    if not bf16:
        np.testing.assert_array_equal(tcorrect.numpy(), np.asarray(jcorrect))


def test_fused_head_equals_dense_head_in_fp32():
    """In fp32 the two heads are one computation: loss and grads agree."""
    _, tm, _, tparams = _model_pair()
    tokens = torch.randint(0, tm.cfg.total_tokens, (2, tm.cfg.total_seq_len),
                           generator=torch.Generator().manual_seed(2))
    results = []
    for fused in (False, True):
        tree = {k: ({n: t.clone().requires_grad_(True) for n, t in v.items()}
                    if isinstance(v, dict) else v.clone().requires_grad_(True))
                for k, v in tparams.items()}
        loss, _ = tm.loss(tree, tokens, train=True, fused_xent=fused)
        loss.backward()
        results.append((loss.item(), dict(convert._flatten(convert.grads_to_numpy(tree)))))
    (dl, dg), (fl, fg) = results
    assert abs(dl - fl) <= 1e-5
    for name, w in dg.items():
        _close(fg[name], w, 1e-5, name)
