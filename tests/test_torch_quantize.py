"""Quantized serving in the port (dalle_mtf_tpu_torch/quantize.py,
ops/decode_matmul.py and the quantized weight access of models/dalle.py)
against the JAX package, on the CPU at small shapes, inputs from numpy seeds.

Tolerances, each with its reason:
- quantized values, scales and packing: equal bit for bit (the same IEEE
  fp32 division and round-half-to-even on both sides).
- plain kernels against the Pallas kernels in interpret mode: the same exact
  products summed in fp32 in another order, so 1e-6 of the output's scale;
  on the JAX wrappers' ragged tail (columns past the last 512-block) JAX
  multiplies by a bf16-rounded dequantized weight and the port does not, so
  there the bound is one bf16 rounding of the weight: 2^-8 of |x| @ |w|.
- quantized prefill and decode, port against JAX with ``decode_kernels``
  off (both dequantize, then a plain matmul): fp32 atol 1e-4 (same math, two
  layers, another summation order); bf16 atol 3e-2 (the two frameworks round
  bf16 at other points inside fused ops, ~2^-8 relative per rounding).
- ``decode_kernels`` on (the port's plain kernel on the CPU) against the JAX
  model running its own Pallas kernels in interpret mode: the same
  arithmetic (x cast to bf16, exact products, fp32 sums, one scale), but an
  activation that the two fp32 paths leave one ulp apart can round to bf16
  on either side of a boundary, moving it by 2^-8 relative and the logits by
  ~3e-3 (seen at these widths): atol 1e-2 on logits of |x| < ~1.5. Against
  JAX's dequant form instead: atol 2e-2, because the kernel path rounds
  every activation to bf16 (2^-9 relative) where the fp32 dequant form does
  not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu import quantize as jq
from dalle_mtf_tpu import sample as jsample
from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu.ops import decode_matmul as jdmm
from dalle_mtf_tpu_torch import quantize as tq
from dalle_mtf_tpu_torch import sample as tsample
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.ops import decode_matmul as tdmm
from dalle_mtf_tpu_torch.utils import convert

# E a multiple of 256, so decode matmuls are eligible for the kernels
KW = dict(
    n_embd=256, text_vocab_size=40, image_vocab_size=32, text_seq_len=8,
    image_seq_len=16, n_layers=2, n_heads=2,
)
# every N a multiple of the JAX kernels' 512-column block: no einsum tail
WIDE = dict(
    n_embd=512, text_vocab_size=40, image_vocab_size=512, text_seq_len=8,
    image_seq_len=8, n_layers=2, n_heads=4,
)
QUANTIZE = {"int8": (jq.quantize_layers_int8, tq.quantize_layers_int8),
            "int4": (jq.quantize_layers_int4, tq.quantize_layers_int4)}


def _tree_items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _random_layers(seed, L=2, E=256, H=3, D=64, V=333):
    """An fp32 tree with odd H (wo's per-head packing) and half-integer
    multiples of the scale, where round-half-to-even decides."""
    rng = np.random.default_rng(seed)

    def w(*shape, std=0.02):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    layers = {"wq": w(L, E, H, D), "wk": w(L, E, H, D), "wv": w(L, E, H, D, std=1.0),
              "wo": w(L, H, D, E), "w_mlp1": w(L, E, 4 * E), "w_mlp2": w(L, 4 * E, E, std=3e-3)}
    col = layers["wq"][0, :, 0, 0]
    unit = np.abs(col).max() / np.float32(127.0)
    col[:4] = np.array([0.5, 1.5, 2.5, -2.5], np.float32) * unit
    return {"layers": layers, "w_out": w(E, V), "b_out": w(V)}


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_tree_equals_jax_bit_for_bit(mode):
    params = _random_layers(0)
    jfn, tfn = QUANTIZE[mode]
    want = jax.device_get(jfn(jax.tree.map(jnp.asarray, params)))
    got = tfn(jax.tree.map(torch.from_numpy, params))
    assert sorted(p for p, _ in _tree_items(got)) == sorted(p for p, _ in _tree_items(want))
    for path, w in _tree_items(want):
        g = got
        for k in path:
            g = g[k]
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))


@pytest.mark.parametrize("shape,axis", [((6, 4), 0), ((2, 6, 4), 1), ((2, 3, 8, 5), 2)])
def test_int4_packing_equals_jax(shape, axis):
    q = np.random.default_rng(axis).integers(-8, 8, shape).astype(np.int8)
    want = np.asarray(jq.pack_int4(jnp.asarray(q), axis))
    packed = tq.pack_int4(torch.from_numpy(q), axis)
    np.testing.assert_array_equal(packed.numpy(), want)
    for got, ref in zip(tq.nibble_views(packed), jq.nibble_views(jnp.asarray(want))):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tq.unpack_int4(packed, axis).numpy(), q)
    np.testing.assert_array_equal(
        np.asarray(jq.unpack_int4(jnp.asarray(want), axis)), q)


def _matmul_inputs(m, k, n, seed, int4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    qmax = 7.0 if int4 else 127.0
    scale = np.maximum(np.abs(w).max(axis=0, keepdims=True) / np.float32(qmax),
                       np.float32(1e-12))
    q = np.clip(np.round(w / scale), -qmax, qmax).astype(np.int8)
    x16 = jnp.asarray(x, jnp.bfloat16)
    return x16, q, scale


def _bf16_torch(x16):
    return torch.from_numpy(np.asarray(x16, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("m,n", [(1, 1024), (4, 1024), (32, 1024), (4, 1100)])
def test_plain_int8_matmul_matches_pallas_interpret(m, n):
    k = 256
    x16, q, scale = _matmul_inputs(m, k, n, seed=m + n, int4=False)
    want = np.asarray(jdmm.int8_matmul(x16, jnp.asarray(q), jnp.asarray(scale),
                                       interpret=True))
    got = tdmm.int8_matmul(_bf16_torch(x16), torch.from_numpy(q),
                           torch.from_numpy(scale)).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    body = (n // jdmm.BN) * jdmm.BN
    np.testing.assert_allclose(got[:, :body], want[:, :body], rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # the JAX tail: x @ bf16(bf16(w) * bf16(scale)), one bf16 rounding of w
    mag = np.abs(np.asarray(x16, np.float32)) @ (np.abs(q.astype(np.float32)) * scale)
    assert (np.abs(got[:, body:] - want[:, body:]) <= 2.0**-8 * mag[:, body:] + 1e-6).all()


@pytest.mark.parametrize("m,n", [(1, 1024), (4, 1024), (32, 1024), (1, 700)])
def test_plain_int4_matmul_matches_pallas_interpret(m, n):
    k = 512
    x16, q, scale = _matmul_inputs(m, k, n, seed=m * n, int4=True)
    packed = np.array(jq.pack_int4(jnp.asarray(q), 0))
    kp = k // 2
    want = np.asarray(jdmm.int4_matmul(x16[:, :kp], x16[:, kp:], jnp.asarray(packed),
                                       jnp.asarray(scale), interpret=True))
    xt = _bf16_torch(x16)
    got = tdmm.int4_matmul(xt[:, :kp].contiguous(), xt[:, kp:].contiguous(),
                           torch.from_numpy(packed), torch.from_numpy(scale)).numpy()
    body = (n // jdmm.BN) * jdmm.BN
    np.testing.assert_allclose(got[:, :body], want[:, :body], rtol=0,
                               atol=1e-6 * np.abs(want).max())
    mag = np.abs(np.asarray(x16, np.float32)) @ (np.abs(q.astype(np.float32)) * scale)
    assert (np.abs(got[:, body:] - want[:, body:]) <= 2.0**-8 * mag[:, body:] + 1e-6).all()


def test_split_k_covers_k_and_fills_the_card():
    """The wrapper's split-K plan (``decode_matmul.plan``: K slices of whole
    passes, at most MAX_CLUSTER of them a cluster) at the dalle_coco decode
    shapes (M = 4) and others: every row in one slice, the fewest slices
    that leave a warp at most MAX_WORK tiles; no split (no cluster) at the
    decode shapes but mlp2, split three ways over 96 CTAs."""
    for k, n in [(1024, 1024), (1024, 4096), (4096, 1024), (1024, 2048), (512, 1024),
                 (2048, 1024), (1024, 52307), (256, 8)]:
        for int4 in (False, True):
            walk = tdmm.plan(k, int4)
            assert walk.k_slice % tdmm.ROWS_PER_PASS == 0
            assert 1 <= walk.splits <= tdmm.MAX_CLUSTER
            assert (walk.splits - 1) * walk.k_slice < k <= walk.splits * walk.k_slice
            assert tdmm.passes(walk) * (2 if int4 else 1) <= tdmm.MAX_WORK
    for k, n in [(1024, 1024), (1024, 4096), (1024, 2048)]:  # qkv, wo, mlp1, head band
        assert tdmm.plan(k).splits == 1 and tdmm.plan(k // 2, True).splits == 1
    mlp2, mlp2_int4 = tdmm.plan(4096), tdmm.plan(2048, True)
    assert mlp2.splits == 3 and tdmm.ctas(mlp2, 4, 1024) == 96
    assert mlp2_int4.splits == 3 and tdmm.ctas(mlp2_int4, 4, 1024) == 96


def test_wrapper_refuses_bad_inputs_off_the_cpu():
    """Off the CPU the wrapper checks before it launches (here on the meta
    device, which has no kernel either)."""
    x = torch.empty((4, 256), dtype=torch.bfloat16, device="meta")
    w = torch.empty((256, 512), dtype=torch.int8, device="meta")
    s = torch.empty((1, 512), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdmm.int8_matmul(x, w, s)
    with pytest.raises(ValueError, match="rows"):
        tdmm.int8_matmul(torch.empty((33, 256), dtype=torch.bfloat16, device="meta"), w, s)
    with pytest.raises(ValueError, match="bf16"):
        tdmm.int8_matmul(x.float(), w, s)
    with pytest.raises(ValueError, match="shapes"):
        tdmm.int4_matmul(x, x[:, :128], w, s)


@pytest.fixture(scope="module")
def jax_params():
    jm = jdalle.DALLE(jdalle.DalleConfig(**KW))
    return jax.device_get(jm.init(jax.random.PRNGKey(0)))


def _run_both(jm, tm, jparams, tparams, steps=3, batch=2):
    """Prefill + ``steps`` greedy decode steps in both packages; yields
    (name, jax array, torch tensor)."""
    cfg = jm.cfg
    lo, hi = cfg.text_vocab_size, cfg.text_vocab_size + cfg.image_vocab_size
    text = np.random.default_rng(1).integers(0, lo, (batch, cfg.text_seq_len))
    jcache = jm.init_cache(batch)
    jl, jcache = jm.prefill(jparams, jnp.asarray(text, jnp.int32), jcache, band=(lo, hi))
    tcache = tm.init_cache(batch)
    tl = tm.prefill(tparams, torch.from_numpy(text), tcache, band=(lo, hi))
    yield "prefill logits", jl, tl
    t = cfg.text_seq_len
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1)) + lo
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok, jnp.int32),
                                    jnp.int32(t + i), band=(lo, hi))
        tl = tm.decode_step(tparams, tcache, torch.from_numpy(tok), t + i, band=(lo, hi))
        yield f"step {i} logits", jl, tl
    yield "cache k", jcache["k"], tcache["k"]


def _quantized(jparams, mode):
    return jax.device_get(QUANTIZE[mode][0](jax.tree.map(jnp.asarray, jparams)))


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("bf16", [False, True])
def test_quantized_prefill_and_decode_match_jax(jax_params, mode, bf16):
    jm = jdalle.DALLE(jdalle.DalleConfig(**KW, bf_16=bf16))
    tm = tdalle.DALLE(tdalle.DalleConfig(**KW, bf_16=bf16), "cpu")
    qp = _quantized(jax_params, mode)
    atol = 3e-2 if bf16 else 1e-4
    for name, want, got in _run_both(jm, tm, qp, convert.dalle_params_from_numpy(qp, tm)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=atol, err_msg=f"{mode} {name}")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_decode_kernels_plain_path_matches_jax_dequant_form(jax_params, mode):
    """The port with decode_kernels on takes the plain kernel on the CPU for
    every matmul of at most 32 rows (here all of them); JAX on the CPU never
    takes its kernels, so it runs the dequant form."""
    jm = jdalle.DALLE(jdalle.DalleConfig(**KW))
    tm = tdalle.DALLE(tdalle.DalleConfig(**KW, decode_kernels=True), "cpu")
    qp = _quantized(jax_params, mode)
    before = dict(tdmm.KERNEL_LAUNCHES)
    for name, want, got in _run_both(jm, tm, qp, convert.dalle_params_from_numpy(qp, tm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                                   err_msg=f"{mode} {name}")
    assert tdmm.KERNEL_LAUNCHES == before  # CPU tensors launch nothing


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_decode_kernels_match_jax_kernels_in_interpret_mode(monkeypatch, mode):
    """JAX's own streaming kernels (interpret mode, eligibility without the
    TPU test) against the port's plain kernels, at widths whose every N is
    a multiple of the JAX 512-column block."""
    monkeypatch.setattr(jdalle.DALLE, "_streaming_eligible",
                        lambda self, m, k: self.cfg.decode_kernels and m <= 32 and k % 256 == 0)
    monkeypatch.setattr(jdmm, "int8_matmul", functools.partial(jdmm.int8_matmul, interpret=True))
    monkeypatch.setattr(jdmm, "int4_matmul", functools.partial(jdmm.int4_matmul, interpret=True))
    jm = jdalle.DALLE(jdalle.DalleConfig(**WIDE, decode_kernels=True))
    tm = tdalle.DALLE(tdalle.DalleConfig(**WIDE, decode_kernels=True), "cpu")
    qp = _quantized(jax.device_get(jm.init(jax.random.PRNGKey(3))), mode)
    for name, want, got in _run_both(jm, tm, qp, convert.dalle_params_from_numpy(qp, tm),
                                     steps=2):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2,
                                   err_msg=f"{mode} {name}")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_greedy_tokens_match_jax(jax_params, mode):
    jm = jdalle.DALLE(jdalle.DalleConfig(**KW))
    tm = tdalle.DALLE(tdalle.DalleConfig(**KW), "cpu")
    qp = _quantized(jax_params, mode)
    text = np.random.default_rng(2).integers(0, 40, (2, 8))
    want = jsample.generate_image_tokens(jm, qp, jnp.asarray(text, jnp.int32),
                                         jax.random.PRNGKey(0), temperature=0.0)
    got = tsample.generate_image_tokens(tm, convert.dalle_params_from_numpy(qp, tm),
                                        torch.from_numpy(text),
                                        torch.Generator().manual_seed(0), temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_forward_matches_jax(jax_params, mode):
    """``forward`` reads w_out through ``_w_out`` and the blocks take the
    [B, H, S, D] arm under quantized weights, as in JAX."""
    jm = jdalle.DALLE(jdalle.DalleConfig(**KW))
    tm = tdalle.DALLE(tdalle.DalleConfig(**KW), "cpu")
    qp = _quantized(jax_params, mode)
    tokens = np.random.default_rng(3).integers(0, 72, (2, 24))
    want = jm.forward(qp, jnp.asarray(tokens, jnp.int32))
    got = tm.forward(convert.dalle_params_from_numpy(qp, tm), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_trees_convert_from_jax_and_back(tmp_path, jax_params, mode):
    tm = tdalle.DALLE(tdalle.DalleConfig(**KW), "cpu")
    qp = _quantized(jax_params, mode)
    got = convert.dalle_params_from_numpy(qp, tm)
    assert convert.quantize_mode(got) == mode
    mine = QUANTIZE[mode][1](convert.dalle_params_from_numpy(jax_params, tm))
    assert dict(convert._flatten(got)).keys() == dict(convert._flatten(mine)).keys()
    for key, want in convert._flatten(mine):
        t = dict(convert._flatten(got))[key]
        assert t.dtype == want.dtype and t.shape == want.shape, key
        assert torch.equal(t, want), key
    convert.save_npz(tmp_path / "q.npz", got)
    back = convert.dalle_params_from_numpy(convert.load_npz(tmp_path / "q.npz"), tm)
    for key, want in convert._flatten(got):
        assert torch.equal(dict(convert._flatten(back))[key], want), key
    bad = convert.load_npz(tmp_path / "q.npz")
    bad["layers"]["wq_scale"] = bad["layers"]["wq_scale"][:, :, :1]
    with pytest.raises(ValueError, match="layers/wq_scale"):
        convert.dalle_params_from_numpy(bad, tm)
