"""The LayerNorm backward kernel's order of work, written once in numpy
(``dalle_mtf_tpu_torch/ops/layer_norm_tiles.py``), on the CPU: the walk of
CTAs, tiles, row groups and the final sum's groups, and its dx, dg, db
against the port's plain backward and against the JAX package's
``layer_norm`` (its Pallas pair in interpret mode at E % 128 == 0, its XLA
reference elsewhere, as the JAX call itself chooses), at ragged R, E in
{8, 136, 1024, 5120}, in fp32 and bf16. The card tests hold the kernel's
dg/db against this walk (tests/test_torch_cuda.py).

Tolerances: against the plain backward in fp32, dx 1e-5 of max(1, |plain|)
and dg, db 1e-5 of their max (the same terms; the walk adds them one row
after another in fp32, the plain version by torch's own reduction).
Against JAX, as tests/test_torch_layer_norm.py: fp32 dx 1e-5 of the largest
|value|, bf16 dx one bf16 ulp of it, dg and db 1e-4 of their max.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.ops import layer_norm as jln
from dalle_mtf_tpu_torch.ops import layer_norm as tln
from dalle_mtf_tpu_torch.ops import layer_norm_tiles as walk

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
SHAPES = [(37, 8), (301, 136), (301, 1024), (41, 5120)]  # ragged R at every E


def _inputs(dtype, rows, e, seed):
    """x (offset and scaled, so the mean matters), dy in ``dtype`` and g
    fp32, as fp32 numpy arrays holding the dtype's values."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, e)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal((rows, e)).astype(np.float32)
    g = (1 + 0.3 * rng.standard_normal(e)).astype(np.float32)
    x, dy = (torch.from_numpy(a).to(dtype).float().numpy() for a in (x, dy))
    return x, g, dy


def _ctas(rows, e, dtype, most):
    tile_rows = tln.bwd_tile_rows(e, dtype)
    return tile_rows, min(most, math.ceil(rows / tile_rows))


@pytest.mark.parametrize("e", [8, 136, 768, 1024, 2048, 2056, 5120, 8192])
def test_walk_takes_every_row_once_in_the_kernels_groups(e):
    """Every row lands in one CTA (CTA c takes a contiguous range, no CTA a
    row over another), row j of a tile in group j mod G with G = 256 //
    (E / 8) below 256 chunks and 1 above; the final sum's CTAs cover the 2E
    columns once and its groups every partial once; a tile's x and dy in
    both stages, with g, fit two CTAs' share of an SM (one row at least)."""
    n_chunks = e // 8
    groups = walk.row_groups(e)
    assert groups == (1 if n_chunks >= 256 else 256 // n_chunks)
    assert groups * n_chunks <= 256 or groups == 1
    for dtype in (torch.float32, torch.bfloat16):
        tile_rows = tln.bwd_tile_rows(e, dtype)
        ring = 2 * 2 * e * (4 if dtype == torch.float32 else 2)  # x and dy, both stages
        assert tile_rows & (tile_rows - 1) == 0 and 1 <= tile_rows <= 64
        assert tile_rows == 1 or tile_rows * ring + 4 * e <= 112 * 1024
        assert tile_rows == 64 or 2 * tile_rows * ring + 4 * e > 112 * 1024
    for rows, n_ctas in ((1, 1), (10, 3), (17408, 396), (5, 5)):
        ranges = [walk.cta_rows(c, n_ctas, rows) for c in range(n_ctas)]
        assert [r for rg in ranges for r in rg] == list(range(rows))
        assert max(map(len, ranges)) - min(map(len, ranges)) <= 1
        cols, width, pgroups = walk.final_split(n_ctas, e)
        assert cols * n_ctas >= 2 * e > (cols - 1) * n_ctas
        assert width == min(cols, 256) and pgroups * width <= 256 < (pgroups + 1) * width


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,e", SHAPES)
@pytest.mark.parametrize("most", [1, 5])
def test_walk_matches_the_plain_backward(dtype, rows, e, most):
    """dx, dg, db of the walk, under one CTA and under several, against
    ``layer_norm_backward_reference`` on the same values in fp32."""
    x, g, dy = _inputs(dtype, rows, e, seed=rows + e)
    tile_rows, n_ctas = _ctas(rows, e, dtype, most)
    dx, dg, db = walk.backward_walk(x, g, dy, n_ctas, tile_rows)
    want = tln.layer_norm_backward_reference(*(torch.from_numpy(a) for a in (x, g, dy)))
    want_dx = want[0].numpy()
    np.testing.assert_allclose(dx, want_dx, atol=1e-5 * max(1.0, np.abs(want_dx).max()))
    for name, got, w in (("dg", dg, want[1].numpy()), ("db", db, want[2].numpy())):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, w, atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,e", SHAPES)
def test_walk_matches_jax(dtype, rows, e):
    """The walk against the JAX package's ``layer_norm`` backward (through
    ``jax.vjp``): its Pallas ``_ln_bwd_kernel`` in interpret mode where
    E % 128 == 0, its XLA reference where the same call takes it."""
    x, g, dy = _inputs(dtype, rows, e, seed=3 * rows + e)
    b = np.zeros(e, np.float32)
    jx, jdy = (jnp.asarray(a).astype(JDT[dtype]) for a in (x, dy))
    _, vjp = jax.vjp(lambda x_, g_, b_: jln.layer_norm(x_, g_, b_, use_pallas=True,
                                                       interpret=True),
                     jx, jnp.asarray(g), jnp.asarray(b))
    jdx, jdg, jdb = (np.asarray(jnp.asarray(t).astype(jnp.float32)) for t in vjp(jdy))
    tile_rows, n_ctas = _ctas(rows, e, dtype, 7)
    dx, dg, db = walk.backward_walk(x, g, dy, n_ctas, tile_rows)
    if dtype == torch.bfloat16:  # the kernel writes dx in the rows' dtype
        dx = torch.from_numpy(dx).to(dtype).float().numpy()
        atol = 2.0 ** (np.floor(np.log2(np.abs(jdx).max())) - 7)
    else:
        atol = 1e-5 * np.abs(jdx).max()
    np.testing.assert_allclose(dx, jdx, atol=atol)
    for name, got, w in (("dg", dg, jdg), ("db", db, jdb)):
        np.testing.assert_allclose(got, w, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_walk_models_the_fma_and_the_order():
    """The walk's sums are its own order and not another: one fp32 add
    after another (a product added with one rounding), so summing the same
    terms by rows in reverse, or by a float64 sum, moves some bits; and the
    walk refuses a CTA count with no tile to take."""
    x, g, dy = _inputs(torch.float32, 300, 136, seed=9)
    tile_rows, n_ctas = _ctas(300, 136, torch.float32, 7)
    _, dg, db = walk.backward_walk(x, g, dy, n_ctas, tile_rows)
    _, _, _, _, xhat = walk.row_stats(x, g, dy)
    exact = (dy.astype(np.float64) * xhat).sum(0)
    assert not np.array_equal(dg, exact.astype(np.float32))
    assert np.abs(dg - exact).max() <= 1e-5 * np.abs(exact).max()
    again = walk.final_sum(walk.cta_partials(dy, xhat, n_ctas, tile_rows))
    assert np.array_equal(again[0], dg) and np.array_equal(again[1], db)
    assert np.array_equal(walk._fma32(np.float32([1 + 2**-23]), np.float32([1 - 2**-23]),
                                      np.float32([-1])), np.float32([-(2.0**-46)]))
    with pytest.raises(ValueError, match="tiles"):
        walk.backward_walk(x, g, dy, 300, tile_rows)
