"""The LayerNorm backward kernel's order of work (``csrc/layer_norm.cu``),
written once in numpy. Nothing on the path imports this module: the CPU
tests hold it against the plain backward and the JAX package, and the card
tests hold the kernel's dg/db against it.

The kernel is one cooperative launch of ``n_ctas`` CTAs over tiles of
``tile_rows`` rows (``ops/layer_norm.py::bwd_tile_rows``):

- CTA c takes the contiguous rows [c R / n_ctas, (c + 1) R / n_ctas)
  (``cta_rows``), in tiles of ``tile_rows`` rows from the first, the last
  one ragged;
- within a tile, row j goes to row group j mod G (``row_groups``), and the
  threads of a group add dy * xhat (one fma) and dy into their columns' dg
  and db, row after row in the CTA's order of tiles;
- the CTA adds its groups' sums in group order into its fp32 partial [2, E];
- after a grid barrier, each of the [2E] sums is taken over the partials by
  ``final_split(n_ctas, e)``'s groups: group r adds partials r, r + G, ...
  in CTA order, and the G groups' sums are added in group order.

The walk models that order of fp32 additions exactly (an fma as the exact
product and sum rounded once to fp32, through float64). The row statistics
(mean, rstd, the two means of dxhat) it takes in float64 and rounds to fp32,
where the kernel sums in its own lane order, so the card's dg/db meet the
walk's to a stated bound, not bit for bit.
"""

from __future__ import annotations

import math

import numpy as np

THREADS = 256
VEC = 8  # columns a thread's chunk holds


def row_groups(e: int) -> int:
    """Row groups G of a tile at row width ``e``: 256 threads over E / 8
    chunks, so 256 // (E / 8) groups when a row has fewer chunks than
    threads, else one (a thread then owns chunks t, t + 256, ...)."""
    n_chunks = e // VEC
    return 1 if n_chunks >= THREADS else THREADS // n_chunks


def cta_rows(cta: int, n_ctas: int, rows: int) -> range:
    """The rows CTA ``cta`` of ``n_ctas`` takes, in its order: an even split
    of ``rows``, no CTA a row over another."""
    return range(cta * rows // n_ctas, (cta + 1) * rows // n_ctas)


def final_split(n_ctas: int, e: int) -> tuple[int, int, int]:
    """(columns a CTA sums, columns a pass, partial groups G) of the final
    sum over the [n_ctas, 2E] partials: CTA c takes columns
    [c cols, (c + 1) cols), ``width`` = min(cols, 256) at a time, and its
    256 threads are G = 256 // width groups of ``width`` columns."""
    cols = math.ceil(2 * e / n_ctas)
    width = min(cols, THREADS)
    return cols, width, THREADS // width


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """fp32 fma(a, b, c): the product of two fp32 values is exact in
    float64; the sum is rounded there and then to fp32."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(
        np.float32)


def row_stats(x: np.ndarray, g: np.ndarray, dy: np.ndarray, eps: float = 1e-5):
    """(mean, rstd, mean(dxhat), mean(dxhat * xhat)) of each row, each [R]
    fp32, from float64 sums; xhat = (x - mean) * rstd in fp32."""
    x64 = x.astype(np.float64)
    mean = x64.mean(-1, keepdims=True)
    rstd = 1.0 / np.sqrt(((x64 - mean) ** 2).mean(-1, keepdims=True) + eps)
    mean32, rstd32 = mean.astype(np.float32), rstd.astype(np.float32)
    xhat = (x - mean32) * rstd32
    dxhat = dy.astype(np.float64) * g.astype(np.float64)
    m1 = dxhat.mean(-1, keepdims=True).astype(np.float32)
    m2 = (dxhat * xhat).mean(-1, keepdims=True).astype(np.float32)
    return mean32, rstd32, m1, m2, xhat


def cta_partials(dy: np.ndarray, xhat: np.ndarray, n_ctas: int, tile_rows: int) -> np.ndarray:
    """The CTAs' fp32 partials [n_ctas, 2, E] (dg, then db) in the kernel's
    order: per row group, fma / add row after row over the CTA's tiles, then
    the groups added in group order."""
    rows, e = dy.shape
    groups = row_groups(e)
    partial = np.zeros((n_ctas, 2, e), np.float32)
    for cta in range(n_ctas):
        dg = np.zeros((groups, e), np.float32)
        db = np.zeros((groups, e), np.float32)
        mine = cta_rows(cta, n_ctas, rows)
        for r in mine:
            gi = (r - mine.start) % tile_rows % groups  # its tile's row j, j mod G
            dg[gi] = _fma32(dy[r], xhat[r], dg[gi])
            db[gi] = db[gi] + dy[r]
        for gi in range(groups):
            partial[cta, 0] = partial[cta, 0] + dg[gi]
            partial[cta, 1] = partial[cta, 1] + db[gi]
    return partial


def final_sum(partial: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """dg, db [E] from the partials [n_ctas, 2, E]: each partial group r of
    ``final_split`` over partials r, r + G, ... in CTA order, then the
    groups in group order, in fp32 (the same G for every column)."""
    n_ctas, _, e = partial.shape
    flat = partial.reshape(n_ctas, 2 * e)
    total = np.zeros(2 * e, np.float32)
    groups = final_split(n_ctas, e)[2]
    for r in range(groups):
        s = np.zeros(2 * e, np.float32)
        for p in range(r, n_ctas, groups):
            s = s + flat[p]
        total = total + s
    return total[:e], total[e:]


def backward_walk(x: np.ndarray, g: np.ndarray, dy: np.ndarray, n_ctas: int,
                  tile_rows: int, eps: float = 1e-5):
    """The kernel's backward over fp32 arrays x, dy [R, E] (values already
    in the rows' dtype) and g [E]: (dx fp32 [R, E], dg, db fp32 [E]), dg/db
    summed in the kernel's order over ``n_ctas`` CTAs and tiles of
    ``tile_rows`` rows."""
    x, g, dy = (np.asarray(a, np.float32) for a in (x, g, dy))
    rows = x.shape[0]
    if not 1 <= n_ctas <= math.ceil(rows / tile_rows):
        raise ValueError(f"n_ctas {n_ctas}: between 1 and the {math.ceil(rows / tile_rows)} "
                         f"tiles")
    _, rstd, m1, m2, xhat = row_stats(x, g, dy, eps)
    dx = rstd * (dy * g - m1 - xhat * m2)
    dg, db = final_sum(cta_partials(dy, xhat, n_ctas, tile_rows))
    return dx, dg, db
