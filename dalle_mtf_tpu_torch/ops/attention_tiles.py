"""The tile walk of the tensor-core attention kernels, in Python.

The bf16 kernels of ``csrc/causal_attention_fwd.cu``, the bf16 and fp32
kernels of ``csrc/causal_attention_bwd.cu`` and the tensor-core kernels of
``csrc/ring_attention.cu`` walk 64-key (or, in the dK/dV pass, 64-row) tiles
of one head; their index arithmetic is written once here, and the CUDA
sources point at these functions as its definition:

- ``forward_tile_rows``: the forward's q tile (64 or 128 rows) by shape;
- ``key_tile_range`` / ``query_tile_range``: the first and last streamed tile
  of an owner tile;
- ``tile_needs_mask``: which tiles must test every element against the mask;
- ``attention_tiled_reference`` / ``attention_backward_tiled_reference``:
  plain torch versions that walk the tiles exactly so (online softmax in the
  log2 domain from the finite NEG_INF, the mask only on edge tiles, p_v and
  ds rounded where the kernels round);
- ``ring_key_tile_range`` / ``ring_query_tile_range`` /
  ``ring_tile_needs_mask`` and ``ring_partial_tiled_reference`` /
  ``ring_block_grads_tiled_reference``: the same for one hop of ring
  attention, between a local q shard and a visiting k/v shard whose global
  offsets differ by ``diff`` (``ops/ring_attention.py``);
- ``tf32_round`` and the references' ``split`` argument: the fp32 kernels'
  products on the tensor cores, emulated. Each operand x is split into
  big = tf32(x) and small = tf32(x - big), and a product is big·big +
  big·small + small·big (``split="tf32x3"``, what the kernels run), summed
  as the tensor cores sum (each mma rounds toward zero, so the kernels sum
  every k step of 8 apart and add it rounding to nearest);
  ``split="tf32"`` is one TF32 product, which the tests show cannot hold
  the fp32 bound. With a ``split`` the forward references also walk as the
  fp32 forwards do: two warp groups a q tile, each taking one 32-key half
  of every key tile with its own online softmax, merged once at the end;
- ``tile_rel_err``: that bound measured, each 64-long tile of S against its
  own max |plain|.

Nothing on the serving or training path imports this module: the CPU tests
hold it against the dense mask, the one-shot plain versions and the JAX
package, and a test on the card holds ``forward_tile_rows`` against the
built kernel's own choice.
"""

from __future__ import annotations

import math

import torch

from dalle_mtf_tpu_torch.ops.attention import (
    NEG_INF,
    RING_FORWARD_TILES,
    dropout_keep,
    program_seeds,
)

STREAM_TILE = 64  # rows of a streamed tile (keys in the forward and the dQ pass)
TILE_ROWS = (64, 128)  # rows of the forward's q tile: 4 warps of one or two 16-row blocks
BACKWARD_TILE_ROWS = 64  # both backward passes measured slower with 128 rows: not built
SMS = 132  # an H100's SMs
_LOG2E = 1.4426950408889634


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32``: on the int32 view,
    (min(bits, 0x7FFFEFFF) + 0x1000) & ~0x1FFF, as the kernels' ``split``
    rounds small (big skips the min: the same bits for every value that is
    not a NaN). For those the sign bit is untouched, so the magnitude
    rounds; the min keeps a positive NaN a NaN (the add would carry
    0x7FFFFFFF into the sign bit)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits.clamp_max(0x7FFFEFFF) + 0x1000) & ~0x1FFF).view(torch.float32)


SPLITS = (None, "tf32", "tf32x3")


def _toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` to fp32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def split_matmul(a: torch.Tensor, b: torch.Tensor, split: str | None = None,
                 chunk: int | None = 1, into: torch.Tensor | None = None) -> torch.Tensor:
    """a @ b in fp32 (added to ``into`` when given) as a kernel's tensor
    cores take it: ``split`` None is the plain fp32 product; "tf32" one
    product of the operands rounded to TF32; "tf32x3" the three-product
    split, big = tf32(x), small = tf32(x - big), a b = a_small b_big +
    a_big b_small + a_big b_big (the small·small term, about 2^-22 of the
    product, is dropped), as the tensor cores sum it: k steps of 8, each mma
    adding its 8 exact products (two TF32 values multiply exactly) into the
    fp32 accumulator and rounding toward zero. ``chunk`` k steps are summed
    so in a fresh accumulator, which is then added into the result rounding
    to nearest: 1, every step apart, is what the kernels do
    (csrc/attention_tf32.cuh::add_part); None, one accumulator over all of
    k, is what they avoid, and then ``into`` is that accumulator's start
    (the running sum itself rounds toward zero at every mma)."""
    if split is None or split == "tf32":
        if split is not None:
            a, b = tf32_round(a), tf32_round(b)
        out = torch.matmul(a, b)
        return out if into is None else into + out
    if split not in SPLITS:
        raise ValueError(f"split must be one of {SPLITS}, got {split!r}")
    a_big, b_big = tf32_round(a), tf32_round(b)
    a_small, b_small = tf32_round(a - a_big), tf32_round(b - b_big)
    steps = -(-a.shape[-1] // 8)
    pad = steps * 8 - a.shape[-1]

    def by_step(x, y):
        """The exact products of each k step: [..., steps, M, N] in float64."""
        xs = torch.nn.functional.pad(x.double(), (0, pad)).unflatten(-1, (steps, 8))
        ys = torch.nn.functional.pad(y.double(), (0, 0, 0, pad)).unflatten(-2, (steps, 8))
        return torch.matmul(xs.movedim(-2, -3), ys)

    prods = [by_step(x, y) for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big))]
    if chunk == 1:  # each step's three mma into a fresh accumulator, all steps at once
        part = _toward_zero(prods[0])
        for exact in prods[1:]:
            part = _toward_zero(part.double() + exact)
        total = into
        for i in range(steps):
            total = part[..., i, :, :] if total is None else total + part[..., i, :, :]
        return total
    total, part = (None, into) if chunk is None else (into, None)
    for i in range(steps):
        for exact in prods:
            step = exact[..., i, :, :]
            part = _toward_zero(step if part is None else part.double() + step)
        if (chunk and (i + 1) % chunk == 0) or i == steps - 1:
            total = part if total is None else total + part
            part = None
    return total


def tile_rel_err(got: torch.Tensor, want: torch.Tensor, tile: int = STREAM_TILE) -> float:
    """The kernels' per-tile bound, measured: the worst, over the heads and
    the ``tile``-long tiles of S of [B, H, S, D] tensors (the last tile
    ragged), of max |got - want| over max |want| within the tile. Each tile
    is held to its own scale, so the small values far down a sequence are
    checked too (chip_smoke.py holds the kernels to the same measure)."""
    b, h, s, d = want.shape
    n = -(-s // tile)

    def tiles(t):
        t = torch.nn.functional.pad(t.float().reshape(b * h, s, d), (0, 0, 0, n * tile - s))
        return t.reshape(b * h, n, tile * d)

    w = tiles(want)
    err = (tiles(got) - w).abs().amax(-1)
    return (err / w.abs().amax(-1).clamp_min(1e-30)).max().item()


def forward_tile_rows(head_dim: int, programs: int, seq_len: int) -> int:
    """The q tile's rows the bf16 forward kernel takes for ``programs`` = B*H
    heads of ``seq_len`` rows (``forward_tile_rows`` in
    csrc/attention_mma.cuh): 128 at D = 128 when those tiles still give every
    SM a CTA (measured 18-21% faster at S = 1280 and 4352: a warp's two
    16-row blocks share each fragment read from shared memory), else 64 (the
    serving prefill, B*H = 32 and S = 256, stays at 128 CTAs; D = 64 gains
    nothing and is built with 64 rows only)."""
    return 128 if head_dim == 128 and programs * -(-seq_len // 128) >= SMS else 64


def key_tile_range(q0: int, rows: int, seq_len: int, window: int | None) -> tuple[int, int]:
    """(first, last) 64-key tile, inclusive, that the q tile [q0, q0 + rows)
    walks in the forward and the dQ pass: from the tile of the first key the
    window lets row q0 see, up to the tile of the diagonal of the last row."""
    q_last = min(q0 + rows, seq_len) - 1
    k_first = max(0, q0 - window + 1) if window is not None else 0
    return k_first // STREAM_TILE, q_last // STREAM_TILE


def query_tile_range(c0: int, rows: int, seq_len: int, window: int | None) -> tuple[int, int]:
    """(first, last) 64-row q tile, inclusive, that the key tile
    [c0, c0 + rows) walks in the dK/dV pass: from the tile of row c0 (the
    diagonal) down to the tile of the last row the window lets see a key."""
    k_last = min(c0 + rows, seq_len) - 1
    q_last = min(seq_len - 1, k_last + window - 1) if window is not None else seq_len - 1
    return c0 // STREAM_TILE, q_last // STREAM_TILE


def tile_needs_mask(q0: int, q_rows: int, c0: int, k_rows: int, seq_len: int,
                    window: int | None, ragged_rows: bool = False) -> bool:
    """Whether the tile of rows [q0, q0 + q_rows) and keys [c0, c0 + k_rows)
    may hold a masked pair, so the kernel must test every element: the
    diagonal crosses it (its largest key exceeds its smallest row), or the
    window's edge does (its largest row is ``window`` or more beyond its
    smallest key). Keys at or beyond ``seq_len`` only occur where the
    diagonal crosses. ``ragged_rows`` (the dK/dV pass, where q rows are
    streamed) also flags a tile with rows at or beyond ``seq_len``."""
    return (c0 + k_rows - 1 > q0
            or (window is not None and q0 + q_rows - 1 - c0 >= window)
            or (ragged_rows and q0 + q_rows > seq_len))


def _tile_mask(q0, q_rows, c0, k_rows, window, device):
    i = torch.arange(q0, q0 + q_rows, device=device)[:, None]
    j = torch.arange(c0, c0 + k_rows, device=device)[None, :]
    mask = j > i
    if window is not None:
        mask = mask | (i - j >= window)
    return i, j, mask


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """[B, H, S, D] zero-padded to ``rows`` rows, as the kernels' copies fill
    rows at or beyond S with zeros."""
    return torch.nn.functional.pad(t, (0, 0, 0, rows - t.shape[2]))


def _forward_walk(qt, kf, vf, tiles, scale_log2, mask, keep, v_dtype, split):
    """One q tile's forward over the 64-key tiles ``tiles`` (their first
    keys), as the kernels walk it: an online softmax in the log2 domain whose
    running max starts at the finite NEG_INF. ``mask(x, c0, n)`` masks the
    scores x of keys [c0, c0 + n) where the kernels mask them; ``keep(p, c0,
    n)`` is p_v, the hash dropout of the same keys; p_v is rounded to
    ``v_dtype`` before its product. With a ``split`` (the fp32 kernels) the
    products are ``split_matmul``'s and two groups each take one 32-key half
    of every tile with their own (m, l, acc), merged once at the end as
    csrc/attention_tf32.cuh::merge_halves merges them: m = max(m0, m1),
    acc = acc0 2^(m0 - m) + acc1 2^(m1 - m), l likewise. Returns (acc, m, l)
    of the tile's rows, m in the log2 domain."""
    rows, d = qt.shape[-2], qt.shape[-1]
    width = STREAM_TILE if split is None else STREAM_TILE // 2
    groups = []
    for g0 in range(0, STREAM_TILE, width):
        acc = torch.zeros((*qt.shape[:-2], rows, d), dtype=torch.float32, device=qt.device)
        m = torch.full((*qt.shape[:-2], rows, 1), NEG_INF, dtype=torch.float32,
                       device=qt.device)
        l = torch.zeros_like(m)
        for c0 in tiles:
            h0 = c0 + g0
            kt, vt = kf[:, :, h0:h0 + width], vf[:, :, h0:h0 + width]
            x = mask(split_matmul(qt, kt.transpose(-1, -2), split) * scale_log2, h0, width)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)  # the undropped normalizer
            p_v = keep(p, h0, width).to(v_dtype).float()
            acc = split_matmul(p_v, vt, split, into=acc * alpha)
            m = m_new
        groups.append((acc, m, l))
    if len(groups) == 1:
        return groups[0]
    (acc0, m0, l0), (acc1, m1, l1) = groups
    m = torch.maximum(m0, m1)
    f0, f1 = torch.exp2(m0 - m), torch.exp2(m1 - m)
    return acc0 * f0 + acc1 * f1, m, l0 * f0 + l1 * f1


def attention_tiled_reference(q, k, v, window=None, dropout_rate=0.0, dropout_seed=None,
                              rows: int = 64, split=None):
    """The forward as the kernels walk it, in plain torch: q tiles of
    ``rows`` rows, each walking the 64-key tiles of ``key_tile_range`` with
    an online softmax in the log2 domain whose running max starts at the
    finite NEG_INF; the mask is applied only on tiles ``tile_needs_mask``
    flags; p_v is rounded to v's dtype before its product. ``split`` takes
    both products as ``split_matmul`` does, with the fp32 kernels' two warp
    groups a q tile ("tf32x3": the fp32 forward, 64-row tiles only; see
    ``_forward_walk``). Returns (out [B, H, S, D] in q's dtype, fp32 lse
    [B*H, S])."""
    if split is not None and rows != STREAM_TILE:
        raise ValueError(f"the fp32 forward takes {STREAM_TILE}-row q tiles, not {rows}")
    b, h, s, d = q.shape
    padded = -(-s // max(rows, STREAM_TILE)) * max(rows, STREAM_TILE)
    qf, kf, vf = (_pad_rows(t, padded).float() for t in (q, k, v))
    scale_log2 = _LOG2E / math.sqrt(d)
    out = torch.zeros((b, h, padded, d), dtype=torch.float32, device=q.device)
    lse = torch.zeros((b, h, padded), dtype=torch.float32, device=q.device)
    seeds = None
    if dropout_rate > 0.0:
        seeds = (int(dropout_seed) + torch.arange(b * h, device=q.device)).reshape(b, h, 1, 1)
    for q0 in range(0, s, rows):
        def mask(x, c0, n, q0=q0):
            if not tile_needs_mask(q0, rows, c0 // STREAM_TILE * STREAM_TILE, STREAM_TILE, s,
                                   window):
                return x
            return x.masked_fill(_tile_mask(q0, rows, c0, n, window, q.device)[2], NEG_INF)

        def keep(p, c0, n, q0=q0):
            if seeds is None:
                return p
            i, j, _ = _tile_mask(q0, rows, c0, n, window, q.device)
            return torch.where(dropout_keep(i, j, seeds, dropout_rate),
                               p * (1.0 / (1.0 - dropout_rate)), 0.0)

        first, last = key_tile_range(q0, rows, s, window)
        acc, m, l = _forward_walk(qf[:, :, q0:q0 + rows], kf, vf,
                                  range(first * STREAM_TILE, (last + 1) * STREAM_TILE,
                                        STREAM_TILE),
                                  scale_log2, mask, keep, v.dtype, split)
        l_safe = l.clamp_min(1e-30)
        out[:, :, q0:q0 + rows] = acc / l_safe
        lse[:, :, q0:q0 + rows] = (m * math.log(2.0) + torch.log(l_safe)).squeeze(-1)
    return out[:, :, :s].to(q.dtype), lse[:, :, :s].reshape(b * h, s)


def attention_backward_tiled_reference(q, k, v, out, lse, g, window=None, dropout_rate=0.0,
                                       dropout_seed=None, rows: int = 64, split=None):
    """The backward as the tensor-core kernels walk it, in plain torch: a dQ
    pass (q tiles of ``rows`` rows over ``key_tile_range``) and a dK/dV pass
    (key tiles of ``rows`` keys over ``query_tile_range``), each recomputing
    p = exp2(s log2 e - lse log2 e) and dp per tile, masking only where
    ``tile_needs_mask`` says, with ds and p_v rounded to the input dtype
    before their products. ``split`` takes each of the five products as
    ``split_matmul`` does ("tf32x3": the fp32 kernels). Returns dq, dk, dv
    in q's dtype."""
    b, h, s, d = q.shape
    big = max(rows, STREAM_TILE)
    padded = -(-s // big) * big
    qf, kf, vf, gf = (_pad_rows(t, padded).float() for t in (q, k, v, g))
    scale = 1.0 / math.sqrt(d)
    dsum = torch.nn.functional.pad((g.float() * out.float()).sum(-1), (0, padded - s))
    lse2 = torch.nn.functional.pad(lse.reshape(b, h, s), (0, padded - s)) * _LOG2E
    inv = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0.0 else 1.0
    seeds = None
    if dropout_rate > 0.0:
        seeds = (int(dropout_seed) + torch.arange(b * h, device=q.device)).reshape(b, h, 1, 1)

    def mm(a, b):
        return split_matmul(a, b, split)

    def tile(q0, q_rows, c0, k_rows, ragged_rows):
        """(ds, p_v) of one tile, rounded as the kernels round, fp32."""
        x = mm(qf[:, :, q0:q0 + q_rows], kf[:, :, c0:c0 + k_rows].transpose(-1, -2))
        p = torch.exp2(x * (scale * _LOG2E) - lse2[:, :, q0:q0 + q_rows, None])
        i, j, mask = _tile_mask(q0, q_rows, c0, k_rows, window, q.device)
        if tile_needs_mask(q0, q_rows, c0, k_rows, s, window, ragged_rows):
            p = torch.where(mask | (i >= s), 0.0, p)
        dp = mm(gf[:, :, q0:q0 + q_rows], vf[:, :, c0:c0 + k_rows].transpose(-1, -2))
        p_v = p
        if seeds is not None:
            keep = dropout_keep(i, j, seeds, dropout_rate)
            dp = torch.where(keep, dp * inv, 0.0)
            p_v = torch.where(keep, p * inv, 0.0)
        ds = (p * (dp - dsum[:, :, q0:q0 + q_rows, None])).to(k.dtype).float()
        return ds, p_v.to(g.dtype).float()

    dq = torch.zeros_like(qf)
    for q0 in range(0, s, rows):
        first, last = key_tile_range(q0, rows, s, window)
        for t in range(first, last + 1):
            c0 = t * STREAM_TILE
            ds, _ = tile(q0, rows, c0, STREAM_TILE, False)
            dq[:, :, q0:q0 + rows] += mm(ds, kf[:, :, c0:c0 + STREAM_TILE])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for c0 in range(0, s, rows):
        first, last = query_tile_range(c0, rows, s, window)
        for t in range(first, last + 1):
            q0 = t * STREAM_TILE
            ds, p_v = tile(q0, STREAM_TILE, c0, rows, True)
            dk[:, :, c0:c0 + rows] += mm(ds.transpose(-1, -2), qf[:, :, q0:q0 + STREAM_TILE])
            dv[:, :, c0:c0 + rows] += mm(p_v.transpose(-1, -2), gf[:, :, q0:q0 + STREAM_TILE])
    return tuple(t[:, :, :s].to(q.dtype) for t in (dq * scale, dk * scale, dv))


# ---------------------------------------------------------------- ring hops
# One hop between the local q shard (Sq rows) and a visiting k/v shard (Sk
# keys): local (r, c) is masked where c - r > diff, where (r - c) + diff >=
# window, and where c >= Sk (ops/ring_attention.py::_masks).


def ring_key_tile_range(q0: int, rows: int, s_q: int, s_k: int, diff: int,
                        window: int | None) -> tuple[int, int]:
    """(first, last) 64-key tile, inclusive, that the q tile [q0, q0 + rows)
    walks in ``ring_partial`` and the dQ pass: the tiles holding a live key
    for one of its rows, [q0 + diff - window + 1, q_last + diff] clamped to
    [0, Sk). last = first - 1 when there is none (only under a window)."""
    q_last = min(q0 + rows, s_q) - 1
    c_hi = min(s_k - 1, q_last + diff)
    c_lo = max(0, q0 + diff - window + 1) if window is not None else 0
    first = c_lo // STREAM_TILE
    return first, (c_hi // STREAM_TILE if c_hi >= c_lo else first - 1)


def ring_query_tile_range(c0: int, rows: int, s_q: int, s_k: int, diff: int,
                          window: int | None) -> tuple[int, int]:
    """(first, last) 64-row q tile, inclusive, that the key tile
    [c0, c0 + rows) walks in the dK/dV pass: the rows that can see one of its
    keys, r >= c0 - diff and, under a window, r <= k_last - diff + window - 1,
    clamped to [0, Sq). last = first - 1 when there is none."""
    k_last = min(c0 + rows, s_k) - 1
    r_lo = max(0, c0 - diff)
    r_hi = min(s_q - 1, k_last - diff + window - 1) if window is not None else s_q - 1
    first = r_lo // STREAM_TILE
    return first, (r_hi // STREAM_TILE if r_hi >= r_lo else first - 1)


def ring_tile_needs_mask(q0: int, q_rows: int, c0: int, k_rows: int, s_q: int, s_k: int,
                         diff: int, window: int | None, ragged_rows: bool = False) -> bool:
    """Whether the tile of rows [q0, q0 + q_rows) and keys [c0, c0 + k_rows)
    of a hop may hold a masked pair, so the kernel must test every element:
    the causal edge crosses it (its largest key less its smallest row exceeds
    ``diff``), the window's edge does (its largest row less its smallest key,
    plus ``diff``, reaches ``window``), or it runs past the visiting shard's
    end. ``ragged_rows`` (the dK/dV pass, where q rows are streamed) also
    flags a tile with rows at or beyond Sq. At a past hop (diff = Sk, no
    window, Sk a multiple of 64) no tile is flagged."""
    return (c0 + k_rows - 1 - q0 > diff
            or (window is not None and q0 + q_rows - 1 - c0 + diff >= window)
            or c0 + k_rows > s_k
            or (ragged_rows and q0 + q_rows > s_q))


def _ring_tile_mask(q0, q_rows, c0, k_rows, diff, window, device):
    """(local rows [q_rows, 1], local keys [1, k_rows], band-masked) of a tile."""
    i = torch.arange(q0, q0 + q_rows, device=device)[:, None]
    j = torch.arange(c0, c0 + k_rows, device=device)[None, :]
    mask = (j - i) > diff
    if window is not None:
        mask = mask | ((i - j) + diff >= window)
    return i, j, mask


def ring_partial_tiled_reference(q, k, v, diff, row0, col0, window=None, rate=0.0, seed=0,
                                 head0=0, heads_total=None, split=None):
    """One hop's forward as the kernels walk it, in plain torch: 64-row q
    tiles over the key tiles of ``ring_key_tile_range``, an online softmax
    in the log2 domain whose running max starts at the finite NEG_INF, the
    mask only on tiles ``ring_tile_needs_mask`` flags (a key at or beyond
    Sk scores -inf, so it adds nothing even to a row whose max is still
    NEG_INF), p_v rounded to v's dtype before its product, hash dropout at
    (row0 + r, col0 + c, seed + b*heads_total + head0 + h: the heads are
    [head0, head0 + H) of ``heads_total``, ``program_seeds``). ``split``
    takes both products as ``split_matmul`` does, with the fp32 kernel's
    two warp groups a q tile ("tf32x3": the fp32 forward; see
    ``_forward_walk``). Returns num fp32
    [B, H, Sq, D] and m, l fp32 [B*H, Sq]; m = m2 ln 2, and a row with no
    live key keeps m = NEG_INF itself, l = the count of its visited keys
    below Sk and num = their sum of p_v v."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    (rows,) = RING_FORWARD_TILES
    qf = _pad_rows(q, -(-s_q // rows) * rows).float()
    kf, vf = (_pad_rows(t, -(-s_k // STREAM_TILE) * STREAM_TILE).float() for t in (k, v))
    scale_log2 = _LOG2E / math.sqrt(d)
    seeds = program_seeds(seed, b, h, q.device, head0, heads_total) if rate > 0.0 else None
    num = torch.zeros((b, h, qf.shape[2], d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, qf.shape[2]), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    for q0 in range(0, s_q, rows):
        def mask(x, c0, n, q0=q0):
            if not ring_tile_needs_mask(q0, rows, c0 // STREAM_TILE * STREAM_TILE, STREAM_TILE,
                                        s_q, s_k, diff, window):
                return x
            _, j, band = _ring_tile_mask(q0, rows, c0, n, diff, window, q.device)
            return x.masked_fill(band, NEG_INF).masked_fill(j >= s_k, -math.inf)

        def keep(p, c0, n, q0=q0):
            if seeds is None:
                return p
            i, j, _ = _ring_tile_mask(q0, rows, c0, n, diff, window, q.device)
            return torch.where(dropout_keep(i + row0, j + col0, seeds, rate),
                               p * (1.0 / (1.0 - rate)), 0.0)

        first, last = ring_key_tile_range(q0, rows, s_q, s_k, diff, window)
        acc, m2, l2 = _forward_walk(qf[:, :, q0:q0 + rows], kf, vf,
                                    range(first * STREAM_TILE, (last + 1) * STREAM_TILE,
                                          STREAM_TILE),
                                    scale_log2, mask, keep, v.dtype, split)
        num[:, :, q0:q0 + rows] = acc
        m[:, :, q0:q0 + rows] = torch.where(m2 == NEG_INF, NEG_INF, m2 * math.log(2.0))[..., 0]
        l[:, :, q0:q0 + rows] = l2[..., 0]
    return num[:, :, :s_q], m[:, :, :s_q].reshape(b * h, s_q), l[:, :, :s_q].reshape(b * h, s_q)


def ring_block_grads_tiled_reference(q, g, lse, dsum, k, v, diff, row0, col0, window=None,
                                     rate=0.0, seed=0, head0=0, heads_total=None, split=None):
    """One hop's gradient as the tensor-core kernels walk it, in plain
    torch: a dQ pass (64-row q tiles over ``ring_key_tile_range``) and a
    dK/dV pass (64-key tiles over ``ring_query_tile_range``), each
    recomputing p = exp2(s D^-0.5 log2 e - lse log2 e) and dp per tile,
    masking only where ``ring_tile_needs_mask`` says (with ``ragged_rows`` in
    the dK/dV pass), ds and p_v rounded to the input dtype before their
    products, each of the five products taken as ``split_matmul`` takes it
    with ``split`` ("tf32x3": the fp32 kernels); the dropout's heads as in
    ``ring_partial_tiled_reference``. Returns dq in q's dtype and dk, dv
    fp32 [B, H, Sk, D], as ``ring_block_grads_reference``."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    tile = STREAM_TILE
    qf, gf = (_pad_rows(t, -(-s_q // tile) * tile).float() for t in (q, g))
    kf, vf = (_pad_rows(t, -(-s_k // tile) * tile).float() for t in (k, v))
    pad = qf.shape[2] - s_q
    lse2 = torch.nn.functional.pad(lse.reshape(b, h, s_q), (0, pad)) * _LOG2E
    dsum_p = torch.nn.functional.pad(dsum.reshape(b, h, s_q), (0, pad))
    scale = 1.0 / math.sqrt(d)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    seeds = program_seeds(seed, b, h, q.device, head0, heads_total) if rate > 0.0 else None

    def mm(a, b):
        return split_matmul(a, b, split)

    def tile_grads(q0, c0, ragged_rows):
        """(ds, p_v) of one 64 x 64 tile, rounded as the kernels round."""
        x = mm(qf[:, :, q0:q0 + tile], kf[:, :, c0:c0 + tile].transpose(-1, -2))
        p = torch.exp2(x * (scale * _LOG2E) - lse2[:, :, q0:q0 + tile, None])
        i, j, mask = _ring_tile_mask(q0, tile, c0, tile, diff, window, q.device)
        if ring_tile_needs_mask(q0, tile, c0, tile, s_q, s_k, diff, window, ragged_rows):
            dead = mask | (j >= s_k)
            p = torch.where(dead | (i >= s_q) if ragged_rows else dead, 0.0, p)
        dp = mm(gf[:, :, q0:q0 + tile], vf[:, :, c0:c0 + tile].transpose(-1, -2))
        p_v = p
        if seeds is not None:
            keep = dropout_keep(i + row0, j + col0, seeds, rate)
            dp = torch.where(keep, dp * inv, 0.0)
            p_v = torch.where(keep, p * inv, 0.0)
        ds = (p * (dp - dsum_p[:, :, q0:q0 + tile, None])).to(k.dtype).float()
        return ds, p_v.to(g.dtype).float()

    dq = torch.zeros_like(qf)
    for q0 in range(0, s_q, tile):
        first, last = ring_key_tile_range(q0, tile, s_q, s_k, diff, window)
        for t in range(first, last + 1):
            c0 = t * tile
            ds, _ = tile_grads(q0, c0, False)
            dq[:, :, q0:q0 + tile] += mm(ds, kf[:, :, c0:c0 + tile])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for c0 in range(0, s_k, tile):
        first, last = ring_query_tile_range(c0, tile, s_q, s_k, diff, window)
        for t in range(first, last + 1):
            q0 = t * tile
            ds, p_v = tile_grads(q0, c0, True)
            dk[:, :, c0:c0 + tile] += mm(ds.transpose(-1, -2), qf[:, :, q0:q0 + tile])
            dv[:, :, c0:c0 + tile] += mm(p_v.transpose(-1, -2), gf[:, :, q0:q0 + tile])
    return ((dq[:, :, :s_q] * scale).to(q.dtype), dk[:, :, :s_k] * scale, dv[:, :, :s_k])
