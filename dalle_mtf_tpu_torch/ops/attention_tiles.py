"""The tile walk of the bf16 tensor-core attention kernels, in Python.

``csrc/causal_attention_fwd.cu`` and ``csrc/causal_attention_bwd.cu`` walk
64-key (or, in the dK/dV pass, 64-row) tiles of one head; their index
arithmetic is written once here, and the CUDA sources point at these
functions as its definition:

- ``forward_tile_rows``: the forward's q tile (64 or 128 rows) by shape;
- ``key_tile_range`` / ``query_tile_range``: the first and last streamed tile
  of an owner tile;
- ``tile_needs_mask``: which tiles must test every element against the mask;
- ``attention_tiled_reference`` / ``attention_backward_tiled_reference``:
  plain torch versions that walk the tiles exactly so (online softmax in the
  log2 domain from the finite NEG_INF, the mask only on edge tiles, p_v and
  ds rounded where the kernels round).

Nothing on the serving or training path imports this module: the CPU tests
hold it against the dense mask, the one-shot plain versions and the JAX
package, and a test on the card holds ``forward_tile_rows`` against the
built kernel's own choice.
"""

from __future__ import annotations

import math

import torch

from dalle_mtf_tpu_torch.ops.attention import NEG_INF, dropout_keep

STREAM_TILE = 64  # rows of a streamed tile (keys in the forward and the dQ pass)
TILE_ROWS = (64, 128)  # rows of the forward's q tile: 4 warps of one or two 16-row blocks
BACKWARD_TILE_ROWS = 64  # both backward passes measured slower with 128 rows: not built
SMS = 132  # an H100's SMs
_LOG2E = 1.4426950408889634


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


def attention_tiled_reference(q, k, v, window=None, dropout_rate=0.0, dropout_seed=None,
                              rows: int = 64):
    """The forward as the bf16 kernel walks it, in plain torch: q tiles of
    ``rows`` rows, each walking the 64-key tiles of ``key_tile_range`` with
    an online softmax in the log2 domain whose running max starts at the
    finite NEG_INF; the mask is applied only on tiles ``tile_needs_mask``
    flags; p_v is rounded to v's dtype before its product. Returns
    (out [B, H, S, D] in q's dtype, fp32 lse [B*H, S])."""
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
        acc = torch.zeros((b, h, rows, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, rows, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        first, last = key_tile_range(q0, rows, s, window)
        for t in range(first, last + 1):
            c0 = t * STREAM_TILE
            x = torch.matmul(qf[:, :, q0:q0 + rows],
                             kf[:, :, c0:c0 + STREAM_TILE].transpose(-1, -2)) * scale_log2
            i, j, mask = _tile_mask(q0, rows, c0, STREAM_TILE, window, q.device)
            if tile_needs_mask(q0, rows, c0, STREAM_TILE, s, window):
                x = x.masked_fill(mask, NEG_INF)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)  # the undropped normalizer
            p_v = p
            if seeds is not None:
                keep = dropout_keep(i, j, seeds, dropout_rate)
                p_v = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
            acc = acc * alpha + torch.matmul(p_v.to(v.dtype).float(),
                                             vf[:, :, c0:c0 + STREAM_TILE])
            m = m_new
        l_safe = l.clamp_min(1e-30)
        out[:, :, q0:q0 + rows] = acc / l_safe
        lse[:, :, q0:q0 + rows] = (m * math.log(2.0) + torch.log(l_safe)).squeeze(-1)
    return out[:, :, :s].to(q.dtype), lse[:, :, :s].reshape(b * h, s)


def attention_backward_tiled_reference(q, k, v, out, lse, g, window=None, dropout_rate=0.0,
                                       dropout_seed=None, rows: int = 64):
    """The backward as the bf16 kernels walk it, in plain torch: a dQ pass
    (q tiles of ``rows`` rows over ``key_tile_range``) and a dK/dV pass (key
    tiles of ``rows`` keys over ``query_tile_range``), each recomputing
    p = exp2(s log2 e - lse log2 e) and dp per tile, masking only where
    ``tile_needs_mask`` says, with ds and p_v rounded to the input dtype
    before their products. Returns dq, dk, dv in q's dtype."""
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

    def tile(q0, q_rows, c0, k_rows, ragged_rows):
        """(p, dp after the dropout keep, p_v) of one tile, fp32."""
        x = torch.matmul(qf[:, :, q0:q0 + q_rows], kf[:, :, c0:c0 + k_rows].transpose(-1, -2))
        p = torch.exp2(x * (scale * _LOG2E) - lse2[:, :, q0:q0 + q_rows, None])
        i, j, mask = _tile_mask(q0, q_rows, c0, k_rows, window, q.device)
        if tile_needs_mask(q0, q_rows, c0, k_rows, s, window, ragged_rows):
            p = torch.where(mask | (i >= s), 0.0, p)
        dp = torch.matmul(gf[:, :, q0:q0 + q_rows], vf[:, :, c0:c0 + k_rows].transpose(-1, -2))
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
            dq[:, :, q0:q0 + rows] += torch.matmul(ds, kf[:, :, c0:c0 + STREAM_TILE])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for c0 in range(0, s, rows):
        first, last = query_tile_range(c0, rows, s, window)
        for t in range(first, last + 1):
            q0 = t * STREAM_TILE
            ds, p_v = tile(q0, STREAM_TILE, c0, rows, True)
            dk[:, :, c0:c0 + rows] += torch.matmul(ds.transpose(-1, -2),
                                                   qf[:, :, q0:q0 + STREAM_TILE])
            dv[:, :, c0:c0 + rows] += torch.matmul(p_v.transpose(-1, -2),
                                                   gf[:, :, q0:q0 + STREAM_TILE])
    return tuple(t[:, :, :s].to(q.dtype) for t in (dq * scale, dk * scale, dv))
