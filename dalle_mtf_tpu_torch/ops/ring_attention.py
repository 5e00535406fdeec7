"""Ring attention: causal attention with the sequence sharded over a mesh
axis (port of ``dalle_mtf_tpu/ops/ring_attention.py``).

Every rank of the ``seq`` axis holds one shard of q, k and v, [B, H,
S_local, D], shard i holding global positions [i*S_local, (i+1)*S_local).
Over n hops the k/v shards rotate around the axis (rank i sends to i + 1 and
receives from i - 1), and each rank folds the visiting shard into a running
softmax state in fp32. Masks and dropout bits are keyed on GLOBAL
coordinates: with row0 = my_idx*S_local and col0 = src*S_local, a score is
masked where (c - r) > diff, diff = row0 - col0, and, with a local window,
where (r - c) + diff >= window. A shard wholly in the future (or wholly below
the window's band) is skipped (``_live_shard``).

- ``ring_partial_reference`` / ``ring_partial``: one hop's partial softmax
  triple (num = exp(s - m)·p_v·V unnormalised in fp32, m, l the undropped
  normaliser; one value per row). The wrapper launches
  ``csrc/ring_attention.cu``'s forward on CUDA tensors (the port of the TPU
  kernel ``_ring_fwd_kernel``) and runs the plain version on CPU tensors.
- ``ring_block_grads_reference`` / ``ring_block_grads``: one hop's gradient
  (the port of ``_ring_bwd_kernel``): dq of the hop in q's dtype, and dk, dv
  added in place into the rotating fp32 accumulators.
- ``_RingAttention``: the forward fold (``_ring_fwd_impl``) and the backward
  ring (``_ring_pallas_bwd``), in which k, v, dk and dv rotate together, so
  that dk and dv arrive home summed after n hops.
- ``ring_shift``: the neighbour exchange with ``batch_isend_irecv``; over
  gloo, CUDA tensors are staged through host memory (gloo sends only CPU
  tensors).
- ``ring_attention_auto``: the model's entry. Without a ``seq`` axis of
  size > 1 it is ``causal_attention`` (the JAX semantics: sampling and
  single-device runs compute the same function in one piece).

Every function here takes a block of the heads: q, k, v hold heads [head0,
head0 + H) of ``heads_total`` (a tensor-parallel rank's block; default all
of them), and program (b, h) hashes its dropout with seed + b*heads_total +
head0 + h (``ops.attention.program_seeds``), the mask one process draws on
those heads.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from dalle_mtf_tpu_torch.ops.attention import (
    KERNEL_DTYPES,
    NEG_INF,
    _head_args,
    _on_cpu,
    attention_reference,
    causal_attention,
    check_kernel_inputs,
    dense_for_kernels,
    dropout_args,
    dropout_keep,
    program_seeds,
)

# Launches of the two ring kernels, counted where (and only where) each is
# launched; chip_smoke.py reads and resets them.
KERNEL_LAUNCHES = {"ring_partial": 0, "ring_block_grads": 0}
# Bytes ring_shift staged through host memory (sent plus received), for the
# report of a run whose ranks share a card over gloo.
STAGED_BYTES = {"ring_shift": 0}


def _masks(s_q, s_k, diff, window, device):
    """(local rows [Sq, 1], local cols [1, Sk], masked [Sq, Sk]) of one hop."""
    r = torch.arange(s_q, device=device)[:, None]
    c = torch.arange(s_k, device=device)[None, :]
    mask = (c - r) > diff
    if window is not None:
        mask = mask | ((r - c) + diff >= window)
    return r, c, mask


def _keep(r, c, row0, col0, seed, b, h, rate, head0=0, heads_total=None):
    """The hash dropout's keep bits at global (row0 + r, col0 + c) for the
    programs (b, h) of heads [head0, head0 + h) of ``heads_total``
    (``program_seeds``): [b, h, Sq, Sk] bool."""
    seeds = program_seeds(seed, b, h, r.device, head0, heads_total)
    return dropout_keep(r + row0, c + col0, seeds, rate)


def ring_partial_reference(q, k, v, diff, row0, col0, window=None, rate=0.0, seed=0,
                           head0=0, heads_total=None):
    """The plain version of one hop, with the TPU kernel's math in one shot.

    q [B, H, Sq, D]; k, v [B, H, Sk, D]. Scores in fp32 scaled by D^-0.5,
    masked scores REPLACED by NEG_INF, m = rowmax, p = exp(s - m), l = sum p
    (undropped); p_v = p, or with hash dropout keep ? p / (1 - rate) : 0
    keyed on (row0 + r, col0 + c, seed + b*heads_total + head0 + h); num = (p_v cast to v's
    dtype) @ v in fp32. Returns num fp32 [B, H, Sq, D] and m, l fp32
    [B*H, Sq]. A row with no live key gets m = NEG_INF, l = Sk, num = sum v
    (the fold discards it)."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    r, c, mask = _masks(s_q, s_k, diff, window, q.device)
    s = s.masked_fill(mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    p_v = p
    if rate > 0.0:
        keep = _keep(r, c, row0, col0, seed, b, h, rate, head0, heads_total)
        p_v = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    num = torch.matmul(p_v.to(v.dtype).float(), v.float())
    return num, m.reshape(b * h, s_q), l.reshape(b * h, s_q)


def ring_block_grads_reference(q, g, lse, dsum, k, v, diff, row0, col0, window=None,
                               rate=0.0, seed=0, head0=0, heads_total=None):
    """The plain version of one hop's gradient (the TPU kernel's math).

    q, g [B, H, Sq, D]; k, v [B, H, Sk, D]; lse, dsum fp32 [B*H, Sq].
    p = exp(s - lse) with masked p exactly 0; dp = g v^T, and with hash
    dropout dp and p_v keep-masked and scaled; ds = p (dp - dsum) cast to
    k's dtype; dq = ds k * D^-0.5 in q's dtype; dk = ds^T q * D^-0.5 and
    dv = (p_v cast to g's dtype)^T g, both fp32 [B, H, Sk, D]."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    r, c, mask = _masks(s_q, s_k, diff, window, q.device)
    p = torch.where(mask, 0.0, torch.exp(s - lse.reshape(b, h, s_q, 1)))
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    p_v = p
    if rate > 0.0:
        keep = _keep(r, c, row0, col0, seed, b, h, rate, head0, heads_total)
        inv = 1.0 / (1.0 - rate)
        dp = torch.where(keep, dp * inv, 0.0)
        p_v = torch.where(keep, p * inv, 0.0)
    ds = (p * (dp - dsum.reshape(b, h, s_q, 1))).to(k.dtype).float()
    dq = (torch.matmul(ds, k.float()) * scale).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p_v.to(g.dtype).float().transpose(-1, -2), g.float())
    return dq, dk, dv


def _check_hop(name, q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: q [B, H, Sq, D], k and v [B, H, Sk, D]: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} needs contiguous q, k, v")
    check_kernel_inputs(name, (k, v), q.shape[3])
    check_kernel_inputs(name, (q,), q.shape[3])
    if q.dtype != k.dtype or q.device != k.device:
        raise ValueError(f"{name}: q and k, v must share one dtype and device")


def _check_rows(name, q, **tensors):
    b, h, s_q, _ = q.shape
    for what, t in tensors.items():
        if (t.shape != (b * h, s_q) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name}: {what} must be contiguous fp32 [{b * h}, {s_q}] on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def ring_partial(q, k, v, diff, row0, col0, window=None, rate=0.0, seed=0, head0=0,
                 heads_total=None):
    """One hop's (num fp32 [B, H, Sq, D], m, l fp32 [B*H, Sq]): the kernel on
    CUDA tensors, the plain version on CPU ones. ``seed`` is the program
    seed of (b, h) = (0, 0) of one launch over all ``heads_total`` heads,
    of which q, k, v hold [head0, head0 + H); program (b, h) adds b *
    heads_total + head0 + h. A view off 16 bytes is copied first
    (``ops/attention.py``)."""
    if _on_cpu(q, k, v):
        return ring_partial_reference(q, k, v, diff, row0, col0, window, rate, seed, head0,
                                      heads_total)
    q, k, v = dense_for_kernels(q, k, v)
    _check_hop("ring_partial", q, k, v)
    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    lib = library()
    with torch.cuda.device(q.device):
        num = torch.empty((b, h, s_q, d), dtype=torch.float32, device=q.device)
        m = torch.empty((b * h, s_q), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        err = lib.ring_partial(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), num.data_ptr(), m.data_ptr(),
            l.data_ptr(), b * h, s_q, s_k, d, KERNEL_DTYPES[q.dtype], int(diff),
            int(row0), int(col0), -1 if window is None else int(window),
            *dropout_args(rate, seed), h, *_head_args(h, head0, heads_total),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_partial launch failed: cudaError {err}")
    KERNEL_LAUNCHES["ring_partial"] += 1
    return num, m, l


def add_block_grads_reference(q, g, lse, dsum, k, v, dk_acc, dv_acc, diff, row0, col0,
                              window=None, rate=0.0, seed=0, head0=0, heads_total=None):
    """``ring_block_grads`` by its plain version, on any device: returns dq
    and adds dk, dv into the accumulators."""
    dq, dk, dv = ring_block_grads_reference(q, g, lse, dsum, k, v, diff, row0, col0, window,
                                            rate, seed, head0, heads_total)
    dk_acc += dk
    dv_acc += dv
    return dq


def ring_block_grads(q, g, lse, dsum, k, v, dk_acc, dv_acc, diff, row0, col0,
                     window=None, rate=0.0, seed=0, head0=0, heads_total=None):
    """One hop's gradient: returns dq of the hop in q's dtype and adds dk
    and dv into the fp32 accumulators ``dk_acc``, ``dv_acc`` [B, H, Sk, D]
    in place. The kernel (a dQ launch and a dK/dV launch, no atomics) on
    CUDA tensors, the plain version on CPU ones. Inputs off 16 bytes are
    copied first; the accumulators, which the kernel adds into, are not.
    ``seed``, ``head0`` and ``heads_total`` as in ``ring_partial``."""
    if _on_cpu(q, g, k, v):
        return add_block_grads_reference(q, g, lse, dsum, k, v, dk_acc, dv_acc, diff, row0,
                                         col0, window, rate, seed, head0, heads_total)
    q, g, k, v = dense_for_kernels(q, g, k, v)
    _check_hop("ring_block_grads", q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or not g.is_contiguous():
        raise ValueError("ring_block_grads: g must be contiguous and match q")
    check_kernel_inputs("ring_block_grads", (q, g), q.shape[3])
    _check_rows("ring_block_grads", q, lse=lse, dsum=dsum)
    for what, t in (("dk_acc", dk_acc), ("dv_acc", dv_acc)):
        if t.shape != k.shape or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != k.device:
            raise ValueError(f"ring_block_grads: {what} must be contiguous fp32 "
                             f"{tuple(k.shape)} on {k.device}")
        if t.data_ptr() % 8:
            # the kernels add into them by pairs, 8-byte accesses
            raise ValueError(f"ring_block_grads: {what} must be 8-byte aligned (data_ptr "
                             f"{t.data_ptr():#x})")
    from dalle_mtf_tpu_torch.ops._build import library  # noqa: PLC0415

    b, h, s_q, d = q.shape
    lib = library()
    with torch.cuda.device(q.device):
        dq = torch.empty_like(q)
        err = lib.ring_block_grads(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            dsum.data_ptr(), dq.data_ptr(), dk_acc.data_ptr(), dv_acc.data_ptr(),
            b * h, s_q, k.shape[2], d, KERNEL_DTYPES[q.dtype], int(diff), int(row0),
            int(col0), -1 if window is None else int(window), *dropout_args(rate, seed),
            h, *_head_args(h, head0, heads_total),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_block_grads launch failed: cudaError {err}")
    KERNEL_LAUNCHES["ring_block_grads"] += 1
    return dq


def _live_shard(src: int, my_idx: int, s_local: int, window) -> bool:
    """False when the visiting shard contributes nothing: strictly future
    (src > my_idx), or, under a window, wholly below the band (the least
    global row - col over the pair, diff - S_local + 1, is >= window)."""
    if src > my_idx:
        return False
    return window is None or (my_idx - src) * s_local - s_local + 1 < window


class Ring:
    """This rank's place on the ring: the process group, the global ranks in
    axis order and this rank's index. Made by ``ring_attention_auto`` from
    the mesh; the functions below take it."""

    def __init__(self, group, ranks: list[int], index: int):
        self.group, self.ranks, self.index, self.n = group, ranks, index, len(ranks)
        self.stage = dist.get_backend(group) == "gloo"


def ring_shift(tensors, ring: Ring):
    """Send each tensor to the next rank of the ring and return what the
    previous rank sent (same shapes, dtypes and device). Over gloo a CUDA
    tensor goes through host memory, counted in ``STAGED_BYTES``."""
    nxt = ring.ranks[(ring.index + 1) % ring.n]
    prv = ring.ranks[(ring.index - 1) % ring.n]
    ops, outs = [], []
    for i, t in enumerate(tensors):
        staged = ring.stage and t.device.type != "cpu"
        src = t.detach().to("cpu") if staged else t.detach().contiguous()
        dst = torch.empty_like(src)
        if staged:
            STAGED_BYTES["ring_shift"] += 2 * src.numel() * src.element_size()
        ops.append(dist.P2POp(dist.isend, src, nxt, ring.group, tag=i))
        ops.append(dist.P2POp(dist.irecv, dst, prv, ring.group, tag=i))
        outs.append((dst, t.device, staged))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [dst.to(dev) if staged else dst for dst, dev, staged in outs]


def _fold_forward(q, k, v, ring: Ring, window, rate, seed, plain, head0=0, heads_total=None):
    """(out in q's dtype, fp32 lse [B*H, S_local]): the fp32 fold of the
    live hops' partial triples (JAX ``_ring_fwd_impl``); ``plain`` takes
    the hops' plain versions. q, k, v hold heads [head0, head0 + H) of
    ``heads_total``."""
    partial = ring_partial_reference if plain else ring_partial
    b, h, s_local, d = q.shape
    my = ring.index
    acc = torch.zeros((b, h, s_local, d), dtype=torch.float32, device=q.device)
    m = torch.full((b * h, s_local), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    k_cur, v_cur = k, v
    for hop in range(ring.n):
        src = (my - hop) % ring.n
        if _live_shard(src, my, s_local, window):
            num, m_cur, l_cur = partial(q, k_cur, v_cur, (my - src) * s_local, my * s_local,
                                        src * s_local, window, rate, seed, head0, heads_total)
            m_new = torch.maximum(m, m_cur)
            alpha, beta = torch.exp(m - m_new), torch.exp(m_cur - m_new)
            acc = acc * alpha.reshape(b, h, s_local, 1) + num * beta.reshape(b, h, s_local, 1)
            l = l * alpha + l_cur * beta
            m = m_new
        if hop < ring.n - 1:
            k_cur, v_cur = ring_shift((k_cur, v_cur), ring)
    l_safe = l.clamp_min(1e-30)
    out = (acc / l_safe.reshape(b, h, s_local, 1)).to(q.dtype)
    return out, m + torch.log(l_safe)


def _ring_backward(q, k, v, out, lse, g, ring: Ring, window, rate, seed, plain, head0=0,
                   heads_total=None):
    """dq, dk, dv: the backward ring (JAX ``_ring_pallas_bwd``). dsum is one
    reduction outside the kernels; k, v and their fp32 dk, dv accumulators
    rotate together, so after n hops dk and dv are home and summed.
    ``plain`` takes the hops' plain versions; the heads as in
    ``_fold_forward``."""
    block_grads = add_block_grads_reference if plain else ring_block_grads
    b, h, s_local, d = q.shape
    my = ring.index
    g = g.contiguous()
    dsum = (g.float() * out.float()).sum(-1).reshape(b * h, s_local)
    dq = torch.zeros((b, h, s_local, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    k_cur, v_cur = k, v
    for hop in range(ring.n):
        src = (my - hop) % ring.n
        if _live_shard(src, my, s_local, window):
            dq += block_grads(q, g, lse, dsum, k_cur, v_cur, dk, dv, (my - src) * s_local,
                              my * s_local, src * s_local, window, rate, seed, head0,
                              heads_total).float()
        if hop < ring.n - 1:
            k_cur, v_cur, dk, dv = ring_shift((k_cur, v_cur, dk, dv), ring)
        else:
            dk, dv = ring_shift((dk, dv), ring)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """out = ring attention(q, k, v) of this rank's shard; saves q, k, v,
    out and the fp32 lse, as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, ring, window, rate, seed, plain, head0, heads_total):
        out, lse = _fold_forward(q, k, v, ring, window, rate, seed, plain, head0, heads_total)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ring, window, rate, seed, plain, head0, heads_total)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, g, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def ring_seed(dropout_seed: int, mesh, batch_axis: str | None, rows: int,
              heads_total: int) -> int:
    """The seed of program (0, 0) of this rank's launches: ``dropout_seed``
    offset by its first global batch row b0 = (index on ``batch_axis``) *
    ``rows``, times ``heads_total`` (JAX ``ring_attention_auto``'s
    ``axis_index(batch) * bl * h_total``; the heads' offset head0 is the
    kernels' own)."""
    return int(dropout_seed) + (mesh.index(batch_axis) * rows * heads_total if mesh else 0)


def ring_attention_auto(q, k, v, mesh=None, seq_axis: str = "seq",
                        batch_axis: str | None = "data", window=None,
                        dropout_rate: float = 0.0, dropout_seed: int | None = None,
                        plain: bool = False, head0: int = 0, heads_total: int | None = None):
    """The model's entry (``attention_type`` "ring"/"local_ring"): q, k, v
    are this rank's [B, H, S_local, D] shard, its heads [head0, head0 + H)
    of ``heads_total`` (default H: every head; a tensor-parallel rank's
    block, ``DALLE.heads``). With a ``mesh`` whose ``seq_axis`` has size > 1
    it runs the ring; otherwise it is ``causal_attention`` over the whole
    sequence, the same function. ``plain`` (the model's choice at a head dim
    the kernels do not take: ``kernel_takes_head_dim``) runs the plain
    versions instead, on any device.

    The dropout seed is offset by the rank's global batch row b0 =
    (index on ``batch_axis``) * B (``ring_seed``), so that program (b, h)
    uses dropout_seed + (b0 + b)*heads_total + head0 + h, as a single
    process would (as JAX's ``ring_attention_auto`` offsets its seed and
    its kernels hash with ``heads_total``)."""
    rate = float(dropout_rate) if dropout_seed is not None else 0.0
    total, head0 = _head_args(q.shape[1], head0, heads_total)  # the block lies in the heads
    seed = None
    if rate > 0.0:
        seed = ring_seed(dropout_seed, mesh, batch_axis, q.shape[0], total)
    if mesh is None or mesh.size(seq_axis) == 1:
        if plain:
            return attention_reference(q, k, v, True, window, False, rate, seed, head0, total)
        return causal_attention(q, k, v, window=window, dropout_rate=rate, dropout_seed=seed,
                                head0=head0, heads_total=total)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    ring = Ring(mesh.group(seq_axis), mesh.ranks(seq_axis), mesh.index(seq_axis))
    args = (ring, window, rate, seed or 0, plain, head0, total)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RingAttention.apply(q, k, v, *args)
    return _fold_forward(q, k, v, *args)[0]
