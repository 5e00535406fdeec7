"""Text -> image sampling (port of ``dalle_mtf_tpu/sample.py``).

Whole-batch pipeline: DALLE prefill over the text prompt -> a Python loop of
image_seq_len decode steps against the KV cache -> VAE decode_tokens ->
pixels in [0, 1]. Logits are computed only over the image-token band
[text_vocab_size, text_vocab_size + image_vocab_size), so the model can never
emit text or EOS tokens inside the image. The continuous-batching engine
(serve.ContinuousBatchingSampler) runs ``admit_rows`` and ``decode_chunk``
instead: rows at their own positions, per-row sampling parameters.

Randomness comes from an explicit ``torch.Generator`` on the logits' device.
The JAX package draws from ``jax.random`` keys, so sampled (temperature > 0)
tokens differ between the two packages; greedy tokens match.
"""

from __future__ import annotations

import torch

_NUCLEUS_K = 256  # candidate width for top_p when top_k doesn't supply one


def _nucleus_mask(vals, safe, top_p):
    """Keep-mask for nucleus sampling over a DESC-sorted candidate set
    ``vals`` [B, K]: keep candidate i while the cumulative probability of
    the candidates before it is < top_p (the first is always kept). The
    probabilities are the temperature-scaled softmax over the candidates —
    the same distribution the draw uses."""
    p = torch.softmax(vals / safe, dim=-1)
    cum_excl = torch.cumsum(p, dim=-1) - p
    return cum_excl < top_p[:, None]


def _categorical(generator, logits):
    """One draw per row from softmax(logits) (Gumbel-max, like
    jax.random.categorical); -inf logits are never drawn."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min_(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _sample_token(generator, logits, temperature, top_k: int, top_p=None):
    """Sample one token per row from fp32 ``logits`` [B, V].

    ``temperature``: float or [B] tensor; a row with temperature <= 0 takes
    the EXACT full argmax (greedy). ``top_k`` (0 = untruncated) is clamped
    to the band width. ``top_p`` ([B] tensor or None) applies nucleus
    sampling over the top-k set, or over the top 256 when top_k is 0.

    The candidate sets come from ``torch.topk``, which is exact; the JAX
    package uses ``lax.approx_max_k`` at recall 0.99, so on the TPU a
    candidate may rarely be missed there. Greedy rows are unaffected (both
    take the full argmax)."""
    logits = logits.float()
    b, v = logits.shape
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    temp = temp.expand(b)[:, None]
    safe = temp.clamp_min(1e-6)
    greedy = torch.argmax(logits, dim=-1)
    if top_p is None and not top_k:
        tok = _categorical(generator, logits / safe)
        return torch.where(temp[:, 0] <= 0.0, greedy, tok)
    if top_p is None:
        k = min(top_k, v)
    else:
        k = min(top_k if top_k else _NUCLEUS_K, v - 1)
    vals, idxs = torch.topk(logits, k, dim=-1)
    if top_p is not None:
        pvec = torch.as_tensor(top_p, dtype=torch.float32, device=logits.device)
        vals = torch.where(
            _nucleus_mask(vals, safe, pvec.expand(b)), vals, -torch.inf
        )
    tok = torch.gather(idxs, 1, _categorical(generator, vals / safe)[:, None])[:, 0]
    return torch.where(temp[:, 0] <= 0.0, greedy, tok)


@torch.inference_mode()
def generate_image_tokens(
    dalle, params, text_tokens, generator, temperature=1.0, top_k: int = 0,
    top_p=None,
):
    """text_tokens [B, text_seq_len] -> image token ids int64 [B,
    image_seq_len] (0-based within the VAE codebook).

    ``temperature`` and ``top_p`` may be per-row [B] tensors. The KV cache is
    written in place; the banded head (w_out's image columns) is sliced
    once, not per token."""
    cfg = dalle.cfg
    b = text_tokens.shape[0]
    t = cfg.text_seq_len
    lo = cfg.text_vocab_size
    head = dalle.logits_head(params, (lo, lo + cfg.image_vocab_size))
    cache = dalle.init_cache(b)
    logits = dalle.prefill(params, text_tokens.long(), cache, head=head)
    out = torch.empty((b, cfg.image_seq_len), dtype=torch.long, device=logits.device)
    for i in range(cfg.image_seq_len):
        tok = _sample_token(generator, logits, temperature, top_k, top_p)
        out[:, i] = tok
        if i + 1 < cfg.image_seq_len:  # the last token needs no next logits
            logits = dalle.decode_step(params, cache, tok + lo, t + i, head=head)
    return out


def _sample_token_rows(generator, logits, temperature, top_k_rows, k_max: int,
                       top_p_rows=None):
    """Per-row sampling with per-row ``top_k`` and ``top_p``, one code path
    for a batch whose rows ask for different values (the continuous
    engine's). The candidate set is the top ``k_max`` of each row; a row's
    ``top_k`` masks candidates by rank (any k in [1, k_max]); k = 0 rows
    sample from the whole band, unless the row also sets top_p < 1, which
    takes the k_max candidates. Nucleus masking composes per row; rows with
    temperature <= 0 take the exact argmax.

    ``torch.topk`` is exact. The JAX engine uses ``lax.approx_max_k`` at
    recall 0.99, which on the CPU, where the tests compare the two, is exact
    as well; on the TPU it may rarely miss a candidate."""
    logits = logits.float()
    b, v = logits.shape
    dev = logits.device
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=dev).expand(b)[:, None]
    safe = temp.clamp_min(1e-6)
    ks = torch.as_tensor(top_k_rows, dtype=torch.long, device=dev).expand(b)[:, None]
    ps = (torch.ones((b,), device=dev) if top_p_rows is None
          else torch.as_tensor(top_p_rows, dtype=torch.float32, device=dev).expand(b))
    k_max = min(k_max, v - 1)
    vals, idxs = torch.topk(logits, k_max, dim=-1)
    rank = torch.arange(k_max, device=dev)[None, :]
    # a k = 0 row with nucleus on still needs candidates: widen it to k_max
    k_eff = torch.where((ks == 0) & (ps[:, None] < 1.0), k_max, ks)
    vals = torch.where(rank < k_eff.clamp(1, k_max), vals, -torch.inf)
    vals = torch.where(_nucleus_mask(vals, safe, ps), vals, -torch.inf)
    tok_topk = torch.gather(idxs, 1, _categorical(generator, vals / safe)[:, None])[:, 0]
    tok_full = _categorical(generator, logits / safe)
    tok = torch.where((ks[:, 0] == 0) & (ps >= 1.0), tok_full, tok_topk)
    return torch.where(temp[:, 0] <= 0.0, torch.argmax(logits, dim=-1), tok)


@torch.inference_mode()
def decode_chunk(dalle, params, cache, last_logits, positions, generator,
                 temperature, top_k_rows, chunk: int = 128, k_max: int = 256,
                 top_p_rows=None, head=None):
    """``chunk`` decode steps of a continuously batched generation.

    Each row advances from its own position (``positions``, long [B]); rows
    at the end of the sequence park: they ride the steps (decode cost is the
    weight stream, shared by all rows) but stop advancing, and their writes
    land on their own last cache slot, which the next occupant's prefill and
    decode overwrite before any read. The per-step math is that of
    ``generate_image_tokens``: greedy rows give the same tokens.

    ``last_logits`` [B, image_vocab] are banded; the cache is written in
    place. Returns (last_logits, positions, tokens long [chunk, B] 0-based
    image tokens, active bool [chunk, B] marking the real emissions)."""
    cfg = dalle.cfg
    lo = cfg.text_vocab_size
    end_pos = cfg.text_seq_len + cfg.image_seq_len
    head = head or dalle.logits_head(params, (lo, lo + cfg.image_vocab_size))
    tokens, actives = [], []
    for _ in range(chunk):
        active = positions < end_pos
        tok = _sample_token_rows(generator, last_logits, temperature, top_k_rows,
                                 k_max, top_p_rows)
        last_logits = dalle.decode_step_rows(
            params, cache, tok + lo, positions.clamp_max(end_pos - 1), head=head)
        positions = positions + active.long()
        tokens.append(tok)
        actives.append(active)
    return last_logits, positions, torch.stack(tokens), torch.stack(actives)


@torch.inference_mode()
def admit_rows(dalle, params, cache, last_logits, positions, texts, mask, head=None):
    """Admit new requests into the ``mask`` rows of a live continuous batch:
    prefill their prompts (a full-batch pass), writing the cache only on the
    masked rows, and take their banded logits and the text-end position
    there; other rows are untouched. Returns (last_logits, positions)."""
    cfg = dalle.cfg
    lo = cfg.text_vocab_size
    head = head or dalle.logits_head(params, (lo, lo + cfg.image_vocab_size))
    new_logits = dalle.prefill_rows(params, texts.long(), cache, mask, head=head)
    last_logits = torch.where(mask[:, None], new_logits, last_logits)
    positions = torch.where(mask, cfg.text_seq_len, positions)
    return last_logits, positions


@torch.inference_mode()
def generate_images(
    dalle, dalle_params, vae, vae_params, text_tokens, generator,
    temperature=1.0, top_k: int = 0, top_p=None,
):
    """Full text->pixels path. Returns f32 [B, H, W, C] in [0, 1]."""
    img_tokens = generate_image_tokens(
        dalle, dalle_params, text_tokens, generator,
        temperature=temperature, top_k=top_k, top_p=top_p,
    )
    return vae.decode_tokens(vae_params, img_tokens)
