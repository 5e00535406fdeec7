"""Text -> image sampling (port of ``dalle_mtf_tpu/sample.py``).

Whole-batch pipeline: DALLE prefill over the text prompt -> image_seq_len
decode steps against the KV cache -> VAE decode_tokens -> pixels in [0, 1].
Logits are computed only over the image-token band [text_vocab_size,
text_vocab_size + image_vocab_size), so the model can never emit text or EOS
tokens inside the image. The continuous-batching engine
(serve.ContinuousBatchingSampler) runs ``admit_rows`` and ``decode_chunk``
instead: rows at their own positions, per-row sampling parameters.

The JAX package runs the decode loop as one compiled ``lax.scan``. Here, on
the card, ``CapturedDecoder`` captures one decode step as a CUDA graph and
replays it: every tensor the step reads or writes has a fixed address (the
KV cache, the last logits, the positions, the step index, the token buffers,
the per-row sampling parameters and a generator registered with the graph),
and the step advances its own position and step index on the device.
``generate_image_tokens``, ``generate_images`` and ``decode_chunk`` take
that path whenever their tensors are on CUDA; on the CPU they run the eager
loops (``generate_image_tokens_eager``, ``decode_chunk_eager``), which are
also the card's reference, reached there only by name. Prefill and
``admit_rows`` run eagerly, one pass a batch.

Randomness comes from an explicit ``torch.Generator`` on the logits' device.
The JAX package draws from ``jax.random`` keys, so sampled (temperature > 0)
tokens differ between the two packages; greedy tokens match.

Every function here also runs on a rank's blocks of a model split over a
tensor-parallel axis (``DALLE.sharding``): a rank's cache holds its heads,
the model joins the banded logits over the group, and every rank of the
group, seeded alike, draws the same tokens. The group's collectives run in
each step, so there the decoder runs its step functions eagerly on the
card: ranks that share a card talk over gloo, whose collectives sync
through the host and cannot be captured, and capturing NCCL collectives
inside a step is not ported. The mesh decides this (``capture_rule``),
not a failed capture. A model group also keeps the dequant einsum forms
(``DALLE._streaming_eligible``). Each group decodes the whole batch: the
rows are not split over the data axis.
"""

from __future__ import annotations

import contextlib
import functools
import logging

import torch

from dalle_mtf_tpu_torch.ops import attention, decode_matmul, layer_norm

logger = logging.getLogger(__name__)

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
def generate_image_tokens_eager(
    dalle, params, text_tokens, generator, temperature=1.0, top_k: int = 0,
    top_p=None, steps: int | None = None,
):
    """text_tokens [B, text_seq_len] -> image token ids int64 [B,
    image_seq_len] (0-based within the VAE codebook), one decode step
    dispatched from Python at a time.

    ``temperature`` and ``top_p`` may be per-row [B] tensors. The KV cache is
    written in place; the banded head (w_out's image columns) is sliced
    once, not per token. ``steps`` stops after that many tokens (a shorter
    reference run): [B, steps]."""
    cfg = dalle.cfg
    b = text_tokens.shape[0]
    t = cfg.text_seq_len
    lo = cfg.text_vocab_size
    n = cfg.image_seq_len if steps is None else steps
    head = dalle.logits_head(params, (lo, lo + cfg.image_vocab_size))
    cache = dalle.init_cache(b)
    logits = dalle.prefill(params, text_tokens.long(), cache, head=head)
    out = torch.empty((b, n), dtype=torch.long, device=logits.device)
    for i in range(n):
        tok = _sample_token(generator, logits, temperature, top_k, top_p)
        out[:, i] = tok
        if i + 1 < n:  # the last token needs no next logits
            logits = dalle.decode_step(params, cache, tok + lo, t + i, head=head)
    return out


@torch.inference_mode()
def generate_image_tokens(
    dalle, params, text_tokens, generator, temperature=1.0, top_k: int = 0,
    top_p=None, decoder: CapturedDecoder | None = None,
):
    """text_tokens [B, text_seq_len] -> image token ids int64 [B,
    image_seq_len]. On CUDA through ``decoder`` (by default a new
    ``CapturedDecoder``), drawing from ``generator``'s stream and advancing
    it as the eager loop would; on the CPU the eager loop."""
    if text_tokens.device.type != "cuda":
        return generate_image_tokens_eager(dalle, params, text_tokens, generator,
                                           temperature, top_k, top_p)
    decoder = decoder or CapturedDecoder(dalle, params, text_tokens.shape[0])
    with decoder.drawing_from(generator):
        return decoder.generate(text_tokens, temperature, top_k, top_p).clone()


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
def decode_chunk_eager(dalle, params, cache, last_logits, positions, generator,
                       temperature, top_k_rows, chunk: int = 128, k_max: int = 256,
                       top_p_rows=None, head=None):
    """``chunk`` decode steps of a continuously batched generation, one
    dispatched from Python at a time.

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
def decode_chunk(dalle, params, cache, last_logits, positions, generator,
                 temperature, top_k_rows, chunk: int = 128, k_max: int = 256,
                 top_p_rows=None, head=None, decoder: CapturedDecoder | None = None):
    """``decode_chunk_eager``'s contract. On CUDA through ``decoder`` (by
    default a new ``CapturedDecoder`` over ``cache``; a given one must hold
    ``cache``), drawing from ``generator``'s stream; on the CPU the eager
    loop."""
    if last_logits.device.type != "cuda":
        return decode_chunk_eager(dalle, params, cache, last_logits, positions, generator,
                                  temperature, top_k_rows, chunk, k_max, top_p_rows, head)
    decoder = decoder or CapturedDecoder(dalle, params, last_logits.shape[0], chunk=chunk,
                                         head=head, cache=cache)
    if decoder.cache is not cache or decoder.chunk != chunk:
        raise ValueError("decode_chunk: the decoder holds another cache or chunk length")
    decoder.logits.copy_(last_logits)
    decoder.positions.copy_(positions)
    with decoder.drawing_from(generator):
        tokens, active = decoder.decode_chunk(temperature, top_k_rows, top_p_rows, k_max)
    return (decoder.logits.clone(), decoder.positions.clone(), tokens.clone(),
            active.clone())


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
    temperature=1.0, top_k: int = 0, top_p=None, decoder: CapturedDecoder | None = None,
):
    """Full text->pixels path (the decode loop as ``generate_image_tokens``
    takes it). Returns f32 [B, H, W, C] in [0, 1]."""
    img_tokens = generate_image_tokens(
        dalle, dalle_params, text_tokens, generator,
        temperature=temperature, top_k=top_k, top_p=top_p, decoder=decoder,
    )
    return vae.decode_tokens(vae_params, img_tokens)


# ------------------------------------------------------- the captured loop

WARMUP_STEPS = 1  # eager runs of a step before its capture: builds, handles, attributes


def _launch_counters() -> tuple[dict, ...]:
    """The launch counts of every kernel wrapper a decode step can reach."""
    return (attention.KERNEL_LAUNCHES, decode_matmul.KERNEL_LAUNCHES,
            layer_norm.KERNEL_LAUNCHES)


def _counts() -> list[tuple[dict, str, int]]:
    return [(c, name, n) for c in _launch_counters() for name, n in c.items()]


def capture_rule(dalle) -> tuple[bool, str | None]:
    """(whether a decoder of ``dalle`` captures its steps as CUDA graphs,
    the reason where it does not): on CUDA, unless the model is split over
    a tensor-parallel axis, whose collectives run inside every step."""
    if dalle.device.type != "cuda":
        return False, "CPU tensors: the step functions run eagerly"
    if dalle.sharding is not None:
        import torch.distributed as dist  # noqa: PLC0415

        backend = dist.get_backend(dalle.sharding.group)
        why = ("gloo collectives sync through the host and cannot be captured"
               if backend == "gloo" else
               "capturing NCCL collectives inside a decode step is not ported")
        return False, f"a model group over {backend}: {why}; the step runs eagerly on the card"
    return True, None


def _fill(buf, value) -> None:
    """Copy ``value`` (a number, or a tensor broadcastable to ``buf``) into
    the static buffer ``buf``, outside any capture."""
    buf.copy_(torch.as_tensor(value, dtype=buf.dtype).expand(buf.shape))


class CapturedDecoder:
    """One sampler's decode loop, kept on the device.

    It owns the buffers a decode step reads and writes, all at fixed
    addresses: the KV cache (one for the sampler's life: each prefill
    overwrites ``[:, :, :, :t]``, and a decode step writes its slot before
    it reads it, so stale entries past a row's position are never read:
    the mask ``j > position`` hides them), the banded last ``logits`` [B,
    image_vocab], the ``positions`` long [B], the ``step`` index long [1],
    the per-row ``temperature``, ``top_k`` and ``top_p``, the whole-batch
    ``image`` tokens [B, image_seq_len] and the continuous ``tokens`` and
    ``active`` [chunk, B], and a ``generator``. A step writes its token at
    ``step`` (``index_copy_``) and advances ``positions`` and ``step``
    itself, so replaying it n times runs n steps.

    On CUDA each step function is captured once as a CUDA graph, after
    ``WARMUP_STEPS`` eager runs on a side stream (the kernels' build and
    attributes happen there, never during capture), with the generator
    registered with the graph so that every replay draws new numbers: one
    graph for each whole-batch (top_k, top_p present) pair, as the JAX
    package compiles one executable for each static top_k, and one for the
    continuous engine's k_max. The graphs share one memory pool. A capture
    or a replay that fails raises: there is no eager fallback. On the CPU,
    and on a rank of a tensor-parallel model group (``capture_rule``:
    ``captures`` False, ``eager_reason`` says why), the same step functions
    run eagerly.

    A capture records the kernels' launches without launching them, so the
    decoder takes the capture's counts back off the wrappers' counters and
    adds them again for each replay (``replays`` counts them by graph):
    ``KERNEL_LAUNCHES`` keep counting the launches the card makes.

    ``params`` may be a model's live training parameters: the graphs read
    each leaf at its address, so updates made in place (AdamW) are seen by
    later replays; the banded head, which is a copy, is rebuilt on each
    ``generate``.
    """

    def __init__(self, dalle, params, batch: int, chunk: int = 128, head=None, cache=None):
        cfg = dalle.cfg
        dev = torch.device(dalle.device)
        self.dalle, self.params, self.batch, self.chunk = dalle, params, int(batch), int(chunk)
        lo = cfg.text_vocab_size
        self.band = (lo, lo + cfg.image_vocab_size)
        self.end_pos = cfg.text_seq_len + cfg.image_seq_len
        with torch.inference_mode():
            self.head = head or dalle.logits_head(params, self.band)
            self.cache = cache if cache is not None else dalle.init_cache(self.batch)
            b = self.batch
            self.logits = torch.zeros((b, cfg.image_vocab_size), dtype=torch.float32, device=dev)
            self.positions = torch.full((b,), cfg.text_seq_len, dtype=torch.long, device=dev)
            self.step = torch.zeros((1,), dtype=torch.long, device=dev)
            self.temperature = torch.ones((b,), dtype=torch.float32, device=dev)
            self.top_k = torch.zeros((b,), dtype=torch.long, device=dev)
            self.top_p = torch.ones((b,), dtype=torch.float32, device=dev)
            self.image = torch.zeros((b, cfg.image_seq_len), dtype=torch.long, device=dev)
            self.tokens = torch.zeros((self.chunk, b), dtype=torch.long, device=dev)
            self.active = torch.zeros((self.chunk, b), dtype=torch.bool, device=dev)
        self.generator = torch.Generator(device=dev)
        self.captures, self.eager_reason = capture_rule(dalle)
        if dev.type == "cuda" and not self.captures:
            logger.info("decode steps not captured: %s", self.eager_reason)
        self.replays: dict[tuple, int] = {}
        self._graphs: dict[tuple, torch.cuda.CUDAGraph] = {}
        self._per_replay: dict[tuple, list[tuple[dict, str, int]]] = {}
        self._pool = None

    # ----------------------------------------------------------- the steps

    def _sample_into_image(self, top_k: int, nucleus: bool):
        tok = _sample_token(self.generator, self.logits, self.temperature, top_k,
                            self.top_p if nucleus else None)
        self.image.index_copy_(1, self.step, tok[:, None])
        return tok

    def _batch_step(self, top_k: int, nucleus: bool) -> None:
        """One whole-batch step: sample at the last logits, write the token
        at ``step``, decode it at ``positions`` (every row at the same one:
        ``decode_step_rows`` is then ``decode_step``'s math)."""
        tok = self._sample_into_image(top_k, nucleus)
        self.logits.copy_(self.dalle.decode_step_rows(
            self.params, self.cache, tok + self.band[0], self.positions, head=self.head))
        self.positions.add_(1)
        self.step.add_(1)

    def _chunk_step(self, k_max: int) -> None:
        """One continuous step: ``decode_chunk_eager``'s loop body."""
        active = self.positions < self.end_pos
        tok = _sample_token_rows(self.generator, self.logits, self.temperature, self.top_k,
                                 k_max, self.top_p)
        self.tokens.index_copy_(0, self.step, tok[None])
        self.active.index_copy_(0, self.step, active[None])
        self.logits.copy_(self.dalle.decode_step_rows(
            self.params, self.cache, tok + self.band[0],
            self.positions.clamp_max(self.end_pos - 1), head=self.head))
        self.positions.add_(active.long())
        self.step.add_(1)

    # ------------------------------------------------------ capture, replay

    def _capture(self, key, body) -> None:
        """Capture ``body`` as the graph ``key`` (on first use). The warm-up
        runs change what a live batch holds, so the logits, positions, step
        and generator are put back after it; its cache writes land on slots
        that the next real step writes again before reading them."""
        if not self.captures or key in self._graphs:
            return
        dev = self.logits.device
        saved = (self.logits.clone(), self.positions.clone(), self.step.clone(),
                 self.generator.get_state())
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.step.zero_()
                body()
        torch.cuda.current_stream(dev).wait_stream(side)
        for buf, value in zip((self.logits, self.positions, self.step), saved):
            buf.copy_(value)
        self.generator.set_state(saved[3])
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = _counts()
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            body()
        per_replay = [(c, name, c[name] - n) for c, name, n in before if c[name] != n]
        for c, name, n in per_replay:
            c[name] -= n  # recorded, not launched
        self._pool = self._pool or graph.pool()
        self._graphs[key] = graph
        self._per_replay[key] = per_replay
        self.replays[key] = 0

    def _run(self, key, body, n: int) -> None:
        """``n`` steps: replays of graph ``key`` on CUDA, eager calls on the CPU."""
        if not self.captures:
            for _ in range(n):
                body()
            return
        graph = self._graphs[key]
        for _ in range(n):
            graph.replay()
        for c, name, k in self._per_replay[key]:
            c[name] += k * n
        self.replays[key] += n

    def launches_per_replay(self, key) -> dict[str, int]:
        """The kernel launches one replay of graph ``key`` makes, by name."""
        return {name: k for _, name, k in self._per_replay[key]}

    @contextlib.contextmanager
    def drawing_from(self, generator):
        """A context in which the decoder draws from ``generator``'s stream
        (its state copied in) and leaves ``generator`` where the draws
        ended, as if the steps had drawn from it."""
        self.generator.set_state(generator.get_state())
        yield
        generator.set_state(self.generator.get_state())

    @torch.inference_mode()
    def warm(self, text_tokens) -> None:
        """One prefill of ``text_tokens`` [B, text_seq_len] into the cache:
        the kernels' build, all a decoder that captures nothing needs before
        its first batch. The cache entries it writes are written again by
        the next prefill or admission before any read."""
        self.dalle.prefill(self.params, text_tokens.long(), self.cache, head=self.head)

    # ------------------------------------------------------------ whole batch

    @torch.inference_mode()
    def generate(self, text_tokens, temperature=1.0, top_k: int = 0, top_p=None):
        """``generate_image_tokens_eager``'s tokens, drawn from
        ``self.generator``: prefill (eager) into the cache, then
        image_seq_len - 1 replays of the graph for (top_k, top_p present),
        then the last token's draw. Returns the ``image`` buffer (the next
        call overwrites it)."""
        cfg = self.dalle.cfg
        if tuple(text_tokens.shape) != (self.batch, cfg.text_seq_len):
            raise ValueError(f"text tokens {tuple(text_tokens.shape)}: the decoder takes "
                             f"({self.batch}, {cfg.text_seq_len})")
        top_k, nucleus = int(top_k), top_p is not None
        key = ("batch", top_k, nucleus)
        body = functools.partial(self._batch_step, top_k, nucleus)
        self.positions.fill_(cfg.text_seq_len)  # the warm-up's positions
        self._capture(key, body)
        fresh = self.dalle.logits_head(self.params, self.band)
        for have, new in zip(self.head, fresh):
            if isinstance(have, torch.Tensor):
                have.copy_(new)
        self.logits.copy_(self.dalle.prefill(self.params, text_tokens.long(), self.cache,
                                             head=self.head))
        self.positions.fill_(cfg.text_seq_len)
        self.step.zero_()
        _fill(self.temperature, temperature)
        _fill(self.top_p, 1.0 if top_p is None else top_p)
        self._run(key, body, cfg.image_seq_len - 1)
        self._sample_into_image(top_k, nucleus)  # the last token needs no next logits
        return self.image

    # ------------------------------------------------------------- continuous

    @torch.inference_mode()
    def reset(self, seed: int) -> None:
        """Every row parked at the end, the generator reseeded: an empty
        continuous batch."""
        self.positions.fill_(self.end_pos)
        self.logits.zero_()
        self.generator.manual_seed(seed)

    @torch.inference_mode()
    def admit(self, texts, mask) -> None:
        """``admit_rows`` into the decoder's buffers (eager)."""
        logits, positions = admit_rows(self.dalle, self.params, self.cache, self.logits,
                                       self.positions, texts, mask, head=self.head)
        self.logits.copy_(logits)
        self.positions.copy_(positions)

    @torch.inference_mode()
    def decode_chunk(self, temperature, top_k_rows, top_p_rows=None, k_max: int = 256):
        """``chunk`` steps of the continuous batch from its buffers: the
        graph for ``k_max`` replayed ``chunk`` times. Returns the ``tokens``
        and ``active`` buffers [chunk, B] (the next chunk overwrites them)."""
        key = ("chunk", int(k_max))
        body = functools.partial(self._chunk_step, int(k_max))
        self._capture(key, body)
        _fill(self.temperature, temperature)
        _fill(self.top_k, top_k_rows)
        _fill(self.top_p, 1.0 if top_p_rows is None else top_p_rows)
        self.step.zero_()
        self._run(key, body, self.chunk)
        return self.tokens, self.active
