#!/usr/bin/env python3
"""Drive the PyTorch port (dalle_mtf_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, none of them optional:

1. Device and build: the card's name and power limit, then the CUDA kernels
   built from the repository's csrc/ sources (one nvcc per source, timed)
   and, beside them, the native data library from native/dataloader.cpp
   (g++, where it and libjpeg's jpeglib.h are found; with whether the
   container allows io_uring),
   and "resources" lines for each head size of the bf16 causal-attention
   kernels, the bf16 ring kernels and the fp32 (3xTF32) kernels of both
   pairs: registers a thread, spilled bytes, shared memory a CTA and CTAs an
   SM of the forward (bf16 under either q tile; fp32 on 64 rows), the dQ
   and the dK/dV kernel; and for the decode matmuls (csrc/decode_matmul.cu)
   each built instantiation (int8 or int4, rows aligned or not) at a whole
   chunk of K in clusters of 8, and each decode shape's plan (K slices,
   cluster size, CTAs): registers, spills, static and dynamic shared memory,
   CTAs an SM, clusters the card holds at once.
2. Kernels against plain, on the card, both times from CUDA events. The
   attention kernels are timed over 20 launches or more, on inputs that
   together exceed the 50 MB L2 (rotating over copies where one set does
   not); a backward's time includes its dsum reduction, which is also timed
   alone (``dsum_ms``); at the serving shapes, where a launch is shorter than
   the host's dispatch of it, the card's own time is read beside it under
   torch.profiler (``device_ms``, ``library_device_ms``); dq, dk, dv of two
   runs on the same inputs must be equal bit for bit (no atomics); the rows
   of the bf16 [B, H, S, D] forward carry its time under either q tile
   (``ms_by_tile_rows``):
   - the [B, H, S, D] forward ``causal_attention`` against
     ``attention_reference`` at the serving prefill shape and two others;
   - the packed training pair (forward ``causal_attention_fwd`` by strides,
     backward ``causal_attention_bwd``) against ``attention_packed_reference``
     and ``backward_reference``: out, lse, dq, dk, dv at the training shape
     (B=16, S=1280, H=8, D=128, bf16), a ragged fp32 shape with window 64,
     the training shape with hash dropout 0.1 (one seed on both sides),
     dalle_12B's microbatch (B=8, S=2560, H=40, D=128, bf16), a
     tensor-parallel rank's block of dalle_coco (B=8, S=1280, H=4) and of
     dalle_12B at model:8 (B=4, S=2560, H=5), and a pipeline stage's
     microbatch of dalle_coco_synth on pipe:2,data:2 (B=4, S=1280, H=8);
   - the [B, H, S, D] forward with hash dropout;
   - ``phase_tile_cases``: the pair at the edges of its tile walk, in bf16
     (the forward under every q tile it is built for: 64 rows, and 128 at
     D = 128) and in fp32 (the 3xTF32 forward and backward), in both
     layouts: D = 64 with windows that are not a multiple of the 64-key
     tile, S in {1, 63, 65, 129}, a window of 1 and one wider than S, the
     packed layout with H = 1, with and without hash dropout; each with the
     per-tile bound, the planted zeroed tile and the two-run bit-equality
     of the forward and of the backward; and both pairs on heads 4..7 of 8
     (``head0``, ``heads_total``: a tensor-parallel rank's block) with hash
     dropout, in bf16 and fp32, and the packed bf16 pair on heads 35..39 of
     40 at B=4 S=2560 (a dalle_12B rank at model:8), against the plain
     versions and bit for bit against those heads of one launch over all
     the heads (``head_block_cases``);
   - the [B, H, S, D] pair (``causal_attention_fwd``/``_bwd`` through
     ops/attention.py) against ``attention_reference`` and
     ``attention_backward_reference`` at the shapes of the TPU package's
     regimes: B=16 S=1280 bf16 with and without hash dropout (wedge,
     whole-row), dalle_4k's B=4 S=4352 bf16 (the capped wedge forward and the
     hybrid backward), and the loop regime's B=1 S=4352 fp32 and B=1 H=2
     S=6200 bf16 (ragged);
   - the LayerNorm pair (csrc/layer_norm.cu) against
     ``layer_norm_reference`` and ``layer_norm_backward_reference`` at
     dalle_4k's rows (R=17,408, E=1024, bf16), at dalle_12B's width (R=8192,
     E=5120, bf16) and a ragged fp32 shape; dg and db within 1e-4 of max
     |plain| and equal bit for bit over two runs; the device time split by
     kernel name (the backward is one launch) and a "resources" line for
     each shape;
   - ``phase_ring_kernels``: the ring's per-hop pair (csrc/ring_attention.cu,
     ``ring_partial`` and ``ring_block_grads``) against
     ``ring_partial_reference`` and ``ring_block_grads_reference`` at the
     ring slice's shard shape (B=4, H=8, S_local=1088, D=128, bf16): the
     diagonal hop (diff 0), a past hop (1088) and a far one (3264), the
     window band (``local_ring``, window 256) across the shard edge, hash
     dropout 0.1 at global row0 and col0, and one fp32 case, each timed
     between events and on the card under torch.profiler (``device_ms``,
     the profiler's events of the kernels held to the launches made);
     then the pair at the edges of its tile walk in bf16 and in fp32
     (S_local in {1, 65, 200, 333}, ragged shards under windows whose band
     ends mid-tile, D = 64, a window of 1, hash dropout), and the past hop
     of a TP x SP rank of the dalle_4k run (B=4, heads 4..7 of 8, S_local
     2176, ``head0`` and ``heads_total``), timed. The triple is compared on rows with a
     live key (m = NEG_INF itself on the others); every tensor per 64-long
     tile, each case shows that a copy with its last tile zeroed fails, and
     two runs give the same bits.
   Tolerance: max |kernel - plain| <= atol * max(1, max|plain|), atol 1e-5
   in fp32 and 1e-2 in bf16 on unit-scale inputs (uniform in [-1, 1); one
   bf16 rounding is 2^-8 relative); lse atol 1e-4. The [B, H, S, D] pair is
   also held per 64-long tile of S (query rows for out and dq, keys for dk
   and dv, the last tile ragged): within 2^-6 (bf16) or 1e-5 (fp32) of the
   tile's own max |plain|, a bound shown to fail a result whose last tile
   is zeroed.
3. Training values: a full-width configs/dalle_coco_synth.json model cut to
   2 layers, fp32, batch 2: loss and every parameter grad on the card
   (through the kernels) against the port's plain path on the CPU, same
   weights and tokens; once with the packed attention, once with
   ``attn_packed: false, ln_impl: "pallas"`` (the [B, H, S, D] pair and the
   LN kernels, launches counted); and a third arm, four ranks on the card
   with ``attention_type: "ring"`` on ``data:2,seq:2``, and a fourth on
   ``data:1,seq:2,model:2`` with dalle_coco's tensor-parallel rules against
   one process on the card (both in ``phase_train_sharded``'s launch, below).
   Tolerance: loss atol 1e-4; each grad
   leaf within relative L2 error 1e-2. fp32 sums run in another order on each side, and
   a ReLU gate whose input is within rounding of 0 may flip between the two:
   a flip moves single elements of the MLP grads by ~1% of the leaf's
   largest and spreads into the LN grads (~1e-3 in L2), so there is no
   per-element bound.
4. Training slice, the main path: a copy of configs/dalle_coco_synth.json
   (full width and depth, batch 16, bf16) in tokens mode on tfrecords
   written from a seed, through ``train_dalle.main`` for 8 steps with a
   checkpoint and an eval, then a second ``main`` that resumes there for 2
   more. Checks the first loss within 0.1 of its expectation at init,
   ln(vocab) + n_embd * 0.02^2 / 2 (the logits' variance over 2), finite
   losses and grad norms, and the kernels' launch counts; times the steady steps (tokens/s,
   MFU against 989 TFLOP/s dense bf16 with bench.py's FLOP formula, peak
   memory), then profiles two more steps for the split of device time.
   Then the long-sequence slice: a copy of configs/dalle_4k.json (full width
   and depth, S = 256 + 64 x 64 = 4352, batch 4, bf16) with
   ``attn_packed: false`` and ``ln_impl: "pallas"`` in tokens mode, through
   ``train_dalle.main`` for 6 steps with an eval and a checkpoint; the same
   checks, exact launch counts of the [B, H, S, D] pair and the LN kernels
   (and none of the packed pair), the same timing and profile.
   Then the memory-bound options (``memory_option_values``): the fused
   loss head (``fused_xent``, ops/xent_fused.py) against the plain fp32 loss
   and the dense head at N = 4096 rows of dalle_coco_synth's width and
   vocabulary (loss, dx, dw, db; z-loss 0 and 1e-4); every remat policy
   against no remat on a 2-layer bf16 copy of dalle_coco_synth with every
   dropout at 0.1 (loss and grads bit-equal, the generator's state equal,
   the packed forward launched once or twice a layer as the policy keeps or
   re-runs it); ``skip_nonfinite_updates: 3`` around AdamW (foreach, fused)
   and Adafactor with a NaN loss planted (nothing moves). Then the loss head
   by name (``phase_loss_head``): two profiled steps of dalle_coco_synth with
   the dense head and with ``fused_xent: true``, and each head alone under
   the profiler, its device ms by kernel name. Then dalle_12B
   (``phase_train_12b``): configs/dalle_12B.json at full width (n_embd 5120,
   40 heads of 128, S = 256 + 48 x 48 = 2560, vocab 52,307, bf16) cut to 4
   of its 38 layers and one data replica's 32 rows (4 microbatches of 8, as
   published), through ``train_dalle.main``: the published arm (AdamW,
   dense head, ``dots_saveable``) for 3 steps with an eval and a
   checkpoint, then a remat sweep of 1 step a policy on its state (peak
   memory, step s, the packed forward's launches held to one or two a layer
   and microbatch; peak memory nothing_saveable < dots_saveable < none);
   the lean arm (+ ``fused_xent``, Adafactor, ``skip_nonfinite_updates: 3``)
   for 3 steps with checkpoints at 2 and 3, and a resume from step 2 whose
   losses and grad norms equal the unbroken run's bit for bit; then the
   fused head's products timed at a chunk of the microbatch. Its
   "train_12b" line holds each arm's step s, tokens/s, MFU and peak memory,
   the sweep and the head's product ms.
   Then sequence parallelism, four ranks sharing the one card (NCCL refuses
   two ranks on one device, so they run gloo, the ring's sends staged through
   host memory; the kernels are built once here first, so the ranks never
   race on the build):
   - ``phase_train_sharded``, first, in its launch (``ring_checks_rank``, read
     by ``check_ring_attention``; once a launch of their own): four
     ranks run
     ``ring_attention`` forward and backward on their shards of seeded q, k,
     v, g (B=4, H=8, S=4352, D=128, bf16); out, dq, dk, dv gathered and held
     per 64-long tile (2^-6 of the tile's max) against the single-device
     [B, H, S, D] kernel pair on the whole sequence, without and with hash
     dropout 0.1 (one seed: the masks are keyed on global coordinates); each
     rank then runs the ring pair on its block of the heads at its
     ``data:1,seq:2,model:2`` coordinates (B=4, heads 0..3 or 4..7 of 8,
     S_local 2176, the diagonal or the past hop, dropout 0.1, bf16 and fp32)
     against the plain versions, held here bit for bit to those heads of
     one launch over all 8; then the values check's third and fourth arms;
     then the main path of this slice: a copy of the
     dalle_4k config with ``attention_type: "ring"``, ``mesh_shape:
     data:1,seq:4`` and ``layout: batch_dim:data,total_seq_dim:seq`` through
     four ranks (``run_ranks``) and
     ``train_dalle.main`` for 3 steps with an eval and a checkpoint, cut to
     2 of the 12 layers. Checks the first
     loss against ln V + var/2 and within 2e-3 of the single-process port's
     on the same records and seed, finite losses and grad
     norms, the parameters bit-equal over the ranks (a checksum a rank), the
     exact ``ring_partial``/``ring_block_grads`` launches of each rank (rank r
     runs r + 1 live hops a layer a pass) and the LN kernels', and no
     launch of the [B, H, S, D] or packed pairs; prints step time and
     tokens/s labelled as four ranks on one card, the bytes staged and the
     peak memory a rank. In the same launch, the same run on
     ``data:1,seq:2,model:2`` with the tensor-parallel rules of
     configs/dalle_coco.json beside the ring's (TP x SP: each rank 4 of the
     8 heads over 2176 positions): its first loss within 2e-3 of the single
     process's, the launches of rows 10-12 a rank, the bytes staged and the
     TP, gradient and other all_reduce bytes a rank a step equal to the
     counts worked out from the code (``tpsp_expected_bytes``), the
     checkpoint read by one process bit-equal to every rank's blocks; its
     "train" line labelled as four ranks sharing one card.
   Then tensor parallelism, ranks sharing the one card over gloo in the
   same way (the all_reduces staged through host memory):
   - the tensor-parallel values check (``check_tp_values``, on the ranks of
     ``phase_train_sharded``'s launch, which run it after the ring checks):
     four ranks on ``data:2,model:2`` with dalle_coco's
     layout (heads, MLP width and vocabulary on ``model``) run the 2-layer
     fp32 values model at dalle_coco width with the dense head, the fused
     head, and attention dropout 0.1 through the packed and the
     [B, H, S, D] pair, each against one process on the card (loss within
     1e-5, each gradient, the blocks gathered, within relative L2 1e-2;
     one forward and one backward launch a layer a rank); under dropout the
     kernels on each rank's heads equal one 8-head launch's bit for bit;
   - the tensor-parallel run (in ``phase_train_sharded``'s launch, its third run;
     once a two-rank launch of its own, ``data:1,model:2``):
     configs/dalle_coco.json as published (its ``data:16,model:2`` and
     layout verbatim: ``data:2,model:2`` on four ranks, each 4 heads, 2048
     MLP columns and a 26,240- or 26,067-row block of the vocabulary) in
     tokens mode, cut to batch 8 and 4 of its 12 layers, through
     ``train_dalle.main`` for 3 steps with an eval and a checkpoint (the
     whole tree, streamed to rank 0 leaf by leaf). Checks the first loss
     within 2e-3 of the single-process port's on the same records and
     seed, the ranks' losses equal, the packed pair's exact launches a
     rank; its "train_tp" line holds step s and tokens/s (labelled as four
     ranks on one card), the collective bytes a rank a step and the peak
     memory a rank;
   - the main path of pipeline parallelism (``phase_train_sharded``'s launch,
     after the ring runs; once a launch of its own):
     configs/dalle_coco_synth.json as published (1024 wide, batch 16, bf16,
     dots_and_attn) cut to 4 of its 12 layers, with ``mesh_shape:
     pipe:2,data:2`` and ``layout: batch_dim:data,layers:pipe`` (each stage
     2 layers; 2
     microbatches of 4 rows a data rank; the loss head on 4 rows a rank) in
     tokens mode through four ranks (``run_ranks``) and ``train_dalle.main``
     for 2 steps with an eval and a checkpoint, then, in the same launch,
     PP x TP: configs/dalle_coco.json with its published layout plus
     ``layers:pipe`` on ``data:16,pipe:2,model:2`` (``data:1,pipe:2,model:2``
     on the four ranks: each its stage's 2 of 4 layers on 4 of the 8 heads,
     half the MLP width and a block of the vocabulary), batch 8, 2
     microbatches, for 2 steps with an eval and a checkpoint; before both,
     a values check: a 4-layer fp32 model of that width, 8 rows, at M = 2
     and M = 4 on the pipe mesh and, with the attention dropout on, at M =
     2 on ``data:1,pipe:2,model:2``, its loss (within 1e-5) and every
     gradient (the layers gathered over the pipeline and the blocks over
     the model group; relative L2 1e-2) against one process on the card.
     Checks of each run the first loss within 2e-3 of the single-process
     port's on the same records and seed, the losses equal on every rank,
     the packed pair's launches a rank (2 layers x 2 microbatches a pass),
     the bytes each rank's hops sent a step by kind and its all_reduce
     bytes a step (under PP x TP by kind), both to the byte of what the
     code implies, and the checkpoint read by one process holding every
     rank's final parameters (its blocks) bit for bit; its "train_pp" and
     "train_pptp" lines hold step s and tokens/s (labelled as four ranks on
     one card), the bytes a hop, the staged and collective bytes a rank,
     the bubble and the peak memory a rank;
   - ``phase_train_vae_dp``: VAE data and tensor parallelism, after fp32
     values checks at vae_coco's width on 8 rows (``data:2`` on 2 ranks;
     on 4, in one launch, ``data:2,model:2`` with ``conv_cout`` +
     ``tokens_dim`` and with ``conv_cin`` + ``vae_hid_dim``, the convs split
     by channels beside the codebook by columns or rows; each
     against one process: losses 1e-5, eval metrics 1e-4 relative,
     gradients within relative L2 1e-2, measured 2.5e-3 on a conv bias; the
     4 ranks at cuDNN's default, non-deterministic algorithms, whose copies
     of the replicated leaves must still end with one value in each model
     group): configs/vae_coco.json as published (batch 128, 64 rows a rank)
     on 2 ranks through ``train_vae.main`` for 4 steps with evals and
     checkpoints at 2 and 4, then in the same launch vae_coco on
     ``data:1,model:2`` with ``conv_cout`` + ``tokens_dim``, 4 rows, for 2
     steps, an eval and a checkpoint, its collective bytes a step equal to
     what the code implies and its checkpoint, read back whole by one
     process, equal to the ranks' gathered blocks, then a run of 1 step and
     its resume to 2, bit-equal to it (the ranks restore their conv blocks
     and moments); its "train_vae_tp" line
     holds step s, images/s, the TP bytes a rank a step, peak memory a rank,
     the "train_vae_dp" line step s, images/s, the gradient bytes a rank a
     step, peak memory a rank and the data-wait share;
   - ``phase_train_12b_tp``: configs/dalle_12B.json's published
     ``data:16,model:8`` as ``data:1,model:8`` on 8 ranks, cut to 1 of 38
     layers, 4 rows and Adafactor, through ``train_dalle.main`` for 2 steps
     and a checkpoint, then a resume for 1 whose restored parameters and moments
     equal the saved ones bit for bit on every rank; the first loss within
     2e-3 of the single-process port's on the same config, records and seed,
     and each rank's device peak during the init within its blocks' bytes
     and one unit of the draw; its "train_12b_tp" line
     holds each rank's init seconds, device bytes and peak host RSS (the
     sharded init draws only the rank's blocks), rank 0's write seconds and
     peak host RSS, the collective bytes a rank a step and the packed pair's
     launches (its 5 heads: two forwards and one backward a layer a
     step); then, in the same launch, each rank samples from the resumed
     checkpoint: its blocks read out of the mapped file
     (``sample_dalle.load_dalle_params``), bf16, the prefill of 64 seeded
     captions (the published predict_batch_size) and 32 of the 2303 decode
     steps (temperature 1, top_k 64); the tokens must be equal on the 8
     ranks and rank 0's prefill band logits within 0.1 of one process's on
     the card on the same checkpoint; its "sample_12b_tp" line holds each
     rank's read seconds and bytes, KV cache bytes, ms a step and
     collective bytes a step;
   - ``phase_serve_tp``, the main path of this slice: configs/dalle_coco.json
     (as published: 12 layers of 1024, 8 heads, bf16, ``data:16,model:2``
     and layout; each batch decodes 32 of its 1023 steps, the tokens past
     them 0) and configs/vae_coco.json through ``serve_dalle.build_server``
     on two ranks sharing the card: rank 0 serves HTTP (three requests at
     once in one batch of 4, then the first again, greedy repeated bit for
     bit; the warm-up is one prefill on each rank) and sends its orders,
     rank 1 follows until the
     drain; the decode steps run eagerly (gloo cannot be captured). Then
     the fp32 values check on the same two ranks (dalle_coco's width, 2
     layers): prefill and 16 teacher-forced steps' logits within 1e-4 of
     one process on the card, both ranks bit-equal, and greedy tokens over
     a whole image equal to one process's. Its "serve_tp" line holds the
     latencies, decode ms a step, collective bytes a rank a step, peak GB a
     rank and why the decoder did not capture. The prefill kernel on a
     rank's heads at both sharded shapes is held to one launch over all
     the heads before, in ``tp_prefill_cases``.
   Then stage-1 VAE training, ``phase_train_vae`` (no TPU kernel on its
   path: cuDNN convs, cuBLAS codebook products): a small VAE's training and
   eval step on the card against the CPU in fp32 and bf16 (same weights,
   images and Gumbel draw; loss and metrics within 1e-4 relative in fp32,
   2e-2 in bf16), then configs/vae_coco_synth.json at full width (256 px,
   bf16, batch 32) through ``train_vae.main`` for 30 steps with evals,
   checkpoints and image summaries at 20 and 30 and two steps traced in the
   same loop, and a resume from step 20 that repeats the losses bit for bit
   (cuDNN's deterministic switch on). Its records are the port's own
   dataset tooling's: 256 seeded quadrant JPEGs of 256² from
   ``data/smoke_data.py`` and 128 seeded JPEGs at COCO sizes, each set
   through ``create_tfrecords random`` and then ``paired --reencode``; they
   are read through the native library (``data/native.py``, built from
   native/dataloader.cpp beside the kernels: the io_uring reader and the
   C++ decode pool, the JAX package's default path), which the phase
   requires wherever ``g++`` and ``jpeglib.h`` are found (else the Python
   reader and PIL, as in the JAX package). Then the host's data: the
   pool's images a second alone on 4, 8 and 16 threads at COCO sizes, and
   on the pool and on PIL (the Python reader, PIL on ``DECODE_WORKERS``
   threads; PIL alone where the library cannot be built) the pipeline's
   images a second alone and the data-wait share of 14-step runs, at 256²
   and at COCO sizes; and the
   steps run with no sync between them. Its "train_vae" line holds step s,
   images/s, MFU, peak memory, the device's busy share and ms by bucket
   from the traced steps (on the pool), the readers that ran and the
   data-wait shares.
   Then DALLE in image mode, ``phase_train_image``, the two-stage flow on
   the VAE phase's step-30 checkpoint (the same packed attention pair as
   the tokens mode; the frozen encoder's convs are cuDNN): a small fp32
   image-mode step (2 layers of 256, the values VAE, uint8 pixels) on the
   card against the CPU (the pixels' normalization bit-equal to the host's,
   the tokens equal, loss atol 1e-4, grads within relative L2 1e-2, the
   packed pair's launches counted); configs/dalle_coco_synth.json as
   published (image mode: no ``dataset.tokens``, the frozen vae_coco_synth
   restored from that checkpoint; full width and depth, batch 16, bf16) on
   the VAE phase's 256² records, whose captions ``create_tfrecords random``
   drew and ``paired`` tokenized, through ``train_dalle.main``
   for 8 steps with an eval and a checkpoint and a resumed ``main`` for 2
   more, ``train_path`` and ``model_path`` given as file:// URLs (the
   records, read ahead a shard a thread, the checkpoints, the eval and the
   resume all through fsspec), with the tokens-mode run's checks and exact
   launches; the ``uint8_images: true`` arm from the same init (its batch
   ``to_uint8`` of the f32 arm's bit for bit, its first loss bit-equal to
   the f32 arm's, or where the native decoder's pixels are not whole
   numbers to that of a one-step f32 run fed the rounded pixels);
   ``create_tfrecords encode`` of the same records (batch 16; at least 99%
   of its tokens agree with the in-step encode) and tokens mode on them
   (first loss within 1e-3 of image mode's) with ``predict_steps: 1``,
   ``predict_batch_size: 4``: the frozen VAE restored for its decoder, one
   predict at the checkpoint through the captured decode loop on the live
   training parameters (four 256² PNGs, the prompts and the image
   summaries; the prefill's [B, H, S, D] forward kernel counted), timed; the encoder's ms a step by
   CUDA events and a profile of two steps with its convs as a bucket; its
   "train_image" line holds step s, tokens/s, MFU with the encoder's FLOPs
   beside it, peak memory, the data-wait share and the uint8 arm's step.
5. Serving slice: configs/dalle_coco.json at full width and depth with
   weights from a seed. Banded prefill logits on the card against the port's
   plain path on the CPU in fp32 (same weights); then the HTTP server
   (BatchingSampler, batch 4) answers mixed requests, with every kernel
   launch counted. Every engine decodes through ``sample.CapturedDecoder``:
   one decode step captured as a CUDA graph per bucket (after one eager
   warm-up step) and replayed image_seq_len - 1 times a batch; a replay's
   kernel launches are counted by the decoder (the capture's counts, per
   replay).
6. Decode matmuls against plain, on the card: ``int8_matmul`` and
   ``int4_matmul`` (csrc/decode_matmul.cu) at every dalle_coco decode shape
   at batch 4 (q/k/v, wo with its per-head int4 split, mlp1, mlp2, the
   image-token head band), at M = 1 and 32, and at the ragged full-vocabulary
   head (N = 52,307). Tolerance: max |kernel - plain| <= 1e-5 * max |plain|:
   the same exact products summed in fp32 in another order; two runs equal
   bit for bit. Timed on the card under torch.profiler from traces with one
   kernel event a call (one launch a call), on weight copies that together
   exceed the 50 MB L2, so every launch reads its weight from device memory
   as the decode loop does.
7. Quantized serving, the main paths of ``--quantize int8`` and
   ``--quantize int4``: a temporary copy of configs/dalle_coco.json with
   ``decode_kernels: true`` through ``serve_dalle.build_server`` (weights from
   a seed, quantized on load); banded prefill logits on the card against the
   port's CPU plain path on the same quantized weights; the HTTP server
   answers a greedy and a sampled request in one batch and the greedy one
   again, which must repeat exactly; every decode-matmul launch is counted
   against 1 + (image_seq_len - 1) * (6 * n_layers + 1) per batch, through
   the graph's replays, plus the warm-up step of a bucket captured in the
   window.
8. The captured decode loop against the eager one, at batch 4, in each of
   bf16, int8 in the dequant form (``decode_kernels`` off), int8 and int4
   through the kernels (``captured_batch``): greedy tokens bit-equal to the
   eager loop's over all 1023 steps (bf16; timed, the eager "before") or
   the first 128 (the others); a sampled batch (temperature 1, top_k 64)
   through ``generate_images`` timed and split into prefill, decode loop
   and VAE, its first 128 tokens compared with the eager loop's from the
   same seed (reported); the bf16 greedy graph replayed from flat logits
   draws a spread of tokens (the generator moves on at every replay); the
   host's time to enqueue a replay against a replay's wall time; a
   window of 16 replays under torch.profiler (device ops, busy share, the
   decode-matmul kernel events held to the counted launches); then a
   profiled window of eager bf16 steps, and the continuous engine's
   captured chunk against ``decode_chunk_eager`` from one state with rows
   at two positions (greedy rows bit-equal, sampled rows reported).
9. Continuous batching: ``--quantize int8 --continuous`` over HTTP at batch 4
   with requests admitted at three chunk boundaries; the greedy request's
   images equal the whole-batch int8 engine's byte for byte, and the launches
   equal (6 * n_layers + 1) * chunk per chunk (chunk replays of its graph)
   plus one per admission.

``chip_smoke.py --ring-worker <checks|vae_values|serve_tp|train|train_vae>
...`` is one rank of the ring, tensor-parallel, VAE
data-parallel and sharded serving phases, started by them through
``run_ranks`` with the environment ``torch.distributed.run`` would give it.

Prints "kernel", "train", "memory_options_values", "loss_head",
"loss_head_steps", "head", "train_12b", "train_tp", "train_pp", "train_pptp",
"train_vae_tp", "train_vae_dp", "train_12b_tp", "train_vae",
"train_image", "batch", "decode_profile" and "continuous_chunk" JSON lines,
then each phase's seconds ("phase_seconds") and the whole run's against its
1000 s budget,
then the kernel report as one JSON line (with each kernel's least time on the
card, ``bound_ms``, one PyTorch call's time for the same function,
``library_ms``, and on rows 1-2 the image-mode run's launches,
``image_mode_launches``, the pipeline run's launches a rank,
``pp_launches`` and the pair's row at that run's microbatch,
``pp_microbatch``, the same of the PP x TP run, ``pptp_launches`` and
``pptp_microbatch``, and the row at dalle_12B's shape with the
published arm's launches, ``dalle_12B``), the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit code
is non-zero and no result is printed. fp32 matmuls and convs run in full
fp32 here (TF32 off), so fp32 comparisons are like for like.
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
FWD_SOURCE = "dalle_mtf_tpu_torch/csrc/causal_attention_fwd.cu"
BWD_SOURCE = "dalle_mtf_tpu_torch/csrc/causal_attention_bwd.cu"
DECODE_SOURCE = "dalle_mtf_tpu_torch/csrc/decode_matmul.cu"
LN_SOURCE = "dalle_mtf_tpu_torch/csrc/layer_norm.cu"
RING_SOURCE = "dalle_mtf_tpu_torch/csrc/ring_attention.cu"
RING = "dalle_mtf_tpu/ops/ring_attention.py"
REPLACES = {
    "causal_attention_packed_fwd": "dalle_mtf_tpu/ops/attention_packed.py:160",  # _fused_fwd_kernel
    "causal_attention_packed_bwd": "dalle_mtf_tpu/ops/attention_packed.py:205",  # _fused_bwd_kernel
    "causal_attention_fwd": "dalle_mtf_tpu/ops/attention.py:572",  # _wedge_fwd_kernel
    "int8_matmul": "dalle_mtf_tpu/ops/decode_matmul.py:45",  # _int8_kernel
    "int4_matmul": "dalle_mtf_tpu/ops/decode_matmul.py:54",  # _int4_kernel
    "layer_norm_fwd": "dalle_mtf_tpu/ops/layer_norm.py:53",  # _ln_fwd_kernel
    "layer_norm_bwd": "dalle_mtf_tpu/ops/layer_norm.py:63",  # _ln_bwd_kernel
    "ring_partial": f"{RING}:230",  # _ring_fwd_kernel
    "ring_block_grads": f"{RING}:333",  # _ring_bwd_kernel
}
# The [B, H, S, D] regimes of the TPU package, all ported onto the one
# kernel pair: one kernels-line row per wrapper and regime shape of
# phase_bhsd_kernels, with the run whose launches it reports and the TPU
# kernels (file:line) it replaces
ATTN = "dalle_mtf_tpu/ops/attention.py"
BHSD_ROWS = [  # (wrapper, shape, launches from, [(TPU kernel, file:line), ...])
    ("causal_attention_fwd", "dalle_4k", "long",
     [("_wedge_fwd_kernel (hybrid cap)", f"{ATTN}:572")]),
    ("causal_attention_bwd", "dalle_4k", "long", [("_hybrid_bwd_kernel", f"{ATTN}:1053")]),
    ("causal_attention_fwd", "train_1280", "long", [("_wr_fwd_kernel", f"{ATTN}:233")]),
    ("causal_attention_bwd", "train_1280", "long", [("_wedge_bwd_kernel", f"{ATTN}:683"),
                                                    ("_wr_bwd_kernel", f"{ATTN}:321")]),
    ("causal_attention_fwd", "loop_fp32", "values", [("_flash_kernel", f"{ATTN}:100")]),
    ("causal_attention_bwd", "loop_fp32", "values", [("_bwd_dq_kernel", f"{ATTN}:945"),
                                                     ("_bwd_dkv_kernel", f"{ATTN}:996")]),
]
ATTN_ITERS = 20  # timed launches of an attention kernel (a launch is 0.1-3 ms)
LAUNCHES_ON = {  # the run whose launches of the row's instantiation (bf16 or fp32) it reports
    "long": "dalle_4k training, bf16: the bf16 kernels (the train_1280 shape runs on no "
            "unpacked path, so that row counts the same kernel here)",
    "values": "train values, attn_packed false: a 2-layer fp32 model at S = 1280, the fp32 "
              "kernels (no path runs the loop regime's shape)",
}
BATCH = 4
TRAIN_CONFIG = "dalle_coco_synth"
LONG_CONFIG = "dalle_4k"
SERVE_CONFIG = "dalle_coco"
TRAIN_STEPS, RESUME_STEPS, TIMED_FROM = 8, 2, 3  # steps 3..8 are timed
LONG_STEPS, LONG_TIMED_FROM = 6, 3  # dalle_4k: steps 3..6 are timed
PEAK_BF16_TFLOPS = 989.0  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_TFLOPS = 67.0  # H100 SXM fp32 outside the tensor cores (data sheet)
PEAK_TF32_TFLOPS = 494.7  # H100 SXM dense TF32 on the tensor cores (data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
L2_BYTES = 50e6
CHUNK = 128  # continuous engine: decode steps between admissions
# eager reference steps of the quantized forms and of sampled runs (128 before
# the pipeline phase took its card time)
EAGER_STEPS = 64
PROFILED_REPLAYS = 16  # replays of a decode graph under torch.profiler
PROFILE_EDGE_S = 0.02  # host idle between the profiler window's edges and the replays
PREDICT_ROWS = 4  # predict_batch_size of the training phase's predict
DECODE_SHAPES = [  # (name, M, K, N): dalle_coco at batch 4, then M = 1 and 32, then ragged N
    ("qkv", 4, 1024, 1024), ("wo", 4, 1024, 1024), ("mlp1", 4, 1024, 4096),
    ("mlp2", 4, 4096, 1024), ("head_band", 4, 1024, 2048), ("mlp1_m1", 1, 1024, 4096),
    ("mlp1_m32", 32, 1024, 4096), ("head_full_vocab", 4, 1024, 52307),
]
DECODE_HEADS, DECODE_HEAD_DIM = 8, 128  # dalle_coco's heads: wo's int4 packing
DECODE_ITERS = 200  # timed launches of a decode matmul (a launch is a few µs)
# sequence parallelism: ranks sharing the one card over gloo
RING_RANKS = 4
RING_MESH, VALUES_MESH = "data:1,seq:4", "data:2,seq:2"
RING_LAYOUT = "batch_dim:data,total_seq_dim:seq"
# the ring run: 3 steps (step 3 timed) + eval + checkpoint (4 before the
# pipeline phase took its card time)
RING_STEPS = 3
RING_LABEL = "4 ranks sharing one card, gloo staged through host: not a multi-GPU number"
RING_SEED = 2**31 - 7
# tensor parallelism under ring attention (TP x SP): the ring run's 4 ranks on
# seq:2,model:2, the TP rules of configs/dalle_coco.json beside the ring's
TPSP_MESH = "data:1,seq:2,model:2"
TPSP_SEQ, TPSP_MODEL = 2, 2
TPSP_LAYOUT = ("batch_dim:data,total_seq_dim:seq,heads_dim:model,intermediate_expanded:model,"
               "vocab_dim:model")
TPSP_LABEL = "4 ranks sharing one card over gloo, staged through host: not a multi-GPU number"
TPSP_METRICS = ("loss", "loss_text", "loss_image")  # the train task's shares, summed
# the ring pair on a rank's block of the heads at the TP x SP rank's shape:
# (B, heads_total, heads a rank, S_local, D); a rank at seq index i runs the
# hop i back (the diagonal, then the past hop) on heads 4 x its model index
TPSP_HOP = (4, 8, 4, 2176, 128)
# tensor parallelism: ranks sharing the one card over gloo
TP_CONFIG = "dalle_coco"
TP_RANKS = 2
TP_VALUES_MESH = "data:2,model:2"
TP_LAYOUT = "batch_dim:data,heads_dim:model,intermediate_expanded:model,vocab_dim:model"
# dalle_coco as published, its mesh_shape and layout verbatim (data:16,model:2:
# data:2,model:2 on the four ranks of phase_train_sharded's launch, its third run;
# once data:1,model:2 on a two-rank launch of its own), cut to 8 rows
# of the published 128 (the rule phase_train_12b takes; 4 a data rank) and 4
# of its 12 layers (12 until the TP x SP run took its card time)
TP_CUT = dict(train_batch_size=8, eval_batch_size=8, n_layers=4)
TP_TRAIN_MESH, TP_TRAIN_DATA = "data:2,model:2", 2
TP_STEPS, TP_TIMED_FROM = 3, 3  # step 3 is timed (4 steps before the pipeline phase)
TP_LABEL = "2 ranks sharing one card over gloo, staged through host: not a multi-GPU number"
TP_VALUES_LABEL = ("4 ranks sharing one card over gloo, staged through host: not a multi-GPU "
                   "number")
TP_SEED = 11  # the values arms' dropout generator
TP_VALUES_ARMS = (  # (name, config fields, fused head) of the 2-layer fp32 values model
    ("dense", {}, False),
    ("fused_xent", {}, True),
    ("dropout_packed", {"attention_dropout": 0.1}, False),
    ("dropout_unpacked", {"attention_dropout": 0.1, "attn_packed": False}, False),
)
RUN_LIMIT_S = 1000  # the whole run's budget on the card, the build included


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch  # noqa: PLC0415

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_rotating(fn, copies: int, iters: int) -> float:
    """``cuda_ms`` of ``fn(i)`` with i cycling over ``copies`` inputs."""
    calls = itertools.count()
    return cuda_ms(lambda: fn(next(calls) % copies), iters)


def past_l2(tensors) -> list[tuple]:
    """Copies of ``tensors`` that together exceed twice the 50 MB L2 (the
    tensors themselves first; no copy when they already do), to time a
    kernel on inputs it reads from device memory: ``rotating_ms``."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = max(1, math.ceil(2 * L2_BYTES / nbytes)) if nbytes < L2_BYTES else 1
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(copies - 1)]


def rotating_ms(fn, sets, iters: int) -> float:
    """``cuda_ms`` of ``fn(*sets[i])`` with i cycling over the input sets."""
    return cuda_ms_rotating(lambda i: fn(*sets[i]), len(sets), iters)


def same_bits(first, again) -> bool:
    """Whether two runs' tensors are equal bit for bit."""
    import torch  # noqa: PLC0415

    return all(torch.equal(a, b) for a, b in zip(first, again))


def device_profile(torch, fn, copies: int, iters: int, names=(), per_call: int = 0,
                   attempts: int = 5) -> tuple[float, dict]:
    """(device ms of one ``fn(i)`` call, {kernel name: [events, total µs]})
    with i cycling over ``copies`` inputs: the durations of the kernels and
    copies it ran on the card, summed under torch.profiler over ``iters``
    calls, and what the profiler saw by name. On the H100 machine the
    profiler now and then returns a trace without some or all of the
    device's events (once, in a whole run, one with none at all; in another,
    three traces in a row one kernel event short; in a third, five traces
    in a row short of a few of the ring backward's events), so each trace
    is taken after a warm-up cycle of the same calls that the profiler
    traces and discards (its ``schedule``), with the host idle
    ``PROFILE_EDGE_S`` at each edge of the kept window (as
    ``profile_replays``: the events lost sit at the window's edges), and is
    kept only when it holds device work and, given kernel ``names``, exactly
    ``iters * per_call`` events of them, one a launch; a lost trace is
    reported and taken again, ``attempts`` times at most."""
    from torch.profiler import ProfilerActivity, profile, schedule  # noqa: PLC0415

    for i in range(3):
        fn(i % copies)
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up cycle, then the one kept
                for i in range(iters):
                    fn(i % copies)
                torch.cuda.synchronize()
                time.sleep(PROFILE_EDGE_S)
                prof.step()
                time.sleep(PROFILE_EDGE_S)
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        by_name = {}
        for e in device:
            seen = by_name.setdefault(e.name, [0, 0.0])
            seen[0] += 1
            seen[1] += e.time_range.elapsed_us()
        events = sum(c for name, (c, _) in by_name.items() if any(n in name for n in names))
        if device and (not names or events == iters * per_call):
            return sum(e.time_range.elapsed_us() for e in device) / 1e3 / iters, by_name
        print(f"device_profile: the profiler's trace lost device events (attempt "
              f"{attempt + 1}: {len(device)} device events, {events} of {names}, launched "
              f"{iters * per_call}); taken again", flush=True)
    raise AssertionError(f"the profiler lost device events in {attempts} traces: {by_name}")


def kernel_device_ms(torch, fn, copies: int, iters: int, names, per_call: int) -> float:
    """``device_profile`` of a call that launches ``per_call`` kernels whose
    names contain one of ``names``, from a trace that saw every launch."""
    return device_profile(torch, fn, copies, iters, names, per_call)[0]


def device_ms_rotating(torch, fn, copies: int, iters: int) -> float:
    """Device time of one ``fn(i)`` call (``device_profile``). For calls of
    a few µs the host's launch cost sets the pace of back-to-back calls
    (``cuda_ms``); this counts only what the card did."""
    return device_profile(torch, fn, copies, iters)[0]


def roofline(flops: float, nbytes: float, peak_tflops: float = PEAK_BF16_TFLOPS) -> dict:
    """The least time the card could take, ``bound_ms``: the larger of the
    operations at the peak for their type (dense bf16 by default) and the
    bytes at the memory rate, and which of the two it is, ``bound_by``."""
    ops_ms = flops / (peak_tflops * 1e12) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms > bytes_ms else "bytes")


def attention_bound(flops: float, nbytes: float, elem: int) -> dict:
    """``roofline`` of an attention kernel's products, ``flops``, on
    elements of ``elem`` bytes: bf16 at its tensor-core peak; fp32 as the
    kernels run it, three TF32 products for each (3xTF32) at the TF32 peak,
    with the bound at the fp32 peak outside the tensor cores beside it,
    ``bound_ms_fp32_peak`` (what the rows gave before the fp32 kernels moved
    to the tensor cores)."""
    if elem != 4:
        return roofline(flops, nbytes)
    return dict(**roofline(3 * flops, nbytes, PEAK_TF32_TFLOPS),
                bound_ms_fp32_peak=roofline(flops, nbytes, PEAK_FP32_TFLOPS)["bound_ms"])


def attention_roofline(b, h, s, d, elem, tensors, lse_tensors, matmuls) -> dict:
    """Causal attention over [B, H, S, D]: ``matmuls`` products of 2*D
    operations per (query, key) pair on or below the diagonal
    (``attention_bound``); ``tensors`` [B, H, S, D] arrays of ``elem`` bytes
    and ``lse_tensors`` fp32 [B*H, S] rows read or written once."""
    pairs = b * h * s * (s + 1) / 2
    nbytes = tensors * b * h * s * d * elem + lse_tensors * b * h * s * 4
    return attention_bound(matmuls * 2 * d * pairs, nbytes, elem)


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max(1, max |want|))."""
    return ((got.float() - want.float()).abs().max().item(),
            max(1.0, want.float().abs().max().item()))


def tile_rtol(dtype) -> float:
    """The bound on ``tile_rel_err``: 2^-6 in bf16, a few roundings of 2^-8
    relative (kernel and plain round to bf16 in the same places, from fp32
    sums taken in another order); 1e-5 in fp32."""
    import torch  # noqa: PLC0415

    return 2.0 ** -6 if dtype == torch.bfloat16 else 1e-5


def tile_rel_err(got, want, tile: int = 64) -> float:
    """The worst, over the heads and the ``tile``-long tiles of S of
    [B, H, S, D] tensors (query rows for out and dq, keys for dk and dv; the
    last tile ragged), of max |got - want| over max |want| within the tile.
    Each tile is held to its own scale: far down a long sequence the values
    are a small fraction of the tensor's largest, so a bound on the tensor's
    scale alone would pass zeros there."""
    import torch  # noqa: PLC0415

    b, h, s, d = want.shape
    n = -(-s // tile)

    def tiles(t):
        t = torch.nn.functional.pad(t.float().reshape(b * h, s, d), (0, 0, 0, n * tile - s))
        return t.reshape(b * h, n, tile * d)

    w = tiles(want)
    err = (tiles(got) - w).abs().amax(-1)
    return (err / w.abs().amax(-1).clamp_min(1e-30)).max().item()


def phase_kernel(torch, attn, card):
    """[B, H, S, D] kernel vs plain at three shapes; returns the serving
    shape's row."""
    shapes = [  # (name, B, H, S, D, dtype, window, atol)
        ("prefill", 4, 8, 256, 128, torch.bfloat16, None, 1e-2),
        ("ragged_window", 2, 4, 200, 64, torch.float32, 64, 1e-5),
        ("multi_tile", 2, 8, 1280, 128, torch.bfloat16, None, 1e-2),
    ]
    rows = []
    gen = torch.Generator().manual_seed(0)
    for name, b, h, s, d, dtype, window, atol in shapes:
        q, k, v = (
            (torch.rand((b, h, s, d), generator=gen) * 2 - 1).to("cuda", dtype)
            for _ in range(3)
        )
        before = attn.KERNEL_LAUNCHES["causal_attention_fwd"]
        out, lse = attn.causal_attention(q, k, v, window=window, with_lse=True)
        ref, ref_lse = attn.attention_reference(q, k, v, True, window, with_lse=True)
        torch.cuda.synchronize()
        if attn.KERNEL_LAUNCHES["causal_attention_fwd"] != before + 1:
            raise AssertionError("causal_attention did not count its launch")
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if not (err <= atol and lse_err <= 1e-4):
            raise AssertionError(
                f"{name}: kernel disagrees with attention_reference: "
                f"max_abs_err {err} (atol {atol}), lse err {lse_err}"
            )
        # these inputs fit the L2: rotate over copies that together do not
        sets = past_l2((q, k, v))
        ms = rotating_ms(lambda q, k, v: attn.causal_attention(q, k, v, window=window), sets, 50)
        plain_ms = rotating_ms(
            lambda q, k, v: attn.attention_reference(q, k, v, True, window), sets, 50)
        # a launch here is shorter than the host's dispatch of it, so ``ms``
        # follows the host; ``device_ms`` is what the card itself spent
        device_ms = device_ms_rotating(
            torch, lambda i: attn.causal_attention(*sets[i], window=window), len(sets), 50)
        library_ms = library_device_ms = None
        if window is None:  # SDPA has no local window
            def sdpa(q, k, v):
                return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)

            library_ms = rotating_ms(sdpa, sets, 50)
            library_device_ms = device_ms_rotating(torch, lambda i: sdpa(*sets[i]), len(sets), 50)
        row = dict(card=card, kernel="causal_attention_fwd", shape=name, B=b, H=h, S=s,
                   D=d, dtype=str(dtype), window=window, max_abs_err=err,
                   lse_err=lse_err, atol=atol, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, device_ms=device_ms,
                   library_device_ms=library_device_ms, input_copies=len(sets),
                   timed_launches=50,
                   **attention_roofline(b, h, s, d, q.element_size(), 4, 0, 2))
        print("kernel", json.dumps(row), flush=True)
        rows.append(row)
    return rows[0]


def phase_train_kernels(torch, attn, card):
    """The packed forward/backward pair and the [B, H, S, D] forward with
    dropout against their plain versions. Returns ({kernel name: row at the
    training shape (without dropout)}, the same at dalle_12B's microbatch:
    B=8, H=40, S=2560, at a tensor-parallel rank's block of dalle_coco:
    B=8, H=4, S=1280, at a dalle_12B rank's at model:8: B=4, H=5, S=2560,
    at a pipeline stage's microbatch of dalle_coco_synth on
    pipe:2,data:2: B=4, H=8, S=1280, and at a PP x TP rank's microbatch of
    dalle_coco on data:1,pipe:2,model:2: B=4, H=4, S=1280)."""
    from dalle_mtf_tpu_torch.ops import attention_packed as ap  # noqa: PLC0415

    cases = [  # (name, B, H, S, D, dtype, window, dropout, plain version's timing iters)
        ("train", 16, 8, 1280, 128, torch.bfloat16, None, 0.0, 10),
        ("ragged_window", 2, 4, 200, 64, torch.float32, 64, 0.0, 20),
        ("train_dropout", 16, 8, 1280, 128, torch.bfloat16, None, 0.1, 5),
        ("dalle_12B", 8, 40, 2560, 128, torch.bfloat16, None, 0.0, 2),
        # a tensor-parallel rank of dalle_coco at model:2: 4 of the 8 heads
        ("tp_rank", 8, 4, 1280, 128, torch.bfloat16, None, 0.0, 10),
        # a rank of dalle_12B at model:8: 5 of the 40 heads, the 12B TP run's 4 rows
        ("tp12b_rank", 4, 5, 2560, 128, torch.bfloat16, None, 0.0, 2),
        # a pipeline stage's microbatch of dalle_coco_synth on pipe:2,data:2: 4 rows
        ("pp_microbatch", 4, 8, 1280, 128, torch.bfloat16, None, 0.0, 10),
        # a PP x TP rank's microbatch of dalle_coco: 4 rows, 4 of the 8 heads
        ("pptp_microbatch", 4, 4, 1280, 128, torch.bfloat16, None, 0.0, 10),
    ]
    seed = 2**31 - 7  # near the top of the range: the uint32 add wraps
    gen = torch.Generator().manual_seed(1)
    best = {}
    for name, b, h, s, d, dtype, window, rate, iters in cases:
        atol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        q, k, v, g = ((torch.rand((b, s, h * d), generator=gen) * 2 - 1).to("cuda", dtype)
                      for _ in range(4))
        before = dict(attn.KERNEL_LAUNCHES)
        out, lse = ap._forward(q, k, v, h, window, rate, seed)
        grads = ap._backward(q, k, v, out, lse, g, h, window, rate, seed)
        ref, ref_lse = ap.attention_packed_reference(q, k, v, h, window, rate, seed,
                                                     with_lse=True)
        # the plain backward from the kernel's out and lse: only the backward differs
        ref_grads = ap.backward_reference(q, k, v, out, lse, g, h, window, rate, seed)
        torch.cuda.synchronize()
        for key in ("causal_attention_packed_fwd", "causal_attention_packed_bwd"):
            if attn.KERNEL_LAUNCHES[key] != before[key] + 1:
                raise AssertionError(f"{key} did not count its launch")
        errs = {"out": max_err(out, ref)}
        errs.update({n: max_err(t, r) for n, t, r in zip(("dq", "dk", "dv"), grads, ref_grads)})
        lse_err = (lse - ref_lse).abs().max().item()
        bad = {n: e for n, (e, scale) in errs.items() if not e <= atol * scale}
        if bad or not lse_err <= 1e-4:
            raise AssertionError(
                f"packed {name}: kernels disagree with the plain versions: {bad} "
                f"(atol {atol} x max(1, |plain|)), lse err {lse_err}; all {errs}")
        # no floating-point atomics: a second run gives the same bits
        if not same_bits(grads, ap._backward(q, k, v, out, lse, g, h, window, rate, seed)):
            raise AssertionError(f"packed {name}: dq, dk, dv differ between two runs")
        sets = past_l2((q, k, v, g, out, lse))
        fwd_ms = rotating_ms(lambda q, k, v, g, out, lse: ap._forward(
            q, k, v, h, window, rate, seed), sets, ATTN_ITERS)
        fwd_plain = cuda_ms(lambda: ap.attention_packed_reference(
            q, k, v, h, window, rate, seed, with_lse=True), iters)
        bwd_ms = rotating_ms(lambda q, k, v, g, out, lse: ap._backward(
            q, k, v, out, lse, g, h, window, rate, seed), sets, ATTN_ITERS)
        dsum_ms = rotating_ms(lambda q, k, v, g, out, lse: ap.dsum_rows(out, g, h), sets,
                              ATTN_ITERS)
        bwd_plain = cuda_ms(lambda: ap.backward_reference(
            q, k, v, out, lse, g, h, window, rate, seed), iters)
        lib_fwd = lib_bwd = None
        if window is None and rate == 0.0:  # SDPA: causal, no window, no hash dropout
            lib_fwd, lib_bwd = sdpa_ms(torch, sets, h, ATTN_ITERS)
        elem = q.element_size()
        common = dict(card=card, shape=name, B=b, H=h, S=s, D=d, dtype=str(dtype),
                      window=window, dropout=rate, atol=atol, input_copies=len(sets),
                      timed_launches=ATTN_ITERS)
        rows = {
            "causal_attention_packed_fwd": dict(
                kernel="causal_attention_packed_fwd", **common,
                max_abs_err=errs["out"][0], lse_err=lse_err, ms=fwd_ms, plain_ms=fwd_plain,
                library_ms=lib_fwd,
                # reads q, k, v; writes out and lse; QK^T and PV
                **attention_roofline(b, h, s, d, elem, 4, 1, 2)),
            "causal_attention_packed_bwd": dict(
                kernel="causal_attention_packed_bwd", **common,
                max_abs_err=max(errs[n][0] for n in ("dq", "dk", "dv")),
                errs={n: errs[n][0] for n in ("dq", "dk", "dv")},
                ms=bwd_ms, plain_ms=bwd_plain, ms_includes="dsum reduction + dQ and dK/dV launches",
                dsum_ms=dsum_ms, bit_equal_two_runs=True, library_ms=lib_bwd,
                # reads q, k, v, out, dout, lse; writes dq, dk, dv; five products
                **attention_roofline(b, h, s, d, elem, 8, 1, 5)),
        }
        for row in rows.values():
            print("kernel", json.dumps(row), flush=True)
        if name in ("train", "dalle_12B", "tp_rank", "tp12b_rank", "pp_microbatch",
                    "pptp_microbatch"):
            best[name] = rows
        del q, k, v, g, out, lse, grads, ref, ref_lse, ref_grads, sets
        torch.cuda.empty_cache()

    # the [B, H, S, D] forward (serving layout) with hash dropout
    for b, h, s, d, window in ((4, 8, 256, 128, None), (2, 4, 200, 64, 64)):
        q, k, v = ((torch.rand((b, h, s, d), generator=gen) * 2 - 1).to("cuda") for _ in range(3))
        before = attn.KERNEL_LAUNCHES["causal_attention_fwd"]
        out, lse = attn.causal_attention(q, k, v, window, 0.1, True, dropout_seed=seed)
        ref, ref_lse = attn.attention_reference(q, k, v, True, window, True, 0.1, seed)
        torch.cuda.synchronize()
        err, scale = max_err(out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        if attn.KERNEL_LAUNCHES["causal_attention_fwd"] != before + 1:
            raise AssertionError("causal_attention did not count its launch")
        if not (err <= 1e-5 * scale and lse_err <= 1e-4):
            raise AssertionError(f"[B, H, S, D] dropout: err {err}, lse err {lse_err}")
        print("kernel", json.dumps(dict(
            card=card, kernel="causal_attention_fwd", shape="dropout", B=b, H=h, S=s, D=d,
            dtype="torch.float32", window=window, dropout=0.1, max_abs_err=err,
            lse_err=lse_err, atol=1e-5,
            ms=cuda_ms(lambda: attn.causal_attention(q, k, v, window, 0.1, dropout_seed=seed), 20),
            plain_ms=cuda_ms(lambda: attn.attention_reference(
                q, k, v, True, window, False, 0.1, seed), 20),
            # a window bounds the pairs, so this bound (every causal pair) is an upper one
            **attention_roofline(b, h, s, d, 4, 4, 1, 2),
        )), flush=True)
    return (best["train"], best["dalle_12B"], best["tp_rank"], best["tp12b_rank"],
            best["pp_microbatch"], best["pptp_microbatch"])


def phase_bhsd_kernels(torch, attn, card):
    """The [B, H, S, D] forward and backward against the plain versions at
    the shapes of the TPU package's regimes: S = 1280 (the wedge and
    whole-row regimes; with and without hash dropout), dalle_4k's
    B=4 S=4352 bf16 (the capped wedge forward and the hybrid backward), and
    the loop regime's fp32 at S = 4352 and bf16 at a ragged S = 6200 (its
    128-rounded 6272 > 6144). Returns {shape name: {wrapper: row}}."""
    cases = [  # (name, B, H, S, dtype, dropout, plain version's timing iters)
        ("train_1280", 16, 8, 1280, torch.bfloat16, 0.0, 5),
        ("train_1280_dropout", 16, 8, 1280, torch.bfloat16, 0.1, 3),
        ("dalle_4k", 4, 8, 4352, torch.bfloat16, 0.0, 3),
        ("loop_fp32", 1, 8, 4352, torch.float32, 0.0, 3),
        ("loop_6200", 1, 2, 6200, torch.bfloat16, 0.0, 3),
    ]
    d, seed = 128, 2**31 - 7
    gen = torch.Generator().manual_seed(2)
    rows = {}
    for name, b, h, s, dtype, rate, iters in cases:
        atol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        q, k, v, g = ((torch.rand((b, h, s, d), generator=gen) * 2 - 1).to("cuda", dtype)
                      for _ in range(4))
        before = dict(attn.KERNEL_LAUNCHES)
        out, lse = attn._forward(q, k, v, None, rate, seed, with_lse=True)
        grads = attn._backward(q, k, v, out, lse, g, None, rate, seed)
        torch.cuda.synchronize()
        for key in ("causal_attention_fwd", "causal_attention_bwd"):
            if attn.KERNEL_LAUNCHES[key] != before[key] + 1:
                raise AssertionError(f"{key} did not count its launch")
        ref, ref_lse = attn.attention_reference(q, k, v, True, None, True, rate, seed)
        lse_err = (lse - ref_lse).abs().max().item()
        # the plain backward from the kernel's out and lse: only the backward differs
        ref_grads = attn.attention_backward_reference(q, k, v, out, lse, g, None, rate, seed)
        pairs = dict(zip(("out", "dq", "dk", "dv"), zip((out, *grads), (ref, *ref_grads))))
        errs = {n: max_err(t, r) for n, (t, r) in pairs.items()}
        rtol = tile_rtol(dtype)
        tile_errs = {n: tile_rel_err(t, r) for n, (t, r) in pairs.items()}
        # the tile bound must catch a kernel that leaves the last tile (ragged
        # at S = 6200) unwritten: plant that fault in a copy of each result
        for n, (t, r) in pairs.items():
            planted = t.clone()
            planted[:, :, (s - 1) // 64 * 64:] = 0
            if not tile_rel_err(planted, r) > rtol:
                raise AssertionError(f"[B, H, S, D] {name}: the tile bound passes {n} "
                                     f"with its last tile zeroed")
        del ref, ref_lse, ref_grads, pairs, planted
        torch.cuda.empty_cache()
        bad = {n: e for n, (e, scale) in errs.items() if not e <= atol * scale}
        bad.update({f"{n} tile": e for n, e in tile_errs.items() if not e <= rtol})
        if bad or not lse_err <= 1e-4:
            raise AssertionError(
                f"[B, H, S, D] {name}: kernels disagree with the plain versions: {bad} "
                f"(atol {atol} x max(1, |plain|); each 64-long tile of S within {rtol} of "
                f"its own max |plain|), lse err {lse_err}; all {errs}, tiles {tile_errs}")
        # no floating-point atomics: a second run gives the same bits
        if not same_bits(grads, attn._backward(q, k, v, out, lse, g, None, rate, seed)):
            raise AssertionError(f"[B, H, S, D] {name}: dq, dk, dv differ between two runs")
        sets = past_l2((q, k, v, g, out, lse))

        def fwd(q, k, v, g, out, lse):
            return attn._forward(q, k, v, None, rate, seed, True)

        def bwd(q, k, v, g, out, lse):
            return attn._backward(q, k, v, out, lse, g, None, rate, seed)

        fwd_ms = rotating_ms(fwd, sets, ATTN_ITERS)
        bwd_ms = rotating_ms(bwd, sets, ATTN_ITERS)
        # the card's own time of the backward (its dsum reduction and two
        # launches), the profiler's events of the two kernels held to the launches
        bwd_dev = kernel_device_ms(torch, lambda i: bwd(*sets[i]), len(sets), ATTN_ITERS,
                                   ("attention_bwd_dq", "attention_bwd_dkv"), 2)
        dsum_ms = rotating_ms(lambda q, k, v, g, out, lse: attn.dsum_rows(out, g), sets,
                              ATTN_ITERS)
        by_tile_rows = None
        if dtype == torch.bfloat16 and rate == 0.0:
            # the forward with its q tile given, 64 and 128 rows one after the other
            by_tile_rows = {
                tile: rotating_ms(lambda q, k, v, *_, tile=tile: attn._forward(
                    q, k, v, None, rate, seed, True, tile_rows=tile), sets, ATTN_ITERS)
                for tile in attn.FORWARD_TILES[d]}
        fwd_plain = cuda_ms(lambda: attn.attention_reference(
            q, k, v, True, None, True, rate, seed), iters)
        bwd_plain = cuda_ms(lambda: attn.attention_backward_reference(
            q, k, v, out, lse, g, None, rate, seed), iters)
        lib_fwd = lib_bwd = None
        if rate == 0.0:  # SDPA: causal, no hash dropout
            lib_fwd, lib_bwd = sdpa_bhsd_ms(torch, sets, ATTN_ITERS)
        elem = q.element_size()
        common = dict(card=card, shape=name, B=b, H=h, S=s, D=d, dtype=str(dtype),
                      window=None, dropout=rate, atol=atol, tile_rtol=rtol,
                      input_copies=len(sets), timed_launches=ATTN_ITERS)
        rows[name] = {
            "causal_attention_fwd": dict(
                kernel="causal_attention_fwd", **common, max_abs_err=errs["out"][0],
                tile_rel_err=tile_errs["out"],
                lse_err=lse_err, ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib_fwd,
                ms_by_tile_rows=by_tile_rows,
                **attention_roofline(b, h, s, d, elem, 4, 1, 2)),
            "causal_attention_bwd": dict(
                kernel="causal_attention_bwd", **common,
                max_abs_err=max(errs[n][0] for n in ("dq", "dk", "dv")),
                errs={n: errs[n][0] for n in ("dq", "dk", "dv")},
                tile_rel_errs={n: tile_errs[n] for n in ("dq", "dk", "dv")},
                ms=bwd_ms, device_ms=bwd_dev, plain_ms=bwd_plain, library_ms=lib_bwd,
                ms_includes="dsum reduction + dQ and dK/dV launches", dsum_ms=dsum_ms,
                bit_equal_two_runs=True,
                **attention_roofline(b, h, s, d, elem, 8, 1, 5)),
        }
        for row in rows[name].values():
            print("kernel", json.dumps(row), flush=True)
        del q, k, v, g, out, lse, grads, sets
        torch.cuda.empty_cache()
    return rows


def phase_tile_cases(torch, attn, card):
    """The pair at the edges of its tile walk, in bf16 (the forward under
    every q tile it is built for: 64 rows, and 128 at D = 128; the backward,
    always on 64-row tiles, from each forward's out and lse) and in fp32 (the
    3xTF32 forward and backward kernels), against the plain versions: D = 64 with
    windows that are not a multiple of the 64-key tile, S in {1, 63, 65,
    129} (ragged under either tile), a window of 1 and one wider than S, the
    packed layout with H = 1, with and without hash dropout. Bounds as
    everywhere: max |kernel - plain| <= atol * max(1, max |plain|) (1e-2 in
    bf16, 1e-5 in fp32), every 64-long tile within 2^-6 (bf16) or 1e-5 (fp32)
    of its own max |plain| (a bound shown to fail a copy with its last tile
    zeroed), lse 1e-4, and dq, dk, dv equal bit for bit over two runs. Where
    the plain gradient is zero up to fp32 rounding (a row that sees only its
    own key has ds = p (dp - dsum) with dp = dsum: S = 1, window 1; max
    |plain| <= 1e-5), the kernel's must be too (max |kernel| <= 1e-5) and
    there is no tile to hold or to plant. out and lse of two forward runs
    must be equal bit for bit too (the fp32 forward's two warp groups are
    merged in one fixed order)."""
    from dalle_mtf_tpu_torch.ops import attention_packed as ap  # noqa: PLC0415

    cases = [  # (name, packed layout, B, H, S, D, window, dropout)
        ("d64_window_37", False, 2, 4, 200, 64, 37, 0.0),
        ("d64_window_100_dropout", True, 2, 4, 333, 64, 100, 0.1),
        ("s1", False, 2, 3, 1, 128, None, 0.0),
        ("s63", False, 2, 3, 63, 128, None, 0.0),
        ("s65_packed", True, 2, 3, 65, 64, None, 0.0),
        ("s129_dropout", False, 2, 3, 129, 128, None, 0.1),
        ("window_1", False, 2, 2, 129, 128, 1, 0.0),
        ("window_wider_than_s", False, 2, 2, 129, 64, 1000, 0.1),
        ("packed_h1", True, 2, 1, 200, 128, None, 0.0),
        ("packed_h1_d64_window_37", True, 3, 1, 129, 64, 37, 0.1),
    ]
    fp32_cases = [  # the same edges for the fp32 (3xTF32) kernels
        ("fp32_d64_window_37", False, 2, 4, 200, 64, 37, 0.0),
        ("fp32_s1", False, 2, 3, 1, 64, None, 0.0),
        ("fp32_s63_dropout", False, 2, 3, 63, 128, None, 0.1),
        ("fp32_s65_packed", True, 2, 3, 65, 64, None, 0.0),
        ("fp32_s129", False, 2, 3, 129, 128, None, 0.0),
        ("fp32_window_1", False, 2, 2, 129, 128, 1, 0.0),
        ("fp32_window_wider_than_s", False, 2, 2, 129, 64, 1000, 0.1),
        ("fp32_packed_h1", True, 2, 1, 200, 128, None, 0.0),
        ("fp32_packed_h1_d64_window_37", True, 3, 1, 129, 64, 37, 0.1),
    ]
    seed = 2**31 - 7
    gen = torch.Generator().manual_seed(7)
    runs = [(*case, torch.bfloat16, tile) for case in cases for tile in attn.FORWARD_TILES[case[5]]]
    runs += [(*case, torch.float32, None) for case in fp32_cases]
    for name, packed, b, h, s, d, window, rate, dtype, tile in runs:
        atol, rtol = (1e-2 if dtype == torch.bfloat16 else 1e-5), tile_rtol(dtype)
        q, k, v, g = ((torch.rand((b, h, s, d), generator=gen) * 2 - 1).to("cuda", dtype)
                      for _ in range(4))
        if packed:
            pq, pk, pv, pg = (ap._pack(t).contiguous() for t in (q, k, v, g))
            out, lse = ap._forward(pq, pk, pv, h, window, rate, seed, tile_rows=tile)
            fwd_equal = same_bits((out, lse), ap._forward(pq, pk, pv, h, window, rate, seed,
                                                          tile_rows=tile))
            grads = ap._backward(pq, pk, pv, out, lse, pg, h, window, rate, seed)
            again = ap._backward(pq, pk, pv, out, lse, pg, h, window, rate, seed)
            out, *grads = (ap._unpack(t, h) for t in (out, *grads))
            again = [ap._unpack(t, h) for t in again]
        else:
            out, lse = attn._forward(q, k, v, window, rate, seed, with_lse=True, tile_rows=tile)
            fwd_equal = same_bits((out, lse), attn._forward(q, k, v, window, rate, seed,
                                                            with_lse=True, tile_rows=tile))
            grads = attn._backward(q, k, v, out, lse, g, window, rate, seed)
            again = attn._backward(q, k, v, out, lse, g, window, rate, seed)
        torch.cuda.synchronize()
        ref, ref_lse = attn.attention_reference(q, k, v, True, window, True, rate, seed)
        # the plain backward from the kernel's out and lse: only the backward differs
        ref_grads = attn.attention_backward_reference(q, k, v, out.contiguous(), lse, g,
                                                      window, rate, seed)
        lse_err = (lse - ref_lse).abs().max().item()
        errs, bad = {}, {}
        for n, t, r in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref, *ref_grads)):
            if r.float().abs().max().item() <= 1e-5:  # zero up to fp32 rounding
                errs[n] = dict(zero=t.float().abs().max().item())
                if not errs[n]["zero"] <= 1e-5:
                    bad[n] = errs[n]
                continue
            err, scale = max_err(t, r)
            errs[n] = dict(abs=err, tile=tile_rel_err(t, r), planted=planted_fails(t, r, rtol))
            # planted is None where the plain last tile is all zero (a dropped weight)
            if not (err <= atol * scale and errs[n]["tile"] <= rtol
                    and errs[n]["planted"] is not False):
                bad[n] = errs[n]
        if not any(e.get("planted") for e in errs.values()):
            bad["planted"] = "no tensor showed that a zeroed last tile fails"
        if bad or not lse_err <= 1e-4 or not fwd_equal or not same_bits(grads, again):
            raise AssertionError(
                f"tile case {name}, {tile}-row q tile: kernels disagree with the plain "
                f"versions: {bad} (atol {atol} x max(1, |plain|), tiles within {rtol}, a zeroed "
                f"last tile must fail), lse err {lse_err}, two forward runs bit-equal: "
                f"{fwd_equal}, two backward runs: {same_bits(grads, again)}; all {errs}")
        print("kernel", json.dumps(dict(
            card=card, kernel="causal_attention_packed" if packed else "causal_attention",
            shape=name, tile_rows=tile, B=b, H=h, S=s, D=d, dtype=str(dtype), window=window,
            dropout=rate, atol=atol, tile_rtol=rtol, lse_err=lse_err, errs=errs,
            bit_equal_two_runs=True, forward_bit_equal_two_runs=True)), flush=True)
    head_block_cases(torch, attn, card)


HEAD_BLOCK_CASES = (  # (packed, dtype name, B, S, D, head0, heads, heads_total)
    *((packed, dtype, 2, 320, 128, 4, 4, 8) for packed in (True, False)
      for dtype in ("bfloat16", "float32")),
    # a dalle_12B rank at model:8 (data:1): rank 7's 5 of the 40 heads, at
    # the 12B TP run's 4 rows
    (True, "bfloat16", 4, 2560, 128, 35, 5, 40),
)


def head_block_cases(torch, attn, card):
    """The dropout hash's head index: the packed and the [B, H, S, D] pair on
    a block of the heads (``head0``, ``heads_total``: a tensor-parallel
    rank's block), HEAD_BLOCK_CASES: heads 4..7 of 8 (dalle_coco at model:2)
    in bf16 (64-row q tile, as the whole launch) and fp32, and the packed
    bf16 pair on heads 35..39 of 40 at B=4 S=2560 (a dalle_12B rank at
    model:8), with hash dropout 0.1, held against their plain versions with
    the same arguments (atol 1e-2 bf16, 1e-5 fp32, x max(1, |plain|); lse
    1e-4) and against those heads of one launch over all the heads, out,
    lse, dq, dk, dv bit for bit. The block launched with the defaults
    (head0 0) must draw another mask."""
    from dalle_mtf_tpu_torch.ops import attention_packed as ap  # noqa: PLC0415

    seed, rate = RING_SEED, 0.1
    gen = torch.Generator().manual_seed(13)
    for packed, dtype_name, b, s, d, h0, heads, total in HEAD_BLOCK_CASES:
        dtype = getattr(torch, dtype_name)
        tile = 64 if dtype == torch.bfloat16 else None
        atol = 1e-2 if dtype == torch.bfloat16 else 1e-5

        def run(tensors, n, head0=0, heads_total=None):
            """(out, dq, dk, dv) as [B, H, S, D] and the lse of one launch
            pair on ``tensors`` (q, k, v, g [B, H, S, D]) of ``n`` heads."""
            if packed:
                pq, pk, pv, pg = (ap._pack(t).contiguous() for t in tensors)
                out, lse = ap._forward(pq, pk, pv, n, None, rate, seed, tile, head0,
                                       heads_total)
                grads = ap._backward(pq, pk, pv, out, lse, pg, n, None, rate, seed,
                                     head0, heads_total)
                return [ap._unpack(t, n) for t in (out, *grads)], lse
            q, k, v, g = tensors
            out, lse = attn._forward(q, k, v, None, rate, seed, True, tile, head0,
                                     heads_total)
            grads = attn._backward(q, k, v, out, lse, g, None, rate, seed, head0,
                                   heads_total)
            return [out, *grads], lse

        whole_in = [(torch.rand((b, total, s, d), generator=gen) * 2 - 1).to("cuda", dtype)
                    for _ in range(4)]
        block_in = [t[:, h0:h0 + heads].contiguous() for t in whole_in]
        whole, whole_lse = run(whole_in, total)
        block, block_lse = run(block_in, heads, h0, total)
        default = run(block_in, heads)[0][0]
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(p, w[:, h0:h0 + heads]) for p, w in zip(block, whole)) \
            and torch.equal(block_lse, whole_lse.reshape(b, total, s)[:, h0:h0 + heads]
                            .reshape(-1, s))
        del whole, whole_lse, whole_in
        ref, ref_lse = attn.attention_reference(*block_in[:3], True, None, True, rate, seed,
                                                h0, total)
        ref_grads = attn.attention_backward_reference(
            *block_in[:3], block[0].contiguous(), block_lse, block_in[3], None, rate, seed,
            h0, total)
        errs = {n: max_err(t, r) for n, t, r in zip(("out", "dq", "dk", "dv"), block,
                                                     (ref, *ref_grads))}
        lse_err = (block_lse - ref_lse).abs().max().item()
        bad = {n: e for n, (e, scale) in errs.items() if not e <= atol * scale}
        other_mask = not torch.equal(default, block[0])
        name = f"head_block_{'packed' if packed else 'bhsd'}_{dtype_name}_{h0}_of_{total}"
        if bad or not lse_err <= 1e-4 or not bit_equal or not other_mask:
            raise AssertionError(
                f"{name}: heads {h0}..{h0 + heads - 1} of {total} with dropout {rate}: "
                f"against the plain versions {bad} (atol {atol}), lse err {lse_err}; "
                f"bit-equal to the {total}-head launch's heads: {bit_equal}; the default "
                f"head0 draws another mask: {other_mask}; all {errs}")
        print("kernel", json.dumps(dict(
            card=card, kernel="causal_attention_packed" if packed else "causal_attention",
            shape=name, B=b, H=heads, head0=h0, heads_total=total, S=s, D=d,
            dtype=str(dtype), dropout=rate, tile_rows=tile, atol=atol, lse_err=lse_err,
            errs={n: e for n, (e, _) in errs.items()},
            bit_equal_to_whole_launch_heads=bit_equal,
            default_head0_draws_another_mask=other_mask)), flush=True)
        del block, block_lse, block_in, default, ref, ref_lse, ref_grads
        torch.cuda.empty_cache()


TP_PREFILL_CASES = (  # (name, B, S, D, heads a rank, heads_total): the prefill on a rank's heads
    ("dalle_coco_model2", 4, 256, 128, 4, 8),  # phase_serve_tp's batch, head0 0 and 4
    ("dalle_12B_model8", 64, 256, 128, 5, 40),  # the 12B sampling, head0 5 x rank
)


def tp_prefill_cases(torch, card) -> dict:
    """The serving prefill's forward (row 3: ``causal_attention`` at
    S = text_seq_len, bf16, no dropout) on a tensor-parallel rank's block of
    the heads (``head0``, ``heads_total``), TP_PREFILL_CASES: every rank's
    block held bit for bit to those heads of one launch over all the heads,
    and rank 0's block to the plain version (atol 1e-2, lse 1e-4); rank 0's
    block timed between events over copies past the L2, on the card under
    torch.profiler, against the plain version and SDPA on the same heads,
    with its bound. Returns {name: row}."""
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415

    gen = torch.Generator().manual_seed(17)
    rows = {}
    for name, b, s, d, heads, total in TP_PREFILL_CASES:
        q, k, v = ((torch.rand((b, total, s, d), generator=gen) * 2 - 1).to("cuda", torch.bfloat16)
                   for _ in range(3))
        whole, whole_lse = attn.causal_attention(q, k, v, with_lse=True)
        whole_lse = whole_lse.reshape(b, total, s)
        blocks = [(h0, [t[:, h0:h0 + heads].contiguous() for t in (q, k, v)])
                  for h0 in range(0, total, heads)]
        bit_equal = []
        for h0, block in blocks:
            out, lse = attn.causal_attention(*block, with_lse=True, head0=h0, heads_total=total)
            bit_equal.append(bool(torch.equal(out, whole[:, h0:h0 + heads]) and torch.equal(
                lse.reshape(b, heads, s), whole_lse[:, h0:h0 + heads])))
        del q, k, v, whole, whole_lse
        block = blocks[0][1]
        out, lse = attn.causal_attention(*block, with_lse=True, head0=0, heads_total=total)
        ref, ref_lse = attn.attention_reference(*block, True, None, True, 0.0, None, 0, total)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if not (all(bit_equal) and err <= 1e-2 and lse_err <= 1e-4):
            raise AssertionError(f"tp prefill {name}: bit-equal to the whole launch's heads "
                                 f"{bit_equal}; against the plain version {err} (atol 1e-2), "
                                 f"lse {lse_err} (1e-4)")

        def fwd(q, k, v):
            return attn.causal_attention(q, k, v, head0=0, heads_total=total)

        def sdpa(q, k, v):
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)

        sets = past_l2(block)
        row = dict(card=card, kernel="causal_attention_fwd", shape=name, B=b, H=heads,
                   heads_total=total, head0s=[h0 for h0, _ in blocks], S=s, D=d,
                   dtype=str(torch.bfloat16), max_abs_err=err, lse_err=lse_err, atol=1e-2,
                   bit_equal_to_whole_launch_heads=bit_equal,
                   ms=rotating_ms(fwd, sets, ATTN_ITERS),
                   plain_ms=rotating_ms(lambda q, k, v: attn.attention_reference(
                       q, k, v, True, None, False, 0.0, None, 0, total), sets, ATTN_ITERS),
                   library_ms=rotating_ms(sdpa, sets, ATTN_ITERS),
                   device_ms=device_ms_rotating(torch, lambda i: fwd(*sets[i]), len(sets),
                                                ATTN_ITERS),
                   library_device_ms=device_ms_rotating(torch, lambda i: sdpa(*sets[i]),
                                                        len(sets), ATTN_ITERS),
                   input_copies=len(sets), timed_launches=ATTN_ITERS,
                   **attention_roofline(b, heads, s, d, 2, 4, 0, 2))
        print("kernel", json.dumps(row), flush=True)
        rows[name] = row
        del blocks, block, sets, out, lse, ref, ref_lse
        torch.cuda.empty_cache()
    return rows


def phase_ln_kernels(torch, lnm, card):
    """The LayerNorm pair against the plain versions at dalle_4k's rows
    (R = 4 x 4352, E = 1024, bf16), at dalle_12B's width (R = 8192,
    E = 5120, bf16) and a ragged fp32 shape; device times under
    torch.profiler, over input copies past the 50 MB L2, the backward's split
    by kernel name; a "resources" line for each shape. Returns {wrapper: row
    at the dalle_4k shape}."""
    cases = [("dalle_4k", 17408, 1024, torch.bfloat16), ("dalle_12B", 8192, 5120, torch.bfloat16),
             ("ragged_fp32", 1001, 768, torch.float32)]
    gen = torch.Generator().manual_seed(3)
    best = {}
    for name, r, e, dtype in cases:
        print("resources", json.dumps(dict(
            kernels="layer_norm forward and backward", shape=name, E=e, dtype=str(dtype),
            rows_a_tile=lnm.bwd_tile_rows(e, dtype), **lnm.kernel_resources(e, dtype))), flush=True)
        atol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        elem = torch.finfo(dtype).bits // 8
        copies = max(1, math.ceil(2 * L2_BYTES / (2 * r * e * elem)))
        xs = [(torch.randn((r, e), generator=gen) * 2 + 0.5).to("cuda", dtype)
              for _ in range(copies)]
        dys = [torch.randn((r, e), generator=gen).to("cuda", dtype) for _ in range(copies)]
        g = (1 + 0.3 * torch.randn(e, generator=gen)).cuda()
        b = (0.2 * torch.randn(e, generator=gen)).cuda()
        x, dy = xs[0], dys[0]
        before = dict(lnm.KERNEL_LAUNCHES)
        y = lnm._forward(x, g, b, 1e-5)
        dx, dg, db = lnm._backward(x, g, dy, 1e-5)
        torch.cuda.synchronize()
        for key in ("layer_norm_fwd", "layer_norm_bwd"):
            if lnm.KERNEL_LAUNCHES[key] != before[key] + 1:
                raise AssertionError(f"{key} did not count its launch")
        want_dx, want_dg, want_db = lnm.layer_norm_backward_reference(x, g, dy)
        errs = {"y": max_err(y, lnm.layer_norm_reference(x, g, b)), "dx": max_err(dx, want_dx)}
        rel = {n: (got - w).abs().max().item() / w.abs().max().item()
               for n, got, w in (("dg", dg, want_dg), ("db", db, want_db))}
        again = lnm._backward(x, g, dy, 1e-5)
        if not (torch.equal(again[1], dg) and torch.equal(again[2], db)):
            raise AssertionError(f"layer_norm_bwd {name}: dg/db differ between two runs")
        bad = {n: err for n, (err, scale) in errs.items() if not err <= atol * scale}
        bad.update({n: v for n, v in rel.items() if not v <= 1e-4})
        if bad:
            raise AssertionError(f"LN {name}: kernels disagree with the plain versions: {bad} "
                                 f"(y, dx atol {atol} x max(1, |plain|); dg, db 1e-4 of max)")
        # the library call takes g and b in x's dtype (it normalises in fp32
        # inside); one autograd graph of it per input copy
        g_lib, b_lib = g.to(dtype), b.to(dtype)
        leaves = [[t.clone().requires_grad_(True) for t in (xs[i], g_lib, b_lib)]
                  for i in range(copies)]
        y_lib = [torch.nn.functional.layer_norm(lv[0], (e,), lv[1], lv[2], 1e-5) for lv in leaves]
        fns = {
            "fwd": (lambda i: lnm._forward(xs[i], g, b, 1e-5),
                    lambda i: lnm.layer_norm_reference(xs[i], g, b),
                    lambda i: torch.nn.functional.layer_norm(xs[i], (e,), g_lib, b_lib, 1e-5)),
            "bwd": (lambda i: lnm._backward(xs[i], g, dys[i], 1e-5),
                    lambda i: lnm.layer_norm_backward_reference(xs[i], g, dys[i]),
                    lambda i: torch.autograd.grad(y_lib[i], leaves[i], dys[i], retain_graph=True)),
        }
        for kind, (kern, plain, lib) in fns.items():
            kernel = f"layer_norm_{kind}"
            # fwd: x read, y written, g and b read; bwd: x and dy read, dx
            # written, g read and dg, db written
            n = 2 if kind == "fwd" else 3
            nbytes = n * r * e * elem + n * e * 4
            dev_ms, by_name = device_profile(torch, kern, copies, 50, (kernel,), 1)
            row = dict(card=card, kernel=kernel, shape=name, R=r, E=e, dtype=str(dtype),
                       max_abs_err=errs["y" if kind == "fwd" else "dx"][0], atol=atol,
                       ms=dev_ms, wall_ms=cuda_ms_rotating(kern, copies, 50),
                       device_ms_by_kernel={n: us / 1e3 / 50 for n, (_, us) in by_name.items()},
                       plain_ms=device_ms_rotating(torch, plain, copies, 10),
                       library_ms=device_ms_rotating(torch, lib, copies, 50),
                       input_copies=copies,
                       **roofline((9 if kind == "fwd" else 16) * r * e, nbytes,
                                  PEAK_FP32_TFLOPS))
            if kind == "bwd":
                row.update(dg_db_rel_err=rel, ms_includes="one launch: the rows, then dg/db "
                           "summed across CTAs after a grid barrier")
            print("kernel", json.dumps(row), flush=True)
            if name == "dalle_4k":
                best[kernel] = row
        del xs, dys, leaves, y_lib, fns
        torch.cuda.empty_cache()
    return best


def sdpa_bhsd_ms(torch, sets, iters, causal: bool = True) -> tuple[float, float]:
    """One ``scaled_dot_product_attention`` forward (causal unless asked),
    and its backward alone, on the [B, H, S, D] (q, k, v, g, ...) of each
    input set in turn: the library yardstick."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        fwd = rotating_ms(lambda q, k, v, *_: sdpa(q, k, v, is_causal=causal), sets, iters)
    graphs = []  # one autograd graph an input set
    for q, k, v, g, *_ in sets:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        graphs.append((sdpa(*leaves, is_causal=causal), leaves, g))
    bwd = rotating_ms(lambda out, leaves, g: torch.autograd.grad(
        out, leaves, g, retain_graph=True), graphs, iters)
    return fwd, bwd


def sdpa_ms(torch, sets, h, iters) -> tuple[float, float]:
    """The library yardstick at a packed training shape:
    ``sdpa_bhsd_ms`` on the [B, H, S, D] copies of the packed (q, k, v, g,
    ...) of each input set."""
    def heads(t):
        b, s, _ = t.shape
        return t.view(b, s, h, -1).transpose(1, 2).contiguous()

    return sdpa_bhsd_ms(torch, [tuple(heads(t) for t in st[:4]) for st in sets], iters)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.detach().to(device)
            for k, v in tree.items()}


def values_model(torch, **over):
    """(config, fp32 parameters, tokens [2, S]) of the values checks: the
    full-width configs/dalle_coco_synth.json model cut to 2 layers, fp32,
    weights and tokens from seeds; ``over`` sets config fields."""
    from dalle_mtf_tpu_torch.models.dalle import DALLE  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    base, _ = make_dalle_models(fetch_model_params(TRAIN_CONFIG), "cpu")
    cfg = dataclasses.replace(base.cfg, **{"n_layers": 2, "bf_16": False, **over})
    params = DALLE(cfg, "cpu").init(torch.Generator().manual_seed(5))
    tokens = torch.randint(0, cfg.total_tokens, (2, cfg.total_seq_len),
                           generator=torch.Generator().manual_seed(6))
    return cfg, params, tokens


def phase_train_values(torch, card, **over):
    """Loss and every grad of a full-width, 2-layer fp32 model: card (through
    the kernels) against the port's plain path on the CPU. ``over`` sets
    config fields (``attn_packed=False, ln_impl="pallas"``: the [B, H, S, D]
    pair and the LN kernels)."""
    from dalle_mtf_tpu_torch.models.dalle import DALLE  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import layer_norm as lnm  # noqa: PLC0415

    cfg, params, tokens = values_model(torch, **over)
    bwd = "causal_attention_packed_bwd" if cfg.attn_packed else "causal_attention_bwd"
    want = {bwd: cfg.n_layers}
    if cfg.ln_impl == "pallas":  # two LNs a layer and the final one
        want["layer_norm_bwd"] = 2 * cfg.n_layers + 1
    results = {}
    for device in ("cuda", "cpu"):
        tree = _to(params, device)
        for _, t in named_leaves(tree):
            t.requires_grad_(True)
        reset_counts(attn, lnm)
        loss, _ = DALLE(cfg, device).loss(tree, tokens.to(device))
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            got = {**attn.KERNEL_LAUNCHES, **lnm.KERNEL_LAUNCHES}
            if any(got[n] != c for n, c in want.items()):
                raise AssertionError(f"the card's loss launched {got}, expected {want}")
            launched = {n: c for n, c in got.items() if c}
        results[device] = (loss.item(), {"/".join(p): t.grad.cpu() for p, t in named_leaves(tree)})
    return dict(**compare_values(over or "packed", cfg, card, results["cuda"], results["cpu"]),
                launches=launched)


def compare_values(label, cfg, card, card_result, cpu_result, ref: str = "cpu") -> dict:
    """Hold (loss, {leaf: grad}) from the card against the CPU plain path
    (or the reference ``ref`` names: "one_process", one process on the
    card): loss atol 1e-4, each leaf within relative L2 error 1e-2."""
    (gl, gg), (cl, cg) = card_result, cpu_result
    l2 = max((((gg[n] - cg[n]).norm() / cg[n].norm().clamp_min(1e-30)).item(), n) for n in cg)
    elem = max(((gg[n] - cg[n]).abs().max().item() / max(cg[n].abs().max().item(), 1e-30), n)
               for n in cg)
    print(f"train values {label}: {cfg.n_embd} wide, {cfg.n_layers} layers, fp32, batch 2, S "
          f"{cfg.total_seq_len}: loss card {gl:.6f} {ref} {cl:.6f} (atol 1e-4); worst grad "
          f"relative L2 error {l2[0]:.3g} ({l2[1]}, bound 1e-2); worst single element "
          f"{elem[0]:.3g} of its leaf's max |grad| ({elem[1]}); {card}", flush=True)
    if not (abs(gl - cl) <= 1e-4 and l2[0] <= 1e-2):
        raise AssertionError(f"{label}: the card's loss or grads disagree with the {ref} "
                             f"reference")
    return {"loss_card": gl, f"loss_{ref}": cl, "worst_grad_rel_l2": l2,
            "worst_grad_elem": elem}


def write_tokens_dataset(root: str, seed: int, image_len: int, image_vocab: int,
                         files: int = 4, per_file: int = 48) -> str:
    """Tokens-mode tfrecords (tokens + caption ids) drawn from ``seed``."""
    import numpy as np  # noqa: PLC0415

    from dalle_mtf_tpu_torch.data.tfrecord import TFRecordWriter, serialize_example  # noqa: PLC0415

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for f in range(files):
        with TFRecordWriter(os.path.join(root, f"synth_{f}.tfrecords")) as w:
            for _ in range(per_file):
                w.write(serialize_example({
                    "tokens": rng.integers(0, image_vocab, image_len).tolist(),
                    "caption": rng.integers(0, 50257, rng.integers(5, 64)).tolist(),
                }))
    return os.path.join(root, "*.tfrecords")


def train_config(tmp: str, train_steps: int, name: str = TRAIN_CONFIG,
                 checkpoint_every: int = TRAIN_STEPS, max_to_keep: int = 1, **extra) -> str:
    """A copy of configs/<name>.json in tokens mode over a seeded dataset in
    ``tmp`` (``extra`` keys added); returns its path."""
    from dalle_mtf_tpu_torch.utils.config import _resolve_config_path  # noqa: PLC0415

    with open(_resolve_config_path(name)) as f:
        cfg = json.load(f)
    pattern = os.path.join(tmp, "data", "*.tfrecords")
    cfg.update(
        dataset={**cfg["dataset"], "train_path": pattern, "eval_path": pattern, "tokens": True},
        train_steps=train_steps, steps_per_checkpoint=checkpoint_every, eval_steps=1,
        log_every=1, max_to_keep=max_to_keep, model_path=os.path.join(tmp, "run"),
    )
    cfg.update(extra)
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def flops_per_token(cfg) -> float:
    """bench.py's analytic FLOPs per token of a DALLE config (6 N_matmul +
    12 L E S)."""
    e, L, v, s = cfg.n_embd, cfg.n_layers, cfg.total_tokens, cfg.total_seq_len
    return 6 * (L * 12 * e * e + e * v) + 12 * L * e * s


def check_dalle_run(trainer, steps: list[int], evals: list[int], launches: dict,
                    want: dict) -> list[float]:
    """The checks of a DALLE training run: the logged steps, finite losses
    and grad norms, the evals and the checkpoint at ``evals``, and exactly
    ``want`` kernel launches (every other attention kernel none). Returns
    the losses."""
    losses = [h["loss"] for h in trainer.history]
    if [h["step"] for h in trainer.history] != steps:
        raise AssertionError(f"logged steps {[h['step'] for h in trainer.history]}, "
                             f"expected {steps}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in trainer.history):
        raise AssertionError(f"non-finite loss or grad_norm: {trainer.history}")
    got = [e["step"] for e in trainer.eval_history]
    if got != evals or not all(math.isfinite(v) for e in trainer.eval_history for v in e.values()):
        raise AssertionError(f"eval: {trainer.eval_history}, expected at {evals}")
    if trainer.checkpoint_steps() != steps[-1:]:
        raise AssertionError(f"checkpoints {trainer.checkpoint_steps()}")
    if launches != {n: want.get(n, 0) for n in launches}:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    return losses


def phase_train(torch, attn, card, kernel_rows):
    """The training main path through train_dalle.main, then a profiled
    window of steps. Returns the launch counts of the main path's run."""
    from dalle_mtf_tpu_torch import train_dalle  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        dalle, _ = make_dalle_models(fetch_model_params(TRAIN_CONFIG), "cpu")
        cfg = dalle.cfg
        t0 = time.perf_counter()
        write_tokens_dataset(os.path.join(tmp, "data"), 0, cfg.image_seq_len, cfg.image_vocab_size)
        path = train_config(tmp, TRAIN_STEPS)
        print(f"train: tokens dataset + config in {time.perf_counter() - t0:.1f}s", flush=True)
        names = ("causal_attention_packed_fwd", "causal_attention_packed_bwd")

        torch.cuda.reset_peak_memory_stats()
        reset_counts(attn)
        t0 = time.perf_counter()
        first = train_dalle.main(["--model", path, "--new", "--yes", "--gpu_ids", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(attn.KERNEL_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        evals = first.eval_history
        losses = check_dalle_run(first, list(range(1, TRAIN_STEPS + 1)), [TRAIN_STEPS], launches,
                                 {names[0]: cfg.n_layers * (TRAIN_STEPS + 1),
                                  names[1]: cfg.n_layers * TRAIN_STEPS})
        # at init the logits are ~N(0, n_embd * 0.02^2) (unit-variance LN
        # output times w_out of std 0.02), so E[loss] = ln(vocab) + var / 2
        init_loss = math.log(cfg.total_tokens) + cfg.n_embd * 0.02**2 / 2
        if abs(losses[0] - init_loss) > 0.1:
            raise AssertionError(f"first loss {losses[0]} vs ln(vocab) + var/2 = {init_loss}")
        step_s = [1.0 / h["steps_per_sec"] for h in first.history[TIMED_FROM - 1:]]
        med = statistics.median(step_s)
        tokens_per_step = first.batch_size * cfg.total_seq_len

        # resume: a second main continues from the checkpoint
        path = train_config(tmp, TRAIN_STEPS + RESUME_STEPS)
        reset_counts(attn)
        second = train_dalle.main(["--model", path, "--gpu_ids", "0"])
        end = TRAIN_STEPS + RESUME_STEPS
        check_dalle_run(second, list(range(TRAIN_STEPS + 1, end + 1)), [end],
                        dict(attn.KERNEL_LAUNCHES), {names[0]: cfg.n_layers * (RESUME_STEPS + 1),
                                                     names[1]: cfg.n_layers * RESUME_STEPS})
        print(f"train: {TRAIN_STEPS} steps + eval + checkpoint in {wall:.1f}s; losses "
              f"{[round(x, 4) for x in losses]}; eval {evals[0]}; resumed at step "
              f"{TRAIN_STEPS}: losses {[round(h['loss'], 4) for h in second.history]}; "
              f"launches {launches}", flush=True)

        split = profile_steps(torch, path, cfg)
        e, L, v, s = cfg.n_embd, cfg.n_layers, cfg.total_tokens, cfg.total_seq_len
        tflops = tokens_per_step / med * flops_per_token(cfg) / 1e12
        attn_ms = cfg.n_layers * (kernel_rows[names[0]]["ms"] + kernel_rows[names[1]]["ms"])
        print("train", json.dumps(dict(
            card=card, config=TRAIN_CONFIG, batch=first.batch_size, seq_len=s,
            n_layers=L, n_embd=e, vocab=v, bf16=cfg.bf_16, steps_timed=len(step_s),
            step_s=step_s, step_s_median=med, tokens_per_s=tokens_per_step / med,
            tflops_per_s=tflops, mfu=tflops / PEAK_BF16_TFLOPS,
            peak_mem_gb=peak / 1e9, first_loss=losses[0], ln_vocab=math.log(v),
            expected_init_loss=init_loss,
            attn_kernels_ms_per_step_from_events=attn_ms,
            attn_kernels_share_from_events=attn_ms / (med * 1e3),
            **split,
        )), flush=True)
        return {n: launches[n] for n in names}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


ENCODER_WORDS = ("fprop", "implicit_convolve", "conv2d", "convolution", "cudnn",
                 "nchwtonhwc", "nhwctonchw")  # the frozen VAE's convs and their layout copies


def profile_steps(torch, path, cfg, steps: int = 2, frozen=None) -> dict:
    """Device time of ``steps`` training steps under torch.profiler, split
    into the attention kernels, the LN kernels, the frozen VAE encoder's
    convs (image mode: ``frozen`` holds its parameters), matmuls and the rest
    (with the rest's largest kernels by name, and the largest of all)."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    from dalle_mtf_tpu_torch.data.pipeline import dalle_input_fn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_task  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.trainer import Trainer, step_generator  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    params = fetch_model_params(path)
    params["padding_id"] = 50257
    _, _, init_fn, loss_fn, _ = make_dalle_task(params, "cuda")
    trainer = Trainer(params, init_fn, loss_fn, params["model_path"] + "_profile",
                      cfg.total_seq_len, "cuda", frozen_params=frozen)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    data = iter(dalle_input_fn(params))
    state, _ = trainer.train_step(state, next(data), step_generator(0, 1, 0))
    batches = [next(data) for _ in range(steps)]
    data.close()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            state, metrics = trainer.train_step(state, batch, step_generator(0, 1, i + 1))
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    buckets = {"attn_fwd": 0.0, "attn_bwd": 0.0, "ln": 0.0, "vae_encoder_convs": 0.0,
               "matmul": 0.0, "other": 0.0}
    others: dict[str, float] = {}
    kernels: dict[str, float] = {}
    # kernels and copies only: user-annotation ranges (Optimizer.step#...)
    # also show on the device timeline and would count their kernels twice
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    for e in device:
        name = e.name.lower()
        if "causal_attention_fwd_kernel" in name:
            key = "attn_fwd"
        elif "attention_bwd" in name:
            key = "attn_bwd"
        elif "layer_norm" in name:
            key = "ln"
        elif any(w in name for w in ENCODER_WORDS):
            key = "vae_encoder_convs"
        elif any(w in name for w in ("gemm", "cutlass", "xmma", "sm90_", "nvjet")):
            key = "matmul"
        else:
            key = "other"
            others[e.name[:90]] = others.get(e.name[:90], 0.0) + e.time_range.elapsed_us() / 1e3
        buckets[key] += e.time_range.elapsed_us() / 1e3
        kernels[e.name[:160]] = kernels.get(e.name[:160], 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(buckets.values())
    top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        profiled_steps=steps,
        profiled_wall_ms_per_step=wall * 1e3 / steps,
        device_ms_per_step={k: v / steps for k, v in buckets.items()},
        other_top_ms_per_step={k: v / steps for k, v in top},
        top_kernels_ms_per_step={k: v / steps for k, v in
                                 sorted(kernels.items(), key=lambda kv: -kv[1])[:16]},
        device_busy_share=busy / (wall * 1e3) if device else None,
        device_ops_per_step=len(device) / steps,
    )


def phase_train_long(torch, attn, lnm, card, kernel_rows):
    """The long-sequence training main path: a tokens-mode copy of
    configs/dalle_4k.json at full width and depth (S = 256 + 64 x 64 = 4352,
    batch 4, bf16) with ``attn_packed: false`` (the [B, H, S, D] pair, the
    layout the JAX package takes at this length) and ``ln_impl: "pallas"``
    (the LN kernels), through ``train_dalle.main`` for LONG_STEPS steps with
    an eval and a checkpoint; exact launch counts, then a profiled window.
    Returns the launch counts of the main path's run."""
    from dalle_mtf_tpu_torch import train_dalle  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    tmp = tempfile.mkdtemp(prefix="chip_smoke_long_")
    try:
        extra = dict(attn_packed=False, ln_impl="pallas")
        dalle, _ = make_dalle_models({**fetch_model_params(LONG_CONFIG), **extra}, "cpu")
        cfg = dalle.cfg
        t0 = time.perf_counter()
        write_tokens_dataset(os.path.join(tmp, "data"), 1, cfg.image_seq_len,
                             cfg.image_vocab_size, files=2, per_file=24)
        path = train_config(tmp, LONG_STEPS, LONG_CONFIG, LONG_STEPS, **extra)
        print(f"train {LONG_CONFIG}: n_embd={cfg.n_embd} layers={cfg.n_layers} "
              f"heads={cfg.n_heads} S={cfg.total_seq_len} vocab={cfg.total_tokens} "
              f"bf16={cfg.bf_16} attn_packed={cfg.attn_packed} ln_impl={cfg.ln_impl}; "
              f"tokens dataset + config in {time.perf_counter() - t0:.1f}s", flush=True)

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(attn, lnm)
        t0 = time.perf_counter()
        run = train_dalle.main(["--model", path, "--new", "--yes", "--gpu_ids", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**attn.KERNEL_LAUNCHES, **lnm.KERNEL_LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        evals = run.eval_history
        passes = LONG_STEPS + 1  # eval_steps 1: one batch per eval
        n_ln = 2 * cfg.n_layers + 1
        losses = check_dalle_run(run, list(range(1, LONG_STEPS + 1)), [LONG_STEPS], launches, {
            "causal_attention_fwd": cfg.n_layers * passes,
            "causal_attention_bwd": cfg.n_layers * LONG_STEPS,
            "layer_norm_fwd": n_ln * passes, "layer_norm_bwd": n_ln * LONG_STEPS})
        init_loss = math.log(cfg.total_tokens) + cfg.n_embd * 0.02**2 / 2
        if abs(losses[0] - init_loss) > 0.1:
            raise AssertionError(f"first loss {losses[0]} vs ln(vocab) + var/2 = {init_loss}")
        step_s = [1.0 / h["steps_per_sec"] for h in run.history[LONG_TIMED_FROM - 1:]]
        med = statistics.median(step_s)
        tokens_per_step = run.batch_size * cfg.total_seq_len
        print(f"train {LONG_CONFIG}: {LONG_STEPS} steps + eval + checkpoint in {wall:.1f}s; "
              f"losses {[round(x, 4) for x in losses]}; eval {evals[0]}; launches "
              f"{launches}", flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()

        split = profile_steps(torch, path, cfg)
        e, L, v, s = cfg.n_embd, cfg.n_layers, cfg.total_tokens, cfg.total_seq_len
        tflops = tokens_per_step / med * flops_per_token(cfg) / 1e12
        attn_ms = L * (kernel_rows["causal_attention_fwd"]["ms"]
                       + kernel_rows["causal_attention_bwd"]["ms"])
        first_loss = losses[0]
        print("train", json.dumps(dict(
            card=card, config=LONG_CONFIG, batch=tokens_per_step // s, seq_len=s,
            n_layers=L, n_embd=e, vocab=v, bf16=cfg.bf_16, attn_packed=cfg.attn_packed,
            ln_impl=cfg.ln_impl, steps_timed=len(step_s), step_s=step_s,
            step_s_median=med, tokens_per_s=tokens_per_step / med, tflops_per_s=tflops,
            mfu=tflops / PEAK_BF16_TFLOPS, peak_mem_gb=peak / 1e9, first_loss=losses[0],
            ln_vocab=math.log(v), expected_init_loss=init_loss,
            attn_kernels_ms_per_step_from_events=attn_ms,
            attn_kernels_share_from_events=attn_ms / (med * 1e3),
            **split,
        )), flush=True)
        return launches, first_loss
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


TWELVE_B_CONFIG = "dalle_12B"
# dalle_12B at full width cut to fit one card and the time limit: 1 of 38
# layers, one data replica's 32 rows of the published 512 (data:16), so
# tokens_per_mb_per_replica 20480 still gives the published 4 microbatches of
# 8 rows; no tensor parallelism (model:8 and its layout rules dropped)
TWELVE_B_CUT = dict(n_layers=1, mesh_shape="data:1", layout="batch_dim:data",
                    train_batch_size=32, eval_batch_size=8)
TWELVE_B_STEPS, TWELVE_B_TIMED_FROM = 3, 2  # steps 2..3 timed
LEAN = dict(fused_xent=True, optimizer="adafactor", skip_nonfinite_updates=3)
HEAD_CHUNK_ITERS = 5  # timed runs of each fused-head product at a chunk's shape


def head_pass(torch, name, x, w, b, t, z, g):
    """(loss, dx, dw, db) of one forward and backward, with cotangent ``g``,
    of the fused head (``chunked_softmax_xent``, 8 chunks), of the dense
    head (``DALLE.loss``'s: bf16 logits and bias) or of the plain fp32 loss
    (fp32 logits of the operands in fp32, autograd)."""
    from dalle_mtf_tpu_torch.ops.losses import softmax_cross_entropy_with_logits  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops.xent_fused import chunked_softmax_xent  # noqa: PLC0415

    dt = torch.float32 if name == "plain" else x.dtype
    leaves = [x.detach().to(dt).requires_grad_(True), w.detach().to(dt).requires_grad_(True),
              b.detach().clone().requires_grad_(True)]
    xl, wl, bl = leaves
    if name == "fused":
        loss = chunked_softmax_xent(xl, wl, bl, t, z, 8)
    else:
        loss = softmax_cross_entropy_with_logits(xl @ wl + bl.to(dt), t, z)
    loss.backward(g)
    return (loss.detach(), *(leaf.grad for leaf in leaves))


def memory_option_values(torch, attn, card) -> dict:
    """The memory-bound options on the card at a small size, each against
    its reference:

    - the fused head against the plain fp32 loss (loss within 1e-4; dx and
      dw, rounded to bf16 as JAX rounds them, within 2^-7 of their max
      |plain|; db within 1e-4 of it) and against the dense head (bf16
      logits: each within 2^-5), at N = 4096 rows of dalle_coco_synth's
      width and vocabulary, z-loss 0 and 1e-4;
    - every remat policy against no remat on a 2-layer bf16 copy of
      dalle_coco_synth with embedding, residual and attention dropout 0.1:
      loss and every grad bit-equal, the generator's state equal, and the
      packed forward launched once a layer where the policy keeps its out and
      lse, twice where the recompute re-runs it;
    - ``skip_nonfinite_updates: 3`` around AdamW (foreach and fused) and
      Adafactor: a step whose loss is NaN moves no parameter and no count,
      the next finite step moves them."""
    from dalle_mtf_tpu_torch.models import dalle as tdalle  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import get_optimizer, named_leaves  # noqa: PLC0415

    result = {"card": card, "heads": {}}
    gen = torch.Generator().manual_seed(21)
    n, e, v = 4096, 1024, 52307
    x = torch.randn((n, e), generator=gen).to("cuda", torch.bfloat16)
    w = (torch.randn((e, v), generator=gen) * 0.02).to("cuda", torch.bfloat16)
    b = (torch.randn(v, generator=gen) * 0.02).cuda()
    t = torch.randint(0, v, (n,), generator=gen).cuda()
    g = torch.full((n,), 1.0 / n, device="cuda")
    for z in (0.0, 1e-4):
        got = {name: head_pass(torch, name, x, w, b, t, z, g)
               for name in ("fused", "dense", "plain")}
        torch.cuda.synchronize()
        errs = {}
        for ref in ("plain", "dense"):
            errs[ref] = {name: (got["fused"][i].float() - got[ref][i].float()).abs().max().item()
                         / max(got[ref][i].float().abs().max().item(), 1e-30)
                         for i, name in enumerate(("loss", "dx", "dw", "db"))}
        loss_abs = (got["fused"][0] - got["plain"][0]).abs().max().item()
        bounds = {"dx": 2**-7, "dw": 2**-7, "db": 1e-4}
        bad = {k: e for k, e in errs["plain"].items() if k in bounds and not e <= bounds[k]}
        if not loss_abs <= 1e-4:
            bad["loss"] = loss_abs
        bad.update({f"dense {k}": e for k, e in errs["dense"].items() if not e <= 2**-5})
        print(f"fused head z_loss {z}: N={n} E={e} V={v} bf16, against the plain fp32 loss: "
              f"loss max abs err {loss_abs:.3g} (bound 1e-4), dx {errs['plain']['dx']:.3g}, "
              f"dw {errs['plain']['dw']:.3g} of max (bound 2^-7), db {errs['plain']['db']:.3g} "
              f"(bound 1e-4); against the dense head (bf16 logits): "
              f"{ {k: round(e, 6) for k, e in errs['dense'].items()} } (bound 2^-5); {card}",
              flush=True)
        if bad:
            raise AssertionError(f"fused head z_loss {z}: {bad}")
        result["heads"][str(z)] = dict(loss_max_abs_err_vs_plain=loss_abs,
                                       rel_err_vs_plain=errs["plain"],
                                       rel_err_vs_dense=errs["dense"])
    del x, w, b, t, g, got
    torch.cuda.empty_cache()

    # every remat policy against no remat, dropout on
    cfg, params, tokens = values_model(torch, bf_16=True, embed_dropout=0.1,
                                       residual_dropout=0.1, attention_dropout=0.1)
    params, tokens = _to(params, "cuda"), tokens.cuda()

    def run(policy):
        c = dataclasses.replace(cfg, recompute_grad=policy is not None,
                                remat_policy=policy or "dots_saveable")
        tree = {k: ({m: t.clone().requires_grad_(True) for m, t in val.items()}
                    if isinstance(val, dict) else val.clone().requires_grad_(True))
                for k, val in params.items()}
        reset_counts(attn)
        gen = torch.Generator().manual_seed(7)
        loss, _ = tdalle.DALLE(c, "cuda").loss(tree, tokens, gen, train=True)
        loss.backward()
        torch.cuda.synchronize()
        return (loss.detach(), [t.grad for _, t in named_leaves(tree)], gen.get_state(),
                dict(attn.KERNEL_LAUNCHES))

    want = run(None)
    keeps = {"dots_and_attn", "everything_saveable", "save_attn", "save_attn_lean"}
    result["remat"] = {}
    for policy in tdalle.REMAT_POLICIES:
        loss, grads, state, launches = run(policy)
        fwd = launches["causal_attention_packed_fwd"]
        need = cfg.n_layers * (1 if policy in keeps else 2)
        same = (torch.equal(loss, want[0]) and torch.equal(state, want[2])
                and all(torch.equal(a, b) for a, b in zip(grads, want[1])))
        print(f"remat {policy}: loss and every grad bit-equal to no remat: {same}; packed "
              f"forward launches {fwd} (expected {need}), backward "
              f"{launches['causal_attention_packed_bwd']}", flush=True)
        if not same or fwd != need or launches["causal_attention_packed_bwd"] != cfg.n_layers:
            raise AssertionError(f"remat {policy}: bit-equal {same}, launches {launches}")
        result["remat"][policy] = dict(bit_equal=same, packed_fwd_launches=fwd)

    # skip_nonfinite_updates: a NaN loss moves nothing
    model = tdalle.DALLE(dataclasses.replace(cfg, embed_dropout=0.0, residual_dropout=0.0,
                                             attention_dropout=0.0), "cuda")
    result["skip"] = {}
    for label, over in (("adamw", {}), ("fused_adamw", {"fused_optimizer": True}),
                        ("adafactor", {"optimizer": "adafactor"})):
        tree = _to(params, "cuda")
        for _, t in named_leaves(tree):
            t.requires_grad_(True)
        opt, _ = get_optimizer({"lr": 1e-3, "warmup_steps": 0, "weight_decay": 0.01,
                                "skip_nonfinite_updates": 3, **over}, tree)
        moved = []
        for poison in (False, True, False):
            before = [t.detach().clone() for _, t in named_leaves(tree)]
            count = opt.count
            opt.zero_grad()
            loss, _ = model.loss(tree, tokens, train=True)
            (loss * float("nan") if poison else loss).backward()
            opt.step()
            torch.cuda.synchronize()
            moved.append((any(not torch.equal(a, t.detach())
                              for a, (_, t) in zip(before, named_leaves(tree))),
                          opt.count - count))
        print(f"skip_nonfinite_updates 3, {label}: (params moved, count advanced) over a finite, "
              f"a NaN and a finite step: {moved}", flush=True)
        if moved != [(True, 1), (False, 0), (True, 1)] or opt.total_notfinite != 1:
            raise AssertionError(f"skip_nonfinite_updates {label}: {moved}")
        result["skip"][label] = moved
    print("memory_options_values", json.dumps(result), flush=True)
    return result


def head_products_ms(torch, card, n: int, e: int, v: int, chunks: int) -> dict:
    """The fused head's products at one microbatch of ``n`` rows, by CUDA
    events over a chunk's shape: the logits (bf16 operands, fp32 output:
    ``torch.mm(a, b, out_dtype=torch.float32)`` on the tensor cores; run in
    the forward and again in the backward), dx (the same call on dlogits in
    bf16 and wᵀ) and dw (fp32 xᵀ · fp32 dlogits, IEEE fp32 outside the
    tensor cores, TF32 off); then the whole fused head and the dense head,
    forward and backward, at the microbatch. Each with its bound."""
    from dalle_mtf_tpu_torch.ops.xent_fused import f32_matmul  # noqa: PLC0415

    gen = torch.Generator().manual_seed(22)
    c = n // chunks
    x = torch.randn((n, e), generator=gen).to("cuda", torch.bfloat16)
    w = (torch.randn((e, v), generator=gen) * 0.02).to("cuda", torch.bfloat16)
    b = torch.zeros(v, device="cuda")
    t = torch.randint(0, v, (n,), generator=gen).cuda()
    g = torch.full((n,), 1.0 / n, device="cuda")
    d = torch.rand((c, v), generator=gen).cuda()
    dw = torch.zeros((e, v), device="cuda")
    flops = 2 * c * e * v
    logits_ms = cuda_ms(lambda: f32_matmul(x[:c], w), HEAD_CHUNK_ITERS)
    dx_ms = cuda_ms(lambda: f32_matmul(d.to(torch.bfloat16), w.t()), HEAD_CHUNK_ITERS)
    dw_ms = cuda_ms(lambda: dw.addmm_(x[:c].float().t(), d), HEAD_CHUNK_ITERS)
    del d, dw
    torch.cuda.empty_cache()
    heads = {}
    for name in ("fused", "dense"):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        heads[name] = cuda_ms(lambda: head_pass(torch, name, x, w, b, t, 0.0, g), 2)
        heads[name + "_peak_gb_over_inputs"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    per_mb = chunks * (2 * logits_ms + dx_ms + dw_ms)
    out = dict(
        card=card, rows=n, n_embd=e, vocab=v, chunks=chunks, chunk_rows=c,
        logits_call="torch.mm(a, b, out_dtype=torch.float32)",
        chunk_logits_ms=logits_ms, chunk_dx_ms=dx_ms, chunk_dw_fp32_ms=dw_ms,
        chunk_logits_bound_ms=roofline(flops, 2 * (c * e + e * v) + 4 * c * v)["bound_ms"],
        chunk_dw_bound_ms=roofline(flops, 4 * (c * e + c * v + 2 * e * v),
                                   PEAK_FP32_TFLOPS)["bound_ms"],
        products_ms_per_microbatch=per_mb,
        fused_head_fwd_bwd_ms=heads["fused"], dense_head_fwd_bwd_ms=heads["dense"],
        fused_head_peak_gb_over_inputs=heads["fused_peak_gb_over_inputs"],
        dense_head_peak_gb_over_inputs=heads["dense_peak_gb_over_inputs"],
    )
    print("head", json.dumps(out), flush=True)
    del x, w, b, t, g
    torch.cuda.empty_cache()
    return out


def head_kernels(torch, card, fused: bool, iters: int = 2) -> dict:
    """The loss head alone at dalle_coco_synth's step (16 rows of 1280,
    n_embd 1024, V = 52,307, bf16) under torch.profiler: ``DALLE.loss``
    with its ``hidden`` replaced by a fixed bf16 input, forward and
    backward. Device ms a step by kernel name, all of them."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    dalle, _ = make_dalle_models(fetch_model_params(TRAIN_CONFIG), "cuda")
    cfg = dalle.cfg
    gen = torch.Generator().manual_seed(23)
    x = torch.randn((16, cfg.total_seq_len, cfg.n_embd), generator=gen).to("cuda", torch.bfloat16)
    params = {"w_out": (torch.randn((cfg.n_embd, cfg.total_tokens), generator=gen) * 0.02).cuda(),
              "b_out": torch.zeros(cfg.total_tokens, device="cuda")}
    tokens = torch.randint(0, cfg.total_tokens, (16, cfg.total_seq_len), generator=gen).cuda()
    leaf = x.requires_grad_(True)
    for p in params.values():
        p.requires_grad_(True)
    dalle.hidden = lambda *a, **k: leaf

    def step():
        loss, _ = dalle.loss(params, tokens, fused_xent=fused)
        loss.backward()

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    kernels: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                ev, "is_user_annotation", False):
            kernels[ev.name[:160]] = kernels.get(ev.name[:160], 0.0) + \
                ev.time_range.elapsed_us() / 1e3 / iters
    out = dict(card=card, head="fused" if fused else "dense", rows=16 * cfg.total_seq_len,
               n_embd=cfg.n_embd, vocab=cfg.total_tokens, device_ms_per_step=sum(kernels.values()),
               kernels_ms_per_step=dict(sorted(kernels.items(), key=lambda kv: -kv[1])))
    print("loss_head", json.dumps(out), flush=True)
    return out


def phase_loss_head(torch, card) -> dict:
    """The loss head by name at dalle_coco_synth: two profiled steps of the
    published config (the dense head) and of a ``fused_xent: true`` copy, in
    turn, then each head alone under the profiler (its kernels by name)."""
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    tmp = tempfile.mkdtemp(prefix="chip_smoke_head_")
    try:
        dalle, _ = make_dalle_models(fetch_model_params(TRAIN_CONFIG), "cpu")
        cfg = dalle.cfg
        write_tokens_dataset(os.path.join(tmp, "data"), 0, cfg.image_seq_len,
                             cfg.image_vocab_size, files=2, per_file=24)
        steps = {}
        for label, extra in (("dense", {}), ("fused", {"fused_xent": True})):
            gc.collect()
            torch.cuda.empty_cache()
            steps[label] = profile_steps(torch, train_config(tmp, 2, **extra), cfg)
        heads = {label: head_kernels(torch, card, label == "fused") for label in ("dense", "fused")}
        out = dict(card=card, config=TRAIN_CONFIG, steps=steps,
                   head_alone_device_ms={k: h["device_ms_per_step"] for k, h in heads.items()})
        print("loss_head_steps", json.dumps(out), flush=True)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def arm_line(run, cfg, first: int, peak: int, wall: float, launches: dict) -> dict:
    """A dalle_12B arm's figures from its Trainer: step s from step
    ``first`` on, tokens/s, MFU, peak memory, losses, evals, launches."""
    step_s = [1.0 / h["steps_per_sec"] for h in run.history[first - 1:]]
    med = statistics.median(step_s)
    tokens = run.batch_size * cfg.total_seq_len
    tflops = tokens / med * flops_per_token(cfg) / 1e12
    return dict(steps_timed=len(step_s), step_s=step_s, step_s_median=med,
                tokens_per_s=tokens / med, tflops_per_s=tflops, mfu=tflops / PEAK_BF16_TFLOPS,
                peak_mem_gb=peak / 1e9, wall_s=wall, losses=[h["loss"] for h in run.history],
                grad_norms=[h["grad_norm"] for h in run.history], evals=run.eval_history,
                launches=launches)


def phase_train_12b(torch, attn, card) -> dict:
    """configs/dalle_12B.json at full width (n_embd 5120, 40 heads of 128,
    S = 256 + 48 x 48 = 2560, vocab 52,307, bf16) cut to TWELVE_B_CUT, in
    tokens mode through ``train_dalle.main``, two arms:

    - published: AdamW (weight decay 0.01), the dense head, ``dots_saveable``
      (the JAX default its ``recompute_grad: true`` takes), TWELVE_B_STEPS
      steps with an eval and a checkpoint (the remat sweep that ran on its
      state, each policy's peak memory at this width, was cut for the card
      time of the sharded serving phase; every policy stays held to no
      remat on the card by ``memory_option_values``);
    - lean: + ``fused_xent``, Adafactor, ``skip_nonfinite_updates: 3``, the
      same steps with checkpoints at 2 and at the last step (both kept); the
      last checkpoint is removed and a second ``main`` resumes from step 2:
      its losses and grad norms equal the unbroken run's bit for bit.

    Exact launches of the packed pair (two forwards a layer and microbatch
    under dots_saveable, one in eval), step s, tokens/s, MFU (bench.py's
    formula), peak memory. Returns the published arm's launches."""
    from dalle_mtf_tpu_torch import train_dalle  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.trainer import num_microbatches  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    tmp = tempfile.mkdtemp(prefix="chip_smoke_12b_")
    names = ("causal_attention_packed_fwd", "causal_attention_packed_bwd")
    try:
        published = {**fetch_model_params(TWELVE_B_CONFIG), **TWELVE_B_CUT}
        dalle, _ = make_dalle_models(published, "cpu")
        cfg = dalle.cfg
        mb = num_microbatches(published, TWELVE_B_CUT["train_batch_size"], cfg.total_seq_len, 1)
        print(f"train {TWELVE_B_CONFIG}: n_embd={cfg.n_embd} heads={cfg.n_heads} "
              f"S={cfg.total_seq_len} vocab={cfg.total_tokens} layers={cfg.n_layers} (of 38) "
              f"batch {TWELVE_B_CUT['train_batch_size']} in {mb} microbatches, remat "
              f"{cfg.remat_policy}, parameters {dalle_param_count(dalle)}", flush=True)
        L, steps = cfg.n_layers, TWELVE_B_STEPS
        arms = {}

        # published arm
        root = os.path.join(tmp, "published")
        write_tokens_dataset(os.path.join(root, "data"), 3, cfg.image_seq_len,
                             cfg.image_vocab_size, files=2, per_file=32)
        path = train_config(root, steps, TWELVE_B_CONFIG, steps, **TWELVE_B_CUT)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(attn)
        t0 = time.perf_counter()
        run = train_dalle.main(["--model", path, "--new", "--yes", "--gpu_ids", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: attn.KERNEL_LAUNCHES[n] for n in names}
        check_dalle_run(run, list(range(1, steps + 1)), [steps], dict(attn.KERNEL_LAUNCHES),
                        {names[0]: L * (2 * mb * steps + 1), names[1]: L * mb * steps})
        arms["published"] = arm_line(run, cfg, TWELVE_B_TIMED_FROM,
                                     torch.cuda.max_memory_allocated(), wall, launches)
        print(f"train {TWELVE_B_CONFIG} published: {arms['published']}", flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()

        # lean arm: unbroken, then resumed from its step-2 checkpoint
        root = os.path.join(tmp, "lean")
        write_tokens_dataset(os.path.join(root, "data"), 3, cfg.image_seq_len,
                             cfg.image_vocab_size, files=2, per_file=32)
        path = train_config(root, steps, TWELVE_B_CONFIG, 2, max_to_keep=2,
                            **TWELVE_B_CUT, **LEAN)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(attn)
        t0 = time.perf_counter()
        run = train_dalle.main(["--model", path, "--new", "--yes", "--gpu_ids", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lean_launches = {n: attn.KERNEL_LAUNCHES[n] for n in names}
        if run.checkpoint_steps() != [2, steps]:
            raise AssertionError(f"lean arm checkpoints {run.checkpoint_steps()}")
        if lean_launches != {names[0]: L * (2 * mb * steps + 2), names[1]: L * mb * steps}:
            raise AssertionError(f"lean arm launches {lean_launches}")
        arms["lean"] = arm_line(run, cfg, TWELVE_B_TIMED_FROM, torch.cuda.max_memory_allocated(),
                                wall, lean_launches)
        unbroken = run.history
        del run
        gc.collect()
        torch.cuda.empty_cache()
        os.unlink(os.path.join(root, "run", "checkpoints", f"ckpt_{steps}.pt"))
        resumed = train_dalle.main(["--model", path, "--gpu_ids", "0"]).history
        pairs = [(a["step"], a["loss"], b["loss"], a["grad_norm"], b["grad_norm"])
                 for a, b in zip(unbroken[2:], resumed)]
        bit_equal = len(resumed) == steps - 2 and all(
            la == lb and ga == gb for _, la, lb, ga, gb in pairs)
        arms["lean"]["resumed_from_step_2"] = pairs
        arms["lean"]["resume_bit_equal"] = bit_equal
        print(f"train {TWELVE_B_CONFIG} lean: {arms['lean']}", flush=True)
        if not bit_equal:
            raise AssertionError(f"lean arm: the resumed steps differ from the unbroken run: "
                                 f"{pairs}")
        for arm in arms.values():
            if not all(math.isfinite(x) for x in arm["losses"]):
                raise AssertionError(f"{TWELVE_B_CONFIG}: non-finite loss {arm['losses']}")
        head = head_products_ms(torch, card, cfg.total_seq_len * TWELVE_B_CUT["train_batch_size"]
                                // mb, cfg.n_embd, cfg.total_tokens, 8)
        lean_ms = arms["lean"]["step_s_median"] * 1e3
        out = dict(
            card=card, config=TWELVE_B_CONFIG, cut=TWELVE_B_CUT, microbatches=mb,
            n_layers=L, n_embd=cfg.n_embd, heads=cfg.n_heads, seq_len=cfg.total_seq_len,
            vocab=cfg.total_tokens, flops_per_token=flops_per_token(cfg),
            params=dalle_param_count(dalle), arms=arms, head=head,
            fused_head_products_share_of_lean_step=head["products_ms_per_microbatch"] * mb
            / lean_ms,
        )
        print("train_12b", json.dumps(out), flush=True)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dalle_param_count(dalle) -> dict:
    shapes = dalle.param_shapes()
    layers = sum(math.prod(s) for s in shapes["layers"].values())
    rest = sum(math.prod(s) for k, s in shapes.items() if k != "layers")
    return {"layers": layers, "embeddings_and_head": rest}


def ring_hop(torch, ring, s, diff, window):
    """(rows with a live key [S] bool, live (row, key) pairs) of one hop
    between S-long shards: what the hop's work depends on."""
    _, _, mask = ring._masks(s, s, diff, window, "cpu")
    return ~mask.all(-1), int((~mask).sum())


def planted_fails(t, want, rtol):
    """Whether the tile bound fails a copy of ``t`` with its last 64-long
    tile of S zeroed; None where ``want`` is zero there (nothing to plant)."""
    last = (want.shape[2] - 1) // 64 * 64
    if want[:, :, last:].abs().max().item() == 0:
        return None
    planted = t.clone()
    planted[:, :, last:] = 0
    return tile_rel_err(planted, want) > rtol


def ring_hop_kernels(torch, ring, q, k, v, g, args) -> tuple:
    """One hop's kernels on q, k, v and dO ``g``: the forward, then the
    backward from the lse and dsum of its normalised output, into zeroed
    accumulators. Returns (num, m, l, lse, dsum, dq, dk, dv); raises on an
    uncounted launch."""
    b, h, s, d = q.shape
    before = dict(ring.KERNEL_LAUNCHES)
    num, m, l = ring.ring_partial(q, k, v, *args)
    # a backward input of this hop: lse and dsum of its normalised output
    lse = m + torch.log(l.clamp_min(1e-30))
    out = (num / l.clamp_min(1e-30).reshape(b, h, s, 1)).to(q.dtype)
    dsum = (g.float() * out.float()).sum(-1).reshape(b * h, s)
    dk, dv = (torch.zeros((b, h, s, d), device="cuda") for _ in range(2))
    dq = ring.ring_block_grads(q, g, lse, dsum, k, v, dk, dv, *args)
    torch.cuda.synchronize()
    for key in ring.KERNEL_LAUNCHES:
        if ring.KERNEL_LAUNCHES[key] != before[key] + 1:
            raise AssertionError(f"{key} did not count its launch")
    return num, m, l, lse, dsum, dq, dk, dv


def ring_case_errors(torch, ring, q, k, v, g, args):
    """One hop's kernels against the plain versions, and a second run of each
    against the first. Returns (errs, outputs): errs holds m and l's relative
    errors on live rows and, for each tensor, its max abs error, tile error
    and planted-zero result (or, where the plain tensor is zero up to fp32
    rounding, the kernel's max |value|); outputs the kernels' (num, m, l,
    lse, dsum, dq, dk, dv). Raises on a bound, an uncounted launch, a dead
    row's m other than NEG_INF, or two runs that differ."""
    s = q.shape[2]
    dtype, diff, window = q.dtype, args[0], args[3]
    live, _ = ring_hop(torch, ring, s, diff, window)
    live = live.cuda()
    num, m, l, lse, dsum, dq, dk, dv = ring_hop_kernels(torch, ring, q, k, v, g, args)
    again = ring.ring_partial(q, k, v, *args)
    dk2, dv2 = torch.zeros_like(dk), torch.zeros_like(dv)
    dq2 = ring.ring_block_grads(q, g, lse, dsum, k, v, dk2, dv2, *args)
    torch.cuda.synchronize()
    bit_equal = same_bits((num, m, l, dq, dk, dv), (*again, dq2, dk2, dv2))
    ref_num, ref_m, ref_l = ring.ring_partial_reference(q, k, v, *args)
    ref_dq, ref_dk, ref_dv = ring.ring_block_grads_reference(q, g, lse, dsum, k, v, *args)
    dead_m = m[:, ~live]
    if dead_m.numel() and not (dead_m == ring.NEG_INF).all():
        raise AssertionError("a row without a live key has m other than NEG_INF")
    errs = {n: ((got - w)[:, live].abs() / w[:, live].abs().clamp_min(1.0)).max().item()
            if live.any() else 0.0 for n, got, w in (("m", m, ref_m), ("l", l, ref_l))}
    keep = live.reshape(1, 1, s, 1)
    rtol = tile_rtol(dtype)
    bad = {n: e for n, e in errs.items() if not e <= 1e-5}
    for n, t, w in (("num", num * keep, ref_num * keep), ("dq", dq * keep, ref_dq * keep),
                    ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        if w.float().abs().max().item() <= 1e-5:  # zero up to fp32 rounding
            errs[n] = dict(zero=t.float().abs().max().item())
            if not errs[n]["zero"] <= 1e-5:
                bad[n] = errs[n]
            continue
        errs[n] = dict(abs=(t.float() - w.float()).abs().max().item(),
                       tile=tile_rel_err(t, w), planted=planted_fails(t, w, rtol))
        # planted is None where the plain last tile is all zero (a dropped weight)
        if not (errs[n]["tile"] <= rtol and errs[n]["planted"] is not False):
            bad[n] = errs[n]
    if not any(isinstance(e, dict) and e.get("planted") for e in errs.values()):
        bad["planted"] = "no tensor showed that a zeroed last tile fails"
    if not bit_equal:
        bad["bit_equal"] = "two runs of the kernels gave different bits"
    if bad:
        raise AssertionError(
            f"ring hop {tuple(q.shape)} {dtype} diff {diff} window {window} dropout {args[4]}: "
            f"kernels disagree with the plain versions: {bad} "
            f"(tiles within {rtol} of their own max |plain|, a zeroed last tile must fail; m "
            f"and l 1e-5 relative; two runs bit-equal); all {errs}")
    return errs, (num, m, l, lse, dsum, dq, dk, dv)


def phase_ring_kernels(torch, ring, card):
    """ring_partial and ring_block_grads against their plain versions at the
    ring slice's shard shape (B=4, H=8, S_local=1088, D=128): the diagonal,
    a past and a far past hop, the window band across the shard edge, hash
    dropout at global coordinates, and fp32; then the kernels at the edges
    of their tile walk, in bf16 and fp32. The triple is compared on rows with
    a live key (m = NEG_INF on the others), and every 64-long tile within
    2^-6 (bf16) or 1e-5 (fp32) of its own max |plain|, a bound shown to fail
    a copy with its last tile zeroed; two runs give the same bits. Times
    from CUDA events (``ms``) and, since a bf16 hop's launch is about as
    short as the host's dispatch of it, the card's own under torch.profiler
    (``device_ms``, every case, with the profiler's kernel events held to
    the launches). Then the past hop of a TP x SP rank of the dalle_4k run
    (``tpsp_past``: B=4, heads 4..7 of 8, S_local=2176, D=128, bf16; its
    ``head0`` and ``heads_total``), timed the same way. Returns {case:
    {wrapper: row}}."""
    d = 128
    cases = [  # (name, dtype, hops back, window, dropout, timing iters, (B, H, S_local,
        #        head0, heads_total))
        ("diagonal", torch.bfloat16, 0, None, 0.0, 30, (4, 8, 1088, 0, None)),
        ("past", torch.bfloat16, 1, None, 0.0, 30, (4, 8, 1088, 0, None)),
        ("far_past", torch.bfloat16, 3, None, 0.0, 20, (4, 8, 1088, 0, None)),
        ("window_256", torch.bfloat16, 1, 256, 0.0, 30, (4, 8, 1088, 0, None)),
        ("dropout", torch.bfloat16, 1, None, 0.1, 20, (4, 8, 1088, 0, None)),
        ("fp32", torch.float32, 1, None, 0.0, 3, (4, 8, 1088, 0, None)),
        ("tpsp_past", torch.bfloat16, 1, None, 0.0, 20, (TPSP_HOP[0], TPSP_HOP[2], TPSP_HOP[3],
                                                         TPSP_HOP[2], TPSP_HOP[1])),
    ]
    gen = torch.Generator().manual_seed(4)
    rows = {}
    for name, dtype, hops, window, rate, iters, (b, h, s, head0, total) in cases:
        q, k, v, g = ((torch.rand((b, h, s, d), generator=gen) * 2 - 1).to("cuda", dtype)
                      for _ in range(4))
        row0 = 3 * s if total is None else hops * s  # a TP x SP rank: seq rank 1's hop
        args = (hops * s, row0, row0 - hops * s, window, rate, RING_SEED, head0, total)
        _, pairs = ring_hop(torch, ring, s, hops * s, window)
        errs, (num, m, l, lse, dsum, dq, dk, dv) = ring_case_errors(torch, ring, q, k, v, g, args)
        fwd_ms = cuda_ms(lambda: ring.ring_partial(q, k, v, *args), iters)
        fwd_plain = cuda_ms(lambda: ring.ring_partial_reference(q, k, v, *args), 3)
        bwd_ms = cuda_ms(lambda: ring.ring_block_grads(q, g, lse, dsum, k, v, dk, dv, *args),
                         iters)
        # a bf16 hop's launch is about as short as the host's dispatch of it, so
        # the event times above can follow the host; the card's own time beside
        # them, with the profiler's kernel events held to the launches made
        fwd_dev = kernel_device_ms(torch, lambda _: ring.ring_partial(q, k, v, *args), 1,
                                   iters, ("ring_partial",), 1)
        bwd_dev = kernel_device_ms(
            torch, lambda _: ring.ring_block_grads(q, g, lse, dsum, k, v, dk, dv, *args), 1,
            iters, ("ring_dq", "ring_dkv"), 2)
        bwd_plain = cuda_ms(lambda: ring.ring_block_grads_reference(
            q, g, lse, dsum, k, v, *args), 3)
        lib_fwd = lib_bwd = None
        if window is None and rate == 0.0:  # SDPA: no window, no hash dropout
            lib_fwd, lib_bwd = sdpa_bhsd_ms(torch, [(q, k, v, g)], iters, causal=hops == 0)
        elem, bh = q.element_size(), b * h
        common = dict(card=card, shape=name, B=b, H=h, S_local=s, D=d, dtype=str(dtype),
                      head0=head0, heads_total=total or h,
                      diff=hops * s, row0=row0, window=window, dropout=rate,
                      live_pairs_per_head=pairs, tile_rtol=tile_rtol(dtype),
                      bit_equal_two_runs=True,
                      planted_zero_fails={n: errs[n].get("planted")
                                          for n in ("num", "dq", "dk", "dv")})
        rows[name] = {
            # reads q, k, v; writes num fp32 and m, l; QK^T and PV over the live pairs
            "ring_partial": dict(
                kernel="ring_partial", **common, max_abs_err=errs["num"]["abs"],
                tile_rel_err=errs["num"]["tile"],
                m_l_rel_err={n: errs[n] for n in ("m", "l")}, ms=fwd_ms, device_ms=fwd_dev,
                plain_ms=fwd_plain, library_ms=lib_fwd,
                **attention_bound(2 * 2 * d * bh * pairs,
                                  3 * bh * s * d * elem + bh * s * d * 4 + 2 * bh * s * 4,
                                  elem)),
            # reads q, k, v, dO, lse, dsum; writes dq; reads and writes the fp32
            # dk, dv accumulators; five products over the live pairs
            "ring_block_grads": dict(
                kernel="ring_block_grads", **common,
                max_abs_err=max(errs[n]["abs"] for n in ("dq", "dk", "dv")),
                abs_errs={n: errs[n]["abs"] for n in ("dq", "dk", "dv")},
                tile_rel_errs={n: errs[n]["tile"] for n in ("dq", "dk", "dv")}, ms=bwd_ms,
                device_ms=bwd_dev, plain_ms=bwd_plain, library_ms=lib_bwd,
                ms_includes="dQ and dK/dV launches",
                **attention_bound(5 * 2 * d * bh * pairs,
                                  5 * bh * s * d * elem + 2 * bh * s * 4 + 4 * bh * s * d * 4,
                                  elem)),
        }
        for row in rows[name].values():
            print("kernel", json.dumps(row), flush=True)
        del q, k, v, g, num, m, l, lse, dsum, dk, dv, dq
        torch.cuda.empty_cache()

    # the kernels at the edges of their tile walk, in bf16 and in fp32 (the
    # 3xTF32 backward): ragged shards (one key past a tile, a window band
    # ending mid-tile), D = 64 with windows that are not a multiple of the
    # tile, S = 1, a window of 1 on the diagonal (dq and dk zero up to
    # rounding: ds = p (dp - dsum) with dp = dsum), hash dropout
    edges = [  # (name, B, H, S_local, hops back, window, dropout, D)
        ("s65_diagonal", 2, 3, 65, 0, None, 0.0, 128),
        ("s65_past_dropout", 2, 3, 65, 1, None, 0.1, 128),
        ("ragged_200_window_120", 1, 2, 200, 1, 120, 0.0, 128),
        ("ragged_333_window_300_far", 2, 2, 333, 1, 300, 0.1, 128),
        ("d64_window_100_dropout", 2, 4, 333, 1, 100, 0.1, 64),
        ("d64_diagonal_window_37", 2, 4, 200, 0, 37, 0.0, 64),
        ("s1_past", 2, 2, 1, 1, None, 0.0, 128),
        ("window_1_diagonal", 2, 2, 129, 0, 1, 0.0, 128),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for name, eb, eh, es, hops, window, rate, ed in edges:
            q, k, v, g = ((torch.rand((eb, eh, es, ed), generator=gen) * 2 - 1)
                          .to("cuda", dtype) for _ in range(4))
            args = (hops * es, 3 * es, (3 - hops) * es, window, rate, RING_SEED)
            errs, _ = ring_case_errors(torch, ring, q, k, v, g, args)
            print("kernel", json.dumps(dict(
                card=card, kernel="ring_partial+ring_block_grads", shape=name, B=eb, H=eh,
                S_local=es, D=ed, dtype=str(dtype), diff=hops * es, window=window,
                dropout=rate, tile_rtol=tile_rtol(dtype), errs=errs,
                bit_equal_two_runs=True)), flush=True)
    return rows


RANK_LOGS = "CHIP_SMOKE_RANK_LOGS"  # a directory that keeps every launch's per-rank logs


def run_ranks(args, timeout: float, ranks: int = RING_RANKS) -> None:
    """``ranks`` processes of ``python args...`` on this machine, each with
    the environment ``torch.distributed.run`` gives a rank (RANK and
    LOCAL_RANK, WORLD_SIZE and LOCAL_WORLD_SIZE, MASTER_ADDR and a free
    MASTER_PORT on localhost, OMP_NUM_THREADS 1 unless set): started here
    rather than by the launcher, whose own process imports torch before it
    starts a rank, a cost the size of a rank's own start. Each rank's stdout
    and stderr go to files of their own (<log dir>/<rank>/stdout.log,
    stderr.log); with the environment variable CHIP_SMOKE_RANK_LOGS set to a
    directory the files stay there. Raises if a rank fails or the ranks do
    not finish in ``timeout`` seconds, after printing the end of every
    rank's stderr; every rank still running is stopped."""
    keep = os.environ.get(RANK_LOGS)
    if keep:
        os.makedirs(keep, exist_ok=True)
    log_dir = tempfile.mkdtemp(prefix="ranks_", dir=keep)
    env = {**os.environ, "WORLD_SIZE": str(ranks), "LOCAL_WORLD_SIZE": str(ranks),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    env.setdefault("OMP_NUM_THREADS", "1")
    procs, files = [], []
    try:
        for r in range(ranks):
            os.makedirs(os.path.join(log_dir, str(r)))
            out, err = (open(os.path.join(log_dir, str(r), f"{name}.log"), "w")
                        for name in ("stdout", "stderr"))
            files += [out, err]
            procs.append(subprocess.Popen([sys.executable, *args], cwd=HERE, stdout=out,
                                          stderr=err, env={**env, "RANK": str(r),
                                                           "LOCAL_RANK": str(r)}))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                why = f"the ranks failed: rank {failed[0][0]} exited with {failed[0][1]}"
                break
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                why = f"the ranks did not finish in {timeout}s"
                break
            time.sleep(0.05)
        stop_ranks(procs)
        for f in files:
            f.flush()
        print_rank_logs(log_dir)
        raise AssertionError(f"{' '.join(args[:3])}: {why}")
    finally:
        stop_ranks(procs)
        for f in files:
            f.close()
        if not keep:
            shutil.rmtree(log_dir, ignore_errors=True)


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    import socket  # noqa: PLC0415

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stop_ranks(procs) -> None:
    """Stop every process of ``procs`` still running (SIGTERM, then SIGKILL
    after 30 s) and reap it."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def print_rank_logs(log_dir: str, tail: int = 6000) -> None:
    """The end of each rank's stderr file under ``log_dir``, to stderr."""
    import glob  # noqa: PLC0415

    for path in sorted(glob.glob(os.path.join(log_dir, "**", "stderr.log"), recursive=True)):
        with open(path, errors="replace") as f:
            text = f.read()
        print(f"--- {os.path.relpath(path, log_dir)} ({len(text)} chars), its end:\n"
              f"{text[-tail:]}", file=sys.stderr)


def ring_checks_rank(torch, proc, out_dir):
    """One rank's checks in phase_train_sharded's launch before its runs, in
    the process group that is up: ring attention forward and
    backward on its shard of seeded global q, k, v, g (B=4, H=8, S=4352,
    D=128, bf16) on RING_MESH, without and with hash dropout 0.1; the ring
    pair on this rank's block of the heads at its TPSP_MESH coordinates
    (``tpsp_head_block``); then the 2-layer fp32 values model on VALUES_MESH,
    its loss and grads summed over the world, and on TPSP_MESH, its loss and
    grads (the blocks gathered over the model group) summed over the data
    and sequence axes. Writes <out_dir>/rank<r>.pt; then, in the same
    process group, the tensor-parallel values check's rank
    (``tp_values_rank``)."""
    import torch.distributed as dist  # noqa: PLC0415

    from dalle_mtf_tpu_torch.models.dalle import DALLE  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import layer_norm as lnm  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import ring_attention as ring  # noqa: PLC0415
    from dalle_mtf_tpu_torch.parallel.mesh import build_mesh  # noqa: PLC0415
    from dalle_mtf_tpu_torch.parallel.tensor import gather  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = build_mesh(RING_MESH, RING_LAYOUT, "ring", proc.rank, proc.world)
    res = {"backend": proc.backend, "seq_group_backend": dist.get_backend(mesh.group("seq")),
           "coords": mesh.coords}
    full = ring_attention_inputs(torch)
    sl = full[0].shape[2] // RING_RANKS
    i = mesh.index("seq")
    shard = [t[:, :, i * sl:(i + 1) * sl].contiguous().cuda() for t in full]
    for rate in (0.0, 0.1):
        leaves = [t.clone().requires_grad_(True) for t in shard[:3]]
        reset_counts(ring)
        ring.STAGED_BYTES["ring_shift"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ring.ring_attention_auto(*leaves, mesh, "seq", "data", None, rate,
                                       RING_SEED if rate else None)
        out.backward(shard[3])
        torch.cuda.synchronize()
        res[rate] = dict(out=out.detach().cpu(), seconds=time.perf_counter() - t0,
                         launches=dict(ring.KERNEL_LAUNCHES),
                         staged_bytes=ring.STAGED_BYTES["ring_shift"],
                         **{n: t.grad.cpu() for n, t in zip(("dq", "dk", "dv"), leaves)})
    del full, shard, leaves, out
    torch.cuda.empty_cache()
    tmesh = build_mesh(TPSP_MESH, TPSP_LAYOUT, "ring", proc.rank, proc.world)
    res["head_block"] = tpsp_head_block(torch, ring, tmesh.index("seq"),
                                        tmesh.index("model"))
    torch.cuda.empty_cache()

    vmesh = build_mesh(VALUES_MESH, RING_LAYOUT, "ring", proc.rank, proc.world)
    cfg, params, tokens = values_model(torch, attention_type="ring")
    tree = _to(params, "cuda")
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    reset_counts(attn, lnm, ring)
    dp = vmesh.index("data")
    loss, _ = DALLE(cfg, "cuda", vmesh).loss(tree, tokens[dp:dp + 1].cuda())
    loss.backward()
    grads = {"/".join(p): t.grad for p, t in named_leaves(tree)}
    for t in (loss, *grads.values()):
        dist.all_reduce(t.detach())
    res["values"] = dict(coords=vmesh.coords, loss=loss.item(),
                         launches={**attn.KERNEL_LAUNCHES, **ring.KERNEL_LAUNCHES},
                         grads={n: t.cpu() for n, t in grads.items()}
                         if proc.rank == 0 else None)
    del tree, grads, loss
    torch.cuda.empty_cache()

    # the fourth arm: TP x SP, each rank its heads, MLP columns and
    # vocabulary rows over its half of the sequence
    dalle = DALLE(cfg, "cuda", tmesh)
    sharding = dalle.sharding
    tree = _to(sharding.shard_tree(params), "cuda")
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    reset_counts(attn, lnm, ring)
    loss, _ = dalle.loss(tree, tokens.cuda())
    loss.backward()
    grads = {"/".join(p): gather(t.grad, sharding.of(p), sharding.group)
             for p, t in named_leaves(tree)}
    loss = loss.detach().clone()
    for t in (loss, *grads.values()):
        dist.all_reduce(t, group=tmesh.replica_group)
    res["tpsp_values"] = dict(coords=tmesh.coords, loss=loss.item(), heads=dalle.heads,
                              launches={**attn.KERNEL_LAUNCHES, **ring.KERNEL_LAUNCHES},
                              grads={n: t.cpu() for n, t in grads.items()}
                              if proc.rank == 0 else None)
    torch.save(res, os.path.join(out_dir, f"rank{proc.rank}.pt"))
    del dalle, tree, grads, loss, res
    torch.cuda.empty_cache()
    tp_values_rank(torch, proc, out_dir)
    dist.barrier()


def tpsp_hop_inputs(torch, dtype, hops: int):
    """Seeded global q, k, v, g [B, heads_total, S_local, D] (TPSP_HOP) of
    one head-block case on the CPU: the same draw on every rank and in the
    parent."""
    b, total, _, s, d = TPSP_HOP
    gen = torch.Generator().manual_seed(31 + hops + 2 * (dtype == torch.float32))
    return [(torch.rand((b, total, s, d), generator=gen) * 2 - 1).to(dtype) for _ in range(4)]


def tpsp_hop_args(hops: int, head0: int = 0, heads_total=None) -> tuple:
    """A head-block case's hop arguments: the diagonal hop of seq rank 0
    (hops 0) or seq rank 1's past hop (hops 1), hash dropout 0.1, the block
    heads [head0, ...) of ``heads_total``."""
    s = TPSP_HOP[3]
    return (hops * s, hops * s, 0, None, 0.1, RING_SEED, head0, heads_total)


def tpsp_hop_digests(torch, outs, head0: int = 0, heads=None) -> list:
    """sha256 of a hop's kernel outputs (num, m, l, dq, dk, dv, as
    ``ring_case_errors`` returns them) on heads [head0, head0 + heads) (all
    of them by default)."""
    import hashlib  # noqa: PLC0415

    num, m, l, _, _, dq, dk, dv = outs
    b, h, s, _ = num.shape
    heads = heads or h
    out = []
    for t in (num, m.reshape(b, h, s), l.reshape(b, h, s), dq, dk, dv):
        block = t[:, head0:head0 + heads].contiguous()
        out.append(hashlib.sha256(block.float().cpu().numpy().tobytes()).hexdigest())
    return out


def tpsp_head_block(torch, ring, seq: int, model: int) -> dict:
    """The ring pair (rows 10-11) on the heads of a TP x SP rank at (seq,
    model): heads [4 model, 4 model + 4) of 8 of TPSP_HOP's inputs, the hop
    ``seq`` back, hash dropout 0.1, in bf16 and in fp32 (3xTF32): held
    against the plain versions with the same ``head0``/``heads_total``
    (``ring_case_errors``: per-tile bound, planted tile, two runs
    bit-equal), with the digests of its outputs, which the parent holds to
    those heads of one launch over all 8; the block launched with the
    default head0 must draw another mask (head0 > 0)."""
    _, total, heads, _, _ = TPSP_HOP
    head0 = model * heads
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        block = [t[:, head0:head0 + heads].contiguous().cuda()
                 for t in tpsp_hop_inputs(torch, dtype, seq)]
        args = tpsp_hop_args(seq, head0, total)
        errs, outs = ring_case_errors(torch, ring, *block, args)
        default = ring.ring_partial(*block[:3], *args[:6])[0]
        out[str(dtype)] = dict(hops=seq, head0=head0, heads=heads, heads_total=total, errs=errs,
                               digests=tpsp_hop_digests(torch, outs),
                               other_mask=head0 == 0 or not torch.equal(default, outs[0]))
        del block, outs, default
    return out


def ring_attention_inputs(torch):
    """Seeded global q, k, v, g [4, 8, 4352, 128] bf16 on the CPU."""
    gen = torch.Generator().manual_seed(21)
    return [(torch.rand((4, 8, 4352, 128), generator=gen) * 2 - 1).to(torch.bfloat16)
            for _ in range(4)]


def check_ring_attention(torch, attn, card, out_dir: str, wall: float):
    """What the four ranks of phase_train_sharded's launch wrote before its
    runs (``ring_checks_rank``; ``wall``: the launch's seconds): ring
    attention's forward and backward on their shards, gathered and held per
    64-long tile against the single-device [B, H, S, D] kernel pair on the
    whole sequence (2^-6 of each tile's max |single-device|), without and
    with hash dropout 0.1 (the same seed: the masks are keyed on global
    coordinates); the ring pair on each rank's block of the heads at its
    TPSP_MESH coordinates (``tpsp_head_block``: the diagonal and the past
    hop, heads 0..3 and 4..7 of 8, bf16 and fp32, dropout 0.1), bit for bit
    against those heads of one launch over all 8 here; then the third arm
    of the values check, the 2-layer fp32 model on ``data:2,seq:2`` against
    the port's plain single process on the CPU, and the fourth, the same
    model on TPSP_MESH against one process on the card (loss atol 1e-4,
    every leaf's gradient within relative L2 error 1e-2). Returns the
    values arms' results."""
    from dalle_mtf_tpu_torch.models.dalle import DALLE  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import ring_attention as ring  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415

    ranks, tp_ranks = ([torch.load(os.path.join(out_dir, f"{kind}rank{r}.pt"),
                                   weights_only=False) for r in range(RING_RANKS)]
                       for kind in ("", "tp_"))
    if {(r["backend"], r["seq_group_backend"]) for r in ranks} != {("gloo", "gloo")}:
        raise AssertionError(f"ranks sharing a card must run gloo: {[r['backend'] for r in ranks]}")
    by_seq = sorted(ranks, key=lambda r: r["coords"]["seq"])
    q, k, v, g = (t.cuda() for t in ring_attention_inputs(torch))
    rtol = tile_rtol(torch.bfloat16)
    report = {}
    for rate in (0.0, 0.1):
        out, lse = attn._forward(q, k, v, None, rate, RING_SEED, with_lse=True)
        want = dict(zip(("out", "dq", "dk", "dv"),
                        (out, *attn._backward(q, k, v, out, lse, g, None, rate, RING_SEED))))
        errs = {}
        for n, w in want.items():
            got = torch.cat([r[rate][n] for r in by_seq], 2).cuda()
            errs[n] = tile_rel_err(got, w)
        launches = [r[rate]["launches"] for r in by_seq]
        if launches != [{"ring_partial": i + 1, "ring_block_grads": i + 1}
                        for i in range(RING_RANKS)]:
            raise AssertionError(f"ring attention launches per rank {launches}")
        if not all(e <= rtol for e in errs.values()):
            raise AssertionError(f"ring attention (dropout {rate}) disagrees with the single-"
                                 f"device pair: tile errors {errs} (bound {rtol})")
        report[rate] = dict(tile_rel_errs=errs, seconds=[r[rate]["seconds"] for r in by_seq],
                            staged_bytes=[r[rate]["staged_bytes"] for r in by_seq])
        print(f"ring attention, 4 ranks x S_local 1088 (B=4 H=8 S=4352 D=128 bf16), dropout "
              f"{rate}: out, dq, dk, dv per 64-long tile against the single-device pair "
              f"{errs} (bound {rtol}); launches per rank {launches}; fwd+bwd seconds per rank "
              f"{report[rate]['seconds']} ({RING_LABEL}); {card}", flush=True)
    del q, k, v, g, out, lse, want
    torch.cuda.empty_cache()

    # the head blocks: each rank's block against one launch over all heads
    blocks = []
    for dtype in (torch.bfloat16, torch.float32):
        for hops in range(TPSP_SEQ):
            whole = [t.cuda() for t in tpsp_hop_inputs(torch, dtype, hops)]
            outs = ring_hop_kernels(torch, ring, *whole, tpsp_hop_args(hops))
            for r in ranks:
                mine = r["head_block"][str(dtype)]
                if mine["hops"] != hops:
                    continue
                equal = mine["digests"] == tpsp_hop_digests(torch, outs, mine["head0"],
                                                            mine["heads"])
                blocks.append(dict(dtype=str(dtype), hops=hops, head0=mine["head0"],
                                   heads=mine["heads"], heads_total=mine["heads_total"],
                                   bit_equal_to_whole_launch_heads=equal,
                                   default_head0_draws_another_mask=mine["other_mask"],
                                   errs=mine["errs"]))
                if not (equal and mine["other_mask"]):
                    raise AssertionError(f"ring pair on heads {mine['head0']}.. of "
                                         f"{mine['heads_total']} ({dtype}, hop {hops} back): "
                                         f"bit-equal to the whole launch's heads {equal}; the "
                                         f"default head0 draws another mask "
                                         f"{mine['other_mask']}")
            del whole, outs
            torch.cuda.empty_cache()
    b, total, heads, s_local, d = TPSP_HOP
    print("kernel", json.dumps(dict(
        card=card, kernel="ring_partial+ring_block_grads", shape="tpsp_head_blocks", B=b,
        H=heads, heads_total=total, S_local=s_local, D=d, dropout=0.1, cases=blocks,
        label=f"each block on one of {RING_RANKS} ranks at its {TPSP_MESH} coordinates, the "
              f"whole launch in the parent")), flush=True)

    cfg, params, tokens = values_model(torch, attention_type="ring")
    tree = _to(params, "cpu")
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    loss, _ = DALLE(cfg, "cpu").loss(tree, tokens)
    loss.backward()
    cpu = (loss.item(), {"/".join(p): t.grad for p, t in named_leaves(tree)})
    vals = [r["values"] for r in sorted(ranks, key=lambda r: tuple(r["values"]["coords"].values()))]
    card_result = (vals[0]["loss"], ranks[0]["values"]["grads"])
    result = compare_values(f"{VALUES_MESH} ring, 4 ranks", cfg, card, card_result, cpu)
    launches = [v["launches"] for v in vals]
    for v in vals:
        i = v["coords"]["seq"]
        want = {"ring_partial": cfg.n_layers * (i + 1), "ring_block_grads": cfg.n_layers * (i + 1)}
        if {n: v["launches"][n] for n in want} != want or any(
                c for n, c in v["launches"].items() if n not in want):
            raise AssertionError(f"values arm launches {launches}")
    # the fourth arm: TP x SP against one process on the card
    tree = _to(params, "cuda")
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    loss, _ = DALLE(cfg, "cuda").loss(tree, tokens.cuda())
    loss.backward()
    one = (loss.item(), {"/".join(p): t.grad.cpu() for p, t in named_leaves(tree)})
    del tree, loss
    tvals = [r["tpsp_values"] for r in sorted(
        ranks, key=lambda r: tuple(r["tpsp_values"]["coords"].values()))]
    tpsp = compare_values(f"{TPSP_MESH} ring x TP, {RING_RANKS} ranks", cfg, card,
                          (tvals[0]["loss"], tvals[0]["grads"]), one, "one_process")
    tpsp_launches = [v["launches"] for v in tvals]
    for v in tvals:
        i = v["coords"]["seq"]
        want = {"ring_partial": cfg.n_layers * (i + 1), "ring_block_grads": cfg.n_layers * (i + 1)}
        if {n: v["launches"][n] for n in want} != want or any(
                c for n, c in v["launches"].items() if n not in want):
            raise AssertionError(f"TP x SP values arm launches {tpsp_launches}")
    if any(abs(v["loss"] - tvals[0]["loss"]) > 0 for v in tvals):
        raise AssertionError(f"TP x SP values arm: the ranks' losses differ "
                             f"{[v['loss'] for v in tvals]}")
    print(f"ring checks: 4 ranks, their launch (with the ring runs after them) {wall:.1f}s; "
          f"TP x SP values arm heads per rank "
          f"{[v['heads'] for v in tvals]}, launches per rank {tpsp_launches} "
          f"({TPSP_LABEL})", flush=True)
    tp_values = check_tp_values(torch, attn, card, tp_ranks, wall)
    return dict(**result, launches=launches, attention=report, head_blocks=blocks,
                tpsp=dict(**tpsp, launches=tpsp_launches), tp_values=tp_values)


# set in the environment of the ranks whose digests include the AdamW moments
DIGEST_MOMENTS = "CHIP_SMOKE_DIGEST_MOMENTS"


class PeakRSS:
    """The peak resident set size of this process over a ``with`` block,
    read every 5 ms from /proc/self/statm (``before``, ``peak``: bytes)."""

    def __init__(self):
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.before = self.peak = 0
        self._stop = threading.Event()

    def rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _watch(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self.rss())

    def __enter__(self):
        self.before = self.peak = self.rss()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss())


def state_digest(torch, state, moments: bool = False) -> str:
    """sha256 of a rank's parameters (its blocks) and, with ``moments``, its
    AdamW or Adafactor moments."""
    import hashlib  # noqa: PLC0415

    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415

    digest = hashlib.sha256()
    tensors = [t for _, t in named_leaves(state["params"])]
    if moments:
        opt = state["opt"].state_dict()
        opt = opt.get("inner", opt)
        for st in opt.get("adamw", {}).get("state", {}).values():
            tensors += [st["exp_avg"], st["exp_avg_sq"]]
        tensors += list(opt.get("adafactor", {}).values())
    for t in tensors:
        digest.update(t.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def worker_train(torch, out_dir, argv, cli: str = "train_dalle"):
    """One rank of phase_train_sharded (``train_dalle.main``;
    ``--ring-checks`` first runs ``ring_checks_rank``, ``--pp-values``
    ``pp_values_rank``), phase_train_12b_tp and phase_train_vae_dp
    (``cli`` "train_vae",
    cuDNN deterministic; ``--values <mesh_shape> <layout>`` first runs
    ``vae_values_rank``): the CLI on each of its argvs (separated by
    ``--then``: a resume runs in the same process group), the kernel counts
    and the peak memory reset just before each; writes what the rank saw in run i to
    <out_dir>/rank<r>_<i>.json (history, launches, staged bytes, the bytes
    its collectives moved in each training step, in all and by kind (the
    forward and backward's before the gradient sum, the gradient sum's, the
    rest after it), those its pipeline hops sent, by kind, peak memory, a
    checksum of
    its parameters and moments at the end and just after a restore, the
    seconds and host memory of the model's init and of each checkpoint
    save, the training stream's waits; of a ``train_vae`` run that splits
    the VAE, a checksum of the whole parameters gathered from the model
    group's blocks)."""
    import importlib  # noqa: PLC0415

    import torch.distributed as dist  # noqa: PLC0415

    from dalle_mtf_tpu_torch.models.dalle import DALLE  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import layer_norm as lnm  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import ring_attention as ring  # noqa: PLC0415
    from dalle_mtf_tpu_torch.parallel import pipeline  # noqa: PLC0415
    from dalle_mtf_tpu_torch.parallel.tensor import COLLECTIVES  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.trainer import Trainer  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.distributed import init_distributed  # noqa: PLC0415

    module = importlib.import_module(f"dalle_mtf_tpu_torch.{cli}")
    rank = int(os.environ["RANK"])
    with_moments = bool(os.environ.get(DIGEST_MOMENTS))
    step_bytes, step_kinds, step_hops, events, streams = [], [], [], {}, []
    train_step, save, restore, init = Trainer.train_step, Trainer.save, Trainer.restore, DALLE.init
    sum_shares = Trainer._sum_shares
    marks = {}

    def counted(self, *args, **kw):  # the collectives' and the hops' bytes of one step
        before, hops = COLLECTIVES["bytes"], dict(pipeline.SENT_BYTES)
        marks.clear()
        out = train_step(self, *args, **kw)
        step_bytes.append(COLLECTIVES["bytes"] - before)
        step_hops.append({k: v - hops[k] for k, v in pipeline.SENT_BYTES.items()})
        if marks:
            step_kinds.append({"model": marks["sum"] - before,
                               "gradient_sum": marks["summed"] - marks["sum"],
                               "after": COLLECTIVES["bytes"] - marks["summed"]})
        return out

    def marked_sum(self, opt):  # where the gradient sum starts and ends in a step
        marks["sum"] = COLLECTIVES["bytes"]
        sum_shares(self, opt)
        marks["summed"] = COLLECTIVES["bytes"]

    def timed_init(self, generator):
        torch.cuda.synchronize()
        dev0 = torch.cuda.memory_allocated(0)
        torch.cuda.reset_peak_memory_stats(0)
        t0 = time.perf_counter()
        with PeakRSS() as rss:
            tree = init(self, generator)
            torch.cuda.synchronize()
        leaves = [t for _, t in named_leaves(tree)]
        events["init"] = dict(s=time.perf_counter() - t0, drawn_elements=self.drawn_elements,
                              block_bytes=sum(t.numel() * t.element_size() for t in leaves),
                              leaves=len(leaves),
                              device_bytes=torch.cuda.memory_allocated(0) - dev0,
                              device_peak_bytes=torch.cuda.max_memory_allocated(0) - dev0,
                              host_rss_before=rss.before, host_rss_peak=rss.peak)
        return tree

    def timed_save(self, state, step=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with PeakRSS() as rss:
            save(self, state, step)
        events.setdefault("saves", []).append(dict(
            step=state["step"] if step is None else step, s=time.perf_counter() - t0,
            host_rss_before=rss.before, host_rss_peak=rss.peak))

    def digest_restore(self, state):
        out = restore(self, state)
        if self.checkpoint_steps():
            events["restored"] = dict(step=out["step"], restored_bytes=self.restored_bytes,
                                      digest=state_digest(torch, out, with_moments))
        return out

    Trainer.train_step, Trainer.save, Trainer.restore = counted, timed_save, digest_restore
    Trainer._sum_shares = marked_sum
    DALLE.init = timed_init
    if cli == "train_vae":
        make_pipeline = module.vae_input_fn

        def timed_train_stream(params, eval=False, **kw):
            pipeline = make_pipeline(params, eval=eval, **kw)
            if eval or "skip_steps" not in kw:  # the eval and the summary pipelines
                return pipeline
            streams.append(TimedBatches(pipeline))
            return streams[-1]

        module.vae_input_fn = timed_train_stream
    values = sampling = pp_values = ring_checks = None
    if argv[:1] == ["--ring-checks"]:  # the ring checks first, in the same group
        ring_checks, argv = True, argv[1:]
    if argv[:1] == ["--values"]:  # the VAE values check first, in the same group
        values, argv = argv[1:3], argv[3:]
    if argv[:1] == ["--pp-values"]:  # the pipeline's values check first, in the same group
        pp_values, argv = True, argv[1:]
    if argv[:1] == ["--sample"]:  # sampling from the last run's checkpoint, after the runs
        sampling, argv = [int(a) for a in argv[1:3]], argv[3:]
    runs = [list(g) for sep, g in itertools.groupby(argv, lambda a: a == "--then") if not sep]
    # one process group for every run (``main`` reuses a group that is up): a
    # group destroyed and made again in one process meets the first group's
    # keys in the launcher's store
    proc = init_distributed(["0"], "cuda")
    try:
        if cli == "train_vae":  # as phase_train_vae: no run-dependent sum order
            torch.backends.cudnn.deterministic = True
        if ring_checks:
            ring_checks_rank(torch, proc, out_dir)
            gc.collect()
            torch.cuda.empty_cache()
        if values:
            vae_values_rank(torch, proc, out_dir, *values)
        if pp_values:
            pp_values_rank(torch, proc, out_dir)
        for i, run_argv in enumerate(runs):
            reset_counts(attn, lnm, ring)
            ring.STAGED_BYTES["ring_shift"] = 0
            pipeline.STAGED_BYTES["pipeline"] = 0
            step_bytes.clear()
            step_kinds.clear()
            step_hops.clear()
            events.clear()
            streams.clear()
            torch.cuda.reset_peak_memory_stats(0)
            t0 = time.perf_counter()
            run = module.main(run_argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            gathered = None
            if cli == "train_vae" and run.sharding is not None:  # every rank's blocks, whole
                gathered = state_digest(torch, {"params": run.sharding.gather_tree(
                    run.state["params"])})
            with open(os.path.join(out_dir, f"rank{rank}_{i}.json"), "w") as f:
                json.dump(dict(rank=rank, history=run.history, eval_history=run.eval_history,
                               checkpoints=run.checkpoint_steps(), wall_s=wall,
                               launches={**attn.KERNEL_LAUNCHES, **lnm.KERNEL_LAUNCHES,
                                         **ring.KERNEL_LAUNCHES},
                               staged_bytes=ring.STAGED_BYTES["ring_shift"],
                               collective_bytes_per_step=list(step_bytes),
                               collective_bytes_by_kind_per_step=list(step_kinds),
                               pipe_bytes_per_step=list(step_hops),
                               pipe_staged_bytes=pipeline.STAGED_BYTES["pipeline"],
                               peak_mem_gb=torch.cuda.max_memory_allocated(0) / 1e9,
                               params_sha256=state_digest(torch, run.state),
                               gathered_params_sha256=gathered,
                               state_sha256=state_digest(torch, run.state, True)
                               if with_moments else None,
                               data_waits=streams[-1].waits if streams else None,
                               **events), f)
            del run
            gc.collect()
            torch.cuda.empty_cache()
        if sampling:
            sample_rank(torch, proc, out_dir, runs[-1][runs[-1].index("--model") + 1],
                        *sampling)
    finally:
        dist.destroy_process_group()


TWELVE_B_SAMPLE_SEED = 23


def sample_texts(torch, cfg, batch: int):
    """``batch`` seeded captions (TWELVE_B_SAMPLE_SEED) on the card."""
    gen = torch.Generator().manual_seed(TWELVE_B_SAMPLE_SEED)
    return torch.randint(0, cfg.text_vocab_size, (batch, cfg.text_seq_len), generator=gen).cuda()


def sample_rank(torch, proc, out_dir, path, steps: int, batch: int) -> None:
    """One rank's sampling from the latest checkpoint of the config at
    ``path`` on its mesh: ``sample_dalle.load_dalle_params`` (the rank's
    blocks, timed, their bytes), the bf16 cast, then the prefill of
    ``batch`` seeded captions and ``steps`` decode steps (temperature 1,
    top_k 64, one generator seeded alike on every rank), the kernel and
    collective counts of the loop. Writes <out_dir>/sample_rank<r>.json and
    the tokens (and on rank 0 the prefill's band logits) to
    sample_rank<r>.pt."""
    from dalle_mtf_tpu_torch import sample  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.parallel.mesh import build_mesh  # noqa: PLC0415
    from dalle_mtf_tpu_torch.parallel.tensor import COLLECTIVES  # noqa: PLC0415
    from dalle_mtf_tpu_torch.quantize import cast_decode_weights  # noqa: PLC0415
    from dalle_mtf_tpu_torch.sample_dalle import load_dalle_params  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    params = fetch_model_params(path)
    mesh = build_mesh(params["mesh_shape"], params["layout"], "global", proc.rank, proc.world)
    dalle, _ = make_dalle_models(params, proc.device, mesh)
    cfg = dalle.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(0)
    t0 = time.perf_counter()
    masters = load_dalle_params(params, dalle)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    read_bytes = sum(t.numel() * t.element_size() for _, t in named_leaves(masters))
    weights = cast_decode_weights(masters, cfg.policy.compute_dtype)
    del masters
    text = sample_texts(torch, cfg, batch)
    lo = cfg.text_vocab_size
    reset_counts(attn)
    c0, b0 = COLLECTIVES["calls"], COLLECTIVES["bytes"]
    with torch.inference_mode():
        head = dalle.logits_head(weights, (lo, lo + cfg.image_vocab_size))
        cache = dalle.init_cache(batch)
        kv_bytes = sum(t.numel() * t.element_size() for t in cache.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = dalle.prefill(weights, text, cache, head=head)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_logits = logits.cpu()
        gen = torch.Generator("cuda").manual_seed(TWELVE_B_SAMPLE_SEED)
        tokens = []
        c1, b1 = COLLECTIVES["calls"], COLLECTIVES["bytes"]
        t0 = time.perf_counter()
        for i in range(steps):
            tok = sample._sample_token(gen, logits, 1.0, 64)
            tokens.append(tok)
            logits = dalle.decode_step(weights, cache, tok + lo, cfg.text_seq_len + i, head=head)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    report = dict(rank=proc.rank, heads=list(dalle.heads), read_s=read_s, read_bytes=read_bytes,
                  kv_cache_bytes=kv_bytes, prefill_s=prefill_s, decode_steps=steps,
                  decode_ms_per_step=decode_s / steps * 1e3,
                  prefill_collective_bytes=b1 - b0, prefill_collective_calls=c1 - c0,
                  collective_bytes_per_step=(COLLECTIVES["bytes"] - b1) / steps,
                  collective_calls_per_step=(COLLECTIVES["calls"] - c1) / steps,
                  launches=dict(attn.KERNEL_LAUNCHES), band_columns=int(head.w.shape[1]),
                  peak_gb=torch.cuda.max_memory_allocated(0) / 1e9)
    with open(os.path.join(out_dir, f"sample_rank{proc.rank}.json"), "w") as f:
        json.dump(report, f)
    torch.save(dict(tokens=torch.stack(tokens, 1).cpu(),
                    prefill_logits=prefill_logits if proc.rank == 0 else None),
               os.path.join(out_dir, f"sample_rank{proc.rank}.pt"))


def train_ranks(torch, runs, evals, cfg, models=None, checks=None, pp_argv=None):
    """The ring runs' ranks through ``train_dalle.main``, one launch for all
    of ``runs`` ((config path, steps, new); a resume in the same process
    group); checks what every rank logged and launched in each and that
    the copies of their parameters are bit-equal (``check_ring_ranks``;
    ``models``: each run's model-axis size, 1 for every run by default).
    With ``checks``, the ranks first run ``ring_checks_rank`` in the same
    launch, and ``checks(out_dir, wall)`` reads what they wrote; with
    ``pp_argv`` (``prepare_pp``'s), they also run ``pp_values_rank`` first
    and the pipeline's runs after ``runs``. Returns each run's reports of
    ``runs`` in rank order, and what ``checks`` returned."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_ring_train_")
    try:
        flags = (["--ring-checks"] if checks else []) + (["--pp-values"] if pp_argv else [])
        argv = []
        for path, _, new in runs:
            argv += (["--then"] if argv else []) + [
                "--model", path, "--gpu_ids", "0"] + (["--new", "--yes"] if new else [])
        argv = flags + argv + (["--then", *pp_argv] if pp_argv else [])
        t0 = time.perf_counter()
        run_ranks([os.path.join(HERE, "chip_smoke.py"), "--ring-worker", "train", out_dir,
                   *argv], 900)
        wall = time.perf_counter() - t0
        reports = [[rank_report(out_dir, r, i) for r in range(RING_RANKS)]
                   for i in range(len(runs))]
        checked = checks(out_dir, wall) if checks else None
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for (_, steps, _), ranks, model in zip(runs, reports, models or [1] * len(runs)):
        check_ring_ranks(ranks, steps, evals, cfg, model)
    return reports, checked


def check_ring_ranks(ranks, steps, evals, cfg, model: int = 1) -> None:
    """One ring run's checks on its ranks' reports; ``model``: the size of
    its model axis, the last of the mesh (rank r at seq index r // model,
    model index r % model: the ranks of one model index hold the same
    blocks)."""
    first = ranks[0]["history"][0]["step"]
    for r in ranks:
        if [h["step"] for h in r["history"]] != list(range(first, first + steps)):
            raise AssertionError(f"rank {r['rank']} logged steps {[h['step'] for h in r['history']]}")
        if [h["loss"] for h in r["history"]] != [h["loss"] for h in ranks[0]["history"]]:
            raise AssertionError("the ranks logged different losses")
        if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                   for h in r["history"]):
            raise AssertionError(f"non-finite loss or grad_norm: {r['history']}")
        if len(r["eval_history"]) != evals or not all(
                math.isfinite(e["eval_loss"]) for e in r["eval_history"]):
            raise AssertionError(f"eval: {r['eval_history']}")
        if r["checkpoints"] != [first + steps - 1]:
            raise AssertionError(f"checkpoints {r['checkpoints']}")
        # rank r holds shard r // model: that + 1 live hops a layer in every pass
        n, passes = cfg.n_layers * (r["rank"] // model + 1), steps + evals
        n_ln = 2 * cfg.n_layers + 1
        want = {"ring_partial": n * passes, "ring_block_grads": n * steps,
                "layer_norm_fwd": n_ln * passes, "layer_norm_bwd": n_ln * steps}
        if {k: r["launches"].get(k, 0) for k in want} != want or any(
                c for k, c in r["launches"].items() if k not in want):
            raise AssertionError(f"rank {r['rank']} launched {r['launches']}, expected {want}")
    for j in range(model):
        if len({r["params_sha256"] for r in ranks[j::model]}) != 1:
            raise AssertionError(f"the ranks' parameters differ: "
                                 f"{[r['params_sha256'] for r in ranks]}")


RING_LAYERS = 2  # of dalle_4k's 12: the ring run's depth


def tpsp_splits(dalle) -> dict:
    """Each leaf's split over TPSP_MESH's model axis by TPSP_LAYOUT, as a
    rank there splits it (``parallel.mesh.leaf_split``): {path: Split or
    None}, over ``dalle``'s whole shapes (``Split.bounds``: every model
    index's block)."""
    from dalle_mtf_tpu_torch.parallel.mesh import leaf_split, parse_layout  # noqa: PLC0415

    class ModelAxis:  # what leaf_split reads of a mesh
        tp_axis, rules = "model", parse_layout(TPSP_LAYOUT)

        @staticmethod
        def size(name):
            return TPSP_MODEL if name == "model" else 1

        @staticmethod
        def index(name):
            return 0

    axes = dict(_shape_leaves(dalle.logical_axes()))
    return {path: leaf_split(axes[path], shape, ModelAxis)
            for path, shape in _shape_leaves(dalle.param_shapes(whole=True))}


def tpsp_expected_bytes(dalle, cfg, rows: int, steps: int, evals: int) -> list[dict]:
    """What a TP x SP rank of each model index moves, from the code, with
    ``rows`` batch rows a rank: the ring's bytes staged through the host in
    the run (ops/ring_attention.py::ring_shift counts each tensor sent and
    received: a layer's forward shifts k, v [B, H/m, S/n, D] n - 1 times,
    its backward k, v and the fp32 dk, dv accumulators n - 1 times and dk,
    dv once more; the eval a forward), and the all_reduce bytes of one
    training step by kind (train/trainer.py, parallel/tensor.py): the
    model's collectives before the gradient sum (the vocab-parallel
    embedding's sum and each layer's attention and MLP output sums
    forward, each layer's two input-gradient sums and the loss head's
    backward, [B, S/n, E] in the compute dtype each; the xent's fp32 row
    max and its sum-exp and target logit), the gradient sum over the data
    and sequence axes (every local leaf's fp32 gradient) and what follows
    it (the replicated leaves' gradients broadcast over the model group,
    the global norm's fp32 sum of squares and the metrics' shares)."""
    s_l, e, L = cfg.total_seq_len // TPSP_SEQ, cfg.n_embd, cfg.n_layers
    elem = 2 if cfg.bf_16 else 4
    heads = cfg.n_heads // TPSP_MODEL
    kv = rows * heads * s_l * cfg.head_dim * elem
    acc = rows * heads * s_l * cfg.head_dim * 4
    fwd = (TPSP_SEQ - 1) * 2 * 2 * kv
    bwd = (TPSP_SEQ - 1) * 2 * (2 * kv + 2 * acc) + 2 * 2 * acc
    act = rows * s_l * e * elem
    model_bytes = (2 + 4 * L) * act + 3 * rows * s_l * 4
    splits = tpsp_splits(dalle)
    replicated = sum(math.prod(shape) for path, shape in
                     _shape_leaves(dalle.param_shapes(whole=True)) if splits[path] is None)
    out = []
    for j in range(TPSP_MODEL):
        local = replicated
        for path, shape in _shape_leaves(dalle.param_shapes(whole=True)):
            split = splits[path]
            if split is not None:
                a, b = split.bounds[j]
                local += math.prod(shape) // shape[split.dim] * (b - a)
        out.append(dict(staged=L * (steps * (fwd + bwd) + evals * fwd),
                        staged_per_layer_forward=fwd, staged_per_layer_backward=bwd,
                        hop_kv_bytes=2 * kv,
                        step={"model": model_bytes, "gradient_sum": 4 * local,
                              "after": 4 * replicated + 4 + 4 * len(TPSP_METRICS)},
                        activation_bytes=act, local_params=local,
                        replicated_params=replicated))
    return out


def tpsp_block_digest(torch, obj, splits, model: int) -> str:
    """sha256 of what a TP x SP rank of model index ``model`` holds of the
    parameters of a checkpoint read by one process (``state_digest``'s
    order and bytes): its block of each split leaf, the others whole."""
    import hashlib  # noqa: PLC0415

    digest = hashlib.sha256()
    for path, split in splits.items():
        t = obj["params"]["/".join(path)]
        if split is not None:
            a, b = split.bounds[model]
            t = t.narrow(split.dim, a, b - a)
        digest.update(t.float().contiguous().numpy().tobytes())
    return digest.hexdigest()


def phase_train_sharded(torch, card):
    """The four-rank sharded runs in one launch of four ranks sharing the
    card: the sequence-parallel main path, then the pipeline's and tensor
    parallelism's runs (``prepare_pp``, ``finish_pp``; one launch saves
    each the start and first-call set-up of its own). The sequence-parallel
    main path: a tokens-mode copy of
    configs/dalle_4k.json at full width (as phase_train_long, the same
    dataset and seed) with ``attention_type: "ring"``, ``mesh_shape:
    data:1,seq:4`` and ``layout: batch_dim:data,total_seq_dim:seq``, through
    ``run_ranks`` of four ranks sharing the card and
    ``train_dalle.main`` for RING_STEPS steps with an eval and a checkpoint,
    cut to RING_LAYERS layers (the resumed run after it was cut for the card
    time of the sharded serving phase: the restore is the layout's blocks
    read out of one file, held bit for bit over ranks by
    phase_train_12b_tp); its first loss against the single-process port's
    on the same records and seed. Then, in the same launch, the same run on
    TPSP_MESH with TPSP_LAYOUT (tensor parallelism under the ring: each rank
    4 of the 8 heads, 2048 MLP columns and its block of the vocabulary over
    2176 positions): its first loss within 2e-3 of the single process's,
    the ring and LN kernels' launches of each rank (seq rank i: i + 1 live
    hops a layer a pass), the bytes each rank staged and all_reduced a step
    by kind equal to ``tpsp_expected_bytes`` to the byte, and its
    checkpoint, read by one process, bit-equal to every rank's blocks.
    Before both runs, in the same launch, the ring checks
    (``ring_checks_rank``, read by ``check_ring_attention``). Returns the
    ring kernels' launches over the four ranks of the first run, and per
    rank, each TP x SP rank's ring and LN launches, the ring checks'
    values arms, and ``finish_pp``'s launches of the packed pair a rank of
    the PP, PP x TP and TP runs."""
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ring_run_")
    try:
        extra = dict(attn_packed=False, ln_impl="pallas", attention_type="ring",
                     mesh_shape=RING_MESH, layout=RING_LAYOUT, n_layers=RING_LAYERS)
        dalle, _ = make_dalle_models({**fetch_model_params(LONG_CONFIG), **extra}, "cpu")
        cfg = dalle.cfg
        write_tokens_dataset(os.path.join(tmp, "data"), 1, cfg.image_seq_len,
                             cfg.image_vocab_size, files=2, per_file=24)
        path = shutil.copy(train_config(tmp, RING_STEPS, LONG_CONFIG, RING_STEPS, **extra),
                           os.path.join(tmp, "ring.json"))
        tpsp_path = shutil.copy(train_config(
            tmp, RING_STEPS, LONG_CONFIG, RING_STEPS, **dict(
                extra, mesh_shape=TPSP_MESH, layout=TPSP_LAYOUT,
                model_path=os.path.join(tmp, "run_tpsp"))), os.path.join(tmp, "tpsp.json"))
        long_first_loss = single_first_loss(torch, path)
        pp = prepare_pp(torch, os.path.join(tmp, "pp"))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        (ranks, tpsp), (ring_values, pp_launches) = train_ranks(
            torch, [(path, RING_STEPS, True), (tpsp_path, RING_STEPS, True)], 1, cfg,
            (1, TPSP_MODEL), lambda out_dir, wall: (
                check_ring_attention(torch, attn, card, out_dir, wall),
                finish_pp(torch, card, pp, out_dir, wall, 2)), pp.argv)
        wall = time.perf_counter() - t0
        hist = ranks[0]["history"]
        losses = [h["loss"] for h in hist]
        init_loss = math.log(cfg.total_tokens) + cfg.n_embd * 0.02**2 / 2
        if abs(losses[0] - init_loss) > 0.1 or abs(losses[0] - long_first_loss) > 2e-3:
            raise AssertionError(f"first loss {losses[0]} vs ln(vocab) + var/2 = {init_loss} "
                                 f"and the single-process run's {long_first_loss} (atol 2e-3)")
        step_s = [1.0 / h["steps_per_sec"] for h in hist[LONG_TIMED_FROM - 1:]]
        med = statistics.median(step_s)
        tokens_per_step = cfg.total_seq_len * fetch_model_params(path)["train_batch_size"]
        staged = [r["staged_bytes"] for r in ranks]
        print(f"train ring {LONG_CONFIG}: {RING_STEPS} steps + eval + checkpoint "
              f"in {wall:.1f}s (4 ranks, one launch with the ring checks, the TP x SP run "
              f"and the pipeline's runs); losses "
              f"{[round(x, 4) for x in losses]} (the single-"
              f"process run's first {long_first_loss:.4f}); parameters bit-equal "
              f"over the ranks; launches per rank {[r['launches'] for r in ranks]}", flush=True)
        print("train", json.dumps(dict(
            card=card, config=LONG_CONFIG, label=RING_LABEL, ranks=RING_RANKS,
            mesh_shape=RING_MESH, layout=RING_LAYOUT, batch=tokens_per_step // cfg.total_seq_len,
            seq_len=cfg.total_seq_len, seq_len_per_rank=cfg.total_seq_len // RING_RANKS,
            n_layers=cfg.n_layers, n_embd=cfg.n_embd, vocab=cfg.total_tokens, bf16=cfg.bf_16,
            steps_timed=len(step_s), step_s=step_s, step_s_median=med,
            tokens_per_s=tokens_per_step / med, first_loss=losses[0],
            single_process_first_loss=long_first_loss, expected_init_loss=init_loss,
            staged_bytes_per_rank=staged,
            staged_bytes_per_rank_per_pass=[b / (RING_STEPS + 1) for b in staged],
            peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
            wall_s_per_rank=[r["wall_s"] for r in ranks],
            eval=ranks[0]["eval_history"],
        )), flush=True)
        tpsp_launches = check_train_tpsp(torch, card, tmp, dalle, cfg, tpsp, long_first_loss,
                                         tokens_per_step)
        per_rank = [{k: r["launches"][k] for k in ("ring_partial", "ring_block_grads")}
                    for r in ranks]
        return ({k: sum(p[k] for p in per_rank) for k in per_rank[0]}, per_rank, tpsp_launches,
                ring_values, pp_launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_train_tpsp(torch, card, tmp, dalle, cfg, ranks, single, tokens_per_step) -> list:
    """phase_train_sharded's TP x SP run (``ranks``, already held by
    ``check_ring_ranks``): its first loss within 2e-3 of the single-process
    port's ``single``, the bytes each rank staged in the run and
    all_reduced in each step by kind equal to ``tpsp_expected_bytes``, and
    the checkpoint read by one process bit-equal to each rank's blocks;
    prints its "train" line. Returns each rank's ring and LN launches."""
    from dalle_mtf_tpu_torch.utils import checkpoint  # noqa: PLC0415

    rows = tokens_per_step // cfg.total_seq_len
    want = tpsp_expected_bytes(dalle, cfg, rows, RING_STEPS, 1)
    losses = [h["loss"] for h in ranks[0]["history"]]
    if abs(losses[0] - single) > 2e-3:
        raise AssertionError(f"TP x SP first loss {losses[0]} vs the single-process port's "
                             f"{single} (atol 2e-3)")
    for r in ranks:
        mine = want[r["rank"] % TPSP_MODEL]
        if r["staged_bytes"] != mine["staged"]:
            raise AssertionError(f"TP x SP rank {r['rank']} staged {r['staged_bytes']} bytes, "
                                 f"expected {mine['staged']}")
        kinds = r["collective_bytes_by_kind_per_step"]
        if len(kinds) != RING_STEPS or any(k != mine["step"] for k in kinds):
            raise AssertionError(f"TP x SP rank {r['rank']} all_reduced {kinds} a step, "
                                 f"expected {mine['step']}")
    obj = checkpoint.read(os.path.join(tmp, "run_tpsp", "checkpoints", f"ckpt_{RING_STEPS}.pt"))
    splits = tpsp_splits(dalle)
    digests = [tpsp_block_digest(torch, obj, splits, r["rank"] % TPSP_MODEL) for r in ranks]
    del obj
    if digests != [r["params_sha256"] for r in ranks]:
        raise AssertionError("the TP x SP checkpoint read by one process differs from the ranks' "
                             "final blocks")
    step_s = [1.0 / h["steps_per_sec"] for h in ranks[0]["history"][LONG_TIMED_FROM - 1:]]
    med = statistics.median(step_s)
    names = ("ring_partial", "ring_block_grads", "layer_norm_fwd", "layer_norm_bwd")
    launches = [{k: r["launches"][k] for k in names} for r in ranks]
    print(f"train tpsp {LONG_CONFIG}: {RING_STEPS} steps + eval + checkpoint on {TPSP_MESH}; "
          f"losses {[round(x, 4) for x in losses]} (the single-process run's first "
          f"{single:.4f}); checkpoint bit-equal to every rank's blocks; launches per rank "
          f"{launches}", flush=True)
    print("train", json.dumps(dict(
        card=card, config=LONG_CONFIG, label=TPSP_LABEL, ranks=RING_RANKS, mesh_shape=TPSP_MESH,
        layout=TPSP_LAYOUT, batch=rows, seq_len=cfg.total_seq_len,
        seq_len_per_rank=cfg.total_seq_len // TPSP_SEQ,
        heads_per_rank=cfg.n_heads // TPSP_MODEL, n_layers=cfg.n_layers, n_embd=cfg.n_embd,
        vocab=cfg.total_tokens, bf16=cfg.bf_16, steps_timed=len(step_s), step_s=step_s,
        step_s_median=med, tokens_per_s=tokens_per_step / med, first_loss=losses[0],
        single_process_first_loss=single, losses=losses,
        staged_bytes_per_rank=[r["staged_bytes"] for r in ranks],
        tp_all_reduce_bytes_per_rank_per_step=[r["collective_bytes_by_kind_per_step"][0]["model"]
                                              for r in ranks],
        gradient_all_reduce_bytes_per_rank_per_step=[
            r["collective_bytes_by_kind_per_step"][0]["gradient_sum"] for r in ranks],
        other_collective_bytes_per_rank_per_step=[
            r["collective_bytes_by_kind_per_step"][0]["after"] for r in ranks],
        expected_bytes_by_model_index=want, bytes_equal_expected=True,
        peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
        wall_s_per_rank=[r["wall_s"] for r in ranks], launches_per_rank=launches,
        checkpoint_bit_equal_to_rank_blocks=True, eval=ranks[0]["eval_history"],
    )), flush=True)
    return launches


def tp_values_rank(torch, proc, out_dir):
    """One rank of the tensor-parallel values check (``check_tp_values``),
    run by ``ring_checks_rank`` in its process group, on TP_VALUES_MESH
    (dalle_coco's layout):
    each arm of TP_VALUES_ARMS on the 2-layer fp32 values model, the rank's
    row of the two and its blocks of the parameters: the loss and every
    leaf's gradient, the blocks gathered over the model group and summed
    over the replicas, which rank 0 holds against one process on the card
    (``values_errors``); then, with hash dropout 0.1, the packed and the
    [B, H, S, D] pair on the rank's heads (``head0``, ``heads_total``) of
    seeded global q, k, v, g. Writes <out_dir>/tp_rank<r>.pt."""
    import torch.distributed as dist  # noqa: PLC0415

    from dalle_mtf_tpu_torch.models.dalle import DALLE  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import attention_packed as ap  # noqa: PLC0415
    from dalle_mtf_tpu_torch.parallel.mesh import build_mesh  # noqa: PLC0415
    from dalle_mtf_tpu_torch.parallel.tensor import gather  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415

    mesh = build_mesh(TP_VALUES_MESH, TP_LAYOUT, "global", proc.rank, proc.world)
    dp = mesh.index("data")
    res = {"backend": proc.backend, "coords": mesh.coords, "arms": {}, "kernels": {}}
    base, params, tokens = values_model(torch)  # the arms change no parameter
    for name, over, fused in TP_VALUES_ARMS:
        cfg = dataclasses.replace(base, **over)
        dalle = DALLE(cfg, "cuda", mesh)
        sharding = dalle.sharding
        tree = _to(sharding.shard_tree(params), "cuda")
        for _, t in named_leaves(tree):
            t.requires_grad_(True)
        reset_counts(attn)
        loss, _ = dalle.loss(tree, tokens[dp:dp + 1].cuda(),
                             torch.Generator().manual_seed(TP_SEED), fused_xent=fused)
        loss.backward()
        launches = {n: c for n, c in attn.KERNEL_LAUNCHES.items() if c}
        grads = {"/".join(p): gather(t.grad, sharding.of(p), sharding.group)
                 for p, t in named_leaves(tree)}
        loss = loss.detach().clone()
        for t in (loss, *grads.values()):
            dist.all_reduce(t, group=mesh.replica_group)
        res["arms"][name] = dict(loss=loss.item(), launches=launches, heads=dalle.heads)
        if proc.rank == 0:
            res["arms"][name]["one_process"] = values_errors(torch, cfg, params, tokens,
                                                             fused, grads)
        del tree, grads, loss
        torch.cuda.empty_cache()
    h0, heads = dalle.heads
    q, k, v, g = (t[dp:dp + 1, h0:h0 + heads].contiguous().cuda()
                  for t in tp_kernel_inputs(torch))
    seed = RING_SEED + dp * 8  # row dp of 8 heads, as the model offsets it
    for packed in (True, False):
        if packed:
            pq, pk, pv, pg = (ap._pack(t).contiguous() for t in (q, k, v, g))
            out, lse = ap._forward(pq, pk, pv, heads, None, 0.1, seed, None, h0, 8)
            grads = ap._backward(pq, pk, pv, out, lse, pg, heads, None, 0.1, seed, h0, 8)
            got = [ap._unpack(t, heads) for t in (out, *grads)]
        else:
            out, lse = attn._forward(q, k, v, None, 0.1, seed, True, None, h0, 8)
            got = [out, *attn._backward(q, k, v, out, lse, g, None, 0.1, seed, h0, 8)]
        res["kernels"][packed] = dict(lse=lse.cpu(), tensors=[t.cpu() for t in got])
    torch.save(res, os.path.join(out_dir, f"tp_rank{proc.rank}.pt"))


def values_errors(torch, cfg, params, tokens, fused, grads) -> dict:
    """One process's loss on the card for the values model ``cfg`` (the same
    parameters, rows and dropout generator as the ranks) and the relative L2
    error and worst single element of ``grads`` (the ranks' whole
    gradients) against its gradients, leaf by leaf."""
    from dalle_mtf_tpu_torch.models.dalle import DALLE  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415

    tree = _to(params, "cuda")
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    loss, _ = DALLE(cfg, "cuda").loss(tree, tokens.cuda(), torch.Generator().manual_seed(TP_SEED),
                                      fused_xent=fused)
    loss.backward()
    want = {"/".join(p): t.grad for p, t in named_leaves(tree)}
    l2 = max((((grads[n] - w).norm() / w.norm().clamp_min(1e-30)).item(), n)
             for n, w in want.items())
    elem = max(((grads[n] - w).abs().max().item() / max(w.abs().max().item(), 1e-30), n)
               for n, w in want.items())
    return dict(loss=loss.item(), worst_grad_rel_l2=l2, worst_grad_elem=elem)


def tp_kernel_inputs(torch):
    """Seeded global q, k, v, g [2, 8, 1280, 128] fp32 on the CPU: the values
    model's two rows and eight heads."""
    gen = torch.Generator().manual_seed(23)
    return [torch.rand((2, 8, 1280, 128), generator=gen) * 2 - 1 for _ in range(4)]


def check_tp_values(torch, attn, card, ranks, wall: float) -> dict:
    """The values check of tensor parallelism, on what the 4 ranks of
    phase_train_sharded's launch wrote (``tp_values_rank``; ``wall``: the
    launch's seconds): TP_VALUES_MESH with dalle_coco's
    layout, the 2-layer fp32 values model at dalle_coco width (each rank 4
    heads, 2048 MLP columns, a 26,240-row block of the vocabulary), each arm
    of TP_VALUES_ARMS (the dense head, the fused head, attention dropout 0.1
    through the packed and the [B, H, S, D] pair) against one process on the
    card on the same parameters, rows and dropout generator: loss within
    1e-5, every leaf's gradient within relative L2 error 1e-2 (the values
    checks' bound, ``compare_values``: a single element is not held, since
    a relu whose input sits at 0 turns a last-bit difference of the split
    products into a whole gradient term; the worst one is printed), the
    launches of the arm's attention pair (one forward and one backward a
    layer on each rank). Under dropout the kernels on each rank's heads
    equal the heads of one 8-head launch bit for bit (the same hash)."""
    from dalle_mtf_tpu_torch.ops import attention_packed as ap  # noqa: PLC0415

    if {r["backend"] for r in ranks} != {"gloo"}:
        raise AssertionError(f"ranks sharing a card must run gloo: {[r['backend'] for r in ranks]}")
    report = {}
    base, _, _ = values_model(torch)
    for name, over, fused in TP_VALUES_ARMS:
        cfg = dataclasses.replace(base, **over)
        one = ranks[0]["arms"][name]["one_process"]
        losses = [r["arms"][name]["loss"] for r in ranks]
        l2, elem = one["worst_grad_rel_l2"], one["worst_grad_elem"]
        pair = ("causal_attention_packed" if cfg.attn_packed else "causal_attention")
        launches = [r["arms"][name]["launches"] for r in ranks]
        need = {f"{pair}_fwd": cfg.n_layers, f"{pair}_bwd": cfg.n_layers}
        report[name] = dict(loss_tp=losses, loss_one_process=one["loss"], worst_grad_rel_l2=l2,
                            worst_grad_elem=elem,
                            heads_per_rank=[r["arms"][name]["heads"] for r in ranks],
                            launches_per_rank=launches)
        print(f"tp values {name}: {cfg.n_embd} wide, {cfg.n_layers} layers, fp32, 2 rows on "
              f"{TP_VALUES_MESH}: loss per rank {losses} vs one process {one['loss']:.7f} "
              f"(atol 1e-5); worst grad relative L2 error {l2[0]:.3g} ({l2[1]}, bound 1e-2); "
              f"worst single element {elem[0]:.3g} of its leaf's max |grad| ({elem[1]}); "
              f"launches per rank {launches} ({TP_VALUES_LABEL}); {card}", flush=True)
        if not (all(abs(x - one["loss"]) <= 1e-5 for x in losses) and l2[0] <= 1e-2):
            raise AssertionError(f"tp values {name}: the ranks disagree with one process")
        if any(x != need for x in launches):
            raise AssertionError(f"tp values {name}: launches {launches}, expected {need}")
    q, k, v, g = (t.cuda() for t in tp_kernel_inputs(torch))
    for packed in (True, False):
        if packed:
            pq, pk, pv, pg = (ap._pack(t).contiguous() for t in (q, k, v, g))
            out, lse = ap._forward(pq, pk, pv, 8, None, 0.1, RING_SEED)
            whole = [ap._unpack(t, 8) for t in
                     (out, *ap._backward(pq, pk, pv, out, lse, pg, 8, None, 0.1, RING_SEED))]
        else:
            out, lse = attn._forward(q, k, v, None, 0.1, RING_SEED, True)
            whole = [out, *attn._backward(q, k, v, out, lse, g, None, 0.1, RING_SEED)]
        lse = lse.reshape(2, 8, -1)
        for r in ranks:
            dp, (h0, heads) = r["coords"]["data"], r["arms"]["dense"]["heads"]
            mine = r["kernels"][packed]
            equal = all(torch.equal(t, w[dp:dp + 1, h0:h0 + heads].cpu())
                        for t, w in zip(mine["tensors"], whole)) and torch.equal(
                mine["lse"], lse[dp:dp + 1, h0:h0 + heads].reshape(heads, -1).cpu())
            if not equal:
                layout = "packed" if packed else "[B, H, S, D]"
                raise AssertionError(f"tp values: rank {r['coords']}'s {layout} kernels under "
                                     f"dropout differ from the single launch's heads "
                                     f"{h0}..{h0 + heads - 1}")
    print(f"tp values: under dropout 0.1 each rank's packed and [B, H, S, D] kernels on its "
          f"heads equal one 8-head launch's bit for bit; 4 ranks, the ring launch "
          f"{wall:.1f}s", flush=True)
    return report


def single_first_loss(torch, path, shards=((0, 1),)) -> float:
    """The single-process port's first training loss on the records and
    seed of the config at ``path``: its Trainer's init and first batch, or
    the first batches of the data ``shards`` (index, count) one after
    another, the rows the ranks of a data axis read."""
    import numpy as np  # noqa: PLC0415

    from dalle_mtf_tpu_torch.data.pipeline import dalle_input_fn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_task  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.trainer import step_generator  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    params = fetch_model_params(path)
    params["padding_id"] = 50257
    seed = params.get("seed") or 0
    _, _, init_fn, loss_fn, _ = make_dalle_task(params, "cuda")
    tree = init_fn(torch.Generator().manual_seed(seed))
    parts = []
    for shard in shards:
        data = iter(dalle_input_fn(params, eval=False, shard=shard))
        parts.append(next(data))
        data.close()
    batch = {k: torch.as_tensor(np.concatenate([np.asarray(p[k]) for p in parts])).cuda()
             for k in parts[0]}
    with torch.no_grad():
        loss, _ = loss_fn(tree, None, batch, step_generator(seed, 1, 0), 0)
    return loss.item()


def report_train_tp(card, cfg, published, ranks, single: float, wall: float) -> None:
    """The tensor-parallel run's checks beyond ``pp_train_checks`` and its
    "train_tp" line: its first loss against ln V + var/2 and within 2e-3 of
    the single-process port's on the same records (both data ranks' first
    batches) and seed; step s, tokens/s, the collective bytes and peak
    memory a rank."""
    from dalle_mtf_tpu_torch.parallel.mesh import VOCAB, split_bounds  # noqa: PLC0415

    hist = ranks[0]["history"]
    losses = [h["loss"] for h in hist]
    init_loss = math.log(cfg.total_tokens) + cfg.n_embd * 0.02**2 / 2
    if abs(losses[0] - init_loss) > 0.1 or abs(losses[0] - single) > 2e-3:
        raise AssertionError(f"first loss {losses[0]} vs ln(vocab) + var/2 = {init_loss} "
                             f"and the single-process port's {single} (atol 2e-3)")
    step_s = [1.0 / h["steps_per_sec"] for h in hist[TP_TIMED_FROM - 1:]]
    med = statistics.median(step_s)
    batch = TP_CUT["train_batch_size"]
    per_step = [r["collective_bytes_per_step"] for r in ranks]
    print(f"train tp {TP_CONFIG}: {TP_STEPS} steps + eval + checkpoint on {TP_TRAIN_MESH} "
          f"(the pipeline launch's third run, {wall:.1f}s for the launch); losses "
          f"{[round(x, 4) for x in losses]} (the single-process port's first {single:.4f}); "
          f"launches per rank "
          f"{[{k: c for k, c in r['launches'].items() if c} for r in ranks]}", flush=True)
    print("train_tp", json.dumps(dict(
        card=card, config=TP_CONFIG, label=PP_LABEL, ranks=PP_RANKS,
        mesh_shape=published["mesh_shape"], layout=published["layout"],
        resized_mesh=TP_TRAIN_MESH, cut=TP_CUT, batch=batch,
        rows_per_data_rank=batch // TP_TRAIN_DATA, seq_len=cfg.total_seq_len,
        n_layers=cfg.n_layers, n_embd=cfg.n_embd, heads_per_rank=cfg.n_heads // TP_RANKS,
        vocab=cfg.total_tokens, bf16=cfg.bf_16,
        vocab_rows_per_rank=[b - a for a, b in split_bounds(VOCAB, cfg.total_tokens,
                                                             TP_RANKS)],
        remat_policy=cfg.remat_policy, steps_timed=len(step_s), step_s=step_s,
        step_s_median=med, tokens_per_s=cfg.total_seq_len * batch / med,
        collective_bytes_per_rank_per_step=per_step,
        collective_bytes_per_rank_per_step_median=[statistics.median(b) for b in per_step],
        peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
        wall_s_per_rank=[r["wall_s"] for r in ranks], launch_wall_s=wall,
        first_loss=losses[0], single_process_first_loss=single,
        expected_init_loss=init_loss, losses=losses,
        eval=ranks[0]["eval_history"],
        packed_launches_per_rank=[{k: r["launches"][k] for k in (
            "causal_attention_packed_fwd", "causal_attention_packed_bwd")} for r in ranks],
    )), flush=True)


# ------------------------------------------------ pipeline parallelism

PP_RANKS = 4
PP_MESH, PP_LAYOUT = "pipe:2,data:2", "batch_dim:data,layers:pipe"
PP_STAGES, PP_DATA = 2, 2
# steps 2..PP_STEPS are timed (3 steps until the PP x TP arms took the card
# time of the third)
PP_STEPS, PP_TIMED_FROM = 2, 2
# the run's depth: 4 of dalle_coco_synth's 12 layers, 2 a stage (12 until the
# TP x SP run took its card time)
PP_CUT = dict(n_layers=4)
PP_LABEL = ("4 ranks sharing one card over gloo, staged through host: not a multi-GPU "
            "number")
# the values check: the full-width model cut to 4 layers (2 a stage), fp32,
# 8 rows (4 a data rank) at M = 2 and M = 4 microbatches
PP_VALUES_LAYERS, PP_VALUES_ROWS, PP_VALUES_MICROBATCHES = 4, 8, (2, 4)
PP_FIRST_LOSS_ATOL = 2e-3  # bf16, the rows in another grouping: as the ring and TP runs
# PP x TP: configs/dalle_coco.json's published mesh and layout with a pipe
# axis and layers:pipe added (data:16,pipe:2,model:2 -> data:1,pipe:2,model:2
# on the 4 ranks of phase_train_sharded's launch): a rank runs its stage's 2 of 4
# layers on 4 of the 8 heads, half the MLP width and a 26,240- or 26,067-row
# block of the vocabulary; batch 8 (the published 128 over data:16), 2
# microbatches of 4 rows, each stage's head on 4 rows; bf16, dots_and_attn
PPTP_MESH = "data:16,pipe:2,model:2"
PPTP_LAYOUT = TP_LAYOUT + ",layers:pipe"
PPTP_MODEL = 2
PPTP_CUT = dict(n_layers=4, train_batch_size=8, eval_batch_size=8, pipeline_microbatches=2)
PPTP_STEPS = 2
PPTP_METRICS = ("loss", "loss_text", "loss_image")
# its values arm, in the launch's values check: the 4-layer fp32 values model
# of the same width with the attention dropout on, 8 rows, M = 2, on
# data:1,pipe:2,model:2; the loss within PP_VALUES_LOSS_ATOL and every
# gradient within relative L2 PP_VALUES_GRAD_L2 of one process on the card,
# as the PP arms (the TP values arms: 1e-5 and 1e-2 too)
PPTP_VALUES_MESH, PPTP_VALUES_DROPOUT = "data:1,pipe:2,model:2", 0.1
PP_VALUES_LOSS_ATOL, PP_VALUES_GRAD_L2 = 1e-5, 1e-2


def pp_whole_grads(torch, dalle, mesh, tree) -> dict:
    """Every leaf's whole gradient on a pipe mesh: a stage's layers gathered
    over the pipeline (and a split leaf's blocks over the model group) and
    summed over the replicas, the other leaves summed over the replicas and
    the stages (a leaf a stage did not use: zeros)."""
    import torch.distributed as dist  # noqa: PLC0415

    from dalle_mtf_tpu_torch.parallel.tensor import gather  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415

    out = {}
    for p, t in named_leaves(tree):
        g = torch.zeros_like(t) if t.grad is None else t.grad
        placed = dalle.sharding.placed(p)
        g = gather(g, placed, None)
        stage = any(x.axis == mesh.pipe_axis for x in placed)
        n, group = (mesh.replicas, mesh.replica_group) if stage else (mesh.shares,
                                                                    mesh.share_group)
        if n > 1:
            dist.all_reduce(g, group=group)
        out["/".join(p)] = g
    return out


def pp_values_arm(torch, dalle, mesh, params, tokens, mine) -> dict:
    """One values arm on a rank: the loss (summed over the shares) and
    every leaf's whole gradient of ``dalle`` on its rows ``mine``, the
    packed pair's launches; rank 0 adds one process's errors on ``tokens``."""
    import torch.distributed as dist  # noqa: PLC0415

    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415

    tree = _to(dalle.sharding.shard_tree(params), "cuda")
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    reset_counts(attn)
    loss, _ = dalle.loss(tree, mine, torch.Generator().manual_seed(TP_SEED))
    loss.backward()
    launches = {n: c for n, c in attn.KERNEL_LAUNCHES.items() if c}
    grads = pp_whole_grads(torch, dalle, mesh, tree)
    loss = loss.detach().clone()
    dist.all_reduce(loss, group=mesh.share_group)
    arm = dict(loss=loss.item(), launches=launches, layers=dalle.layers, heads=dalle.heads)
    if mesh.rank == 0:
        arm["one_process"] = values_errors(torch, dalle.cfg, params, tokens, False, grads)
    del tree, grads, loss
    torch.cuda.empty_cache()
    return arm


def pp_values_rank(torch, proc, out_dir) -> None:
    """One rank's values check of pipeline parallelism, in phase_train_sharded's
    launch before its training: the PP_VALUES_LAYERS-layer fp32 values model
    on PP_MESH, the rank's data rows of PP_VALUES_ROWS, at each of
    PP_VALUES_MICROBATCHES, then the same model with the attention dropout
    on (PPTP_VALUES_DROPOUT) on PPTP_VALUES_MESH with PPTP_LAYOUT's rules at
    M = 2 (``pp_values_arm``: the loss and every leaf's whole gradient,
    which rank 0 holds against one process on the card, ``values_errors``,
    and the packed pair's launches on this rank). Writes
    <out_dir>/pp_values_rank<r>.pt."""
    import torch.distributed as dist  # noqa: PLC0415

    from dalle_mtf_tpu_torch.models.dalle import DALLE  # noqa: PLC0415
    from dalle_mtf_tpu_torch.parallel.mesh import build_mesh  # noqa: PLC0415

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = build_mesh(PP_MESH, PP_LAYOUT, "global", proc.rank, proc.world)
    base, params, _ = values_model(torch, n_layers=PP_VALUES_LAYERS)
    tokens = torch.randint(0, base.total_tokens, (PP_VALUES_ROWS, base.total_seq_len),
                           generator=torch.Generator().manual_seed(7))
    rows = PP_VALUES_ROWS // mesh.size("data")
    mine = tokens[mesh.index("data") * rows:][:rows].cuda()
    res = {"backend": proc.backend, "coords": mesh.coords, "stage": mesh.stage, "arms": {}}
    for m in PP_VALUES_MICROBATCHES:
        cfg = dataclasses.replace(base, pipeline_microbatches=m)
        res["arms"][m] = pp_values_arm(torch, DALLE(cfg, "cuda", mesh), mesh, params, tokens,
                                       mine)
    mesh = build_mesh(PPTP_VALUES_MESH, PPTP_LAYOUT, "global", proc.rank, proc.world)
    cfg = dataclasses.replace(base, pipeline_microbatches=2,
                              attention_dropout=PPTP_VALUES_DROPOUT)
    res["pptp"] = pp_values_arm(torch, DALLE(cfg, "cuda", mesh), mesh, params, tokens,
                                tokens.cuda())
    res["pptp"]["coords"] = mesh.coords
    torch.save(res, os.path.join(out_dir, f"pp_values_rank{proc.rank}.pt"))
    dist.barrier()


def check_pp_values(torch, card, out_dir) -> dict:
    """phase_train_sharded's values check on the ranks' reports: in every arm
    every rank's loss within PP_VALUES_LOSS_ATOL of one process's on the
    card, every gradient within relative L2 error PP_VALUES_GRAD_L2 (the
    values checks' band: the 3xTF32 kernels and fp32 sums in another order),
    one forward and one backward launch a layer of the stage and a
    microbatch on each rank (of its heads in the PP x TP arm)."""
    ranks = [torch.load(os.path.join(out_dir, f"pp_values_rank{r}.pt"), weights_only=False)
             for r in range(PP_RANKS)]
    if {r["backend"] for r in ranks} != {"gloo"}:
        raise AssertionError(f"ranks sharing a card must run gloo: {[r['backend'] for r in ranks]}")
    report = {}
    per = PP_VALUES_LAYERS // PP_STAGES
    arms = [(f"M{m}", m, PP_MESH, [r["arms"][m] for r in ranks])
            for m in PP_VALUES_MICROBATCHES]
    arms.append(("pptp_M2", 2, f"{PPTP_VALUES_MESH} ({PPTP_LAYOUT}; attention dropout "
                                f"{PPTP_VALUES_DROPOUT})", [r["pptp"] for r in ranks]))
    for name, m, where, got in arms:
        one = got[0]["one_process"]
        losses = [a["loss"] for a in got]
        l2, elem = one["worst_grad_rel_l2"], one["worst_grad_elem"]
        need = {"causal_attention_packed_fwd": per * m, "causal_attention_packed_bwd": per * m}
        launches = [a["launches"] for a in got]
        report[name] = dict(loss_pp=losses, loss_one_process=one["loss"],
                            worst_grad_rel_l2=l2, worst_grad_elem=elem,
                            layers_per_rank=[a["layers"] for a in got],
                            heads_per_rank=[a["heads"] for a in got],
                            launches_per_rank=launches)
        print(f"pp values {name}: {PP_VALUES_LAYERS} layers, fp32, {PP_VALUES_ROWS} rows "
              f"on {where}: loss per rank {losses} vs one process {one['loss']:.7f} (atol "
              f"{PP_VALUES_LOSS_ATOL}); worst grad relative L2 error {l2[0]:.3g} ({l2[1]}, "
              f"bound {PP_VALUES_GRAD_L2}); worst single element {elem[0]:.3g} of its leaf's "
              f"max |grad| ({elem[1]}); heads per rank {report[name]['heads_per_rank']}; "
              f"launches per rank {launches} ({PP_LABEL}); {card}", flush=True)
        if not (all(abs(x - one["loss"]) <= PP_VALUES_LOSS_ATOL for x in losses)
                and l2[0] <= PP_VALUES_GRAD_L2):
            raise AssertionError(f"pp values {name}: the ranks disagree with one process")
        if any(x != need for x in launches):
            raise AssertionError(f"pp values {name}: launches {launches}, expected {need}")
    return report


def pp_expected_bytes(cfg, batch: int, microbatches: int, stage: int,
                      data: int = PP_DATA, stages: int = PP_STAGES) -> dict:
    """What a rank of ``stage`` sends in one training step, from the code
    (parallel/pipeline.py), by kind: each microbatch's activations
    [b/M, S, E] forward to the next stage and their gradients backward to
    the previous one; the head rows [b/P, S, E] from the last stage to each
    other stage and their gradients back (compute dtype). ``b``: a data
    rank's rows of ``batch`` over ``data`` ranks (under PP x TP every rank
    of a model group sends its own copy)."""
    rows = batch // data
    elem = 2 if cfg.bf_16 else 4
    hop = rows // microbatches * cfg.total_seq_len * cfg.n_embd * elem
    head = rows // stages * cfg.total_seq_len * cfg.n_embd * elem
    last = stage == stages - 1
    return {"activations": 0 if last else microbatches * hop,
            "gradients": 0 if stage == 0 else microbatches * hop,
            "head_rows": (stages - 1) * head if last else 0,
            "head_grads": 0 if last else head}


def pp_expected_collective_bytes(dalle_whole, n_metrics: int) -> dict:
    """A rank's all_reduce bytes in one training step, from the code
    (train/trainer.py): its stage's layers over the data group and the
    replicated leaves over the data and pipe ranks (fp32 gradients), the
    global norm's one fp32 sum of the stage's squares over the pipeline and
    the metrics' shares (``n_metrics`` fp32 values) over the data and pipe
    ranks. ``dalle_whole``: the model on one process (its whole shapes)."""
    blocks = sum(math.prod(s) for p, s in _shape_leaves(dalle_whole.param_shapes())
                 if p[0] == "layers") // PP_STAGES
    replicated = sum(math.prod(s) for p, s in _shape_leaves(dalle_whole.param_shapes())
                     if p[0] != "layers")
    return dict(stage_layer_values=blocks, stage_layer_bytes=4 * blocks,
                replicated_values=replicated, replicated_bytes=4 * replicated,
                total=4 * blocks + 4 * replicated + 4 + 4 * n_metrics)


def pptp_block_shape(logical, shape, stage: int, index: int) -> tuple:
    """The block of a leaf of whole ``shape`` (its JAX ``logical`` dims)
    that the PP x TP rank of ``stage`` and model index ``index`` holds,
    as [(dim, start, stop)]: the stage's half of the layers, and of a head,
    MLP-width or vocabulary dim the model index's block
    (``parallel.mesh.split_bounds``)."""
    from dalle_mtf_tpu_torch.parallel.mesh import LAYERS, split_bounds  # noqa: PLC0415

    out = []
    for dim, (name, size) in enumerate(zip(logical, shape)):
        if name == LAYERS:
            per = size // PP_STAGES
            out.append((dim, stage * per, (stage + 1) * per))
        elif name in ("heads_dim", "intermediate_expanded", "vocab_dim"):
            a, b = split_bounds(name, size, PPTP_MODEL)[index]
            out.append((dim, a, b))
    return out


def pptp_expected_collective_bytes(dalle_whole, rows: int, microbatches: int, stage: int,
                                   index: int) -> dict:
    """What a PP x TP rank of ``stage`` and model index ``index`` all_reduces
    in one training step, from the code, by kind (train/trainer.py,
    parallel/tensor.py, ops/losses.py), with ``rows`` batch rows a data rank
    (one data rank):

    - "model", before the gradient sum: on the first stage the
      vocab-parallel embedding's sum of the ``rows`` rows; each of the
      stage's layers on each microbatch the attention and MLP outputs' sums
      forward and their inputs' gradient sums backward ([b/M, S, E] in the
      compute dtype each); the head rows' input-gradient sum ([b/P, S, E])
      and the xent's fp32 row max and its sum-exp and target logit;
    - "gradient_sum": the leaves that are not a stage's layers (the
      embeddings, the final LN and the loss head's block) over the pipe
      group, fp32; a stage's layers have one data rank, nothing to sum;
    - "after": the gradients of the leaves whole on the model group (the
      position embedding, the LNs, ``o_b``, ``b_mlp2``) broadcast over it,
      the global norm's fp32 squares (one all_reduce over the model group,
      one over the pipeline, and two, model then pipeline, for the stacked
      blocks) and the metrics' shares over the pipeline."""
    cfg = dalle_whole.cfg
    elem = 2 if cfg.bf_16 else 4
    s, e, per = cfg.total_seq_len, cfg.n_embd, cfg.n_layers // PP_STAGES
    head = rows // PP_STAGES
    act = rows // microbatches * s * e * elem
    model = ((rows * s * e * elem if stage == 0 else 0) + per * microbatches * 4 * act
             + head * s * e * elem + 3 * head * s * 4)
    axes = dict(_shape_leaves(dalle_whole.logical_axes()))
    shared = copied = 0
    for path, shape in _shape_leaves(dalle_whole.param_shapes()):
        block = list(shape)
        for dim, a, b in pptp_block_shape(axes[path], shape, stage, index):
            block[dim] = b - a
        n = math.prod(block)
        if path[0] != "layers":
            shared += n
        if not any(name in ("heads_dim", "intermediate_expanded", "vocab_dim")
                   for name in axes[path]):
            copied += n
    return {"model": model, "gradient_sum": 4 * shared,
            "after": 4 * copied + 4 * 4 + 4 * len(PPTP_METRICS)}


def checkpoint_block_digest(torch, obj, shapes, logical, blocks) -> str:
    """sha256 of what a rank holds of the parameters of a checkpoint read by
    one process (``state_digest``'s order and bytes): of each leaf the
    block ``blocks(path, logical dims, whole shape)`` gives as [(dim, start,
    stop)], the whole leaf where it gives none."""
    import hashlib  # noqa: PLC0415

    digest = hashlib.sha256()
    for p, _ in shapes:
        t = obj["params"]["/".join(p)]
        for dim, a, b in blocks(p, logical[p], tuple(t.shape)):
            t = t.narrow(dim, a, b - a)
        digest.update(t.float().numpy().tobytes())
    return digest.hexdigest()


def pp_train_checks(ranks, steps: int, evals: int, want: dict, hops, coll=None) -> None:
    """The checks of a run's rank reports: the logged steps, the losses
    equal on every rank and finite, the evals, the checkpoint at the last
    step, the packed pair's launches ``want``, the bytes each rank's hops
    sent a step, ``hops(rank)``, and (with ``coll``) its all_reduce bytes a
    step, ``coll(rank)`` (a total, or by kind)."""
    for r in ranks:
        if [h["step"] for h in r["history"]] != list(range(1, steps + 1)):
            raise AssertionError(f"rank {r['rank']} logged {r['history']}")
        if [h["loss"] for h in r["history"]] != [h["loss"] for h in ranks[0]["history"]]:
            raise AssertionError("the ranks logged different losses")
        if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                   for h in r["history"]):
            raise AssertionError(f"non-finite loss or grad_norm: {r['history']}")
        if len(r["eval_history"]) != evals or not all(
                math.isfinite(e["eval_loss"]) for e in r["eval_history"]):
            raise AssertionError(f"eval: {r['eval_history']}")
        if r["checkpoints"] != [steps]:
            raise AssertionError(f"checkpoints {r['checkpoints']}")
        if {k: c for k, c in r["launches"].items() if c} != want:
            raise AssertionError(f"rank {r['rank']} launched {r['launches']}, expected {want}")
        if any(step != hops(r["rank"]) for step in r["pipe_bytes_per_step"]):
            raise AssertionError(f"rank {r['rank']} sent {r['pipe_bytes_per_step']} a step, "
                                 f"expected {hops(r['rank'])}")
        if coll is None:
            continue
        want_bytes = coll(r["rank"])
        got = (r["collective_bytes_by_kind_per_step"] if isinstance(want_bytes, dict)
               else r["collective_bytes_per_step"])
        if any(b != want_bytes for b in got):
            raise AssertionError(f"rank {r['rank']} all_reduced {got} bytes a step, expected "
                                 f"{want_bytes}")


def prepare_pp(torch, tmp: str) -> types.SimpleNamespace:
    """The pipeline and tensor-parallel runs of ``phase_train_sharded``'s
    launch, set up under ``tmp``: their configs and records, and the
    single-process port's first losses on them. ``argv``: the three runs'
    ``train_dalle.main`` arguments, joined by ``--then`` (the launch runs
    ``--pp-values`` before them); the rest is for ``finish_pp``."""
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    published = fetch_model_params(TRAIN_CONFIG)
    over = dict(mesh_shape=PP_MESH, layout=PP_LAYOUT, **PP_CUT)
    dalle, _ = make_dalle_models({**published, **over}, "cpu")
    cfg = dalle.cfg
    write_tokens_dataset(os.path.join(tmp, "data"), 6, cfg.image_seq_len,
                         cfg.image_vocab_size, files=2, per_file=48)
    path = train_config(tmp, PP_STEPS, TRAIN_CONFIG, PP_STEPS, **over)
    single = single_first_loss(torch, path, [(d, PP_DATA) for d in range(PP_DATA)])
    # PP x TP: dalle_coco's published layout plus layers:pipe
    tmp_tp = os.path.join(tmp, "pptp")
    tp_published = fetch_model_params(TP_CONFIG)
    tp_over = dict(mesh_shape=PPTP_MESH, layout=PPTP_LAYOUT, **PPTP_CUT)
    tp_dalle, _ = make_dalle_models({**tp_published, **tp_over}, "cpu")
    tp_cfg = tp_dalle.cfg
    write_tokens_dataset(os.path.join(tmp_tp, "data"), 8, tp_cfg.image_seq_len,
                         tp_cfg.image_vocab_size, files=1, per_file=32)
    tp_path = train_config(tmp_tp, PPTP_STEPS, TP_CONFIG, PPTP_STEPS, **tp_over)
    tp_single = single_first_loss(torch, tp_path)
    # TP alone: dalle_coco as published, data:2,model:2 on the four ranks
    tmp_tp_run = os.path.join(tmp, "tp")
    write_tokens_dataset(os.path.join(tmp_tp_run, "data"), 4, tp_cfg.image_seq_len,
                         tp_cfg.image_vocab_size, files=2, per_file=48)
    tp_run_path = train_config(tmp_tp_run, TP_STEPS, TP_CONFIG, TP_STEPS, **TP_CUT)
    tp_run_single = single_first_loss(torch, tp_run_path,
                                      [(d, TP_TRAIN_DATA) for d in range(TP_TRAIN_DATA)])
    argv = ["--model", path, "--gpu_ids", "0", "--new", "--yes",
            "--then", "--model", tp_path, "--gpu_ids", "0", "--new", "--yes",
            "--then", "--model", tp_run_path, "--gpu_ids", "0", "--new", "--yes"]
    return types.SimpleNamespace(
        argv=argv, tmp=tmp, tmp_tp=tmp_tp, published=published, dalle=dalle, cfg=cfg,
        single=single, tp_published=tp_published, tp_dalle=tp_dalle, tp_cfg=tp_cfg,
        tp_single=tp_single, tp_run_single=tp_run_single)


def finish_pp(torch, card, pp, out_dir: str, wall: float, first: int):
    """The checks of the pipeline-parallel main path, on what the ranks of
    ``phase_train_sharded``'s launch wrote (its runs ``first``.. are
    ``prepare_pp``'s; ``wall``: the launch's seconds): a tokens-mode copy of
    configs/dalle_coco_synth.json as published (1024 wide, 8 heads of 128,
    S = 1280, vocab 52,307, batch 16, bf16, dots_and_attn) cut to PP_CUT
    (4 of its 12 layers), with ``mesh_shape`` PP_MESH and ``layout``
    PP_LAYOUT (each stage 2 layers, 2
    microbatches of 4 rows a data rank, the loss head on 4 rows a rank),
    through ``run_ranks`` of PP_RANKS ranks sharing the card and
    ``train_dalle.main`` for PP_STEPS steps with an eval and a checkpoint;
    then, in the same launch, PP x TP: a tokens-mode copy of
    configs/dalle_coco.json with its published layout plus ``layers:pipe``
    on PPTP_MESH (data:1,pipe:2,model:2), cut to PPTP_CUT, for PPTP_STEPS
    steps with an eval and a checkpoint; then tensor parallelism alone: a
    tokens-mode copy of configs/dalle_coco.json as published (its mesh and
    layout, TP_TRAIN_MESH on the four ranks), cut to TP_CUT, for TP_STEPS
    steps with an eval and a checkpoint (``report_train_tp``).
    In the same launch, first, the values check (``pp_values_rank``,
    ``check_pp_values``: PP at M = 2 and 4, PP x TP at M = 2 with the
    attention dropout on). Checks of each run: the first loss within
    PP_FIRST_LOSS_ATOL of the single-process port's on the same seed and
    the same records (PP: the first batches of both data ranks' shards);
    the losses equal on every rank; the
    packed pair's launches a rank (its 2 layers, a forward a microbatch a
    pass and a backward a microbatch a step); the bytes each rank sent a
    step, by kind, to the byte of ``pp_expected_bytes``; the all_reduce
    bytes a rank a step to the byte of ``pp_expected_collective_bytes``
    (PP x TP: by kind, of ``pptp_expected_collective_bytes``);
    the checkpoint read by one process holding each rank's final parameters
    (its blocks) bit for bit (not held of the TP run, which phase_train_12b_tp
    holds). Returns the packed pair's launches per rank of each run."""
    from dalle_mtf_tpu_torch.utils import checkpoint  # noqa: PLC0415

    names = ("causal_attention_packed_fwd", "causal_attention_packed_bwd")
    (published, dalle, cfg, single, tp_published, tp_dalle, tp_cfg, tp_single, tp_run_single,
     tmp, tmp_tp) = (pp.published, pp.dalle, pp.cfg, pp.single, pp.tp_published, pp.tp_dalle,
                     pp.tp_cfg, pp.tp_single, pp.tp_run_single, pp.tmp, pp.tmp_tp)
    values = check_pp_values(torch, card, out_dir)
    ranks = [rank_report(out_dir, r, first) for r in range(PP_RANKS)]
    tp_ranks = [rank_report(out_dir, r, first + 1) for r in range(PP_RANKS)]
    tp_run_ranks = [rank_report(out_dir, r, first + 2) for r in range(PP_RANKS)]
    batch, m = published["train_batch_size"], cfg.pipeline_microbatches or PP_STAGES
    evals = 1
    per = cfg.n_layers // PP_STAGES
    want = {names[0]: per * m * (PP_STEPS + evals), names[1]: per * m * PP_STEPS}
    metrics = ("loss", "loss_text", "loss_image")
    coll = pp_expected_collective_bytes(dalle, len(metrics))
    pp_train_checks(ranks, PP_STEPS, evals, want,
                    lambda r: pp_expected_bytes(cfg, batch, m, r // PP_DATA),
                    lambda r: coll["total"])
    tp_batch, tp_m = PPTP_CUT["train_batch_size"], PPTP_CUT["pipeline_microbatches"]
    tp_want = {names[0]: per * tp_m * (PPTP_STEPS + evals), names[1]: per * tp_m * PPTP_STEPS}
    tp_coll = [pptp_expected_collective_bytes(tp_dalle, tp_batch, tp_m, r // PPTP_MODEL,
                                              r % PPTP_MODEL) for r in range(PP_RANKS)]
    pp_train_checks(tp_ranks, PPTP_STEPS, evals, tp_want,
                    lambda r: pp_expected_bytes(tp_cfg, tp_batch, tp_m, r // PPTP_MODEL, 1),
                    lambda r: tp_coll[r])
    tp_layers = TP_CUT["n_layers"]
    pp_train_checks(tp_run_ranks, TP_STEPS, evals,
                    {names[0]: tp_layers * (TP_STEPS + evals), names[1]: tp_layers * TP_STEPS},
                    lambda r: dict.fromkeys(("activations", "gradients", "head_rows",
                                             "head_grads"), 0))
    report_train_tp(card, tp_cfg, tp_published, tp_run_ranks, tp_run_single, wall)
    init_loss = math.log(cfg.total_tokens) + cfg.n_embd * 0.02**2 / 2
    for run, one in ((ranks, single), (tp_ranks, tp_single)):
        first = run[0]["history"][0]["loss"]
        if abs(first - init_loss) > 0.1 or abs(first - one) > PP_FIRST_LOSS_ATOL:
            raise AssertionError(f"first loss {first} vs ln(vocab) + var/2 = {init_loss} "
                                 f"and the single-process port's {one} (atol "
                                 f"{PP_FIRST_LOSS_ATOL})")
    losses = [h["loss"] for h in ranks[0]["history"]]
    t_read = time.perf_counter()
    shapes = list(_shape_leaves(dalle.param_shapes(whole=True)))
    logical = dict(_shape_leaves(dalle.logical_axes()))

    def stage_block(r):  # a PP rank's: its stage's layers, the other leaves whole
        return lambda p, names_, shape: [
            (0, r // PP_DATA * per, (r // PP_DATA + 1) * per)] if p[0] == "layers" else []

    def pptp_block(r):
        return lambda p, names_, shape: pptp_block_shape(names_, shape, r // PPTP_MODEL,
                                                         r % PPTP_MODEL)

    for run, root, block in ((ranks, tmp, stage_block), (tp_ranks, tmp_tp, pptp_block)):
        steps = run[0]["checkpoints"][-1]
        obj = checkpoint.read(os.path.join(root, "run", "checkpoints", f"ckpt_{steps}.pt"))
        digests = [checkpoint_block_digest(torch, obj, shapes, logical, block(r["rank"]))
                   for r in run]
        if digests != [r["params_sha256"] for r in run]:
            raise AssertionError(f"the checkpoint read by one process differs from the "
                                 f"ranks' final parameters ({root})")
        del obj
    read_s = time.perf_counter() - t_read
    step_s = [1.0 / h["steps_per_sec"] for h in ranks[0]["history"][PP_TIMED_FROM - 1:]]
    med = statistics.median(step_s)
    hop = pp_expected_bytes(cfg, batch, m, 0)["activations"] // m
    launched = [{k: c for k, c in r["launches"].items() if c} for r in ranks]
    print(f"train pp {TRAIN_CONFIG}: {PP_STEPS} steps + eval + checkpoint, then pp x tp "
          f"{TP_CONFIG}: {PPTP_STEPS} steps + eval + checkpoint ({PP_RANKS} ranks, the "
          f"four-rank launch of {wall:.1f}s, the values check first); losses "
          f"{[round(x, 4) for x in losses]} (the single-process port's first {single:.4f});"
          f" launches per rank {launched}; {hop} bytes a microbatch a hop; checkpoint "
          f"bit-equal to every rank's parameters ({PP_LABEL})", flush=True)
    print("train_pp", json.dumps(dict(
        card=card, config=TRAIN_CONFIG, label=PP_LABEL, ranks=PP_RANKS, mesh_shape=PP_MESH,
        layout=PP_LAYOUT, stages=PP_STAGES, data_ranks=PP_DATA, microbatches=m,
        microbatch_rows=batch // PP_DATA // m, head_rows_per_rank=batch // PP_DATA // PP_STAGES,
        bubble=(PP_STAGES - 1) / (m + PP_STAGES - 1), batch=batch, seq_len=cfg.total_seq_len,
        n_layers=cfg.n_layers, layers_per_stage=per, n_embd=cfg.n_embd,
        vocab=cfg.total_tokens, bf16=cfg.bf_16, remat_policy=cfg.remat_policy,
        steps_timed=len(step_s), step_s=step_s, step_s_median=med,
        tokens_per_s=cfg.total_seq_len * batch / med,
        hop_bytes_per_microbatch=hop,
        sent_bytes_per_rank_per_step=[r["pipe_bytes_per_step"] for r in ranks],
        staged_bytes_per_rank=[r["pipe_staged_bytes"] for r in ranks],
        collective_bytes_per_rank_per_step=[r["collective_bytes_per_step"] for r in ranks],
        collective_bytes_expected=coll,
        peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
        wall_s_per_rank=[r["wall_s"] for r in ranks], launch_wall_s=wall,
        checkpoint_read_s=read_s, checkpoint_bit_equal=True,
        first_loss=losses[0], single_process_first_loss=single,
        expected_init_loss=init_loss, losses=losses, eval=ranks[0]["eval_history"],
        packed_launches_per_rank=[{k: r["launches"][k] for k in names} for r in ranks],
        values=values,
    )), flush=True)
    tp_losses = [h["loss"] for h in tp_ranks[0]["history"]]
    tp_step_s = [1.0 / h["steps_per_sec"] for h in tp_ranks[0]["history"][1:]]
    tp_med = statistics.median(tp_step_s)
    print("train_pptp", json.dumps(dict(
        card=card, config=TP_CONFIG, label=PP_LABEL, ranks=PP_RANKS,
        mesh_shape=PPTP_MESH, resized_mesh="data:1,pipe:2,model:2", layout=PPTP_LAYOUT,
        published_mesh_shape=tp_published["mesh_shape"],
        published_layout=tp_published["layout"], cut=PPTP_CUT, batch=tp_batch,
        microbatches=tp_m, microbatch_rows=tp_batch // tp_m,
        head_rows_per_rank=tp_batch // PP_STAGES, stages=PP_STAGES, model=PPTP_MODEL,
        bubble=(PP_STAGES - 1) / (tp_m + PP_STAGES - 1), seq_len=tp_cfg.total_seq_len,
        n_layers=tp_cfg.n_layers, layers_per_stage=per, n_embd=tp_cfg.n_embd,
        heads_per_rank=tp_cfg.n_heads // PPTP_MODEL, vocab=tp_cfg.total_tokens,
        bf16=tp_cfg.bf_16, remat_policy=tp_cfg.remat_policy,
        steps_timed=len(tp_step_s), step_s=tp_step_s, step_s_median=tp_med,
        tokens_per_s=tp_cfg.total_seq_len * tp_batch / tp_med,
        hop_bytes_per_microbatch=pp_expected_bytes(tp_cfg, tp_batch, tp_m, 0, 1)[
            "activations"] // tp_m,
        sent_bytes_per_rank_per_step=[r["pipe_bytes_per_step"] for r in tp_ranks],
        staged_bytes_per_rank=[r["pipe_staged_bytes"] for r in tp_ranks],
        collective_bytes_by_kind_per_rank_per_step=[
            r["collective_bytes_by_kind_per_step"] for r in tp_ranks],
        collective_bytes_by_kind_expected=tp_coll,
        peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in tp_ranks],
        wall_s_per_rank=[r["wall_s"] for r in tp_ranks],
        checkpoint_bit_equal=True, first_loss=tp_losses[0],
        single_process_first_loss=tp_single, losses=tp_losses,
        eval=tp_ranks[0]["eval_history"],
        packed_launches_per_rank=[{k: r["launches"][k] for k in names} for r in tp_ranks],
        values=values["pptp_M2"],
    )), flush=True)
    return ([{k: r["launches"][k] for k in names} for r in ranks],
            [{k: r["launches"][k] for k in names} for r in tp_ranks],
            [{k: r["launches"][k] for k in names} for r in tp_run_ranks])


# ----------------------------------- VAE data parallelism and 12B's model:8

VAE_DP_CONFIG = "vae_coco"
VAE_DP_RANKS, VAE_TP_VALUES_RANKS = 2, 4
VAE_DP_STEPS, VAE_DP_SPLIT, VAE_DP_TIMED_FROM = 4, 2, 2  # steps 2..4 of the unbroken run timed
VAE_DP_LABEL = TP_LABEL
VAE_TP_VALUES_LABEL = TP_VALUES_LABEL
# the values check: the published width in fp32, 8 rows, 1 step (2 until
# the PP x TP arms took the card time of the second) and the eval after it,
# each arm against one process: data:2 on 2 ranks; on 4, in one launch, the
# convs split by output channels beside the codebook's columns (so the
# codebook's column split is held too) and by input channels beside its rows
VAE_DP_VALUES_ROWS, VAE_DP_VALUES_STEPS = 8, 1
VAE_DP_VALUES = ("data:2", "batch_dim:data")
VAE_TP_VALUES = (("data:2,model:2", "batch_dim:data,conv_cout:model,tokens_dim:model"),
                 ("data:2,model:2", "batch_dim:data,conv_cin:model,vae_hid_dim:model"))
# the training arm: vae_coco in bf16 on data:1,model:2 (2 ranks), the convs
# by output channels and the codebook by columns, VAE_TP_ROWS of the
# published 128 rows (each rank runs every row: the activation gathers of
# a step grow with them; 8 rows took 3.4-6.4 s a step through gloo, and the
# three runs below did not fit the phase's time at that), VAE_TP_STEPS
# steps, an eval and a checkpoint; then a run of VAE_TP_SPLIT steps and its
# resume to VAE_TP_STEPS, which must repeat it bit for bit (the ranks
# restore their blocks and moments)
VAE_TP_LAYOUT = VAE_TP_VALUES[0][1]
VAE_TP_MESH = "data:1,model:2"
VAE_TP_ROWS, VAE_TP_STEPS, VAE_TP_SPLIT = 4, 2, 1
# the same arithmetic in another order (cuDNN takes its algorithm by the batch
# it is given; relu gates at 0 move a bias gradient): losses and metrics
# relative 1e-5 and 1e-4, each gradient within relative L2 1e-2, the bound of
# every values check on the card (``compare_values``)
VAE_DP_TOL = dict(loss=1e-5, grad_rel_l2=1e-2, metric=1e-4)


def _contiguous(tree):
    """Every leaf of ``tree`` dense (a rank's block of a split leaf is a
    strided view)."""
    return {k: _contiguous(v) if isinstance(v, dict) else v.contiguous() for k, v in tree.items()}


def vae_values_run(torch, params, mesh, tree, images) -> dict:
    """VAE_DP_VALUES_STEPS ``Trainer.train_step``s of the VAE task on
    ``mesh`` (None: one process) from the whole ``tree`` on this rank's rows
    of ``images`` (on the host: the trainer moves them), then
    ``Trainer.eval_step``: the losses, the last step's
    gradients (whole: every split leaf gathered), the eval metrics. The
    Gumbel draw is the trainer's own, keyed on the global rows, so every
    layout draws one process's noise. ``step_s``, ``eval_s``: each step's
    and the eval's seconds (host clock; a step ends in a host read). ``replicated_sha256``: the digest of
    the replicated leaves (every leaf the layout does not split) after the
    steps."""
    from dalle_mtf_tpu_torch.parallel.tensor import gather  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import get_optimizer, named_leaves  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_vae_task  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.trainer import Trainer, step_generator  # noqa: PLC0415

    vae, init_fn, loss_fn, eval_fn = make_vae_task(params, "cuda", mesh)
    sharding = vae.sharding
    tree = _to(sharding.shard_tree(tree) if sharding else tree, "cuda")
    tree = _contiguous(tree)
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vae_values_")
    try:
        trainer = Trainer(params, init_fn, loss_fn, tmp, vae.cfg.image_seq_len, "cuda",
                          eval_loss_fn=eval_fn, mesh=mesh, sharding=sharding)
        opt, trainer.schedule = get_optimizer(params, tree, sharding)
        state = {"step": 0, "params": tree, "opt": opt}
        n, i = (mesh.size("data"), mesh.index("data")) if mesh else (1, 0)
        rows = images.shape[0] // n
        batch = {"image": images[i * rows:(i + 1) * rows]}
        losses, step_s = [], []
        for step in range(VAE_DP_VALUES_STEPS):
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, batch, step_generator(0, 1, step))
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t0)
        grads = {"/".join(p): gather(t.grad, sharding.of(p) if sharding else None,
                                     sharding.group if sharding else None).cpu()
                 for p, t in named_leaves(tree)}
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.eval_step(
            state, batch, step_generator(0, 2, 0)).items()}
        eval_s = time.perf_counter() - t0
        trainer.close()
        replicated = {"params": {"/".join(p): t for p, t in named_leaves(tree)
                                 if sharding is None or sharding.of(p) is None}}
        return dict(losses=losses, grads=grads, eval=metrics,
                    replicated_sha256=state_digest(torch, replicated), step_s=step_s,
                    eval_s=eval_s)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def vae_values_file(mesh_shape: str, layout: str) -> str:
    """The file name of a values arm's results."""
    return "values_" + "".join(c if c.isalnum() else "_" for c in f"{mesh_shape}_{layout}") + ".pt"


def vae_values_rank(torch, proc, out_dir, mesh_shape: str, layout: str) -> None:
    """One rank of phase_train_vae_dp's values check, in the process group
    that is up: ``vae_values_run`` on ``mesh_shape`` and ``layout`` from
    <out_dir>/inputs.pt (fp32: TF32 off); rank 0 writes
    <out_dir>/``vae_values_file`` with every rank's model-group ranks
    (``Mesh.copy_ranks``) and digest of its replicated leaves, and whether
    cuDNN ran deterministic."""
    import torch.distributed as dist  # noqa: PLC0415

    from dalle_mtf_tpu_torch.parallel.mesh import build_mesh  # noqa: PLC0415

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    mesh = build_mesh(mesh_shape, layout, "global", proc.rank, proc.world)
    res = vae_values_run(torch, inputs["params"], mesh, inputs["tree"], inputs["images"])
    copies = [None] * proc.world
    dist.all_gather_object(copies, (mesh.copy_ranks, res["replicated_sha256"]))
    if proc.rank == 0:
        torch.save(dict(res, replicas=mesh.replicas, tp_axis=mesh.tp_axis, copies=copies,
                        cudnn_deterministic=torch.backends.cudnn.deterministic),
                   os.path.join(out_dir, vae_values_file(mesh_shape, layout)))
    dist.barrier()


def worker_vae_values(torch, out_dir, argv):
    """``--ring-worker vae_values <out_dir> <mesh_shape> <layout>
    [<mesh_shape> <layout> ...]``: ``vae_values_rank`` on each pair in turn
    in one process group of its own, cuDNN at its default
    (non-deterministic algorithms allowed): the ranks of a model group
    compute the replicated convs' gradients each on its own, and the
    trainer must still leave them one value."""
    import torch.distributed as dist  # noqa: PLC0415

    from dalle_mtf_tpu_torch.utils.distributed import init_distributed  # noqa: PLC0415

    proc = init_distributed(["0"], "cuda")
    try:
        for mesh_shape, layout in zip(argv[0::2], argv[1::2]):
            vae_values_rank(torch, proc, out_dir, mesh_shape, layout)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def vae_values_errors(got: dict, want: dict) -> dict:
    """The ranks' values against one process's: the worst relative error
    of the losses and the eval metrics, and the worst relative L2 error of
    a gradient leaf (with its name)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], want["losses"]))
    metric = max((abs(got["eval"][k] - v) / max(abs(v), 1e-30), k)
                 for k, v in want["eval"].items())
    grad = max((((got["grads"][n] - w).norm() / w.norm().clamp_min(1e-30)).item(), n)
               for n, w in want["grads"].items())
    return dict(loss=loss, metric=metric, grad_rel_l2=grad)


def vae_tp_expected_bytes(cfg, rows: int, m: int) -> dict:
    """The collective bytes a rank moves in one training step of
    ``models/vae.py`` on VAE_TP_LAYOUT (every conv split by output
    channels where they divide by ``m``, the codebook by columns) over
    ``data:1,model:m`` with ``rows`` rows, a soft Gumbel sample, from the
    code, by the trainer's kinds (``worker_train``):

    - "model", the forward and backward's: a conv whose input is split
      gathers it whole (``gather_from_model``, the whole tensor's bytes),
      and a conv split by output channels sums its input's gradient over
      the group (``copy_to_model``'s all_reduce; not the image's, which has
      none); under ``recompute_grad`` a residual block's forward runs again
      in the backward, and with it both its gathers; the features are
      gathered before the codebook product (compute dtype) and the
      product's input gradient summed (fp32); the Gumbel softmax's max
      (forward) and sum (forward and backward) of [rows, g, g, 1] fp32; the
      decoder's partial product summed over the tokens ([rows, g, g, n_hid]
      fp32); the final conv (3 channels: whole) gathers its input;
    - "gradient_sum": none (one data rank);
    - "after": the replicated leaves' gradients broadcast (the final conv's
      kernel and bias, fp32) and the global norm's square sum (4 bytes);
      the metrics are not summed (one share)."""
    e = 2 if cfg.use_bf16 else 4
    side = cfg.image_size // cfg.stack_factor
    fwd = bwd = 0

    def conv(c_in, c_out, s_in, split, grad=True, recomputed=False):
        nonlocal fwd, bwd
        whole = rows * c_in * s_in * s_in * e
        if split:
            fwd += whole * (2 if recomputed else 1)
        if c_out % m == 0:
            bwd += whole if grad else 0
            return True
        return False

    def stack(blocks, c, s, split, up):
        for b, (n, channels) in enumerate(blocks):
            split = conv(c, channels, s, split, grad=up or b > 0)
            c, s = channels, s * 2 if up else s // 2
            for _ in range(1, n):
                out = conv(c, c, s, split, recomputed=cfg.recompute_grad)
                split = conv(c, c, s, out, recomputed=cfg.recompute_grad)
        return c, s, split

    _c, g, split = stack(cfg.convblocks, cfg.n_channels * cfg.stack_factor ** 2, side, False,
                         False)
    cells = rows * g * g
    fwd += cells * cfg.n_hid * e if split else 0  # the features gathered
    bwd += cells * cfg.n_hid * 4  # their fp32 gradient summed
    fwd += 2 * cells * 4  # the softmax's max and sum
    bwd += cells * 4  # the sum's gradient
    fwd += cells * cfg.n_hid * 4  # the decoder's product summed over the tokens
    c, s, split = stack(tuple(reversed(cfg.convblocks)), cfg.n_hid, g, False, True)
    conv(c, cfg.n_channels * cfg.stack_factor ** 2, s, split)
    replicated = (c * cfg.n_channels * cfg.stack_factor ** 2 + cfg.n_channels
                  * cfg.stack_factor ** 2) * 4
    return {"model": fwd + bwd, "gradient_sum": 0, "after": replicated + 4}


def rank_report(out_dir: str, rank: int, run: int) -> dict:
    """What ``worker_train`` wrote for ``rank`` in run ``run``."""
    with open(os.path.join(out_dir, f"rank{rank}_{run}.json")) as f:
        return json.load(f)


def vae_dp_config(tmp: str, pattern: str, run: str, train_steps: int, **over) -> str:
    """A copy of configs/vae_coco.json as published (width, bf16,
    recompute_grad, batch 128) over ``pattern``, ``train_steps`` steps with
    a checkpoint and an eval every VAE_DP_SPLIT, every step logged, in
    ``tmp/<run>``; the learning rate decays over VAE_DP_STEPS whatever
    ``train_steps`` is (its default end)."""
    from dalle_mtf_tpu_torch.utils.config import _resolve_config_path  # noqa: PLC0415

    with open(_resolve_config_path(VAE_DP_CONFIG)) as f:
        cfg = json.load(f)
    cfg.update(dataset={**cfg["dataset"], "train_path": pattern, "eval_path": pattern},
               train_steps=train_steps, steps_per_checkpoint=VAE_DP_SPLIT, eval_steps=1,
               log_every=1, max_to_keep=2, model_path=os.path.join(tmp, run),
               lr_decay_end=VAE_DP_STEPS, **over)
    path = os.path.join(tmp, f"{run}_{train_steps}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def check_vae_tp(torch, card, ranks, split, resumed, path) -> dict:
    """The VAE TP training arm of phase_train_vae_dp from its ranks' reports:
    VAE_TP_STEPS logged steps with one finite loss on every rank, an eval
    and a checkpoint at the last, each step's collective bytes by kind equal
    to ``vae_tp_expected_bytes``, and the checkpoint read back whole on
    this process (``utils/restore.py``, on the card) equal to the ranks'
    gathered blocks; the run of VAE_TP_SPLIT steps (``split``) and its
    resume (``resumed``) log the unbroken run's losses bit for bit and end
    with its parameters (the gathered blocks' digest), so the ranks restored
    their blocks and moments. Prints and returns the "train_vae_tp" line."""
    from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.restore import restore_vae_params  # noqa: PLC0415

    params = fetch_model_params(path)
    cfg = VAEConfig.from_params(params)
    steps = list(range(1, VAE_TP_STEPS + 1))
    for r in ranks:
        hist = r["history"]
        if [h["step"] for h in hist] != steps or not all(math.isfinite(h["loss"]) for h in hist):
            raise AssertionError(f"VAE TP rank {r['rank']} logged {hist}")
        if [h["loss"] for h in hist] != [h["loss"] for h in ranks[0]["history"]]:
            raise AssertionError("VAE TP: the ranks logged different losses")
    evals = ranks[0]["eval_history"]
    if [e["step"] for e in evals] != [VAE_TP_STEPS] or not all(
            math.isfinite(v) for e in evals for v in e.values()):
        raise AssertionError(f"VAE TP eval: {evals}")
    if ranks[0]["checkpoints"] != [VAE_TP_STEPS]:
        raise AssertionError(f"VAE TP checkpoints {ranks[0]['checkpoints']}")
    for part, want_steps in ((split, steps[:VAE_TP_SPLIT]), (resumed, steps[VAE_TP_SPLIT:])):
        for r in part:
            if [h["step"] for h in r["history"]] != want_steps:
                raise AssertionError(f"VAE TP split/resume rank {r['rank']} logged {r['history']}")
    for r, q, u in zip(split, resumed, ranks):
        again = [h["loss"] for h in r["history"] + q["history"]]
        if again != [h["loss"] for h in u["history"]]:
            raise AssertionError(f"VAE TP rank {r['rank']}: the resume does not repeat the "
                                 f"unbroken run bit for bit: {again} vs {u['history']}")
        if q["gathered_params_sha256"] != u["gathered_params_sha256"]:
            raise AssertionError(f"VAE TP rank {r['rank']}: the resumed run ends with other "
                                 "parameters than the unbroken run")
    m = int(VAE_TP_MESH.split("model:")[1])
    want = vae_tp_expected_bytes(cfg, VAE_TP_ROWS, m)
    kinds = [r["collective_bytes_by_kind_per_step"] for r in ranks]
    if any(k != want for r in kinds for k in r) or any(len(r) != VAE_TP_STEPS for r in kinds):
        raise AssertionError(f"VAE TP collective bytes a step {kinds}, expected {want}")
    vae = DiscreteVAE(cfg, "cuda")
    t0 = time.perf_counter()
    restored = restore_vae_params(vae, params["model_path"])
    read_s = time.perf_counter() - t0
    digest = state_digest(torch, {"params": restored})
    if digest != ranks[0]["gathered_params_sha256"]:
        raise AssertionError("VAE TP: the checkpoint read on one process differs from the "
                             "ranks' gathered parameters")
    del restored, vae
    gc.collect()
    torch.cuda.empty_cache()
    step_s = [1.0 / h["steps_per_sec"] for h in ranks[0]["history"]]
    line = dict(
        phase="train_vae_tp", card=card, config=VAE_DP_CONFIG, label=TP_LABEL, ranks=m,
        mesh_shape=VAE_TP_MESH, layout=VAE_TP_LAYOUT, rows=VAE_TP_ROWS,
        published_rows=fetch_model_params(VAE_DP_CONFIG)["train_batch_size"],
        image_size=cfg.image_size, convblocks=cfg.convblocks, bf16=cfg.use_bf16,
        recompute_grad=cfg.recompute_grad,
        timing="train_vae.main, log_every 1 (a sync every step), cudnn.deterministic; step 1 "
               "includes the first call's set-up",
        step_s=step_s, images_per_s=VAE_TP_ROWS / step_s[-1],
        tp_bytes_per_rank_per_step=[[k["model"] for k in r] for r in kinds],
        tp_bytes_expected=want["model"],
        gradient_sum_bytes_per_rank_per_step=[[k["gradient_sum"] for k in r] for r in kinds],
        after_bytes_per_rank_per_step=[[k["after"] for k in r] for r in kinds],
        after_bytes_expected=want["after"],
        collective_bytes_per_rank_per_step=[r["collective_bytes_per_step"] for r in ranks],
        peak_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
        losses=[h["loss"] for h in ranks[0]["history"]], evals=evals,
        checkpoint_read_s=read_s, checkpoint_equals_gathered=True,
        resumed_at=VAE_TP_SPLIT, resume_bit_equal=True,
        split_wall_s=split[0]["wall_s"], resume_wall_s=resumed[0]["wall_s"],
        wall_s=ranks[0]["wall_s"],
    )
    print("train_vae_tp", json.dumps(line), flush=True)
    return line


def phase_train_vae_dp(torch, card) -> dict:
    """VAE data parallelism: configs/vae_coco.json as published (256 px,
    convblocks [[2,128],[3,256],[5,512]], 2048 tokens, bf16, recompute_grad,
    batch 128; no mesh_shape, so its data axis takes every rank) on the
    seeded JPEG tfrecords phase_train_vae writes, through
    ``run_ranks`` of VAE_DP_RANKS ranks sharing the card (64 rows
    a rank) and ``train_vae.main``: VAE_DP_STEPS steps with an eval and a
    checkpoint every VAE_DP_SPLIT (cuDNN deterministic), then in the same
    launch VAE tensor parallelism: vae_coco in bf16 on VAE_TP_MESH with
    VAE_TP_LAYOUT (the convs by output channels, the codebook by columns),
    VAE_TP_ROWS rows, VAE_TP_STEPS steps, an eval and a checkpoint, whose
    collective bytes a step must equal ``vae_tp_expected_bytes`` and whose
    checkpoint, read back whole on this process, must equal the ranks'
    gathered blocks; then a run of VAE_TP_SPLIT steps and its resume, which
    must repeat the TP run's losses and end with its parameters bit for bit
    (``check_vae_tp``).
    Before it, the values check in fp32 at the published width: ``data:2``
    on 2 ranks, and on 4 the two VAE_TP_VALUES arms (``data:2,model:2``, the
    conv splits beside the codebook's), each against one process on the
    same 8 rows (VAE_DP_TOL). Prints the "train_vae_tp" line (step
    s, images/s, the TP bytes a rank a step against the prediction, peak GB
    a rank) and the "train_vae_dp" line: step s, images/s, the gradient
    bytes a rank a step, peak GB a rank, the data-wait share."""
    from dalle_mtf_tpu_torch.models.vae import VAEConfig  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_vae_task  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vae_dp_")
    try:
        published = fetch_model_params(VAE_DP_CONFIG)
        cfg = VAEConfig.from_params(published)
        # the values check: fp32, one process here, the layouts on their ranks
        fp32 = {**published, "use_bf16": False}
        vae, init_fn, _, _ = make_vae_task(fp32, "cpu")
        n_params = sum(math.prod(s) for _, s in _shape_leaves(vae.param_shapes()))
        tree = init_fn(torch.Generator().manual_seed(5))
        images = torch.rand((VAE_DP_VALUES_ROWS, cfg.image_size, cfg.image_size, 3),
                            generator=torch.Generator().manual_seed(6)) * 2 - 1
        torch.save(dict(params=fp32, tree=tree, images=images), os.path.join(tmp, "inputs.pt"))
        one = vae_values_run(torch, fp32, None, tree, images)
        del vae, tree
        gc.collect()
        torch.cuda.empty_cache()

        def check_values(shape, layout, ranks):
            got = torch.load(os.path.join(tmp, vae_values_file(shape, layout)),
                             weights_only=False)
            errs = vae_values_errors(got, one)
            groups = {tuple(g) for g, _ in got["copies"] if g}
            values[f"{shape} {layout}"] = dict(ranks=ranks, replicas=got["replicas"],
                                 tp_axis=got["tp_axis"], losses=got["losses"],
                                 one_process_losses=one["losses"], eval=got["eval"],
                                 one_process_eval=one["eval"], errors=errs,
                                 cudnn_deterministic=got["cudnn_deterministic"],
                                 step_s=got["step_s"], eval_s=got["eval_s"],
                                 model_groups=sorted(groups),
                                 replicated_sha256=[d for _, d in got["copies"]])
            for g in groups:
                if len({got["copies"][r][1] for r in g}) != 1:
                    raise AssertionError(f"VAE {shape} ({layout}): the copies of the replicated "
                                         f"leaves differ in model group {g}: {got['copies']}")
            if not (errs["loss"] <= VAE_DP_TOL["loss"] and errs["metric"][0] <= VAE_DP_TOL["metric"]
                    and errs["grad_rel_l2"][0] <= VAE_DP_TOL["grad_rel_l2"]):
                raise AssertionError(f"VAE {shape} ({layout}) against one process: {errs}, "
                                     f"tolerances {VAE_DP_TOL}")

        values = {}
        dp_shape, dp_layout = VAE_DP_VALUES
        t0 = time.perf_counter()
        run_ranks([os.path.join(HERE, "chip_smoke.py"), "--ring-worker", "vae_values", tmp,
                   *(a for arm in VAE_TP_VALUES for a in arm)], 600, VAE_TP_VALUES_RANKS)
        values_wall = time.perf_counter() - t0
        for shape, layout in VAE_TP_VALUES:
            check_values(shape, layout, VAE_TP_VALUES_RANKS)

        pattern = write_image_dataset(os.path.join(tmp, "data"), 3,
                                      [(cfg.image_size, cfg.image_size)])
        tp_over = dict(mesh_shape=VAE_TP_MESH, layout=VAE_TP_LAYOUT,
                       train_batch_size=VAE_TP_ROWS, eval_batch_size=VAE_TP_ROWS)
        tp_path = vae_dp_config(tmp, pattern, "tp", VAE_TP_STEPS, **tp_over)
        runs = [vae_dp_config(tmp, pattern, "unbroken", VAE_DP_STEPS), tp_path,
                vae_dp_config(tmp, pattern, "tp_split", VAE_TP_SPLIT, **tp_over),
                vae_dp_config(tmp, pattern, "tp_split", VAE_TP_STEPS, **tp_over)]
        argv = []
        for i, path in enumerate(runs):
            argv += (["--then"] if argv else []) + ["--model", path, "--gpu_ids", "0"] + (
                ["--new", "--yes"] if i < 3 else [])
        # the data:2 values check first, in the training launch's group
        t0 = time.perf_counter()
        run_ranks([os.path.join(HERE, "chip_smoke.py"), "--ring-worker", "train_vae", tmp,
                   "--values", dp_shape, dp_layout, *argv], 900, VAE_DP_RANKS)
        wall = time.perf_counter() - t0
        check_values(dp_shape, dp_layout, VAE_DP_RANKS)
        print(f"train_vae_dp values (fp32, {VAE_DP_VALUES_ROWS} rows, {VAE_DP_VALUES_STEPS} "
              f"steps + eval; the 4-rank launch {values_wall:.1f}s): {json.dumps(values)}",
              flush=True)
        out_dir = tmp
        reports = [[rank_report(out_dir, r, i) for r in range(VAE_DP_RANKS)]
                   for i in range(len(runs))]
        unbroken, tp, tp_split, tp_resumed = reports
        check_vae_tp(torch, card, tp, tp_split, tp_resumed, tp_path)
        for r in unbroken:
            if [h["step"] for h in r["history"]] != list(range(1, VAE_DP_STEPS + 1)):
                raise AssertionError(f"rank {r['rank']} logged {r['history']}")
            if [h["loss"] for h in r["history"]] != [h["loss"] for h in unbroken[0]["history"]]:
                raise AssertionError("the ranks logged different losses")
            if not all(math.isfinite(h["loss"]) for h in r["history"]):
                raise AssertionError(f"non-finite loss: {r['history']}")
        losses = [h["loss"] for h in unbroken[0]["history"]]
        evals = unbroken[0]["eval_history"]
        if [e["step"] for e in evals] != list(range(VAE_DP_SPLIT, VAE_DP_STEPS + 1,
                                                     VAE_DP_SPLIT)) or not all(
                math.isfinite(v) for e in evals for v in e.values()):
            raise AssertionError(f"eval: {evals}")
        if unbroken[0]["checkpoints"] != [VAE_DP_SPLIT, VAE_DP_STEPS]:
            raise AssertionError(f"checkpoints {unbroken[0]['checkpoints']}")
        hist = unbroken[0]["history"]
        timed = range(VAE_DP_TIMED_FROM, VAE_DP_STEPS + 1)
        # a step logs before it checkpoints, and the next one's window opens
        # after the checkpoint: every step from the second is a training step
        step_s = [1.0 / hist[s - 1]["steps_per_sec"] for s in timed]
        med = statistics.median(step_s)
        batch = published["train_batch_size"]
        waits = [r["data_waits"] for r in unbroken]
        wait_share = [sum(w[s - 1] for s in timed) / sum(step_s) for w in waits]
        grad_bytes = [statistics.median(r["collective_bytes_per_step"]) for r in unbroken]
        line = dict(
            phase="train_vae_dp", card=card, config=VAE_DP_CONFIG, label=VAE_DP_LABEL,
            ranks=VAE_DP_RANKS, mesh_shape=published.get("mesh_shape"),
            resized_mesh=f"data:{VAE_DP_RANKS}", batch=batch,
            rows_per_rank=batch // VAE_DP_RANKS, image_size=cfg.image_size,
            convblocks=cfg.convblocks, num_tokens=cfg.num_tokens, bf16=cfg.use_bf16,
            recompute_grad=cfg.recompute_grad,
            timing="train_vae.main, log_every 1 (a sync every step), cudnn.deterministic",
            steps_timed=len(step_s), step_s=step_s, step_s_median=med,
            images_per_s=batch / med, gradient_bytes_per_rank_per_step=grad_bytes,
            collective_bytes_per_rank_per_step=[r["collective_bytes_per_step"]
                                                for r in unbroken],
            peak_gb_per_rank=[r["peak_mem_gb"] for r in unbroken],
            data_wait_share_per_rank=wait_share, losses=losses, evals=evals,
            wall_s=wall, n_params=n_params, values=values,
            values_label=f"data:2 {VAE_DP_LABEL}; data:2,model:2 {VAE_TP_VALUES_LABEL}",
            values_launch_s=values_wall,
        )
        print("train_vae_dp", json.dumps(line), flush=True)
        return line
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)


TWELVE_B_TP_RANKS = 8
# configs/dalle_12B.json with its published layout and mesh (data:16,model:8
# -> data:1,model:8 on 8 ranks sharing the card), cut to 1 of 38 layers (2
# before the pipeline phase took its card time) and 4 rows, half of one
# published microbatch (512 / 16 replicas / 4 microbatches = 8); no eval;
# Adafactor in place of the published AdamW, so a checkpoint is the
# parameters (3.5 GB) and small factored moments, not three times them (the
# run's time limit)
TWELVE_B_TP_CUT = dict(n_layers=1, train_batch_size=4, eval_batch_size=4,
                       optimizer="adafactor")
TWELVE_B_TP_STEPS, TWELVE_B_TP_RESUME = 2, 1
# sampling from the resumed run's checkpoint in the same launch: the
# published predict_batch_size, 32 of the 2304 decode steps of an image
# (128 before the pipeline phase took its card time)
TWELVE_B_SAMPLE_STEPS, TWELVE_B_SAMPLE_BATCH = 32, 64
TWELVE_B_SAMPLE_ATOL = 0.1  # bf16 band logits, the blocks' sums in another order
TWELVE_B_TP_LABEL = ("8 ranks sharing one card over gloo, staged through host: not a "
                     "multi-GPU number")


def phase_train_12b_tp(torch, card) -> tuple[list[dict], list[int]]:
    """dalle_12B's published tensor parallelism: configs/dalle_12B.json at
    full width (n_embd 5120, 40 heads of 128, S = 2560, vocab 52,307, bf16,
    dots_saveable) with its mesh_shape and layout, cut to TWELVE_B_TP_CUT, in
    tokens mode through ``run_ranks`` of 8 ranks sharing the
    card (each 5 heads, 2560 MLP columns, 6656 vocabulary rows, the last 5715) and
    ``train_dalle.main``: TWELVE_B_TP_STEPS steps and a checkpoint, then in
    the same launch a resume for TWELVE_B_TP_RESUME more. Every rank's
    parameters and moments just after the restore must equal, bit for bit,
    what it ended the first run with. Prints each rank's init seconds, its
    device bytes and peak host RSS during the sharded init (against the
    whole tree's bytes), rank 0's seconds and peak host RSS while it
    writes, the collective bytes a rank a step and the packed pair's
    launches. The first loss must equal the single-process port's on the
    same config, records and seed within 2e-3 (as the TP run's), and
    each rank's device peak during the init stay within its blocks' bytes
    and one unit of the draw (``init_unit_bytes``). Then, in the same
    launch, each rank samples from the resumed run's checkpoint
    (``sample_rank``: its blocks read through ``sample_dalle.load_dalle_params``,
    the prefill of TWELVE_B_SAMPLE_BATCH captions and TWELVE_B_SAMPLE_STEPS
    decode steps), checked by ``check_sample_12b``. Returns the pair's
    launches per rank of the first run and the sampling's prefill launches
    per rank."""
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    tmp = tempfile.mkdtemp(prefix="chip_smoke_12b_tp_")
    names = ("causal_attention_packed_fwd", "causal_attention_packed_bwd")
    try:
        published = fetch_model_params(TWELVE_B_CONFIG)
        cut = {**published, **TWELVE_B_TP_CUT}
        dalle, _ = make_dalle_models(cut, "cpu")
        cfg = dalle.cfg
        whole_params = sum(math.prod(s) for _, s in _shape_leaves(dalle.param_shapes()))
        write_tokens_dataset(os.path.join(tmp, "data"), 5, cfg.image_seq_len,
                             cfg.image_vocab_size, files=1, per_file=32)
        first = shutil.copy(train_config(tmp, TWELVE_B_TP_STEPS, TWELVE_B_CONFIG,
                                         TWELVE_B_TP_STEPS, eval_steps=0, **TWELVE_B_TP_CUT),
                            os.path.join(tmp, "first.json"))
        resume = train_config(tmp, TWELVE_B_TP_STEPS + TWELVE_B_TP_RESUME, TWELVE_B_CONFIG,
                              TWELVE_B_TP_STEPS, eval_steps=0, **TWELVE_B_TP_CUT)
        t_single = time.perf_counter()
        single = single_first_loss(torch, first)
        single_s = time.perf_counter() - t_single
        out_dir = os.path.join(tmp, "ranks")
        os.makedirs(out_dir)
        argv = ["--sample", str(TWELVE_B_SAMPLE_STEPS), str(TWELVE_B_SAMPLE_BATCH),
                "--model", first, "--gpu_ids", "0", "--new", "--yes", "--then",
                "--model", resume, "--gpu_ids", "0"]
        gc.collect()
        torch.cuda.empty_cache()
        os.environ[DIGEST_MOMENTS] = "1"
        t0 = time.perf_counter()
        try:
            run_ranks([os.path.join(HERE, "chip_smoke.py"), "--ring-worker", "train", out_dir,
                       *argv], 900, TWELVE_B_TP_RANKS)
        finally:
            del os.environ[DIGEST_MOMENTS]
        wall = time.perf_counter() - t0
        runs = [[rank_report(out_dir, r, i) for r in range(TWELVE_B_TP_RANKS)]
                for i in range(2)]
        ranks, resumed = runs
        L = cfg.n_layers
        for run, steps in ((ranks, range(1, TWELVE_B_TP_STEPS + 1)),
                           (resumed, range(TWELVE_B_TP_STEPS + 1,
                                           TWELVE_B_TP_STEPS + TWELVE_B_TP_RESUME + 1))):
            # dots_saveable: the forward again in the backward
            want = {names[0]: 2 * L * len(steps), names[1]: L * len(steps)}
            for r in run:
                if [h["step"] for h in r["history"]] != list(steps):
                    raise AssertionError(f"rank {r['rank']} logged {r['history']}")
                if [h["loss"] for h in r["history"]] != [h["loss"] for h in run[0]["history"]]:
                    raise AssertionError("the ranks logged different losses")
                if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                           for h in r["history"]):
                    raise AssertionError(f"non-finite loss or grad_norm: {r['history']}")
                if {k: c for k, c in r["launches"].items() if c} != want:
                    raise AssertionError(f"rank {r['rank']} launched {r['launches']}, "
                                         f"expected {want}")
        for a, b in zip(ranks, resumed):
            if b["restored"]["step"] != TWELVE_B_TP_STEPS or \
                    b["restored"]["digest"] != a["state_sha256"]:
                raise AssertionError(f"rank {a['rank']}: the restored state differs from the "
                                     f"saved one: {b['restored']} vs {a['state_sha256']}")
        losses = [h["loss"] for h in ranks[0]["history"]]
        init_loss = math.log(cfg.total_tokens) + cfg.n_embd * 0.02**2 / 2
        if abs(losses[0] - init_loss) > 0.1 or abs(losses[0] - single) > 2e-3:
            raise AssertionError(f"first loss {losses[0]} vs ln(vocab) + var/2 = {init_loss} "
                                 f"and the single-process port's {single} (atol 2e-3)")
        inits = [r["init"] for r in ranks]
        whole_bytes = 4 * whole_params
        unit_bytes = init_unit_bytes(dalle)
        # its blocks, one unit of the draw, and the allocator's rounding of
        # each leaf to 512 bytes
        bounds = [i["block_bytes"] + unit_bytes + 512 * i["leaves"] for i in inits]
        if not all(i["device_peak_bytes"] <= b for i, b in zip(inits, bounds)):
            raise AssertionError(f"a rank's init held more than its blocks and one unit: "
                                 f"{inits}, bounds {bounds} (whole tree {whole_bytes} bytes)")
        save = ranks[0]["saves"][-1]
        step_s = [1.0 / h["steps_per_sec"] for h in ranks[0]["history"][1:]]
        per_step = [r["collective_bytes_per_step"] for r in ranks]
        line = dict(
            card=card, config=TWELVE_B_CONFIG, label=TWELVE_B_TP_LABEL, ranks=TWELVE_B_TP_RANKS,
            mesh_shape=published["mesh_shape"], layout=published["layout"],
            resized_mesh=f"data:1,model:{TWELVE_B_TP_RANKS}", cut=TWELVE_B_TP_CUT,
            n_layers=L, n_embd=cfg.n_embd, heads=cfg.n_heads,
            heads_per_rank=cfg.n_heads // TWELVE_B_TP_RANKS, seq_len=cfg.total_seq_len,
            vocab=cfg.total_tokens, remat_policy=cfg.remat_policy,
            whole_tree_params=whole_params, whole_tree_fp32_bytes=whole_bytes,
            init_s_per_rank=[i["s"] for i in inits],
            init_block_bytes_per_rank=[i["block_bytes"] for i in inits],
            init_unit_bytes=unit_bytes, init_device_peak_bound_per_rank=bounds,
            init_device_bytes_per_rank=[i["device_bytes"] for i in inits],
            init_device_peak_bytes_per_rank=[i["device_peak_bytes"] for i in inits],
            init_drawn_elements_per_rank=[i["drawn_elements"] for i in inits],
            init_host_rss_before_per_rank=[i["host_rss_before"] for i in inits],
            init_host_rss_peak_per_rank=[i["host_rss_peak"] for i in inits],
            save_s_rank0=save["s"], save_host_rss_before_rank0=save["host_rss_before"],
            save_host_rss_peak_rank0=save["host_rss_peak"],
            restored_bytes_per_rank=[r["restored"]["restored_bytes"] for r in resumed],
            resume_bit_equal=True, losses=losses, single_process_first_loss=single,
            single_process_s=single_s,
            resumed_losses=[h["loss"] for h in resumed[0]["history"]],
            expected_init_loss=init_loss, step_s=step_s,
            collective_bytes_per_rank_per_step=per_step,
            peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in ranks],
            wall_s_per_rank=[r["wall_s"] for r in ranks], launch_wall_s=wall,
            packed_launches_per_rank=[{k: r["launches"][k] for k in names} for r in ranks],
        )
        print("train_12b_tp", json.dumps(line), flush=True)
        sampling = check_sample_12b(torch, card, out_dir, resume)
        return [{k: r["launches"][k] for k in names} for r in ranks], sampling
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_sample_12b(torch, card, out_dir, path) -> list[int]:
    """The 12B sampling's checks, after phase_train_12b_tp's ranks exit:
    the sampled tokens equal on every rank, and rank 0's prefill band logits
    within TWELVE_B_SAMPLE_ATOL of one process's on the card, which reads
    the whole checkpoint here. Prints the "sample_12b_tp" line; returns the
    prefill kernel's launches a rank."""
    from dalle_mtf_tpu_torch.quantize import cast_decode_weights  # noqa: PLC0415
    from dalle_mtf_tpu_torch.sample_dalle import load_dalle_params  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    reports, outs = [], []
    for r in range(TWELVE_B_TP_RANKS):
        with open(os.path.join(out_dir, f"sample_rank{r}.json")) as f:
            reports.append(json.load(f))
        outs.append(torch.load(os.path.join(out_dir, f"sample_rank{r}.pt"), weights_only=True))
    same = all(torch.equal(o["tokens"], outs[0]["tokens"]) for o in outs)
    params = fetch_model_params(path)
    gc.collect()
    torch.cuda.empty_cache()
    dalle, _ = make_dalle_models(params, "cuda")
    cfg = dalle.cfg
    t0 = time.perf_counter()
    weights = cast_decode_weights(load_dalle_params(params, dalle), cfg.policy.compute_dtype)
    lo = cfg.text_vocab_size
    with torch.inference_mode():
        want = dalle.prefill(weights, sample_texts(torch, cfg, TWELVE_B_SAMPLE_BATCH),
                             dalle.init_cache(TWELVE_B_SAMPLE_BATCH),
                             band=(lo, lo + cfg.image_vocab_size)).cpu()
    one_s = time.perf_counter() - t0
    del weights, dalle
    gc.collect()
    torch.cuda.empty_cache()
    got = outs[0]["prefill_logits"]
    err = (got - want).abs().max().item()
    layers = cfg.n_layers
    launches = [r["launches"]["causal_attention_fwd"] for r in reports]
    if not (same and err <= TWELVE_B_SAMPLE_ATOL and launches == [layers] * len(reports)
            and outs[0]["tokens"].shape == (TWELVE_B_SAMPLE_BATCH, TWELVE_B_SAMPLE_STEPS)):
        raise AssertionError(f"12B sampling: tokens equal on every rank {same}, shape "
                             f"{tuple(outs[0]['tokens'].shape)}; prefill logits against one "
                             f"process {err} (atol {TWELVE_B_SAMPLE_ATOL}); prefill launches "
                             f"{launches} (one a layer)")
    line = dict(
        card=card, label=TWELVE_B_TP_LABEL, config=TWELVE_B_CONFIG, cut=TWELVE_B_TP_CUT,
        ranks=TWELVE_B_TP_RANKS, batch=TWELVE_B_SAMPLE_BATCH,
        decode_steps=TWELVE_B_SAMPLE_STEPS, decode_steps_of_an_image=cfg.image_seq_len - 1,
        weights="bf16 (no quantization, the published arm)",
        sampling="temperature 1, top_k 64, one generator seeded alike on every rank",
        heads_per_rank=[r["heads"] for r in reports],
        band_columns_per_rank=[r["band_columns"] for r in reports],
        read_s_per_rank=[r["read_s"] for r in reports],
        read_bytes_per_rank=[r["read_bytes"] for r in reports],
        kv_cache_bytes_per_rank=[r["kv_cache_bytes"] for r in reports],
        prefill_s_per_rank=[r["prefill_s"] for r in reports],
        decode_ms_per_step_per_rank=[r["decode_ms_per_step"] for r in reports],
        collective_bytes_per_rank_per_step=[r["collective_bytes_per_step"] for r in reports],
        collective_calls_per_rank_per_step=[r["collective_calls_per_step"] for r in reports],
        prefill_collective_bytes_per_rank=[r["prefill_collective_bytes"] for r in reports],
        peak_gb_per_rank=[r["peak_gb"] for r in reports], prefill_launches_per_rank=launches,
        tokens_equal_on_every_rank=same, prefill_logits_max_abs_err=err,
        atol=TWELVE_B_SAMPLE_ATOL, one_process_read_and_prefill_s=one_s)
    print("sample_12b_tp", json.dumps(line), flush=True)
    return launches


TP_SERVE_LABEL = TP_LABEL
# dalle_coco as published, all 12 layers, but each batch decodes only its
# first TP_SERVE_STEPS of the image's 1023 decode steps (the tokens past the
# cut are 0): a step of ranks sharing the card waits on 2 gloo all_reduces a
# layer, each 1.0-3.2 ms through the loopback of the H100 host measured
# (tools/time_gloo_collectives.py), so a whole image took 75-92 s there (128
# steps a batch before the pipeline phase took its card time)
TP_SERVE_STEPS = 32
TP_SERVE_REQUESTS = (  # posted at once (n = 1, 1, 2: one batch of 4), then the first again
    {"text": "a red cube on a table", "n": 1, "temperature": 0.0, "top_k": 64},
    {"text": "two dogs playing in the snow", "n": 1, "temperature": 1.0, "top_k": 64},
    {"text": "a bowl of fruit", "n": 2, "temperature": 0.8, "top_k": 64},
)
# the values check: dalle_coco's width in fp32, 2 of its 12 layers, greedy
TP_SERVE_VALUES = dict(n_layers=2, bf_16=False)
TP_SERVE_FORCED = 16  # teacher-forced decode steps after the prefill
TP_SERVE_SEED = 21
TP_SERVE_LOGITS_ATOL = 1e-4  # fp32, 2 layers: the blocks' partial sums in another order


def tp_serve_values(torch, dalle, params, out_path=None) -> dict:
    """The values check's run of ``dalle`` (on a rank's blocks or whole):
    the prefill's banded logits and those of TP_SERVE_FORCED teacher-forced
    decode steps, then the greedy tokens of a whole image
    (``generate_image_tokens``: the captured loop on one process, the eager
    steps on a model group), on texts and forced tokens from TP_SERVE_SEED."""
    from dalle_mtf_tpu_torch import sample  # noqa: PLC0415

    cfg = dalle.cfg
    gen = torch.Generator().manual_seed(TP_SERVE_SEED)
    text = torch.randint(0, cfg.text_vocab_size, (BATCH, cfg.text_seq_len), generator=gen)
    forced = torch.randint(0, cfg.image_vocab_size, (TP_SERVE_FORCED, BATCH), generator=gen)
    text, forced = text.cuda(), forced.cuda()
    lo = cfg.text_vocab_size
    with torch.inference_mode():
        head = dalle.logits_head(params, (lo, lo + cfg.image_vocab_size))
        cache = dalle.init_cache(BATCH)
        logits = [dalle.prefill(params, text, cache, head=head)]
        for i, tok in enumerate(forced):
            logits.append(dalle.decode_step(params, cache, tok + lo, cfg.text_seq_len + i,
                                            head=head))
        del cache
        tokens = sample.generate_image_tokens(dalle, params, text,
                                              torch.Generator("cuda").manual_seed(0), 0.0)
    return dict(logits=torch.stack(logits).cpu(), tokens=tokens.cpu())


def worker_serve_tp(torch, out_dir, config):
    """One rank of phase_serve_tp: ``serve_dalle.build_server`` on the
    config at ``config`` (rank 0 serves HTTP; the other ranks follow), the
    kernel and collective counts reset just before it; rank 0 posts
    TP_SERVE_REQUESTS (three at once, then the first again) and drains.
    Each batch's decode loop runs its first TP_SERVE_STEPS steps, the
    image's tokens past them set to 0, timed with the collective bytes it
    moved. Then, in
    the same process group, the fp32 values check on the group
    (``tp_serve_values``). Writes <out_dir>/serve_rank<r>.json and
    values_rank<r>.pt."""
    import torch.distributed as dist  # noqa: PLC0415

    from dalle_mtf_tpu_torch import sample, serve, serve_dalle  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.parallel.mesh import build_mesh  # noqa: PLC0415
    from dalle_mtf_tpu_torch.parallel.tensor import COLLECTIVES  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    rank = int(os.environ["RANK"])
    loops = []
    run = sample.CapturedDecoder._run

    def timed_run(self, key, body, n):  # a batch's decode steps, cut
        steps = min(n, TP_SERVE_STEPS)
        torch.cuda.synchronize()
        b0, c0, t0 = COLLECTIVES["bytes"], COLLECTIVES["calls"], time.perf_counter()
        run(self, key, body, steps)
        torch.cuda.synchronize()
        # the last draw writes token ``steps``; the tokens after it are 0
        self.image[:, steps + 1:] = 0
        loops.append(dict(steps=steps, of=n, s=time.perf_counter() - t0,
                          collective_bytes=COLLECTIVES["bytes"] - b0,
                          collective_calls=COLLECTIVES["calls"] - c0))

    sample.CapturedDecoder._run = timed_run
    torch.cuda.set_device(0)  # the ranks share the card
    try:
        reset_counts(attn)
        COLLECTIVES.update(calls=0, bytes=0)
        torch.cuda.reset_peak_memory_stats(0)
        t0 = time.perf_counter()
        sampler, server = serve_dalle.build_server([
            "--model", config, "--device", "cuda", "--host", "127.0.0.1", "--port", "0",
            "--batch-size", str(BATCH), "--seed", "0", "--top_k", "64", "--linger-ms", "200"])
        report = dict(rank=rank, start_s=time.perf_counter() - t0)
        if server is None:
            serve.follow(sampler)
        else:
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            port = server.server_address[1]
            replies = [None] * len(TP_SERVE_REQUESTS)

            def send(i):
                replies[i] = post(port, TP_SERVE_REQUESTS[i])

            t1 = time.perf_counter()
            senders = [threading.Thread(target=send, args=(i,))
                       for i in range(len(TP_SERVE_REQUESTS))]
            for t in senders:
                t.start()
            for t in senders:
                t.join(timeout=600)
            again = post(port, TP_SERVE_REQUESTS[0])
            wall = time.perf_counter() - t1
            if any(r is None for r in replies):
                raise AssertionError("a request got no reply")
            check_pngs(replies + [again], sampler.vae.cfg.image_size)
            if again["images"] != replies[0]["images"]:
                raise AssertionError("two identical greedy requests differ")
            health, stats = get(port, "/healthz"), get(port, "/stats")
            stop_server(sampler, server, thread)
            report.update(latencies_s=[r["latency_s"] for r in replies], again_latency_s=
                          again["latency_s"], requests_wall_s=wall, health=health, stats=stats,
                          images=sum(len(r["images"]) for r in replies + [again]),
                          orders_sent=sampler._commands.sent)
        report.update(launches=dict(attn.KERNEL_LAUNCHES), loops=loops,
                      collective_calls=COLLECTIVES["calls"], collective_bytes=COLLECTIVES["bytes"],
                      peak_gb=torch.cuda.max_memory_allocated(0) / 1e9,
                      captured=sampler._decoder.captures, reason=sampler._decoder.eager_reason,
                      heads=list(sampler.dalle.heads), cache_shape=list(
                          sampler._decoder.cache["k"].shape))
        del sampler, server
        sample.CapturedDecoder._run = run
        gc.collect()
        torch.cuda.empty_cache()
        # the values check on the same group: fp32, 2 layers, weights from the seed
        cut = {**fetch_model_params(SERVE_CONFIG), **TP_SERVE_VALUES}
        mesh = build_mesh(cut["mesh_shape"], cut["layout"], "global", rank,
                          dist.get_world_size())
        dalle, _ = make_dalle_models(cut, "cuda", mesh)
        params = dalle.init(torch.Generator().manual_seed(TP_SERVE_SEED))
        torch.save(tp_serve_values(torch, dalle, params),
                   os.path.join(out_dir, f"values_rank{rank}.pt"))
        with open(os.path.join(out_dir, f"serve_rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        sample.CapturedDecoder._run = run
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_serve_tp(torch, card) -> list[dict]:
    """Sharded serving, the slice's main path: configs/dalle_coco.json as
    published (n_embd 1024, 12 layers, 8 heads of 128, bf16), each batch's
    decode cut to TP_SERVE_STEPS steps, with its data:16,model:2 and layout
    resized to data:1,model:2, and
    configs/vae_coco.json, weights from ``--seed``, through
    ``serve_dalle.build_server`` under ``run_ranks`` of 2 ranks
    sharing the card over gloo (``worker_serve_tp``): the whole-batch engine
    at batch 4, rank 0 answering HTTP, rank 1 following. Checks every reply's
    PNGs, a greedy repeat, the stop reaching the follower, the prefill
    kernel's launches (n_layers a batch and the warm-up's prefill on each
    rank, on its 4 heads), and
    the fp32 values check: prefill and teacher-forced logits within
    TP_SERVE_LOGITS_ATOL of one process on the card on the same weights,
    the same on both ranks bit for bit, and greedy tokens over a whole
    image equal to one process's (run here after the ranks exit). Prints
    the "serve_tp" line; returns each rank's prefill launches."""
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_tp_")
    try:
        published = fetch_model_params(SERVE_CONFIG)
        config = serve_config(out_dir, decode_kernels=False)
        t0 = time.perf_counter()
        run_ranks([os.path.join(HERE, "chip_smoke.py"), "--ring-worker", "serve_tp", out_dir,
                   config], 900, TP_RANKS)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(TP_RANKS):
            with open(os.path.join(out_dir, f"serve_rank{r}.json")) as f:
                ranks.append(json.load(f))
        values = [torch.load(os.path.join(out_dir, f"values_rank{r}.pt"), weights_only=True)
                  for r in range(TP_RANKS)]
        layers = published["n_layers"]
        batches = ranks[0]["stats"]["batches_done"]
        for r in ranks:  # a prefill a batch, and the warm-up's on every rank
            if r["launches"]["causal_attention_fwd"] != layers * (batches + 1):
                raise AssertionError(f"rank {r['rank']} launched the prefill kernel "
                                     f"{r['launches']}, not {layers} x ({batches} batches + "
                                     f"the warm-up)")
            if r["captured"] or len(r["loops"]) != batches:
                raise AssertionError(f"rank {r['rank']}: captured {r['captured']}, decode "
                                     f"loops {r['loops']}")
        if ranks[0]["heads"] == ranks[1]["heads"] or batches != 2:
            raise AssertionError(f"heads {[r['heads'] for r in ranks]}, {batches} batches "
                                 f"(the three requests, the repeat)")
        # one process on the card, the same fp32 weights
        cut = {**published, **TP_SERVE_VALUES}
        dalle, _ = make_dalle_models(cut, "cuda")
        one = tp_serve_values(torch, dalle, dalle.init(torch.Generator().manual_seed(
            TP_SERVE_SEED)))
        del dalle
        gc.collect()
        torch.cuda.empty_cache()
        err = (values[0]["logits"] - one["logits"]).abs().max().item()
        same_ranks = all(torch.equal(v["logits"], values[0]["logits"])
                         and torch.equal(v["tokens"], values[0]["tokens"]) for v in values)
        differ = (values[0]["tokens"] != one["tokens"]).nonzero().tolist()
        if not (err <= TP_SERVE_LOGITS_ATOL and same_ranks and not differ):
            raise AssertionError(f"serve_tp values: logits max_abs_err {err} (atol "
                                 f"{TP_SERVE_LOGITS_ATOL}); the ranks agree: {same_ranks}; "
                                 f"greedy tokens differ from one process's at {differ[:5]}")
        steps = [x for r in ranks for x in r["loops"]]
        per_rank = [[dict(ms_per_step=x["s"] / x["steps"] * 1e3,
                          collective_bytes_per_step=x["collective_bytes"] / x["steps"],
                          collective_calls_per_step=x["collective_calls"] / x["steps"])
                     for x in r["loops"]] for r in ranks]
        line = dict(
            card=card, label=TP_SERVE_LABEL, config=SERVE_CONFIG, vae=published["vae_model"],
            ranks=TP_RANKS, mesh_shape=published["mesh_shape"], layout=published["layout"],
            resized_mesh=f"data:1,model:{TP_RANKS}", n_layers=layers,
            cut=f"each batch decodes {TP_SERVE_STEPS} of its {steps[0]['of']} decode steps, "
                f"the tokens past them 0",
            n_embd=published["n_embd"], heads_per_rank=[r["heads"] for r in ranks],
            cache_shape_per_rank=[r["cache_shape"] for r in ranks], batch=BATCH,
            engine="whole-batch", requests=list(TP_SERVE_REQUESTS),
            latencies_s=ranks[0]["latencies_s"], batch_latency_s=ranks[0]["again_latency_s"],
            requests_wall_s=ranks[0]["requests_wall_s"], images=ranks[0]["images"],
            batches=batches, orders_sent=ranks[0]["orders_sent"],
            decode_steps_per_batch=steps[0]["steps"], decode_per_rank=per_rank,
            decode_ms_per_step=[p["ms_per_step"] for p in per_rank[0]],
            collective_bytes_per_rank_per_step=[p["collective_bytes_per_step"]
                                                for p in per_rank[0]],
            peak_gb_per_rank=[r["peak_gb"] for r in ranks],
            start_s_per_rank=[r["start_s"] for r in ranks], launch_wall_s=wall,
            captured=ranks[0]["captured"], captured_reason=ranks[0]["reason"],
            prefill_launches_per_rank=[r["launches"]["causal_attention_fwd"] for r in ranks],
            values=dict(config=f"{SERVE_CONFIG} {TP_SERVE_VALUES}, weights from seed "
                               f"{TP_SERVE_SEED}", forced_steps=TP_SERVE_FORCED,
                        logits_max_abs_err=err, atol=TP_SERVE_LOGITS_ATOL,
                        ranks_bit_equal=same_ranks, greedy_tokens_equal_one_process=True,
                        tokens=list(one["tokens"].shape)),
        )
        print("serve_tp", json.dumps(line), flush=True)
        return [r["launches"]["causal_attention_fwd"] for r in ranks]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def init_unit_bytes(dalle) -> int:
    """The fp32 bytes of the largest piece ``DALLE.init`` draws at once: a
    layer of a leaf, cut along its unit dim (``INIT_UNITS``) where it has
    one."""
    from dalle_mtf_tpu_torch.models.dalle import INIT_UNITS  # noqa: PLC0415
    from dalle_mtf_tpu_torch.parallel.mesh import LAYERS  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415

    axes = dict(named_leaves(dalle.logical_axes()))
    return 4 * max(math.prod(min(n, INIT_UNITS.get(a, n)) for n, a in zip(shape, axes[path])
                             if a != LAYERS)
                   for path, shape in _shape_leaves(dalle.param_shapes(whole=True)))


def _shape_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _shape_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def png_shape(b64: str) -> tuple[int, int, int]:
    """Decode a PNG with the standard library; return (H, W, C)."""
    data = base64.b64decode(b64)
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
            ">I", data[pos + 8 + n:pos + 12 + n]
        )[0]:
            raise AssertionError(f"bad CRC in PNG chunk {kind!r}")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = ihdr[:4]
    if (depth, color) != (8, 2):
        raise AssertionError(f"expected 8-bit RGB, got depth {depth} color {color}")
    raw = zlib.decompress(idat)
    if len(raw) != h * (1 + 3 * w):
        raise AssertionError("PNG pixel data has the wrong size")
    return h, w, 3


def post(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.load(r)


def get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.load(r)


def phase_slice(torch, attn, card):
    from dalle_mtf_tpu_torch.data.tokenizer import get_tokenizer, pad_or_truncate
    from dalle_mtf_tpu_torch.models.dalle import DALLE
    from dalle_mtf_tpu_torch.quantize import cast_decode_weights
    from dalle_mtf_tpu_torch.serve import BatchingSampler, make_server
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params

    params = fetch_model_params(SERVE_CONFIG)
    dalle, vae = make_dalle_models(params, "cuda")
    cfg = dalle.cfg
    side = vae.cfg.image_size
    t0 = time.perf_counter()
    master = dalle.init(torch.Generator().manual_seed(0))
    vae_params = vae.init(torch.Generator().manual_seed(1))
    serve_params = cast_decode_weights(master, cfg.policy.compute_dtype)
    torch.cuda.synchronize()
    print(f"slice: {params['config_name']} n_embd={cfg.n_embd} layers={cfg.n_layers} "
          f"heads={cfg.n_heads} S={cfg.total_seq_len} vocab={cfg.total_tokens} "
          f"image_vocab={cfg.image_vocab_size} bf16={cfg.bf_16}; weights from "
          f"seed in {time.perf_counter() - t0:.1f}s", flush=True)

    # --- banded prefill logits on the card vs the plain path on the CPU, fp32
    tokenizer = get_tokenizer()
    texts = ["a red cube on a table", "two dogs playing in the snow"]
    tokens = torch.tensor([
        pad_or_truncate(tokenizer.encode(t), cfg.text_seq_len, tokenizer.pad_token_id)
        for t in texts
    ])
    band = (cfg.text_vocab_size, cfg.text_vocab_size + cfg.image_vocab_size)
    cpu32 = DALLE(dataclasses.replace(cfg, bf_16=False), "cpu")
    gpu32 = DALLE(dataclasses.replace(cfg, bf_16=False), "cuda")
    master_cpu = {k: (v.cpu() if not isinstance(v, dict)
                      else {n: t.cpu() for n, t in v.items()})
                  for k, v in master.items()}
    with torch.inference_mode():
        want = cpu32.prefill(master_cpu, tokens, cpu32.init_cache(2), band=band)
        got32 = gpu32.prefill(master, tokens.cuda(), gpu32.init_cache(2), band=band)
        got16 = dalle.prefill(serve_params, tokens.cuda(), dalle.init_cache(2), band=band)
    err32 = (got32.cpu() - want).abs().max().item()
    err16 = (got16.cpu() - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"prefill logits [2, {band[1] - band[0]}] vs CPU fp32 plain path: "
          f"card fp32 max_abs_err {err32:.3g} (atol 1e-3), card bf16 serving "
          f"weights max_abs_err {err16:.3g} (atol 0.1; |logits| max {scale:.3g})",
          flush=True)
    if not (err32 <= 1e-3 and err16 <= 0.1 and torch.isfinite(got16).all()):
        raise AssertionError("prefill logits disagree with the CPU fp32 plain path")

    # --- the server: BatchingSampler + HTTP, every kernel launch counted
    sampler = BatchingSampler(
        dalle, serve_params, vae, vae_params, batch_size=BATCH, top_k=64,
        linger_ms=100.0, seed=0,
    )
    server = make_server(sampler, tokenizer, cfg.text_seq_len,
                         host="127.0.0.1", port=0, timeout_s=600)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        batches_before = sampler.stats()["batches_done"]
        for key in attn.KERNEL_LAUNCHES:
            attn.KERNEL_LAUNCHES[key] = 0
        t0 = time.perf_counter()
        greedy = {"text": texts[0], "n": 2, "temperature": 0.0, "top_k": 0}
        mixed = [
            greedy,
            {"text": texts[1], "n": 2, "temperature": 1.0, "top_k": 64},
            {"text": texts[1], "n": 2, "temperature": 0.7, "top_k": 40},
            {"text": "a bowl of fruit", "n": 2, "temperature": 0.8, "top_k": 16,
             "top_p": 0.9},
        ]
        replies = [None] * len(mixed)

        def send(i):
            replies[i] = post(port, mixed[i])

        senders = [threading.Thread(target=send, args=(i,)) for i in range(len(mixed))]
        for s in senders:
            s.start()
        for s in senders:
            s.join(timeout=900)
        again = post(port, greedy)  # a later batch: greedy must repeat exactly
        wall = time.perf_counter() - t0
        launches = attn.KERNEL_LAUNCHES["causal_attention_fwd"]
        batches = sampler.stats()["batches_done"] - batches_before
        if any(r is None for r in replies):
            raise AssertionError("a request got no reply")
        pngs = [im for r in replies + [again] for im in r["images"]]
        for im in pngs:
            if png_shape(im) != (side, side, 3):
                raise AssertionError(f"an image is not {side}x{side}x3")
        if again["images"] != replies[0]["images"]:
            raise AssertionError("two identical greedy requests differ")
        if launches != cfg.n_layers * batches or batches == 0:
            raise AssertionError(
                f"kernel launches {launches} != n_layers {cfg.n_layers} x "
                f"batches {batches}"
            )
        if get(port, "/healthz")["status"] != "ok":
            raise AssertionError("/healthz")
        stats = get(port, "/stats")
        if stats["batches_done"] != batches_before + batches:
            raise AssertionError(f"/stats: {stats}")
        print(f"served {len(pngs)} images in {len(replies) + 1} requests, "
              f"{batches} batches, {wall:.2f}s; kernel launches {launches} = "
              f"{cfg.n_layers} layers x {batches} batches; latencies "
              f"{[r['latency_s'] for r in replies + [again]]}; stats {stats}",
              flush=True)
    finally:
        server.shutdown()
        server.server_close()
        sampler.drain(timeout=600)
    if sampler._worker.is_alive():
        raise AssertionError("sampler worker did not stop")

    return launches, dict(dalle=dalle, params=serve_params, vae=vae, vae_params=vae_params,
                          tokens=tokens, texts=texts)


def timed(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def profile_replays(torch, decoder, key, replays: int = PROFILED_REPLAYS,
                    attempts: int = 5) -> dict:
    """The host's time to enqueue a replay of the decoder's graph ``key``
    against the wall time of one (4 x ``replays`` back to back, no
    profiler); then ``replays`` replays under torch.profiler
    (from a fresh prefill's positions; two replays before them let the
    profiler settle: a wait and a warm-up step of its schedule, not
    recorded): device ops a step, the device's busy ms a step and its busy
    share of the window's wall time, the decode matmuls' ms a step, and
    their kernel events held to the launches the counters say the replays
    made.

    The profiler now and then loses some of a window's device events
    (once 3 of its 1168 decode matmuls, once 564 of the einsum form's
    14,128 events). It keeps only the events whose times, put on the
    host's clock, lie inside its window, so the host idles
    ``PROFILE_EDGE_S`` between each edge of the window and the replays;
    a trace that still lost decode-matmul events is reported and taken
    again, as ``device_profile`` does, ``attempts`` times at most. A graph
    replays the same kernels every time, so a counter that disagrees with
    them fails every attempt."""
    from torch.profiler import ProfilerActivity, profile, schedule  # noqa: PLC0415

    cfg = decoder.dalle.cfg
    graph = decoder._graphs[key]
    per_replay = sum(decoder.launches_per_replay(key).values())

    def reset():
        with torch.inference_mode():
            decoder.positions.fill_(cfg.text_seq_len)
            decoder.step.zero_()
        torch.cuda.synchronize()

    # unprofiled: the host's time to enqueue a replay against the card's
    # time to run one (one step a graph is enough while the first is far
    # the smaller)
    reset()
    t0 = time.perf_counter()
    for _ in range(4 * replays):
        graph.replay()
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    ran = time.perf_counter() - t0
    for attempt in range(attempts):
        reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=1, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                prof.step()
            time.sleep(PROFILE_EDGE_S)
            t0 = time.perf_counter()
            for _ in range(replays):
                graph.replay()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_EDGE_S)
            prof.step()
        # the schedule's step annotation lies on the device's timeline too: not work
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")]
        mm = [e for e in device if "decode_matmul" in e.name]
        if len(mm) == per_replay * replays:
            break
        print(f"profile_replays: the profiler's trace lost device events (attempt "
              f"{attempt + 1}: {len(device)} device events, {len(mm)} decode matmuls, "
              f"launched {per_replay * replays}); taken again", flush=True)
    else:
        raise AssertionError(f"the profiler saw {len(mm)} decode-matmul kernels over {replays} "
                             f"replays in each of {attempts} traces; the counters say "
                             f"{per_replay} a replay")
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e6
    span = (max(e.time_range.end for e in device)
            - min(e.time_range.start for e in device)) / 1e6 if device else 0.0
    return dict(replays=replays, traces=attempt + 1, device_ops_per_step=len(device) / replays,
                device_busy_ms_per_step=busy / replays * 1e3,
                decode_matmul_kernels_ms_per_step=sum(e.time_range.elapsed_us() for e in mm)
                / replays / 1e3,
                decode_matmul_events=len(mm), launches_per_replay=per_replay,
                profiled_wall_ms_per_step=wall / replays * 1e3,
                device_busy_share=busy / wall if device else None,
                device_span_ms_per_step=span / replays * 1e3,
                busy_share_of_device_span=busy / span if device else None,
                enqueue_ms_per_replay=enqueued / (4 * replays) * 1e3,
                unprofiled_ms_per_replay=ran / (4 * replays) * 1e3)


def draws_advance(torch, decoder) -> int:
    """Replay the greedy bucket's graph 40 times from flat logits at
    temperature 1 (the logits, position and step put back before each):
    the registered generator must move on at every replay, so the draws
    spread over the band. Returns the distinct tokens drawn."""
    cfg = decoder.dalle.cfg
    graph = decoder._graphs[("batch", 0, False)]
    draws = []
    with torch.inference_mode():
        decoder.temperature.fill_(1.0)
        for _ in range(40):
            decoder.logits.zero_()
            decoder.positions.fill_(cfg.text_seq_len)
            decoder.step.zero_()
            graph.replay()
            draws.append(int(decoder.image[0, 0]))
    if len(set(draws)) <= 30:  # 40 uniform draws over the 2048-token band
        raise AssertionError(f"captured draws do not advance across replays: {draws}")
    return len(set(draws))


def captured_batch(torch, card, label, dalle, params, vae, vae_params, text4,
                   eager_steps: int | None) -> dict:
    """One weight form's whole-batch generation at batch 4 through the
    captured decode loop (``sample.CapturedDecoder``), against the eager
    loop on the same inputs:

    - greedy: the first call captures the graph (timed apart), the second
      is timed; its tokens bit-equal to ``generate_image_tokens_eager``'s
      over ``eager_steps`` steps (None: the whole image, timed as the
      eager "before" batch);
    - sampled (temperature 1, top_k 64), the served path
      (``generate_images``' tokens, then VAE) timed after its bucket's capture, split into
      prefill, decode loop and VAE (host clock around work that ends in a
      synchronize); whether its first EAGER_STEPS tokens equal the eager
      loop's from the same seed (reported, not required);
    - a profiled window of replays (``profile_replays``)."""
    from dalle_mtf_tpu_torch import sample  # noqa: PLC0415

    cfg = dalle.cfg
    side = vae.cfg.image_size
    n_ref = cfg.image_seq_len if eager_steps is None else eager_steps
    zeros = torch.zeros((BATCH,), device="cuda")
    ones = torch.ones((BATCH,), device="cuda")
    band = (cfg.text_vocab_size, cfg.text_vocab_size + cfg.image_vocab_size)
    dec = sample.CapturedDecoder(dalle, params, BATCH)
    with torch.inference_mode():
        _, capture_s = timed(torch, lambda: dec.generate(text4, zeros, 0))
        greedy, greedy_s = timed(torch, lambda: dec.generate(text4, zeros, 0).clone())
        want, eager_s = timed(torch, lambda: sample.generate_image_tokens_eager(
            dalle, params, text4, torch.Generator("cuda").manual_seed(0), zeros, 0,
            steps=n_ref))
        if not torch.equal(greedy[:, :n_ref], want):
            bad = (greedy[:, :n_ref] != want).nonzero()[0].tolist()
            raise AssertionError(f"{label}: captured greedy tokens differ from the eager "
                                 f"loop's first at (row, step) {bad}")
        draws = draws_advance(torch, dec) if label == "bf16" else None
        prof = profile_replays(torch, dec, ("batch", 0, False))

        dec.generate(text4, ones, 64)  # captures the sampled bucket

        def served():  # generate_images: the tokens, then the VAE
            tokens = sample.generate_image_tokens(
                dalle, params, text4, torch.Generator("cuda").manual_seed(1), ones, 64,
                decoder=dec)
            return tokens, vae.decode_tokens(vae_params, tokens)

        (sampled, imgs), total = timed(torch, served)
        ref = sample.generate_image_tokens_eager(
            dalle, params, text4, torch.Generator("cuda").manual_seed(1), ones, 64,
            steps=EAGER_STEPS)
        sampled_equal = bool(torch.equal(sampled[:, :EAGER_STEPS], ref))
        head = dalle.logits_head(params, band)
        _, t_prefill = timed(torch, lambda: dalle.prefill(
            params, text4, dalle.init_cache(BATCH), head=head))
        _, t_vae = timed(torch, lambda: vae.decode_tokens(vae_params, sampled))
    distinct = sampled.unique().numel()
    if imgs.shape != (BATCH, side, side, 3) or not torch.isfinite(imgs).all():
        raise AssertionError(f"{label}: generate_images gave {tuple(imgs.shape)}")
    if distinct < 64:
        raise AssertionError(f"{label}: a sampled batch drew only {distinct} distinct tokens")
    steps = cfg.image_seq_len - 1
    split = dict(card=card, weights=label, path="captured CUDA graphs", batch=BATCH,
                 latency_s=total, images_per_s=BATCH / total, prefill_s=t_prefill, vae_s=t_vae,
                 decode_loop_s=total - t_prefill - t_vae, decode_steps=steps,
                 decode_ms_per_step=(total - t_prefill - t_vae) / steps * 1e3,
                 first_call_with_capture_s=capture_s, greedy_tokens_s=greedy_s,
                 greedy_bit_equal_steps=n_ref, eager_steps=n_ref, eager_s=eager_s,
                 eager_ms_per_step=eager_s / n_ref * 1e3,
                 sampled_equal_to_eager_steps=EAGER_STEPS if sampled_equal else 0,
                 sampled_distinct_tokens=distinct, distinct_draws_of_40_replays=draws,
                 **{f"profile_{k}": v for k, v in prof.items()})
    if eager_steps is None:  # the eager loop over the whole image: the "before"
        split.update(eager_latency_s=eager_s + t_vae, eager_images_per_s=BATCH / (eager_s + t_vae),
                     eager_decode_loop_s=eager_s - t_prefill)
    print("batch", json.dumps(split), flush=True)
    del dec
    return split


def decode_profile(torch, card, label, dalle, params, text4, wall_ms_per_step: float,
                   steps: int = 16, names=("decode_matmul",)):
    """A window of EAGER decode steps (``decode_step`` dispatched from
    Python, the loop before capture) under torch.profiler: device ops per
    step, the device ms a step of the kernels named ``names`` and the
    device's busy share (null when the profiler saw no device work)."""
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    cfg = dalle.cfg
    band = (cfg.text_vocab_size, cfg.text_vocab_size + cfg.image_vocab_size)
    with torch.inference_mode():
        head = dalle.logits_head(params, band)
        cache = dalle.init_cache(BATCH)
        logits = dalle.prefill(params, text4, cache, head=head)
        tok = logits.argmax(-1) + cfg.text_vocab_size
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                dalle.decode_step(params, cache, tok, cfg.text_seq_len + i, head=head)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e6
    mm = sum(e.time_range.elapsed_us() for e in device if any(n in e.name for n in names)) / 1e6
    print("decode_profile", json.dumps(dict(
        card=card, weights=label, path="eager loop", steps=steps,
        device_ops_per_step=len(device) / steps,
        device_busy_ms_per_step=busy / steps * 1e3,
        decode_matmul_kernels_ms_per_step=mm / steps * 1e3,
        profiled_wall_ms_per_step=wall / steps * 1e3,
        unprofiled_wall_ms_per_step=wall_ms_per_step,
        device_busy_share=busy / wall if device else None,
    )), flush=True)


def continuous_chunks(torch, card, dalle, params, text4) -> dict:
    """The continuous engine's captured chunk (``CapturedDecoder.decode_chunk``,
    CHUNK replays of its k_max graph) against ``decode_chunk_eager`` from the
    same state: rows 0-1 admitted, a greedy chunk (whose first call captures
    the graph with live rows, the warm-up's changes put back), then rows
    2-3 admitted at the text end while 0-1 sit CHUNK steps in, a chunk with
    per-row sampling (rows 1 and 2 sampled, 0 and 3 greedy). Greedy rows'
    tokens, the active flags, the positions and the greedy rows' logits
    bit-equal; the sampled rows' equality reported."""
    import numpy as np  # noqa: PLC0415

    from dalle_mtf_tpu_torch import sample  # noqa: PLC0415

    dec = sample.CapturedDecoder(dalle, params, BATCH, chunk=CHUNK)
    dec.reset(0)
    cases = [  # (admitted rows, temperature, top_k, top_p)
        ([True, True, False, False], [0.0] * 4, [0] * 4, [1.0] * 4),
        ([False, False, True, True], [0.0, 1.0, 0.8, 0.0], [0, 64, 16, 0], [1.0, 1.0, 0.9, 1.0]),
    ]
    out = dict(card=card, weights="int8_kernels", chunk=CHUNK, chunks=[])
    for c, (mask, temps, ks, ps) in enumerate(cases):
        temps, ks, ps = (np.asarray(temps, np.float32), np.asarray(ks, np.int64),
                         np.asarray(ps, np.float32))
        with torch.inference_mode():
            dec.admit(text4, torch.tensor(mask, device="cuda"))
            cache = {k: v.clone() for k, v in dec.cache.items()}
            logits, pos = dec.logits.clone(), dec.positions.clone()
        dec.generator.manual_seed(c)
        (tok, act), captured_s = timed(torch, lambda: dec.decode_chunk(temps, ks, ps, k_max=256))
        (e_logits, e_pos, e_tok, e_act), eager_s = timed(torch, lambda: sample.decode_chunk_eager(
            dalle, params, cache, logits, pos, torch.Generator("cuda").manual_seed(c),
            torch.from_numpy(temps).cuda(), torch.from_numpy(ks).cuda(), chunk=CHUNK,
            k_max=256, top_p_rows=torch.from_numpy(ps).cuda(), head=dec.head))
        greedy = torch.from_numpy(temps <= 0).cuda()
        if not (torch.equal(tok[:, greedy], e_tok[:, greedy]) and torch.equal(act, e_act)
                and torch.equal(dec.positions, e_pos)
                and torch.equal(dec.logits[greedy], e_logits[greedy])):
            raise AssertionError(f"continuous chunk {c}: the captured chunk differs from "
                                 "decode_chunk_eager on its greedy rows")
        out["chunks"].append(dict(
            admitted=mask, greedy_rows_bit_equal=True,
            sampled_rows_equal=bool(torch.equal(tok[:, ~greedy], e_tok[:, ~greedy])),
            positions=dec.positions.tolist(), captured_s=captured_s, eager_s=eager_s,
            includes_capture=c == 0))
        del cache
    out["replays"] = {"/".join(map(str, k)): v for k, v in dec.replays.items()}
    print("continuous_chunk", json.dumps(out), flush=True)
    return out


def quantize_columns(torch, w, qmax):
    """Per-column (axis 0) int8 values and fp32 scales, as quantize.py."""
    scale = (w.abs().amax(0, keepdim=True) / qmax).clamp_min(1e-12)
    return torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8), scale


def decode_case(torch, dmm, name, kind, x, w):
    """The inputs of ``kind`` ("int8_matmul" or "int4_matmul") at decode
    shape ``name`` from bf16 x [M, K] and fp32 w [K, N]: (wrapper, plain
    version, x operands, int8 or packed weight, scale, the bf16 dequantized
    [K, N] weight that ``torch.matmul`` takes)."""
    from dalle_mtf_tpu_torch.quantize import pack_int4  # noqa: PLC0415

    m, k = x.shape
    n = w.shape[1]
    int4 = kind == "int4_matmul"
    q, scale = quantize_columns(torch, w, 7.0 if int4 else 127.0)
    deq = q.to(torch.bfloat16) * scale.to(torch.bfloat16)
    if not int4:
        return dmm.int8_matmul, dmm.int8_matmul_reference, (x,), q, scale, deq
    if name == "wo":  # packed per head along D: rows (h, d) of [H*D, E]
        packed = pack_int4(q.view(DECODE_HEADS, DECODE_HEAD_DIM, n), 1).reshape(-1, n)
        xh = x.view(m, DECODE_HEADS, DECODE_HEAD_DIM)
        xs = (xh[..., : DECODE_HEAD_DIM // 2].reshape(m, -1).contiguous(),
              xh[..., DECODE_HEAD_DIM // 2:].reshape(m, -1).contiguous())
    else:
        packed = pack_int4(q, 0)
        xs = (x[:, : k // 2].contiguous(), x[:, k // 2:].contiguous())
    return dmm.int4_matmul, dmm.int4_matmul_reference, xs, packed, scale, deq


def decode_resources(dmm) -> None:
    """A "resources" line for each built decode-matmul instantiation, at a
    slice of a whole chunk in clusters of 8 and at each decode shape's plan."""
    for int4, aligned in dmm.INSTANTIATIONS:
        print("resources", json.dumps(dict(
            kernels="decode matmul", int4=int4, aligned=aligned, k_slice=dmm.MAX_PASSES
            * dmm.ROWS_PER_PASS, cluster=dmm.MAX_CLUSTER, **dmm.kernel_resources(int4, aligned))),
            flush=True)
    for name, m, k, n in DECODE_SHAPES:
        for int4 in (False, True):
            kp = k // 2 if int4 else k
            walk = dmm.plan(kp, int4)
            aligned = n % 16 == 0
            print("resources", json.dumps(dict(
                kernels="decode matmul", shape=name, int4=int4, aligned=aligned,
                **walk._asdict(), ctas=dmm.ctas(walk, m, n),
                **dmm.kernel_resources(int4, aligned, walk.k_slice, walk.splits))), flush=True)


def phase_decode_kernels(torch, dmm, card):
    """int8_matmul and int4_matmul against their plain versions at the
    decode shapes, two runs bit-equal, one kernel event a call; returns
    {name: row at the mlp1 shape at M = 4}."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    best = {}
    for name, m, k, n in DECODE_SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
        for kind in ("int8_matmul", "int4_matmul"):
            fn, ref, xs, packed, scale, deq = decode_case(torch, dmm, name, kind, x, w)
            before = dmm.KERNEL_LAUNCHES[kind]
            got = fn(*xs, packed, scale)
            again = fn(*xs, packed, scale)
            want = ref(*xs, packed, scale)
            torch.cuda.synchronize()
            if dmm.KERNEL_LAUNCHES[kind] != before + 2:
                raise AssertionError(f"{kind} did not count its launches")
            err = (got - want).abs().max().item()
            tol = 1e-5 * want.abs().max().item()
            if not err <= tol or got.shape != (m, n):
                raise AssertionError(f"{kind} {name}: max_abs_err {err} > {tol}")
            if not same_bits((got,), (again,)):
                raise AssertionError(f"{kind} {name}: two runs differ")
            # copies past the L2: every timed launch reads its weight cold
            copies = max(1, math.ceil(2 * L2_BYTES / packed.numel()))
            ws = [(packed.clone(), scale.clone()) for _ in range(copies)]
            lib_copies = max(1, math.ceil(2 * L2_BYTES / (2 * deq.numel())))
            ds = [deq.clone() for _ in range(lib_copies)]

            def call(i):
                return fn(*xs, *ws[i])

            times = dict(
                ms=kernel_device_ms(torch, call, copies, DECODE_ITERS, ("decode_matmul",), 1),
                wall_ms=cuda_ms_rotating(call, copies, DECODE_ITERS),
                plain_ms=device_ms_rotating(torch, lambda i: ref(*xs, *ws[i]), copies, 20),
                library_ms=device_ms_rotating(
                    torch, lambda i: torch.matmul(x, ds[i % lib_copies]), copies,
                    DECODE_ITERS))
            nbytes = packed.numel() + x.numel() * 2 + scale.numel() * 4 + m * n * 4
            walk = dmm.plan(packed.shape[0], kind == "int4_matmul")
            row = dict(card=card, kernel=kind, shape=name, M=m, K=k, N=n,
                       weight_bytes=packed.numel(), max_abs_err=err, atol=tol,
                       bit_equal_runs=True, **times, **roofline(2 * m * k * n, nbytes),
                       weight_copies=copies, plan=walk._asdict(),
                       ctas=dmm.ctas(walk, m, n))
            print("kernel", json.dumps(row), flush=True)
            if name == "mlp1":
                best[kind] = row
            del ws, ds
        torch.cuda.empty_cache()
    return best


def serve_config(tmp: str, **over) -> str:
    """A copy of configs/dalle_coco.json with the decode kernels on (and
    ``over``'s fields)."""
    from dalle_mtf_tpu_torch.utils.config import _resolve_config_path  # noqa: PLC0415

    with open(_resolve_config_path(SERVE_CONFIG)) as f:
        cfg = json.load(f)
    cfg.update({"decode_kernels": True, "model_path": os.path.join(tmp, "serve"), **over})
    path = os.path.join(tmp, f"{SERVE_CONFIG}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def start_server(serve_dalle, argv):
    """build_server + a thread running serve_forever; returns (sampler,
    server, thread, port, seconds to load and warm)."""
    t0 = time.perf_counter()
    sampler, server = serve_dalle.build_server(argv + [
        "--device", "cuda", "--host", "127.0.0.1", "--port", "0",
        "--batch-size", str(BATCH), "--seed", "0"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return sampler, server, thread, server.server_address[1], time.perf_counter() - t0


def stop_server(sampler, server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=60)
    sampler.drain(timeout=600)
    if thread.is_alive() or sampler._worker.is_alive():
        raise AssertionError("the server or its engine did not stop")


def reset_counts(*modules):
    for mod in modules:
        for key in mod.KERNEL_LAUNCHES:
            mod.KERNEL_LAUNCHES[key] = 0


def check_pngs(replies, side):
    for r in replies:
        for im in r["images"]:
            if png_shape(im) != (side, side, 3):
                raise AssertionError(f"an image is not {side}x{side}x3")


def phase_quant_serving(torch, attn, dmm, card, mode, config, texts):
    """``serve_dalle --quantize <mode>`` with the decode kernels: prefill
    logits against the CPU plain path, then HTTP with every launch counted.
    Returns what later phases need."""
    from dalle_mtf_tpu_torch import serve_dalle  # noqa: PLC0415
    from dalle_mtf_tpu_torch.models.dalle import DALLE  # noqa: PLC0415
    from dalle_mtf_tpu_torch.data.tokenizer import get_tokenizer, pad_or_truncate  # noqa: PLC0415
    from dalle_mtf_tpu_torch.sample import WARMUP_STEPS  # noqa: PLC0415

    kind = f"{mode}_matmul"
    sampler, server, thread, port, load_s = start_server(
        serve_dalle, ["--model", config, "--quantize", mode, "--top_k", "64",
                      "--linger-ms", "300"])
    dalle, qparams = sampler.dalle, sampler._params[0]
    cfg = dalle.cfg
    side = sampler.vae.cfg.image_size
    try:
        if not (cfg.decode_kernels and qparams["layers"]["w_mlp1"].dtype == torch.int8):
            raise AssertionError(f"{mode}: the served weights are not quantized for the kernels")
        # --- banded prefill logits: card (kernel head) vs CPU (plain) on the same weights
        tokenizer = get_tokenizer()
        tokens = torch.tensor([pad_or_truncate(tokenizer.encode(t), cfg.text_seq_len,
                                               tokenizer.pad_token_id) for t in texts])
        band = (cfg.text_vocab_size, cfg.text_vocab_size + cfg.image_vocab_size)
        cfg32 = dataclasses.replace(cfg, bf_16=False)
        cpu_params = _to(qparams, "cpu")
        with torch.inference_mode():
            want = DALLE(cfg32, "cpu").prefill(cpu_params, tokens,
                                               DALLE(cfg32, "cpu").init_cache(2), band=band)
            before = dmm.KERNEL_LAUNCHES[kind]
            gpu32 = DALLE(cfg32, "cuda")
            got32 = gpu32.prefill(qparams, tokens.cuda(), gpu32.init_cache(2), band=band)
            got16 = dalle.prefill(qparams, tokens.cuda(), dalle.init_cache(2), band=band)
            torch.cuda.synchronize()
        # the heads (2 rows) launch the kernel; the layers' 2 x text_seq_len
        # rows take the dequant form unless they are few enough
        layers = 6 * cfg.n_layers if dalle._streaming_eligible(
            2 * cfg.text_seq_len, cfg.n_embd) else 0
        if dmm.KERNEL_LAUNCHES[kind] != before + 2 * (1 + layers):
            raise AssertionError(f"{mode}: the prefill heads did not launch {kind}")
        err32 = (got32.cpu() - want).abs().max().item()
        err16 = (got16.float().cpu() - want).abs().max().item()
        print(f"{mode} prefill logits [2, {band[1] - band[0]}] vs CPU plain path, same "
              f"quantized weights: card fp32 max_abs_err {err32:.3g} (atol 5e-3: fp32 sums "
              f"in another order, and an activation may round to bf16 across a boundary "
              f"before the head kernel), card bf16 max_abs_err {err16:.3g} (atol 0.1; "
              f"|logits| max {want.abs().max().item():.3g})", flush=True)
        if not (err32 <= 5e-3 and err16 <= 0.1 and torch.isfinite(got16).all()):
            raise AssertionError(f"{mode}: prefill logits disagree with the CPU plain path")

        # --- HTTP: a greedy and a sampled request share a batch, then the greedy again
        batches_before = sampler.stats()["batches_done"]
        graphs_before = len(sampler._decoder.replays)
        reset_counts(attn, dmm)
        t0 = time.perf_counter()
        greedy = {"text": texts[0], "n": 2, "temperature": 0.0, "top_k": 0}
        mixed = [greedy, {"text": texts[1], "n": 2, "temperature": 1.0, "top_k": 0}]
        replies = [None] * len(mixed)

        def send(i):
            replies[i] = post(port, mixed[i])

        senders = [threading.Thread(target=send, args=(i,)) for i in range(len(mixed))]
        for t in senders:
            t.start()
        for t in senders:
            t.join(timeout=900)
        again = post(port, greedy)
        wall = time.perf_counter() - t0
        launches = dict(dmm.KERNEL_LAUNCHES)
        attn_launches = attn.KERNEL_LAUNCHES["causal_attention_fwd"]
        batches = sampler.stats()["batches_done"] - batches_before
        if any(r is None for r in replies):
            raise AssertionError(f"{mode}: a request got no reply")
        check_pngs(replies + [again], side)
        if again["images"] != replies[0]["images"]:
            raise AssertionError(f"{mode}: two identical greedy requests differ")
        # a batch: the prefill's head, then image_seq_len - 1 replays of a
        # graph of 6 launches a layer and the head's; a bucket's first batch
        # also runs its eager warm-up steps before the capture
        per_step = 6 * cfg.n_layers + 1
        per_batch = 1 + (cfg.image_seq_len - 1) * per_step
        captures = len(sampler._decoder.replays) - graphs_before
        want = per_batch * batches + captures * WARMUP_STEPS * per_step
        replays = sum(sampler._decoder.replays.values())
        other = "int4_matmul" if mode == "int8" else "int8_matmul"
        if (batches == 0 or launches[kind] != want or launches[other]
                or attn_launches != cfg.n_layers * batches
                or any(v != {kind: per_step} for v in map(
                    sampler._decoder.launches_per_replay, sampler._decoder.replays))):
            raise AssertionError(
                f"{mode}: launches {launches}, attention {attn_launches}, expected "
                f"{per_batch} x {batches} batches + {captures} warm-ups of {per_step} and "
                f"{cfg.n_layers} x {batches}")
        print(f"{mode} served {sum(len(r['images']) for r in replies + [again])} images in "
              f"{len(mixed) + 1} requests, {batches} batches, {wall:.2f}s (load + warm "
              f"{load_s:.1f}s); {kind} launches {launches[kind]} = {per_batch} x {batches} "
              f"batches + {captures} x {WARMUP_STEPS} warm-up steps of {per_step}, through "
              f"{replays} graph replays in all; latencies "
              f"{[r['latency_s'] for r in replies + [again]]}", flush=True)
    finally:
        stop_server(sampler, server, thread)
    return dict(launches=launches[kind], batches=batches, dalle=dalle, params=qparams,
                greedy=greedy, greedy_images=replies[0]["images"],
                launches_per_replay=per_step, graph_captures_in_window=captures)


def phase_continuous(torch, attn, dmm, card, config, whole_batch):
    """``serve_dalle --quantize int8 --continuous`` over HTTP with requests
    admitted at three chunk boundaries. Returns the int8 launches."""
    from dalle_mtf_tpu_torch import serve_dalle  # noqa: PLC0415

    sampler, server, thread, port, load_s = start_server(
        serve_dalle, ["--model", config, "--quantize", "int8", "--continuous",
                      "--chunk", str(CHUNK), "--top_k", "64"])
    cfg = sampler.dalle.cfg
    try:
        reset_counts(attn, dmm)
        st0 = sampler.stats()
        t0 = time.perf_counter()
        bodies = [whole_batch["greedy"],
                  {"text": "a bowl of fruit", "n": 1, "temperature": 1.0, "top_k": 64},
                  {"text": "a city street at night", "n": 1, "temperature": 0.8,
                   "top_k": 16, "top_p": 0.9}]
        replies = [None] * len(bodies)

        def send(i):
            replies[i] = post(port, bodies[i])

        senders = []
        for i in range(len(bodies)):
            # request i joins after i chunks of the ones before it
            deadline = time.monotonic() + 600
            while (sampler.stats()["chunks_done"] - st0["chunks_done"] < i
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            senders.append(threading.Thread(target=send, args=(i,)))
            senders[-1].start()
        for t in senders:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        st1 = get(port, "/stats")
        launches = dict(dmm.KERNEL_LAUNCHES)
        if any(r is None for r in replies):
            raise AssertionError("continuous: a request got no reply")
        check_pngs(replies, sampler.vae.cfg.image_size)
        chunks = st1["chunks_done"] - st0["chunks_done"]
        admits = st1["admits_done"] - st0["admits_done"]
        want = (6 * cfg.n_layers + 1) * CHUNK * chunks + admits
        if launches["int8_matmul"] != want or launches["int4_matmul"] or admits < 3:
            raise AssertionError(f"continuous: launches {launches}, expected {want} "
                                 f"({chunks} chunks, {admits} admissions)")
        if replies[0]["images"] != whole_batch["greedy_images"]:
            raise AssertionError("continuous: the greedy images differ from the "
                                 "whole-batch engine's on the same weights")
        if st1["engine"] != "continuous" or st1["slots_busy"]:
            raise AssertionError(f"continuous /stats: {st1}")
        print(f"continuous: {len(bodies)} requests admitted at chunk boundaries 0-2 in "
              f"{wall:.2f}s (load + warm {load_s:.1f}s), {chunks} chunks of {CHUNK}, "
              f"{admits} admissions; int8_matmul launches {launches['int8_matmul']} = "
              f"{6 * cfg.n_layers + 1} x {CHUNK} x {chunks} + {admits}; greedy images equal "
              f"the whole-batch engine's; latencies {[r['latency_s'] for r in replies]}; "
              f"stats {st1}; {card}", flush=True)
    finally:
        stop_server(sampler, server, thread)
    return launches["int8_matmul"]


# ----------------------------------------------------------- stage-1 VAE

VAE_CONFIG = "vae_coco_synth"
VAE_STEPS, VAE_CKPT, VAE_TIMED_FROM = 30, 20, 3  # checkpoint + eval at 20 and 30; 3..30 timed
VAE_TRACED_FROM, VAE_TRACED = 10, 2  # steps 10 and 11 of the timed run under torch.profiler
VAE_UNSYNCED = 5  # steps run back to back with one sync at the end
# each host-data run: 14 steps, 6..14 read (20 before the pipeline phase)
VAE_DATA_STEPS, VAE_DATA_FROM = 14, 6
COCO_SIDES = ((640, 480), (480, 640))  # (width, height): the commonest COCO 2017 shapes
VAE_VALUES = dict(  # the values check's small VAE: 64 px, 256 tokens, batch 4
    dataset={"image_size": 64}, num_tokens=256, convblocks=[[1, 32], [2, 64]],
    recompute_grad=True, temp_start=1.0, temp=0.2, temp_anneal_steps=100,
    train_gumbel_hard=False, eval_gumbel_hard=True,
)

def vae_values(torch, bf16: bool) -> dict:
    """One training step (loss and every grad) and one eval step (loss,
    PSNR, codebook perplexity, Fréchet feature distance) of a small VAE
    through ``make_vae_task``: the card against the CPU, same weights,
    images and Gumbel draw ``u``. Bounds: loss and metrics within 1e-4
    relative in fp32 (the port's fp32 convs run in IEEE fp32, TF32 off:
    ``models/vae.py``), 2e-2 in bf16; each grad leaf's max |card - cpu|
    within 1e-3 of its max |grad| in fp32, its relative L2 error within 0.1
    in bf16 (both sides round activations to bf16 at the same points, from
    fp32 sums taken in another order)."""
    from dalle_mtf_tpu_torch.ops import gumbel  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_vae_task  # noqa: PLC0415

    params = {**VAE_VALUES, "use_bf16": bf16}
    vae, init_fn, _, _ = make_vae_task(params, "cpu")
    weights = init_fn(torch.Generator().manual_seed(11))
    gen = torch.Generator().manual_seed(12)
    size, g = vae.cfg.image_size, vae.cfg.grid_size
    img = torch.rand((4, size, size, 3), generator=gen) * 2.0 - 1.0
    u = gumbel.gumbel_uniform((4, g, g, vae.cfg.num_tokens), gen, "cpu")
    draw = gumbel.gumbel_uniform
    gumbel.gumbel_uniform = lambda shape, generator, device: u.to(device)
    results = {}
    try:
        for device in ("cuda", "cpu"):
            _, _, train_loss, eval_loss = make_vae_task(params, device)
            tree = _to(weights, device)
            for _, t in named_leaves(tree):
                t.requires_grad_(True)
            batch = {"image": img.to(device)}
            loss, _ = train_loss(tree, None, batch, torch.Generator(), 10)
            loss.backward()
            with torch.no_grad():
                eloss, aux = eval_loss(tree, None, batch, torch.Generator(), 10)
            metrics = {"loss": loss.item(), "eval_loss": eloss.item(),
                       **{k: v.item() for k, v in aux.items()}}
            results[device] = (metrics, {"/".join(p): t.grad.float().cpu()
                                         for p, t in named_leaves(tree)})
    finally:
        gumbel.gumbel_uniform = draw
    (gm, gg), (cm, cg) = results["cuda"], results["cpu"]
    rtol = 2e-2 if bf16 else 1e-4
    rel = {k: abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-30) for k in cm}
    if bf16:
        grad_err = max((((gg[n] - cg[n]).norm() / cg[n].norm().clamp_min(1e-30)).item(), n)
                       for n in cg)
        grad_ok = grad_err[0] <= 0.1
    else:
        grad_err = max(((gg[n] - cg[n]).abs().max().item()
                        / max(cg[n].abs().max().item(), 1e-30), n) for n in cg)
        grad_ok = grad_err[0] <= 1e-3
    label = "bf16" if bf16 else "fp32"
    print(f"train_vae values {label}: card {gm}; cpu {cm}; worst relative difference "
          f"{max(rel.values()):.3g} (bound {rtol}); worst grad "
          f"{'relative L2' if bf16 else 'max-abs over the leaf max'} {grad_err[0]:.3g} "
          f"({grad_err[1]}, bound {0.1 if bf16 else 1e-3})", flush=True)
    if not (max(rel.values()) <= rtol and grad_ok):
        raise AssertionError(f"train_vae values {label}: the card disagrees with the CPU")
    return dict(card=gm, cpu=cm, worst_rel=max(rel.values()), worst_grad=grad_err)


def seeded_image(rng, side):
    """A random 8 x 8 colour field from ``rng``, bilinearly upsampled to
    ``side`` (width, height), plus noise: uint8 pixels a VAE can learn."""
    import numpy as np  # noqa: PLC0415
    from PIL import Image  # noqa: PLC0415

    field = Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    arr = np.asarray(field.resize(side, Image.BILINEAR), np.int16)
    return np.clip(arr + rng.integers(-8, 9, arr.shape), 0, 255).astype(np.uint8)


def write_image_dataset(root: str, seed: int, sides, files: int = 4, per_file: int = 64,
                        captions: bool = False) -> str:
    """JPEG tfrecords of images drawn from ``seed`` (``seeded_image``),
    (width, height) taken from ``sides`` in turn. With ``captions``, each
    record also carries 5-63 caption ids drawn from a generator of its own,
    so the images are those of the same seed without."""
    import io  # noqa: PLC0415

    import numpy as np  # noqa: PLC0415
    from PIL import Image  # noqa: PLC0415

    from dalle_mtf_tpu_torch.data.tfrecord import TFRecordWriter, serialize_example  # noqa: PLC0415

    rng, text_rng = np.random.default_rng(seed), np.random.default_rng([seed, 1])
    os.makedirs(root, exist_ok=True)
    for f in range(files):
        with TFRecordWriter(os.path.join(root, f"synth_{f}.tfrecords")) as w:
            for i in range(per_file):
                buf = io.BytesIO()
                Image.fromarray(seeded_image(rng, sides[i % len(sides)])).save(
                    buf, format="JPEG", quality=90)
                example = {"image": buf.getvalue()}
                if captions:
                    example["caption"] = text_rng.integers(0, 50257, text_rng.integers(5, 64)).tolist()
                w.write(serialize_example(example))
    return os.path.join(root, "*.tfrecords")


def create_tfrecords_dataset(root: str, images: str, name: str) -> str:
    """The port's dataset tooling over the JPEGs of the glob ``images``:
    ``create_tfrecords random`` (random captions, seeded) into root/paired,
    then ``paired --reencode`` into root/records, 64 records a file; returns
    the records' glob."""
    from dalle_mtf_tpu_torch.data import create_tfrecords  # noqa: PLC0415

    jsonl = create_tfrecords.main(["random", images, "--out", os.path.join(root, "paired")])
    create_tfrecords.main(["paired", jsonl, "--name", name, "--out",
                           os.path.join(root, "records"), "--examples-per-file", "64",
                           "--reencode"])
    return os.path.join(root, "records", "*.tfrecords")


def quadrant_dataset(root: str, side: int, n: int = 256, seed: int = 3) -> str:
    """``n`` seeded quadrant JPEGs of ``side``² (``data/smoke_data.py``, its
    per-pixel noise at 0.1 rather than its default 0.45, under which the
    quadrants' colours are a small share of a pixel's variance) through
    ``create_tfrecords_dataset``: the records' glob."""
    from dalle_mtf_tpu_torch.data.smoke_data import make_quadrant_images  # noqa: PLC0415

    make_quadrant_images(os.path.join(root, "images"), n_images=n, size=side, noise=0.1,
                         seed=seed)
    return create_tfrecords_dataset(root, os.path.join(root, "images", "*.jpg"), "quadrants")


def coco_size_dataset(root: str, n: int = 128, seed: int = 4) -> str:
    """``n`` seeded JPEGs (``seeded_image``, quality 90) at the COCO sizes
    of ``COCO_SIDES`` in turn, through ``create_tfrecords_dataset``: the
    records' glob."""
    import numpy as np  # noqa: PLC0415
    from PIL import Image  # noqa: PLC0415

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i in range(n):
        Image.fromarray(seeded_image(rng, COCO_SIDES[i % len(COCO_SIDES)])).save(
            os.path.join(root, "images", f"coco_{i:03d}.jpg"), quality=90)
    return create_tfrecords_dataset(root, os.path.join(root, "images", "*.jpg"), "coco")


def io_uring_allowed() -> bool:
    """Whether this process may create an io_uring (the io_uring_setup
    syscall, x86-64 number 425, for a one-entry ring, closed at once)."""
    import ctypes  # noqa: PLC0415

    libc = ctypes.CDLL(None, use_errno=True)
    params = ctypes.create_string_buffer(120)  # struct io_uring_params, zeroed
    fd = libc.syscall(425, 1, params)
    if fd < 0:
        return False
    os.close(fd)
    return True


def native_data_library() -> dict:
    """Build the native data library (``data/native.py``, from
    native/dataloader.cpp) where its toolchain is found: {"missing": why it
    cannot be built or None, "io_uring": whether the container allows
    io_uring (``io_uring_allowed``; with the library, a two-shard read
    through its reader must agree), "library": its path, "build_s"}. A
    toolchain that is found and a library that fails to build or load is
    an error."""
    from dalle_mtf_tpu_torch.data import native  # noqa: PLC0415
    from dalle_mtf_tpu_torch.data.tfrecord import TFRecordWriter  # noqa: PLC0415

    out = {"missing": native.missing_toolchain(), "gxx": shutil.which("g++"),
           "jpeglib_h": os.path.isfile("/usr/include/jpeglib.h"),
           "io_uring": io_uring_allowed()}
    if out["missing"] is not None:
        return out
    t0 = time.perf_counter()
    out["library"] = os.path.relpath(native.build(), HERE)
    out["build_s"] = time.perf_counter() - t0
    if not native.available():
        raise AssertionError("the native data library built but does not load")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_uring_")
    try:
        paths = []
        for i in range(2):
            paths.append(os.path.join(tmp, f"{i}.tfrecords"))
            with TFRecordWriter(paths[-1]) as w:
                w.write(f"record {i}".encode())
        ring = native.read_interleaved(paths, cycle=2)
        if (ring is not None) != out["io_uring"]:
            raise AssertionError(f"io_uring allowed: {out['io_uring']}, but the reader "
                                 f"{'opened' if ring is not None else 'did not open'} one")
        if ring is not None and list(ring) != [b"record 0", b"record 1"]:
            raise AssertionError("the io_uring reader read the wrong records")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def require_native_data(pipeline, label: str) -> None:
    """Fail where the native data library can be built but ``pipeline``
    (an image pipeline, its stream started) did not read and decode
    through it: the io_uring reader (or the native one where io_uring is
    refused) and the C++ decode pool."""
    from dalle_mtf_tpu_torch.data import native  # noqa: PLC0415

    if native.missing_toolchain() is not None:
        return
    local = pipeline.reader in ("io_uring", "native")
    if pipeline.decoder != "native pool" or not (local or pipeline.reader.endswith("readahead")):
        raise AssertionError(f"{label}: the native data path did not run (reader "
                             f"{pipeline.reader}, decoder {pipeline.decoder}) though g++ and "
                             f"jpeglib.h are here")


@contextlib.contextmanager
def decode_path(path: str, workers: int):
    """The image pipelines made inside on ``path``: "pool" (the native
    readers and the C++ decode pool on ``workers`` threads) or "pil" (the
    Python reader and PIL on ``workers`` threads: the native library
    unloaded, as where it cannot be built)."""
    from dalle_mtf_tpu_torch.data import native  # noqa: PLC0415
    from dalle_mtf_tpu_torch.data import pipeline as tpipe  # noqa: PLC0415

    saved = native.get_lib, tpipe.POOL_WORKERS, tpipe.DECODE_WORKERS
    if path == "pil":
        native.get_lib, tpipe.DECODE_WORKERS = (lambda: None), workers
    else:
        tpipe.POOL_WORKERS = workers
    try:
        yield
    finally:
        native.get_lib, tpipe.POOL_WORKERS, tpipe.DECODE_WORKERS = saved


def vae_config(tmp: str, pattern: str, run: str, **over) -> str:
    """A copy of configs/vae_coco_synth.json over ``pattern``, cut to
    VAE_STEPS steps with a checkpoint and an eval at VAE_CKPT, every step
    logged, in ``tmp/run``; ``over`` replaces keys after that."""
    from dalle_mtf_tpu_torch.utils.config import _resolve_config_path  # noqa: PLC0415

    with open(_resolve_config_path(VAE_CONFIG)) as f:
        cfg = json.load(f)
    cfg.update(
        dataset={**cfg["dataset"], "train_path": pattern, "eval_path": pattern},
        train_steps=VAE_STEPS, steps_per_checkpoint=VAE_CKPT, eval_steps=1, log_every=1,
        max_to_keep=2, model_path=os.path.join(tmp, run),
    )
    cfg.update(over)
    path = os.path.join(tmp, f"{run}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def encoder_macs(cfg) -> tuple[int, int, int, int]:
    """The encoder's conv trunk for one image: (down-conv multiply-adds,
    residual-block multiply-adds, latent side, latent channels)."""
    side, fwd, res = cfg.image_size // cfg.stack_factor, 0, 0
    cin = cfg.n_channels * cfg.stack_factor ** 2
    for stack, ch in cfg.convblocks:  # down-conv, then residual blocks
        side //= 2
        fwd += side * side * 16 * cin * ch
        res += (stack - 1) * 2 * side * side * 9 * ch * ch
        cin = ch
    return fwd, res, side, cin


def vae_flops(cfg, batch: int) -> dict:
    """Multiply-adds of one image's forward from the conv shapes (each
    output pixel: k * k * cin * cout; an up-conv's input pixel: 4 * 4 *
    cin * cout) and the two codebook products, and of the residual
    blocks' forward alone (recomputed in the backward under
    ``recompute_grad``). A step's FLOPs: 2 * batch * (3 * forward +
    recomputed): the backward as twice the forward."""
    fwd, res, side, cin = encoder_macs(cfg)
    book = side * side * cfg.n_hid * cfg.num_tokens
    fwd += 2 * book  # encoder logits, decoder input
    for stack, ch in reversed(cfg.convblocks):  # decoder: up-conv, residual blocks
        fwd += side * side * 16 * cin * ch
        side *= 2
        res += (stack - 1) * 2 * side * side * 9 * ch * ch
        cin = ch
    fwd += res + side * side * cin * cfg.n_channels * cfg.stack_factor ** 2  # final 1x1
    recompute = res if cfg.recompute_grad else 0
    return dict(forward_gmac_per_image=fwd / 1e9, recomputed_gmac_per_image=recompute / 1e9,
                tflop_per_step=2 * batch * (3 * fwd + recompute) / 1e12)


class TimedBatches:
    """An iterator over a pipeline's batches that keeps the seconds each
    ``next`` waited (the host's data time a step). With ``trace=(first,
    steps)`` it also runs torch.profiler (device activity only) over steps
    first .. first + steps - 1 of the loop that consumes it, from the
    first-th ``next`` to the one after the last, and keeps that window's
    wall seconds: the trace and the step times come from one loop."""

    def __init__(self, pipeline, trace: tuple[int, int] | None = None, batch_fn=None):
        self.pipeline = pipeline  # its ``reader`` and ``decoder`` once the stream starts
        self.it, self.batch_fn = iter(pipeline), batch_fn
        self.waits: list[float] = []
        self.trace, self.prof, self.window_s, self.t_window = trace, None, None, 0.0

    def __iter__(self):
        return self

    def __next__(self):
        step = len(self.waits) + 1  # the step this batch feeds
        if self.prof is not None and self.window_s is None and step == sum(self.trace):
            self.window_s = time.perf_counter() - self.t_window
            self.prof.stop()
        if self.trace and step == self.trace[0]:
            from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self.t_window = time.perf_counter()
        t0 = time.perf_counter()
        batch = next(self.it)
        self.waits.append(time.perf_counter() - t0)
        return batch if self.batch_fn is None else self.batch_fn(batch)

    def close(self):
        self.it.close()


VAE_BUCKETS = (  # device-time buckets of a VAE step, by kernel name (first match)
    ("conv_bwd", ("dgrad", "wgrad", "convolve_dgrad", "convolve_wgrad", "conv2d_grouped_direct_bwd")),
    ("conv_fwd", ("fprop", "implicit_convolve", "conv2d", "convolution", "cudnn")),
    ("layout", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("optimizer", ("adam", "multi_tensor", "foreach")),
    ("matmul", ("gemm", "cutlass", "xmma", "sm90_", "nvjet")),
    ("host_to_device", ("memcpy htod",)),
    ("elementwise", ("elementwise", "vectorized", "reduce", "softmax", "copy", "memcpy", "memset")),
)


def vae_device_split(torch, prof, steps: int, wall_s: float) -> dict:
    """A trace's device time a step by bucket (``VAE_BUCKETS``), the
    busiest kernels by name, and the device's busy share of ``wall_s``."""
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        raise AssertionError("torch.profiler recorded no device activity in the traced steps")
    buckets = {name: 0.0 for name, _ in VAE_BUCKETS} | {"other": 0.0}
    by_name: dict[str, float] = {}
    for e in device:
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        key = next((b for b, words in VAE_BUCKETS if any(w in name for w in words)), "other")
        buckets[key] += ms
        by_name[e.name[:100]] = by_name.get(e.name[:100], 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(
        traced_steps=steps, traced_wall_ms_per_step=wall_s * 1e3 / steps,
        device_ms_per_step={k: v / steps for k, v in buckets.items()},
        top_kernels_ms_per_step={k: v / steps for k, v in top},
        device_busy_share=sum(buckets.values()) / (wall_s * 1e3),
        device_ops_per_step=len(device) / steps,
    )


def vae_unsynced_ms(torch, path, steps: int = VAE_UNSYNCED) -> dict:
    """Milliseconds a step of ``steps`` training steps run back to back on
    batches read beforehand, with one sync at the end (no log between
    steps, as in a run at the config's own log_every), with cuDNN's
    deterministic switch on and off in turn on one trainer, after a block of
    each to warm up: {"deterministic": [ms, ms], "default": [ms, ms]}."""
    from dalle_mtf_tpu_torch.data.pipeline import vae_input_fn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_vae_task  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.trainer import Trainer, step_generator  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    params = fetch_model_params(path)
    vae, init_fn, loss_fn, _ = make_vae_task(params, "cuda")
    trainer = Trainer(params, init_fn, loss_fn, params["model_path"] + "_unsynced",
                      vae.cfg.image_seq_len, "cuda")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    data = iter(vae_input_fn(params))
    batches = [next(data) for _ in range(steps)]
    data.close()
    before = torch.backends.cudnn.deterministic
    out: dict[bool, list[float]] = {True: [], False: []}
    step = 0
    try:
        for det in (True, False) * 3:
            torch.backends.cudnn.deterministic = det
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for batch in batches:
                state, metrics = trainer.train_step(state, batch, step_generator(0, 1, step))
                step += 1
            float(metrics["loss"])
            torch.cuda.synchronize()
            out[det].append((time.perf_counter() - t0) * 1e3 / steps)
    finally:
        torch.backends.cudnn.deterministic = before
        trainer.close()
    return {"deterministic": out[True][1:], "default": out[False][1:]}


def pipeline_rate(pipeline, batch: int, batches: int = 8) -> float:
    """Samples a second that ``pipeline`` alone yields (nothing else
    running beside it) over ``batches`` batches after its first."""
    it = iter(pipeline)
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    seconds = time.perf_counter() - t0
    it.close()
    return batches * batch / seconds


def vae_decode_rate(path) -> float:
    """Images a second that config ``path``'s ``vae_input_fn`` alone yields
    (on the decode path in force: ``decode_path``)."""
    from dalle_mtf_tpu_torch.data.pipeline import vae_input_fn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    params = fetch_model_params(path)
    return pipeline_rate(vae_input_fn(params), params["train_batch_size"])


def tokens_parse_rate(tmp: str) -> float:
    """Records a second that ``dalle_input_fn`` alone yields (tokens mode,
    its one parse thread) at TRAIN_CONFIG's shapes."""
    from dalle_mtf_tpu_torch.data.pipeline import dalle_input_fn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import _configs  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    cfg, _ = _configs(fetch_model_params(TRAIN_CONFIG))
    write_tokens_dataset(os.path.join(tmp, "data"), 0, cfg.image_seq_len, cfg.image_vocab_size)
    params = fetch_model_params(train_config(tmp, 1))
    return pipeline_rate(dalle_input_fn(params), params["train_batch_size"])


def run_train_vae(path, *flags, trace=None):
    """``train_vae.main`` on config ``path`` (on cuda:0) with its training
    stream wrapped in ``TimedBatches`` (``trace``: its traced window): (the
    closed Trainer, the TimedBatches)."""
    from dalle_mtf_tpu_torch import train_vae  # noqa: PLC0415

    make_pipeline = train_vae.vae_input_fn
    streams: list[TimedBatches] = []

    def timed_train_stream(params, eval=False, **kw):
        pipeline = make_pipeline(params, eval=eval, **kw)
        if eval or "skip_steps" not in kw:  # the eval and the summary pipelines
            return pipeline
        streams.append(TimedBatches(pipeline, trace))
        return streams[-1]

    train_vae.vae_input_fn = timed_train_stream
    try:
        return train_vae.main(["--model", path, *flags, "--gpu_ids", "0"]), streams[-1]
    finally:
        train_vae.vae_input_fn = make_pipeline


def vae_datasets(tmp: str, side: int) -> dict:
    """The VAE phase's records: 256 of ``side``² (``quadrant_dataset``) and
    128 at COCO sizes (``coco_size_dataset``): {label: pattern}."""
    return {f"{side}x{side}": quadrant_dataset(os.path.join(tmp, "square"), side),
            "coco": coco_size_dataset(os.path.join(tmp, "coco"))}


POOL_SWEEP = (4, 8, 16)  # decode-pool threads timed alone at COCO sizes


def vae_host_data(torch, tmp: str, patterns: dict, arms) -> dict:
    """The host's image data on each (path, workers) of ``arms``
    (``decode_path``) for each dataset in ``patterns``: ``vae_input_fn``'s
    images a second alone, then a VAE_DATA_STEPS-step ``train_vae.main``
    run's median step and data-wait share over steps VAE_DATA_FROM.. (the
    time in ``next(data_iter)`` over the step time) and the readers that
    ran: {"<label> <path> <workers>": {...}}."""
    out = {}
    for label, pattern in patterns.items():
        for path_, n in arms:
            key = f"{label} {path_} {n}"
            cfg = vae_config(tmp, pattern, key.replace(" ", "_"), train_steps=VAE_DATA_STEPS,
                             steps_per_checkpoint=VAE_DATA_STEPS, eval_steps=0)
            with decode_path(path_, n):
                rate = vae_decode_rate(cfg)
                trainer, stream = run_train_vae(cfg, "--new", "--yes")
            if path_ == "pool":
                require_native_data(stream.pipeline, f"train_vae data {key}")
            read = range(VAE_DATA_FROM, VAE_DATA_STEPS + 1)
            step_s = [1.0 / trainer.history[s - 1]["steps_per_sec"] for s in read]
            out[key] = dict(
                decode_images_per_s=rate, step_s_median=statistics.median(step_s),
                data_wait_share=sum(stream.waits[s - 1] for s in read) / sum(step_s),
                data_wait_s=stream.waits, reader=stream.pipeline.reader,
                decoder=stream.pipeline.decoder)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            print(f"train_vae data {label}, {path_} on {n} threads ({out[key]['reader']} + "
                  f"{out[key]['decoder']}): alone {rate:.1f} images/s; in training "
                  f"{out[key]['step_s_median']:.4f} s a step, data wait "
                  f"{out[key]['data_wait_share']:.5f} of it", flush=True)
    return out


def pool_sweep(tmp: str, pattern: str) -> dict:
    """The decode pool's images a second alone on each count of
    ``POOL_SWEEP`` threads over ``pattern`` (the host has ``os.cpu_count()``
    cores): {threads: images/s}."""
    cfg = vae_config(tmp, pattern, "pool_sweep")
    rates = {}
    for n in POOL_SWEEP:
        with decode_path("pool", n):
            rates[n] = vae_decode_rate(cfg)
    print(f"train_vae data: the decode pool alone at COCO sizes, images/s by threads {rates} "
          f"({os.cpu_count()} cores)", flush=True)
    return rates


def phase_train_vae(torch, card, keep: str | None = None) -> dict:
    """Stage-1 VAE training: the values check in fp32 and bf16, then
    configs/vae_coco_synth.json at full width (256 px, convblocks
    [[2,128],[3,256],[5,512]], 2048 tokens, bf16, recompute_grad, batch 32,
    temperature annealed 1 -> 0.2) on seeded JPEG tfrecords through
    ``train_vae.main`` for VAE_STEPS steps (checkpoint, eval and image
    summaries at VAE_CKPT and VAE_STEPS; steps VAE_TRACED_FROM.. traced in
    the same loop), and a second ``main`` resumed from a copy of the
    step-VAE_CKPT checkpoint to VAE_STEPS, which must repeat the unbroken
    run's losses bit for bit (cuDNN's deterministic switch is on in this
    phase, so no weight gradient is summed in a run-dependent order). The
    records are written by ``vae_datasets`` (the port's smoke_data and
    create_tfrecords) and read through the native library where its
    toolchain is (``require_native_data``). Then the host's data: the
    decode pool alone on POOL_SWEEP threads at COCO sizes, and on the pool
    (POOL_WORKERS threads) and on PIL (DECODE_WORKERS threads), at 256² and
    at COCO sizes (PIL alone where the library cannot be built), the
    tokens pipeline's one thread alone, and the steps run with no sync
    between them, deterministic switch on and off. With ``keep``, the
    unbroken run's step-VAE_STEPS checkpoint is copied to
    ``keep``/checkpoints, a VAE directory for ``phase_train_image``, and
    its 256² records (with their random captions) to ``keep``/records."""
    import PIL  # noqa: PLC0415

    from dalle_mtf_tpu_torch.data import native  # noqa: PLC0415
    from dalle_mtf_tpu_torch.data.pipeline import DECODE_WORKERS, POOL_WORKERS  # noqa: PLC0415
    from dalle_mtf_tpu_torch.models.vae import VAEConfig  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.summaries import read_summaries  # noqa: PLC0415

    t_phase = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vae_")
    try:
        values = {("bf16" if bf16 else "fp32"): vae_values(torch, bf16) for bf16 in (False, True)}
        cfg = VAEConfig.from_params(fetch_model_params(VAE_CONFIG))
        t0 = time.perf_counter()
        patterns = vae_datasets(os.path.join(tmp, "data"), cfg.image_size)
        pattern = patterns[f"{cfg.image_size}x{cfg.image_size}"]
        path = vae_config(tmp, pattern, "whole")
        print(f"train_vae: {VAE_CONFIG} image {cfg.image_size} convblocks {cfg.convblocks} "
              f"tokens {cfg.num_tokens} bf16={cfg.use_bf16} recompute={cfg.recompute_grad}; "
              f"256 quadrant JPEGs of {cfg.image_size}² and 128 of {COCO_SIDES} through "
              f"create_tfrecords random and paired --reencode, + config in "
              f"{time.perf_counter() - t0:.1f}s (PIL {PIL.__version__})", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        whole, stream = run_train_vae(path, "--new", "--yes", trace=(VAE_TRACED_FROM, VAE_TRACED))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in whole.history]
        if [h["step"] for h in whole.history] != list(range(1, VAE_STEPS + 1)):
            raise AssertionError(f"logged steps {[h['step'] for h in whole.history]}")
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            raise AssertionError(f"the loss is not finite or did not fall: {losses}")
        evals = whole.eval_history
        if [e["step"] for e in evals] != [VAE_CKPT, VAE_STEPS]:
            raise AssertionError(f"eval: {evals}")
        for e in evals:
            if not (all(math.isfinite(v) for v in e.values())
                    and 1.0 < e["eval_codebook_perplexity"] <= cfg.num_tokens):
                raise AssertionError(f"eval metrics: {e}")
        if whole.checkpoint_steps() != [VAE_CKPT, VAE_STEPS]:
            raise AssertionError(f"checkpoints {whole.checkpoint_steps()}")
        tags = {(step, tag) for step, tag, v in read_summaries(whole.model_dir)
                if isinstance(v, tuple) and v[:3] == (cfg.image_size, cfg.image_size, 3)}
        want_tags = {(s, f"{n}/image/0") for s in (VAE_CKPT, VAE_STEPS)
                     for n in ("input_image", "reconstruction_image")}
        if not want_tags <= tags:
            raise AssertionError(f"image summaries {sorted(tags)}, expected {sorted(want_tags)}")
        require_native_data(stream.pipeline, "train_vae")
        split = vae_device_split(torch, stream.prof, VAE_TRACED, stream.window_s)
        # untimed: the traced steps and the one after, whose next() stops the profiler
        steady = [s for s in range(VAE_TIMED_FROM, VAE_STEPS + 1)
                  if not VAE_TRACED_FROM <= s <= VAE_TRACED_FROM + VAE_TRACED]
        step_s = [1.0 / whole.history[s - 1]["steps_per_sec"] for s in steady]
        data_wait_share = sum(stream.waits[s - 1] for s in steady) / sum(step_s)
        med = statistics.median(step_s)
        print(f"train_vae: {VAE_STEPS} steps + 2 evals + 2 checkpoints in {wall:.1f}s, records "
              f"read by {stream.pipeline.reader}, decoded by {stream.pipeline.decoder}; losses "
              f"{[round(x, 5) for x in losses]}; evals {evals}; steps {VAE_TRACED_FROM}-"
              f"{VAE_TRACED_FROM + VAE_TRACED - 1} traced: "
              f"{split['traced_wall_ms_per_step']:.1f} ms a step, device busy "
              f"{split['device_busy_share']:.3f}", flush=True)

        if keep is not None:
            os.makedirs(os.path.join(keep, "checkpoints"), exist_ok=True)
            shutil.copy(os.path.join(whole.ckpt_dir, f"ckpt_{VAE_STEPS}.pt"),
                        os.path.join(keep, "checkpoints"))
            shutil.copytree(os.path.dirname(pattern), os.path.join(keep, "records"))
        # resume: a second main from a copy of the step-VAE_CKPT checkpoint
        resume = vae_config(tmp, pattern, "resumed")
        os.makedirs(os.path.join(tmp, "resumed", "checkpoints"))
        shutil.copy(os.path.join(whole.ckpt_dir, f"ckpt_{VAE_CKPT}.pt"),
                    os.path.join(tmp, "resumed", "checkpoints"))
        del whole
        gc.collect()
        second, _ = run_train_vae(resume)
        resumed = [h["step"] for h in second.history]
        if resumed != list(range(VAE_CKPT + 1, VAE_STEPS + 1)):
            raise AssertionError(f"resume logged steps {resumed}")
        again = [h["loss"] for h in second.history]
        print(f"train_vae: resumed at step {VAE_CKPT}: losses {[round(x, 5) for x in again]}; "
              f"bit-equal to the unbroken run's: {again == losses[VAE_CKPT:]}", flush=True)
        if again != losses[VAE_CKPT:]:
            raise AssertionError("the resumed run does not repeat the unbroken run's losses "
                                 f"bit for bit: {again} vs {losses[VAE_CKPT:]}")
        del second
        gc.collect()
        torch.cuda.empty_cache()

        missing = native.missing_toolchain()
        if missing is None:
            sweep = pool_sweep(tmp, patterns["coco"])
            arms = (("pool", POOL_WORKERS), ("pil", DECODE_WORKERS))
        else:  # the pool and PIL would be one path: PIL
            print(f"train_vae data: the native data library cannot be built here ({missing}): "
                  f"the pool's arms are left out", flush=True)
            sweep, arms = None, (("pil", DECODE_WORKERS),)
        host_data = vae_host_data(torch, tmp, patterns, arms)
        tokens_rate = tokens_parse_rate(os.path.join(tmp, "tokens"))
        unsynced = vae_unsynced_ms(torch, path)
        print(f"train_vae: dalle_input_fn alone (tokens, one thread) {tokens_rate:.1f} records/s; "
              f"{VAE_UNSYNCED} steps back to back, ms a step {unsynced}; {card}", flush=True)

        flops = vae_flops(cfg, 32)
        tflops = flops["tflop_per_step"] / med
        line = dict(
            phase="train_vae", card=card, config=VAE_CONFIG, batch=32,
            image_size=cfg.image_size, convblocks=cfg.convblocks, num_tokens=cfg.num_tokens,
            bf16=cfg.use_bf16, recompute_grad=cfg.recompute_grad, pil=PIL.__version__,
            data="256 seeded quadrant JPEGs through create_tfrecords random and paired "
                 "--reencode, through train_vae.main",
            reader=stream.pipeline.reader, decoder=stream.pipeline.decoder,
            pool_workers=POOL_WORKERS, pool_images_per_s_by_threads=sweep,
            timing="train_vae.main, log_every 1 (a sync every step), cudnn.deterministic",
            steps_timed=len(step_s), step_s=step_s, step_s_median=med,
            images_per_s=32 / med, **flops, tflops_per_s=tflops,
            mfu=tflops / PEAK_BF16_TFLOPS, peak_gb=peak / 1e9,
            pil_threads=DECODE_WORKERS, data_wait_share=data_wait_share,
            data_wait_s=[stream.waits[s - 1] for s in steady],
            first_loss=losses[0], last_loss=losses[-1], evals=evals, resume_bit_equal=True,
            values={k: {n: v[n] for n in ("worst_rel", "worst_grad")} for k, v in values.items()},
            **split, host_data=host_data, tokens_records_per_s=tokens_rate,
            unsynced_ms_per_step=unsynced, phase_s=time.perf_counter() - t_phase,
        )
        print(json.dumps(line), flush=True)
        return line
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)

# ------------------------------------------------- stage 2 in image mode

IMAGE_STEPS, IMAGE_RESUME, IMAGE_TIMED_FROM = 8, 2, 3  # as TRAIN_STEPS, RESUME_STEPS, TIMED_FROM
UINT8_STEPS, TOKENS_STEPS = 5, 2  # the uint8 arm (steps 3..5 timed) and the tokens arm
ENCODE_ITERS = 10  # timed encodes of one batch
IMAGE_VALUES = dict(  # the values check's DALLE over VAE_VALUES' VAE in fp32: D = 128, S = 320
    n_embd=256, n_heads=2, n_layers=2, text_seq_len=64, text_vocab_size=1000,
    image_vocab_size=VAE_VALUES["num_tokens"], vae_params={**VAE_VALUES, "use_bf16": False},
)


def encoder_gmac(cfg) -> float:
    """Multiply-adds of one image through the VAE's encoder and the
    codebook product, from the conv shapes (``vae_flops``' count without the
    decoder), in G."""
    fwd, res, side, _ = encoder_macs(cfg)
    return (fwd + res + side * side * cfg.n_hid * cfg.num_tokens) / 1e9


def image_values(torch, card) -> dict:
    """A small image-mode DALLE step in fp32 (IMAGE_VALUES, batch 2, uint8
    pixels): the device's normalization of the pixels bit-equal to the
    host's, the frozen VAE's tokens equal on the card and the CPU, and the
    loss and every grad on the card (through the packed kernels, launches
    counted) against the port's plain path on the CPU (``compare_values``)."""
    import numpy as np  # noqa: PLC0415

    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import _image, make_dalle_task  # noqa: PLC0415

    rng = np.random.default_rng(13)
    size = VAE_VALUES["dataset"]["image_size"]
    pixels = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    batch = {"image": torch.from_numpy(pixels),
             "caption": torch.from_numpy(rng.integers(0, 1000, (2, 64)))}
    host = torch.from_numpy((pixels.astype(np.float32) - 127.5) / 127.5)
    if not torch.equal(_image({"image": batch["image"].cuda()}).cpu(), host):
        raise AssertionError("uint8 pixels normalized on the card differ from the host's")
    dalle, vae, init_fn, _, _ = make_dalle_task(IMAGE_VALUES, "cpu")
    weights = init_fn(torch.Generator().manual_seed(14))
    frozen = vae.init(torch.Generator().manual_seed(15))
    results, tokens = {}, {}
    for device in ("cuda", "cpu"):
        _, dvae, _, train_loss, _ = make_dalle_task(IMAGE_VALUES, device)
        tree, vae_tree = _to(weights, device), _to(frozen, device)
        on = {k: v.to(device) for k, v in batch.items()}
        tokens[device] = dvae.encode_tokens(vae_tree, _image(on)).cpu()
        for _, t in named_leaves(tree):
            t.requires_grad_(True)
        reset_counts(attn)
        loss, _ = train_loss(tree, vae_tree, on, torch.Generator().manual_seed(16), 0)
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            launched = {n: c for n, c in attn.KERNEL_LAUNCHES.items() if c}
            want = {"causal_attention_packed_fwd": 2, "causal_attention_packed_bwd": 2}
            if launched != want:
                raise AssertionError(f"the image-mode values step launched {launched}, "
                                     f"expected {want}")
        results[device] = (loss.item(), {"/".join(p): t.grad.cpu() for p, t in named_leaves(tree)})
    if not torch.equal(tokens["cuda"], tokens["cpu"]):
        raise AssertionError(f"the frozen VAE's fp32 tokens differ on the card in "
                             f"{int((tokens['cuda'] != tokens['cpu']).sum())} of "
                             f"{tokens['cpu'].numel()} places")
    return dict(**compare_values("image mode, uint8 pixels", dalle.cfg, card, results["cuda"],
                                 results["cpu"]), launches=launched)


def image_train_config(tmp: str, pattern: str, run: str, train_steps: int, vae_dir: str,
                       url: bool = False, **over) -> str:
    """A copy of configs/dalle_coco_synth.json as published (image mode,
    its vae_model vae_coco_synth) over ``pattern``, cut to ``train_steps``
    steps with a checkpoint and an eval at IMAGE_STEPS, every step logged,
    the frozen VAE restored from ``vae_dir``, in ``tmp/run`` (a file:// URL
    with ``url``); ``over`` replaces keys (``dataset``: merged into the
    dataset)."""
    from dalle_mtf_tpu_torch.utils.config import _resolve_config_path  # noqa: PLC0415

    with open(_resolve_config_path(TRAIN_CONFIG)) as f:
        cfg = json.load(f)
    dataset = {**cfg["dataset"], "train_path": pattern, "eval_path": pattern,
               **over.pop("dataset", {})}
    model_path = os.path.join(tmp, run)
    cfg.update(dataset=dataset, train_steps=train_steps, steps_per_checkpoint=IMAGE_STEPS,
               eval_steps=1, log_every=1, max_to_keep=1,
               model_path=f"file://{model_path}" if url else model_path,
               vae_checkpoint_path=vae_dir)
    cfg.update(over)
    path = os.path.join(tmp, f"{run}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def run_train_dalle(path, *flags, predict_s: list | None = None, batch_fn=None):
    """``train_dalle.main`` on config ``path`` (on cuda:0) with its training
    stream wrapped in ``TimedBatches``: (the closed Trainer, the
    TimedBatches). With ``predict_s`` (a list), the seconds of each
    predict at a checkpoint are appended to it (host clock, the images
    fetched to the host inside). With ``batch_fn``, the step is fed
    ``batch_fn`` of each training batch."""
    from dalle_mtf_tpu_torch import train_dalle  # noqa: PLC0415

    make_pipeline = train_dalle.dalle_input_fn
    make_predict = train_dalle.make_predict_summary_fn
    streams: list[TimedBatches] = []

    def timed_predict(*args, **kw):
        fn = make_predict(*args, **kw)

        def summary_fn(trainer, state, step):
            t0 = time.perf_counter()
            fn(trainer, state, step)
            predict_s.append(time.perf_counter() - t0)

        return summary_fn if fn is not None else None

    def timed_train_stream(params, eval=False, **kw):
        pipeline = make_pipeline(params, eval=eval, **kw)
        if eval:
            return pipeline
        streams.append(TimedBatches(pipeline, batch_fn=batch_fn))
        return streams[-1]

    train_dalle.dalle_input_fn = timed_train_stream
    if predict_s is not None:
        train_dalle.make_predict_summary_fn = timed_predict
    try:
        return train_dalle.main(["--model", path, *flags, "--gpu_ids", "0"]), streams[-1]
    finally:
        train_dalle.dalle_input_fn = make_pipeline
        train_dalle.make_predict_summary_fn = make_predict


def check_predict(run_dir: str, step: int, side: int, predict_s: list, attn_launches: int,
                  n_layers: int) -> dict:
    """The one predict of a ``predict_steps: 1`` run at its step-``step``
    checkpoint: PREDICT_ROWS PNGs of side x side x 3 and the prompts under
    ``<run_dir>/predict/step_<step>/``, the image summaries in the event
    file, the prefill through the [B, H, S, D] forward kernel (one launch a
    layer)."""
    from dalle_mtf_tpu_torch.utils.summaries import read_summaries  # noqa: PLC0415

    out = os.path.join(run_dir, "predict", f"step_{step:07d}")
    names = sorted(os.listdir(out))
    want = sorted([f"batch0_row{j}.png" for j in range(PREDICT_ROWS)] + ["prompts.txt"])
    shapes = []
    for j in range(PREDICT_ROWS):
        with open(os.path.join(out, f"batch0_row{j}.png"), "rb") as f:
            shapes.append(png_shape(base64.b64encode(f.read())))
    tags = [tag for s_, tag, _ in read_summaries(run_dir) if tag.startswith("predict/")]
    if (names != want or any(sh != (side, side, 3) for sh in shapes) or len(predict_s) != 1
            or len(tags) != PREDICT_ROWS or attn_launches != n_layers):
        raise AssertionError(f"predict at step {step}: files {names}, shapes {shapes}, "
                             f"{len(predict_s)} predicts, summaries {tags}, causal_attention_fwd "
                             f"launches {attn_launches} (want {n_layers})")
    return dict(step=step, rows=PREDICT_ROWS, predict_s=predict_s[0], png_shapes=shapes,
                summaries=len(tags), causal_attention_fwd_launches=attn_launches)


def token_agreement(torch, image_params, tokens_params, vae, frozen) -> dict:
    """The in-step encode (``tokens_of``: ``encode_tokens`` of the batch on
    the card) of every eval batch of ``image_params`` against the records
    of ``tokens_params`` (the same records, encoded offline): the share of
    tokens that agree, and the top-two logit gap of the in-step encode where
    they differ. Captions must be equal."""
    from dalle_mtf_tpu_torch.data.pipeline import dalle_input_fn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import _image  # noqa: PLC0415

    images = iter(dalle_input_fn(image_params, eval=True, repeat=False))
    records = iter(dalle_input_fn(tokens_params, eval=True, repeat=False))
    same, total, gaps = 0, 0, []
    with torch.no_grad():
        for ib in images:
            tb = next(records)
            if not (ib["caption"] == tb["caption"]).all():
                raise AssertionError("the encoded records' captions differ from the images'")
            logits = vae.encoder(frozen, _image({"image": torch.from_numpy(ib["image"]).cuda()}))
            logits = logits.reshape(logits.shape[0], -1, logits.shape[-1])
            top2 = logits.topk(2, dim=-1).values
            mine = logits.argmax(dim=-1).cpu()
            differ = mine != torch.from_numpy(tb["tokens"]).long()
            same += int((~differ).sum())
            total += differ.numel()
            gaps += (top2[..., 0] - top2[..., 1]).cpu()[differ].tolist()
    return dict(tokens_compared=total, agree_share=same / total,
                top2_gap_where_differ_max=max(gaps, default=None))


def init_loss_split(torch, path, frozen) -> dict:
    """The first step's loss at init, taken apart on the trainer's own init
    (its seed) and first training batch of config ``path``: the mean
    log-sum-exp of the fp32 logits, which at init is ln V + n_embd * 0.02²
    / 2 whatever the labels, and the mean logit of the label, which is 0
    only in expectation over the init. Under uniform labels (tokens mode)
    the second averages out; the frozen VAE's tokens repeat a few codebook
    ids, so in one image-mode batch it does not."""
    from dalle_mtf_tpu_torch.data.pipeline import dalle_input_fn  # noqa: PLC0415
    from dalle_mtf_tpu_torch.data.tokenizer import get_tokenizer  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import _image, make_dalle_task  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    params = fetch_model_params(path)
    params["padding_id"] = get_tokenizer().pad_token_id
    dalle, vae, init_fn, _, _ = make_dalle_task(params, "cuda")
    weights = init_fn(torch.Generator().manual_seed(params.get("seed") or 0))
    data = iter(dalle_input_fn(params))
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
    data.close()
    with torch.no_grad():
        image = vae.encode_tokens(frozen, _image(batch)).long() + dalle.cfg.text_vocab_size
        tokens = torch.cat([batch["caption"].long(), image], dim=1)
        logits = dalle.forward(weights, tokens)
        lse = torch.logsumexp(logits, dim=-1).mean().item()
        label = logits.gather(-1, dalle.shifted_labels(tokens)[..., None]).mean().item()
    return dict(mean_logsumexp=lse, mean_label_logit=label, loss=lse - label,
                distinct_image_tokens=int(image.unique().numel()))


def rounded_pixels(batch: dict) -> dict:
    """``batch`` with its f32 pixels rounded by ``to_uint8`` and normalized
    on the host as PIL's are ((x - 127.5) / 127.5 in f32): what the uint8
    arm's step computes from its pixels on the card."""
    import numpy as np  # noqa: PLC0415

    from dalle_mtf_tpu_torch.data.pipeline import to_uint8  # noqa: PLC0415

    return {**batch, "image": (to_uint8(batch["image"]).astype(np.float32) - 127.5) / 127.5}


def uint8_reference_loss(decoder: str, f32_first_loss: float, tmp: str, pattern: str,
                         vae_dir: str) -> tuple[float, str]:
    """The first loss the uint8 arm must equal bit for bit, and whose it is.
    PIL's f32 pixels are whole numbers over 127.5, so the f32 arm itself
    was fed the uint8 arm's pixels. The native pool's are not: then a
    one-step f32 run from the same init fed ``rounded_pixels`` of each batch
    gives it."""
    if decoder != "native pool":
        return f32_first_loss, "the f32 arm's"
    path = image_train_config(tmp, pattern, "rounded", 1, vae_dir, eval_steps=0)
    run, _ = run_train_dalle(path, "--new", "--yes", batch_fn=rounded_pixels)
    return check_dalle_run(run, [1], [], {}, {})[0], "an f32 run's fed the rounded pixels"


def encode_ms(torch, vae, frozen, batch) -> float:
    """Milliseconds of one in-step encode (``encode_tokens`` of a uint8 batch
    normalized on the card) by CUDA events (``cuda_ms``, ENCODE_ITERS)."""
    from dalle_mtf_tpu_torch.train.tasks import _image  # noqa: PLC0415

    on = {"image": torch.from_numpy(batch["image"]).cuda()}
    with torch.no_grad():
        return cuda_ms(lambda: vae.encode_tokens(frozen, _image(on)), ENCODE_ITERS)


def phase_train_image(torch, attn, card, vae_dir: str) -> dict:
    """DALLE in image mode, the two-stage flow: the values check
    (``image_values``), then configs/dalle_coco_synth.json as published
    (image mode, full width and depth, batch 16, bf16) with the frozen
    vae_coco_synth restored from ``vae_dir`` (the VAE phase's step-30
    checkpoint) on its 256 seeded quadrant JPEGs of 256² with random
    captions (``quadrant_dataset``: the port's smoke_data and
    create_tfrecords; ``vae_dir``/records),
    through ``train_dalle.main`` for IMAGE_STEPS steps with an eval and a
    checkpoint and a resumed ``main`` for IMAGE_RESUME more, the records and
    the model dir given as file:// URLs (fsspec, a read-ahead thread a
    shard, the native decode pool where it builds) (the first loss taken apart
    by ``init_loss_split``, its log-sum-exp against ln V + var/2; finite
    losses, the packed pair's exact launches and none of the [B, H, S, D]
    pair); the ``uint8_images`` arm from the same init (its first batch
    ``to_uint8`` of the f32 arm's bit for bit, its first loss that of an f32
    run fed the same pixels bit for bit: ``uint8_reference_loss``);
    ``create_tfrecords encode`` over
    the same records (batch 16) and the share of its tokens that agree with
    the in-step encode (at least 99%); tokens mode on those records from the
    same init (first loss within 1e-3 of image mode's); a profile of two
    steps with the encoder's convs as their own bucket. Prints the
    ``train_image`` line and returns the main path's launches."""
    import numpy as np  # noqa: PLC0415

    from dalle_mtf_tpu_torch.data import create_tfrecords  # noqa: PLC0415
    from dalle_mtf_tpu_torch.data.pipeline import DECODE_WORKERS, dalle_input_fn, to_uint8  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.restore import restore_vae_params  # noqa: PLC0415

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_image_")
    try:
        values = image_values(torch, card)
        dalle, vae = make_dalle_models(fetch_model_params(TRAIN_CONFIG), "cuda")
        cfg, vcfg = dalle.cfg, vae.cfg
        pattern = os.path.join(vae_dir, "records", "*.tfrecords")
        url = f"file://{pattern}"
        path = image_train_config(tmp, url, "image", IMAGE_STEPS, vae_dir, url=True)
        print(f"train_image: the VAE phase's 256 quadrant JPEGs of {vcfg.image_size}² with "
              f"random captions (create_tfrecords random and paired --reencode); train_path "
              f"{url}, model_path {fetch_model_params(path)['model_path']}", flush=True)
        names = ("causal_attention_packed_fwd", "causal_attention_packed_bwd")

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(attn)
        t0 = time.perf_counter()
        first, stream = run_train_dalle(path, "--new", "--yes")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(attn.KERNEL_LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        losses = check_dalle_run(first, list(range(1, IMAGE_STEPS + 1)), [IMAGE_STEPS],
                                 launches, {names[0]: cfg.n_layers * (IMAGE_STEPS + 1),
                                            names[1]: cfg.n_layers * IMAGE_STEPS})
        init_loss = math.log(cfg.total_tokens) + cfg.n_embd * 0.02**2 / 2
        frozen = restore_vae_params(vae, vae_dir)
        split_init = init_loss_split(torch, path, frozen)
        print(f"train_image: first loss {losses[0]!r} = mean log-sum-exp "
              f"{split_init['mean_logsumexp']!r} (ln(vocab) + var/2 = {init_loss!r}) - mean "
              f"label logit {split_init['mean_label_logit']!r} "
              f"({split_init['distinct_image_tokens']} distinct image tokens)", flush=True)
        if (abs(split_init["loss"] - losses[0]) > 1e-2
                or abs(split_init["mean_logsumexp"] - init_loss) > 0.1):
            raise AssertionError(f"first loss {losses[0]}: {split_init} against ln(vocab) + "
                                 f"var/2 = {init_loss}")
        if not (first.model_dir.startswith("file://") and first.checkpoint_steps() == [IMAGE_STEPS]):
            raise AssertionError(f"model dir {first.model_dir}: checkpoints "
                                 f"{first.checkpoint_steps()}")
        require_native_data(stream.pipeline, "train_image")
        reader = (stream.pipeline.reader, stream.pipeline.decoder)
        print(f"train_image: records read by {reader[0]}, decoded by {reader[1]}; checkpoint "
              f"{first.ckpt_dir}/ckpt_{IMAGE_STEPS}.pt", flush=True)
        if reader[0] != "python + readahead":
            raise AssertionError(f"file:// records read by {reader[0]}, not a read-ahead thread")
        timed = range(IMAGE_TIMED_FROM, IMAGE_STEPS + 1)
        step_s = [1.0 / first.history[s - 1]["steps_per_sec"] for s in timed]
        med = statistics.median(step_s)
        data_wait_share = sum(stream.waits[s - 1] for s in timed) / sum(step_s)
        evals = first.eval_history
        del first
        gc.collect()

        resume = image_train_config(tmp, url, "image", IMAGE_STEPS + IMAGE_RESUME, vae_dir,
                                    url=True)
        reset_counts(attn)
        second, _ = run_train_dalle(resume)
        end = IMAGE_STEPS + IMAGE_RESUME
        resumed = check_dalle_run(second, list(range(IMAGE_STEPS + 1, end + 1)), [end],
                                  dict(attn.KERNEL_LAUNCHES),
                                  {names[0]: cfg.n_layers * (IMAGE_RESUME + 1),
                                   names[1]: cfg.n_layers * IMAGE_RESUME})
        print(f"train_image: {IMAGE_STEPS} steps + eval + checkpoint in {wall:.1f}s; losses "
              f"{[round(x, 4) for x in losses]}; eval {evals[0]}; resumed at step "
              f"{IMAGE_STEPS}: losses {[round(x, 4) for x in resumed]}; launches {launches}",
              flush=True)
        del second
        gc.collect()

        u8_path = image_train_config(tmp, pattern, "uint8", UINT8_STEPS, vae_dir, eval_steps=0,
                                     dataset={"uint8_images": True})
        first_batches = []
        for p in (path, u8_path):
            it = iter(dalle_input_fn(fetch_model_params(p)))
            first_batches.append(next(it)["image"])
            it.close()
        f32_batch, u8_batch = first_batches
        if not np.array_equal(u8_batch, to_uint8(f32_batch)):
            raise AssertionError("the uint8 arm's first batch is not to_uint8 of the f32 arm's")
        u8, u8_stream = run_train_dalle(u8_path, "--new", "--yes")
        u8_losses = check_dalle_run(u8, list(range(1, UINT8_STEPS + 1)), [], {}, {})
        u8_timed = range(IMAGE_TIMED_FROM, UINT8_STEPS + 1)
        u8_step_s = [1.0 / u8.history[s - 1]["steps_per_sec"] for s in u8_timed]
        u8_wait = sum(u8_stream.waits[s - 1] for s in u8_timed) / sum(u8_step_s)
        ref_loss, ref = uint8_reference_loss(reader[1], losses[0], tmp, pattern, vae_dir)
        print(f"train_image uint8: losses {[round(x, 4) for x in u8_losses]}; first batch "
              f"to_uint8 of the f32 arm's; first loss {u8_losses[0]!r} against {ref} "
              f"{ref_loss!r}", flush=True)
        if u8_losses[0] != ref_loss:
            raise AssertionError(f"uint8 first loss {u8_losses[0]!r} != {ref} {ref_loss!r}")
        del u8
        gc.collect()

        t0 = time.perf_counter()
        files = create_tfrecords.main([
            "encode", "--input", url, "--out", f"file://{os.path.join(tmp, 'encoded')}",
            "--name", "synth", "--encode-with", VAE_CONFIG, "--vae-checkpoint-path", vae_dir,
            "--batch-size", "16", "--examples-per-file", "64"])
        encode_s = time.perf_counter() - t0
        tokens_pattern = os.path.join(tmp, "encoded", "*.tfrecords")
        tok_path = image_train_config(tmp, tokens_pattern, "tokens", TOKENS_STEPS, vae_dir,
                                      eval_steps=0, dataset={"tokens": True}, predict_steps=1,
                                      predict_batch_size=PREDICT_ROWS)
        agreement = token_agreement(torch, fetch_model_params(path),
                                    fetch_model_params(tok_path), vae, frozen)
        print(f"train_image: create_tfrecords encode wrote {files} files of 256 records in "
              f"{encode_s:.1f}s; tokens agreeing with the in-step encode {agreement}",
              flush=True)
        if agreement["agree_share"] < 0.99:
            raise AssertionError(f"offline tokens agree with the in-step encode on "
                                 f"{agreement['agree_share']:.4f} < 0.99")
        reset_counts(attn)
        predict_s: list[float] = []
        tok, _ = run_train_dalle(tok_path, "--new", "--yes", predict_s=predict_s)
        tok_losses = check_dalle_run(tok, list(range(1, TOKENS_STEPS + 1)), [], {}, {})
        predict = check_predict(os.path.join(tmp, "tokens"), TOKENS_STEPS, vcfg.image_size,
                                predict_s, attn.KERNEL_LAUNCHES["causal_attention_fwd"],
                                cfg.n_layers)
        print(f"train_image tokens: losses {[round(x, 4) for x in tok_losses]}; first loss "
              f"{tok_losses[0]!r} vs image mode {losses[0]!r}; predict_steps 1 at the "
              f"step-{TOKENS_STEPS} checkpoint with the frozen VAE restored in tokens mode: "
              f"{predict}", flush=True)
        if abs(tok_losses[0] - losses[0]) > 1e-3:
            raise AssertionError(f"tokens-mode first loss {tok_losses[0]} vs image mode "
                                 f"{losses[0]}: more than 1e-3 apart")
        del tok
        gc.collect()

        u8_data = iter(dalle_input_fn(fetch_model_params(u8_path)))
        enc_ms = encode_ms(torch, vae, frozen, next(u8_data))
        u8_data.close()
        split = profile_steps(torch, path, cfg, frozen=frozen)
        e, L, v, s = cfg.n_embd, cfg.n_layers, cfg.total_tokens, cfg.total_seq_len
        token_flops = flops_per_token(cfg)
        batch_size = fetch_model_params(path)["train_batch_size"]
        tokens_per_step = batch_size * s
        tflops = tokens_per_step / med * token_flops / 1e12
        enc_tflop = 2 * batch_size * encoder_gmac(vcfg) / 1e3
        line = dict(
            phase="train_image", card=card, config=TRAIN_CONFIG, vae=VAE_CONFIG, batch=batch_size,
            seq_len=s, n_layers=L, n_embd=e, vocab=v, bf16=cfg.bf_16, vae_bf16=vcfg.use_bf16,
            data=f"256 seeded quadrant JPEGs of {vcfg.image_size}² with random captions "
                 "through create_tfrecords random and paired --reencode, from file:// "
                 "through train_dalle.main",
            reader=reader[0], decoder=reader[1],
            timing="train_dalle.main, log_every 1 (a sync every step)",
            steps_timed=len(step_s), step_s=step_s, step_s_median=med,
            tokens_per_s=tokens_per_step / med, tflops_per_s=tflops,
            mfu=tflops / PEAK_BF16_TFLOPS, encoder_gmac_per_image=encoder_gmac(vcfg),
            encoder_tflop_per_step=enc_tflop,
            mfu_with_encoder=(tokens_per_step * token_flops / 1e12 + enc_tflop) / med
            / PEAK_BF16_TFLOPS,
            encoder_ms_per_step=enc_ms, peak_mem_gb=peak / 1e9,
            pil_threads=DECODE_WORKERS, data_wait_share=data_wait_share,
            data_wait_s=[stream.waits[s_ - 1] for s_ in timed],
            first_loss=losses[0], expected_init_loss=init_loss, init_loss_split=split_init,
            evals=evals,
            uint8_step_s=u8_step_s, uint8_step_s_median=statistics.median(u8_step_s),
            uint8_data_wait_share=u8_wait, uint8_first_loss=u8_losses[0],
            uint8_first_loss_bit_equal_to=ref,
            encode_files=files, encode_s=encode_s, **agreement,
            tokens_first_loss=tok_losses[0], image_first_loss=losses[0], predict=predict,
            values={k: values[k] for k in ("loss_card", "loss_cpu", "worst_grad_rel_l2")},
            **split, phase_s=time.perf_counter() - t_phase,
        )
        print(json.dumps(line), flush=True)
        return {n: launches[n] for n in names}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ring_worker(argv) -> int:
    """``chip_smoke.py --ring-worker <checks|vae_values|serve_tp|
    train|train_vae> <out_dir> [argv...]``: one rank under
    ``torch.distributed.run``, for the ring, the tensor-parallel, the VAE
    data-parallel and the sharded serving phases."""
    import torch  # noqa: PLC0415

    mode, out_dir = argv[0], argv[1]
    if mode == "vae_values":
        worker_vae_values(torch, out_dir, argv[2:])
    elif mode == "serve_tp":
        worker_serve_tp(torch, out_dir, argv[2])
    else:
        worker_train(torch, out_dir, argv[2:], "train_vae" if mode == "train_vae" else
                     "train_dalle")
    return 0


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "dalle_mtf_tpu_torch")):
        print("chip_smoke.py: the dalle_mtf_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.chdir(HERE)  # configs/ and logs/ resolve inside the checkout
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--ring-worker"]:
        return ring_worker(sys.argv[2:])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(card, flush=True)

    from dalle_mtf_tpu_torch.ops import _build  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import attention as attn  # noqa: PLC0415

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc builds
        data_lib = pool.submit(native_data_library)
        lib = _build.build()
        print(f"built {os.path.relpath(lib, HERE)} in {time.perf_counter() - t0:.1f}s",
              flush=True)
        data_lib = data_lib.result()
    print("native data library", json.dumps(data_lib), flush=True)
    phase_s = {"build": time.perf_counter() - t0}

    def phase(fn, *args, **kw):
        """``fn(*args, **kw)``, its seconds added to ``phase_s``."""
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            phase_s[fn.__name__] = phase_s.get(fn.__name__, 0.0) + time.perf_counter() - t
            print(f"phase {fn.__name__}: {time.perf_counter() - t:.1f}s, "
                  f"{time.perf_counter() - t0:.1f}s since the start", flush=True)

    from dalle_mtf_tpu_torch.ops import decode_matmul as dmm  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import layer_norm as lnm  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import ring_attention as ring  # noqa: PLC0415

    for d in attn.KERNEL_HEAD_DIMS:
        print("resources", json.dumps(dict(kernels="causal attention pair, bf16", D=d,
                                           **attn.kernel_resources(d))), flush=True)
        print("resources", json.dumps(dict(kernels="ring attention per-hop pair, bf16", D=d,
                                           **attn.kernel_resources(d, "ring"))), flush=True)
        for kind, label in (("causal", "causal attention"), ("ring", "ring attention per-hop")):
            print("resources", json.dumps(dict(
                kernels=f"{label} forward and backward, fp32 (3xTF32)", D=d,
                **attn.kernel_resources(d, kind, torch.float32))), flush=True)
    decode_resources(dmm)
    serving = phase(phase_kernel, torch, attn, card)
    phase(phase_tile_cases, torch, attn, card)
    tp_prefill = phase(tp_prefill_cases, torch, card)
    decode = phase(phase_decode_kernels, torch, dmm, card)
    training, training_12b, training_tp, training_tp12b, training_pp, training_pptp = phase(
        phase_train_kernels, torch, attn, card)
    bhsd = phase(phase_bhsd_kernels, torch, attn, card)
    ln = phase(phase_ln_kernels, torch, lnm, card)
    ring_rows = phase(phase_ring_kernels, torch, ring, card)
    phase(phase_train_values, torch, card)
    unpacked = phase(phase_train_values, torch, card, attn_packed=False, ln_impl="pallas")
    torch.cuda.empty_cache()
    train_launches = phase(phase_train, torch, attn, card, training)
    gc.collect()
    torch.cuda.empty_cache()
    long_launches, _ = phase(phase_train_long, torch, attn, lnm, card, bhsd["dalle_4k"])
    gc.collect()
    torch.cuda.empty_cache()
    phase(memory_option_values, torch, attn, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase(phase_loss_head, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    twelve_b_launches = phase(phase_train_12b, torch, attn, card)
    gc.collect()
    torch.cuda.empty_cache()
    vae_dir = tempfile.mkdtemp(prefix="chip_smoke_vae_ckpt_")
    try:
        phase(phase_train_vae, torch, card, keep=vae_dir)
        gc.collect()
        torch.cuda.empty_cache()
        image_launches = phase(phase_train_image, torch, attn, card, vae_dir)
    finally:
        shutil.rmtree(vae_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    ring_launches, ring_per_rank, tpsp_per_rank, ring_values, pp = phase(
        phase_train_sharded, torch, card)
    pp_launches, pptp_launches, tp_launches = pp
    gc.collect()
    torch.cuda.empty_cache()
    phase(phase_train_vae_dp, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    tp12b_launches, sample12b_launches = phase(phase_train_12b_tp, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    serve_tp_launches = phase(phase_serve_tp, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    serve_launches, bf16 = phase(phase_slice, torch, attn, card)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    t_serve = time.perf_counter()
    try:
        config = serve_config(tmp)
        quant = {mode: phase_quant_serving(torch, attn, dmm, card, mode, config, bf16["texts"])
                 for mode in ("int8", "int4")}
        # per-batch latency of the four weight forms, one after another
        from dalle_mtf_tpu_torch.models.dalle import DALLE  # noqa: PLC0415

        int8_dalle = quant["int8"]["dalle"]
        einsum_dalle = DALLE(dataclasses.replace(int8_dalle.cfg, decode_kernels=False), "cuda")
        text4 = bf16["tokens"].repeat(2, 1).cuda()
        vae, vae_params = bf16["vae"], bf16["vae_params"]
        variants = [
            ("bf16", bf16["dalle"], bf16["params"]),
            ("int8_dequant_einsum", einsum_dalle, quant["int8"]["params"]),
            ("int8_kernels", int8_dalle, quant["int8"]["params"]),
            ("int4_kernels", quant["int4"]["dalle"], quant["int4"]["params"]),
        ]
        splits = {label: captured_batch(torch, card, label, d, p, vae, vae_params, text4,
                                        eager_steps=EAGER_STEPS)
                  for label, d, p in variants}
        gc.collect()
        torch.cuda.empty_cache()
        decode_profile(torch, card, "bf16", bf16["dalle"], bf16["params"], text4,
                       (splits["bf16"]["eager_s"] - splits["bf16"]["prefill_s"])
                       / splits["bf16"]["eager_steps"] * 1e3)
        continuous_chunks(torch, card, int8_dalle, quant["int8"]["params"], text4)
        continuous_launches = phase_continuous(torch, attn, dmm, card, config, quant["int8"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_s["quantized_serving_and_decode"] = time.perf_counter() - t_serve

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def measured(row):
        """The keys every kernels-line row has, and where the row's dsum
        reduction or its device time was read apart, those too."""
        extra = [k for k in ("dsum_ms", "device_ms", "library_device_ms") if k in row]
        return {k: row[k] for k in (*keys, *extra)}

    rows = [
        dict(name=name, route="cuda", source=FWD_SOURCE if "fwd" in name else BWD_SOURCE,
             replaces=REPLACES[name], launches=train_launches[name],
             image_mode_launches=image_launches[name], **measured(training[name]),
             dalle_12B=dict(launches=twelve_b_launches[name],
                            launches_on=f"{TWELVE_B_CONFIG} published arm, {TWELVE_B_CUT}",
                            shape="B=8 H=40 S=2560 D=128 bf16", **measured(training_12b[name])),
             tp_launches=[r[name] for r in tp_launches],
             tp_launches_on=f"{TP_CONFIG} training on {PP_RANKS} ranks ({TP_TRAIN_MESH}, each "
                            f"rank 4 of the 8 heads, head0 0 and 4, on its data rank's 4 rows: "
                            f"pptp_microbatch's shape), {TP_STEPS} steps + eval, {PP_LABEL}",
             tp_rank=dict(shape="B=8 H=4 S=1280 D=128 bf16 (a model:2 rank's heads on 8 rows)",
                          **measured(training_tp[name])),
             tp12b_launches=[r[name] for r in tp12b_launches],
             tp12b_launches_on=f"{TWELVE_B_CONFIG} training on {TWELVE_B_TP_RANKS} ranks "
                               f"(data:1,model:8, each rank 5 of the 40 heads, head0 5 x rank), "
                               f"{TWELVE_B_TP_CUT}, {TWELVE_B_TP_STEPS} steps + a resume of "
                               f"{TWELVE_B_TP_RESUME}, {TWELVE_B_TP_LABEL}",
             tp12b_rank=dict(shape="B=4 H=5 S=2560 D=128 bf16 (a dalle_12B model:8 rank's "
                                   "heads)", **measured(training_tp12b[name])),
             pp_launches=[r[name] for r in pp_launches],
             pp_launches_on=f"{TRAIN_CONFIG} training on {PP_RANKS} ranks ({PP_MESH}, "
                            f"{PP_LAYOUT}, {PP_CUT}: each stage 2 of the 4 layers on 2 "
                            f"microbatches of 4 rows), {PP_STEPS} steps + eval, {PP_LABEL}",
             pp_microbatch=dict(shape="B=4 H=8 S=1280 D=128 bf16 (a pipeline stage's "
                                      "microbatch)", **measured(training_pp[name])),
             pptp_launches=[r[name] for r in pptp_launches],
             pptp_launches_on=f"{TP_CONFIG} training on {PP_RANKS} ranks (data:1,pipe:2,model:2, "
                              f"{PPTP_LAYOUT}, {PPTP_CUT}: each rank 2 of the 4 layers on 4 of "
                              f"the 8 heads, 2 microbatches of 4 rows), {PPTP_STEPS} steps + "
                              f"eval, {PP_LABEL}",
             pptp_microbatch=dict(shape="B=4 H=4 S=1280 D=128 bf16 (a PP x TP rank's "
                                        "microbatch on its heads)",
                                  **measured(training_pptp[name])))
        for name in ("causal_attention_packed_fwd", "causal_attention_packed_bwd")
    ]
    tp_prefill_launches = {
        "dalle_coco_model2": (serve_tp_launches, f"{SERVE_CONFIG} (12 layers, {TP_SERVE_STEPS} decode steps a batch) served on "
                              f"{TP_RANKS} ranks (data:1,model:2, each rank 4 of the 8 heads, "
                              f"head0 0 and 4), phase_serve_tp, {TP_SERVE_LABEL}"),
        "dalle_12B_model8": (sample12b_launches, f"{TWELVE_B_CONFIG} sampled on "
                             f"{TWELVE_B_TP_RANKS} ranks (data:1,model:8, 5 of 40 heads, head0 "
                             f"5 x rank), {TWELVE_B_TP_CUT}, batch {TWELVE_B_SAMPLE_BATCH}, "
                             f"{TWELVE_B_TP_LABEL}"),
    }
    rows.append(dict(
        name="causal_attention_fwd", route="cuda", source=FWD_SOURCE,
        replaces=REPLACES["causal_attention_fwd"], launches=serve_launches,
        **measured(serving),
        tp_prefill=[dict(shape=name, B=r["B"], H=r["H"], heads_total=r["heads_total"], S=r["S"],
                         D=r["D"], launches_per_rank=tp_prefill_launches[name][0],
                         launches_on=tp_prefill_launches[name][1],
                         bit_equal_to_whole_launch_heads=all(
                             r["bit_equal_to_whole_launch_heads"]), **measured(r))
                    for name, r in tp_prefill.items()],
    ))
    for name, mode in (("int8_matmul", "int8"), ("int4_matmul", "int4")):
        rows.append(dict(
            name=name, route="cuda", source=DECODE_SOURCE, replaces=REPLACES[name],
            launches=quant[mode]["launches"], **{k: decode[name][k] for k in keys},
            shape="mlp1 M=4 K=1024 N=4096",
            launches_through="captured CUDA graphs: launches a replay x replays, plus the "
                             "prefill heads and a capture's eager warm-up step",
            launches_per_replay=quant[mode]["launches_per_replay"],
        ))
    rows[3]["continuous_launches"] = continuous_launches
    launches = {"long": long_launches, "values": unpacked["launches"]}
    for name, shape, run, tpu in BHSD_ROWS:
        rows.append(dict(
            name=name, route="cuda", source=FWD_SOURCE if name.endswith("fwd") else BWD_SOURCE,
            replaces=tpu[0][1], also_replaces=[where for _, where in tpu[1:]],
            tpu_kernels=[k for k, _ in tpu], launches=launches[run][name],
            launches_on=LAUNCHES_ON[run], shape=shape, **measured(bhsd[shape][name]),
        ))
    tpsp_on = (f"{LONG_CONFIG} ring training on {TPSP_MESH} ({RING_LAYERS} layers, "
               f"{RING_STEPS} steps + eval; each rank 4 of the 8 heads over 2176 positions, "
               f"head0 0 and 4), {TPSP_LABEL}")
    for name in ("layer_norm_fwd", "layer_norm_bwd"):
        rows.append(dict(
            name=name, route="cuda", source=LN_SOURCE, replaces=REPLACES[name],
            launches=long_launches[name], launches_on=f"{LONG_CONFIG} training",
            shape="dalle_4k R=17408 E=1024 bf16", **{k: ln[name][k] for k in keys},
            tpsp_launches=[r[name] for r in tpsp_per_rank], tpsp_launches_on=tpsp_on,
        ))
    for name in ("ring_partial", "ring_block_grads"):
        rows.append(dict(
            name=name, route="cuda", source=RING_SOURCE, replaces=REPLACES[name],
            launches=ring_launches[name],
            launches_per_rank=[r[name] for r in ring_per_rank],
            launches_on=f"{LONG_CONFIG} ring training, {RING_LABEL}",
            shape="past hop B=4 H=8 S_local=1088 D=128 bf16", **measured(ring_rows["past"][name]),
            tpsp_launches=[r[name] for r in tpsp_per_rank], tpsp_launches_on=tpsp_on,
            tpsp_rank=dict(shape="past hop B=4 H=4 (heads 4-7 of 8) S_local=2176 D=128 bf16 "
                                 "(a TP x SP rank's block)",
                           **measured(ring_rows["tpsp_past"][name])),
        ))
    for name in ("ring_partial", "ring_block_grads"):  # the fp32 instantiations
        per_rank = [v[name] for v in ring_values["launches"]]
        rows.append(dict(
            name=name, route="cuda", source=RING_SOURCE, replaces=REPLACES[name],
            launches=sum(per_rank), launches_per_rank=per_rank,
            launches_on=f"ring values check: 2-layer fp32 model on {VALUES_MESH}, {RING_LABEL}",
            shape="past hop B=4 H=8 S_local=1088 D=128 fp32", **measured(ring_rows["fp32"][name]),
            tpsp_values_launches=[v[name] for v in ring_values["tpsp"]["launches"]],
            tpsp_values_launches_on=f"ring values check's fourth arm: the 2-layer fp32 model on "
                                    f"{TPSP_MESH}, {TPSP_LABEL}",
        ))
    total = time.perf_counter() - t0
    print("phase_seconds", json.dumps(phase_s), flush=True)
    print(f"chip_smoke: every phase, the build included, in {total:.1f}s (the budget is "
          f"{RUN_LIMIT_S} s: {'within' if total <= RUN_LIMIT_S else 'OVER'} it)", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
