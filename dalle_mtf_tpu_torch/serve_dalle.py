"""Batching HTTP inference server for DALLE + VAE on one GPU (port of the
root ``serve_dalle.py``).

    python -m dalle_mtf_tpu_torch.serve_dalle --model dalle_coco \
        --weights dalle.npz --vae-weights vae.npz --port 8000 --batch-size 4 \
        [--quantize int8|int4 | --int8] [--continuous --chunk 128]

    curl -s localhost:8000/generate -d '{"text": "a red cube", "n": 2}'
    # -> {"images": ["<base64 png>", ...], "latency_s": ...}

Weights are ``.npz`` files as ``utils/convert.py::save_npz`` writes them,
keyed by the JAX tree's paths. Without ``--weights``/``--vae-weights`` the
model is initialized from ``--seed`` (random weights: for trying the server
out, not for real images). ``--quantize`` quantizes the loaded fp32 masters
for decoding (a tree that is already quantized is served as it is); the
streaming dequant kernels run when the config sets ``decode_kernels``.
``--continuous`` serves with the continuous-batching engine.

Over the ranks of a tensor-parallel mesh, started by ``torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m dalle_mtf_tpu_torch.serve_dalle --model dalle_coco --port 8000

the config's ``mesh_shape`` and ``layout``, resized to the world, place the
ranks. Each rank holds its blocks (``--weights`` cut by
``utils/convert.py::shard_dalle_params``, else drawn by the sharded
``DALLE.init``) and quantizes after sharding (a tree that is already
quantized cannot be cut into blocks and is refused); rank 0 alone binds
HTTP and runs the engine, and sends every other rank its orders
(``serve.GroupCommands``); they follow until rank 0 drains. Every model
group decodes the whole batch. Ranks that share a card talk over gloo:
their figures are not multi-GPU numbers. Each collective of the model
waits at most the process group's timeout (torch's default), so a rank that
fails makes the others raise instead of hanging.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch
import torch.distributed as dist

from dalle_mtf_tpu_torch.data.tokenizer import get_tokenizer
from dalle_mtf_tpu_torch.quantize import (
    cast_decode_weights,
    quantize_layers_int4,
    quantize_layers_int8,
)
from dalle_mtf_tpu_torch.parallel.mesh import (
    build_mesh,
    check_layout,
    parse_layout,
    parse_mesh_shape,
    refuse_layers,
    resize_axes,
)
from dalle_mtf_tpu_torch.serve import (
    BatchingSampler,
    ContinuousBatchingSampler,
    GroupCommands,
    follow,
    make_server,
)
from dalle_mtf_tpu_torch.train.tasks import make_dalle_models
from dalle_mtf_tpu_torch.utils.config import fetch_model_params
from dalle_mtf_tpu_torch.utils.convert import (
    dalle_params_from_numpy,
    load_npz,
    quantize_mode,
    shard_dalle_params,
    vae_params_from_numpy,
)
from dalle_mtf_tpu_torch.utils.distributed import init_distributed

logger = logging.getLogger(__name__)

def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--weights", type=str, default=None,
                   help="DALLE parameters (.npz keyed by tree path)")
    p.add_argument("--vae-weights", type=str, default=None,
                   help="VAE parameters (.npz keyed by tree path)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=None,
                   help="server batch rows (default: config "
                        "predict_batch_size, else 4)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=64)
    p.add_argument("--linger-ms", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching: requests join the live batch "
                        "at --chunk-step boundaries instead of waiting out "
                        "the in-flight generation")
    p.add_argument("--chunk", type=int, default=128,
                   help="decode steps between admissions in --continuous mode")
    p.add_argument("--int8", action="store_true",
                   help="int8 decode weights (as --quantize int8)")
    p.add_argument("--quantize", choices=("none", "int8", "int4"),
                   default=None, help="decode-weight quantization (int4 packs "
                   "two values per byte: 4x less weight stream than bf16)")
    return p.parse_args(argv)


def load_models(params, args, device=None, mesh=None):
    """(dalle, dalle_params, vae, vae_params) for serving on ``device``
    (default args.device): the DALLE on ``mesh`` (this rank's blocks on a
    tensor-parallel one), the VAE whole."""
    dalle, vae = make_dalle_models(params, device or args.device, mesh)
    if args.weights:
        tree = load_npz(args.weights)
        if quantize_mode(tree) != "none":
            _refuse_blocks(dalle)
            dalle_params = dalle_params_from_numpy(tree, dalle)
        else:
            dalle_params = shard_dalle_params(tree, dalle)
    else:
        logger.warning("no --weights: DALLE initialized from seed %d", args.seed)
        dalle_params = dalle.init(torch.Generator().manual_seed(args.seed))
    if args.vae_weights:
        vae_params = vae_params_from_numpy(load_npz(args.vae_weights), vae)
    else:
        logger.warning("no --vae-weights: VAE initialized from seed %d", args.seed + 1)
        vae_params = vae.init(torch.Generator().manual_seed(args.seed + 1))
    return dalle, decode_weights(dalle, dalle_params, args), vae, vae_params


def decode_weights(dalle, dalle_params, args) -> dict:
    """The DALLE tree as the decode loop reads it: quantized as
    ``--quantize``/``--int8`` ask (a tree that is already quantized as it
    is), else the fp32 masters cast ONCE to the compute dtype, so the loop
    streams bf16 and converts nothing per token."""
    quant = args.quantize or ("int8" if args.int8 else "none")
    if quantize_mode(dalle_params) != "none":
        _refuse_blocks(dalle)
        logger.info("serving the loaded %s weights as they are", quantize_mode(dalle_params))
        return dalle_params
    if quant == "int8":
        return quantize_layers_int8(dalle_params, dalle.sharding)
    if quant == "int4":
        return quantize_layers_int4(dalle_params, dalle.sharding)
    return cast_decode_weights(dalle_params, dalle.cfg.policy.compute_dtype)


def _refuse_blocks(dalle) -> None:
    """A quantized tree cannot be cut into a rank's blocks: its int4 rows
    are paired over the whole contraction axis and its scales are keyed to
    the whole leaves. Quantize the fp32 masters after sharding instead."""
    if dalle.sharding is not None:
        raise ValueError("a quantized DALLE tree cannot be cut into a rank's blocks: serve the "
                         "fp32 masters with --quantize under a tensor-parallel mesh")


def join_group(params, args):
    """This process's (proc, mesh): the process group
    ``torch.distributed.run`` describes, joined after the config's layout is
    checked against the world size (a ``layers`` rule, pipeline
    parallelism, raises: sampling and serving run no pipeline, ROADMAP
    queue 1 item 5c-iv), and the config's mesh resized to it."""
    attention = params.get("attention_type") or "global"
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:  # before the process group is joined
        axes = resize_axes(parse_mesh_shape(params.get("mesh_shape")), world)
        rules = parse_layout(params.get("layout"))
        refuse_layers(axes, rules, "sampling and serving", "5c-iv")
        check_layout(axes, rules, attention)
    proc = init_distributed(None, args.device)
    return proc, build_mesh(params.get("mesh_shape"), params.get("layout"), attention,
                            proc.rank, proc.world)


def build_server(argv=None):
    """Load the models, start the engine ``argv`` asks for, warm it (one
    request, or where the decoder captures nothing one prefill), and bind
    the HTTP server. Returns (sampler, server); the caller
    runs ``server.serve_forever()`` and drains the sampler. Launched over
    several processes, it joins their process group (and leaves it to the
    caller); on every rank but 0 it returns (sampler, None) at once, and the
    caller runs ``serve.follow(sampler)``, which returns when rank 0 drains."""
    args = parse_args(argv)
    params = fetch_model_params(args.model)
    if params["model_type"] != "dalle":
        raise ValueError(f"{args.model} is not a dalle config")
    tokenizer = get_tokenizer()
    proc, mesh = join_group(params, args)
    dalle, dalle_params, vae, vae_params = load_models(params, args, proc.device, mesh)
    batch = args.batch_size or params["predict_batch_size"] or 4
    commands = GroupCommands(batch, dalle.cfg.text_seq_len) if proc.world > 1 else None
    if args.continuous:
        sampler = ContinuousBatchingSampler(
            dalle, dalle_params, vae, vae_params,
            batch_size=batch, temperature=args.temperature, top_k=args.top_k,
            seed=args.seed, chunk=args.chunk, commands=commands,
        )
    else:
        sampler = BatchingSampler(
            dalle, dalle_params, vae, vae_params,
            batch_size=batch, temperature=args.temperature, top_k=args.top_k,
            linger_ms=args.linger_ms, seed=args.seed, commands=commands,
        )
    # what a client's first call would pay, paid now: the kernels' build
    # and the default bucket's decode graph (one request); a decoder that
    # captures nothing (sample.capture_rule: a model group, the CPU) needs
    # the kernels only, built by one prefill on every rank
    pad = [tokenizer.pad_token_id] * dalle.cfg.text_seq_len
    if not sampler._decoder.captures:
        sampler._decoder.warm(torch.tensor([pad] * batch, device=dalle.device))
    if proc.rank != 0:
        return sampler, None
    if sampler._decoder.captures:
        sampler.submit(pad, 1).result()
    logger.info("sampler warm on %s, batch=%d, %s", proc.device, batch, mesh)
    server = make_server(
        sampler, tokenizer, dalle.cfg.text_seq_len, host=args.host, port=args.port,
    )
    return sampler, server


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    sampler, server = build_server(argv)
    try:
        if server is None:  # a rank other than 0: rank 0's orders until it drains
            follow(sampler)
            return
        logger.info("serving on %s:%d", *server.server_address[:2])
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            # graceful: resolve every already-accepted request before exiting
            sampler.drain(timeout=300)
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
