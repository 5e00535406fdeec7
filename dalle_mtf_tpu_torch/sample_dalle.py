"""Generate images from text with a trained DALLE + VAE (port of the root
``sample_dalle.py``, with the same flags):

    python -m dalle_mtf_tpu_torch.sample_dalle --model dalle_coco \
        --text "a red square" --out samples/ --n 4 --temperature 1.0 \
        --top_k 64 [--top_p 0.9] [--seed 0] [--quantize int8|int4 | --int8] \
        [--device cuda|cpu]

Over the ranks of a tensor-parallel mesh, started by ``torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m dalle_mtf_tpu_torch.sample_dalle --model dalle_coco --text "..."

The DALLE weights are the latest ``ckpt_<step>.pt`` under
``<model_path>/checkpoints`` (what ``train_dalle`` writes; ``model_path`` may
be a URL, gs:// or memory://, whose file is read whole); the VAE is
restored as ``train_dalle`` restores it (``vae_checkpoint_path``, else the
VAE config's ``model_path``). The weights are cast or quantized for decoding
as the server does (``serve_dalle.decode_weights``), the batch of ``--n``
rows is generated through ``sample.generate_image_tokens`` (on the card the
captured decode loop) and decoded by the VAE, and ``sample_<i>.png`` is
written for each image. Runs on ``--device`` (default ``cuda``, which
raises without a card).

On several processes the config's ``mesh_shape`` and ``layout``, resized
to the world as ``train_dalle`` resizes them, place the ranks: each rank
reads only its blocks of the checkpoint (the file mapped, a block copied
out of it) and quantizes after sharding, as the root CLI does; every model
group decodes the whole batch, and rank 0 alone decodes the pixels and
writes the PNGs. Sampling never runs the ring: under ring attention the
prefill and the decode attend over the rank's heads (as JAX's
``causal_attention_tp``), so a sequence axis beside the model axis
(``data:1,seq:2,model:2``) only copies the model group. A layout the port
does not run (here: pipeline parallelism, ROADMAP queue 1 item 5c-iv)
raises before the process group is joined.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import torch
import torch.distributed as dist

from dalle_mtf_tpu_torch.data import fs
from dalle_mtf_tpu_torch.data.tokenizer import get_tokenizer, pad_or_truncate
from dalle_mtf_tpu_torch.parallel.tensor import block_to
from dalle_mtf_tpu_torch.sample import generate_image_tokens
from dalle_mtf_tpu_torch.serve_dalle import decode_weights, join_group
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.train.tasks import make_dalle_models
from dalle_mtf_tpu_torch.train.trainer import checkpoint_steps
from dalle_mtf_tpu_torch.train_dalle import load_vae_params
from dalle_mtf_tpu_torch.utils import checkpoint
from dalle_mtf_tpu_torch.utils.config import fetch_model_params
from dalle_mtf_tpu_torch.utils.convert import _check, nest
from dalle_mtf_tpu_torch.utils.logging_utils import setup_logging
from dalle_mtf_tpu_torch.utils.png import encode_png
from dalle_mtf_tpu_torch.utils.restore import _ckpt_dir

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--text", type=str, required=True)
    parser.add_argument("--n", type=int, default=None,
                        help="images to generate (default: config predict_batch_size, else 1)")
    parser.add_argument("--out", type=str, default="samples")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--top_k", type=int, default=0)
    parser.add_argument("--top_p", type=float, default=None,
                        help="nucleus sampling: keep the smallest candidate set with "
                             "cumulative probability >= top_p")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quantize", choices=("none", "int8", "int4"), default=None,
                        help="decode-weight quantization (int4 = 4x less weight stream)")
    parser.add_argument("--int8", action="store_true",
                        help="quantize decode weights to int8 (as --quantize int8)")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def load_dalle_params(params, dalle) -> dict:
    """The parameter tree of the latest DALLE checkpoint under the config's
    ``model_path``, on ``dalle.device``: this rank's blocks of it where the
    model is split over a tensor-parallel axis (the file mapped, each block
    copied out of it, as ``Trainer.restore`` does), every name and whole
    shape, and then every local shape, checked against ``dalle``."""
    d = _ckpt_dir(params["model_path"])
    steps = checkpoint_steps(d)
    if not steps:
        raise FileNotFoundError(f"no DALLE checkpoint under {params['model_path']}")
    obj = checkpoint.read(fs.join(d, f"ckpt_{steps[-1]}.pt"))
    tree = nest(obj["params"])
    try:
        _check(tree, dalle.param_shapes(whole=True))
    except (KeyError, ValueError) as e:
        raise ValueError(f"DALLE checkpoint at step {steps[-1]} under {params['model_path']} "
                         f"does not match the config: {e}") from None
    sharding = dalle.sharding
    blocks: dict = {}
    for path, _ in named_leaves(dalle.param_shapes()):
        node, parent = tree, blocks
        for name in path[:-1]:
            node, parent = node[name], parent.setdefault(name, {})
        parent[path[-1]] = block_to(node[path[-1]], sharding.of(path) if sharding else None,
                                    dalle.device)
    _check(blocks, dalle.param_shapes())
    logger.info("restored DALLE checkpoint at step %d", int(obj["step"]))
    return blocks


def main(argv=None) -> list[str]:
    """Write the images; returns their paths (on rank 0; the other ranks
    of a launch over several processes return [])."""
    args = parse_args(argv)
    params = fetch_model_params(args.model)
    if params["model_type"] != "dalle":
        raise ValueError(f"{args.model} is not a dalle config")
    owns_group = not (dist.is_available() and dist.is_initialized())
    proc, mesh = join_group(params, args)
    try:
        return _sample(args, params, proc, mesh)
    finally:
        if owns_group and proc.world > 1:
            dist.destroy_process_group()


def _sample(args, params, proc, mesh) -> list[str]:
    setup_logging(params["config_name"] or args.model, rank=proc.rank)
    n = args.n if args.n is not None else (params["predict_batch_size"] or 1)
    tokenizer = get_tokenizer()
    params["padding_id"] = tokenizer.pad_token_id
    ids = pad_or_truncate(tokenizer.encode(args.text), params["text_seq_len"],
                          tokenizer.pad_token_id)
    dalle, vae = make_dalle_models(params, proc.device, mesh)
    text = torch.tensor([ids] * n, dtype=torch.long, device=dalle.device)
    dalle_params = decode_weights(dalle, load_dalle_params(params, dalle), args)
    vae_params = load_vae_params(params, vae) if proc.rank == 0 else None

    t0 = time.time()
    generator = torch.Generator(device=dalle.device).manual_seed(args.seed)
    tokens = generate_image_tokens(dalle, dalle_params, text, generator,
                                   temperature=args.temperature, top_k=args.top_k,
                                   top_p=args.top_p)
    if proc.rank != 0:
        return []
    with torch.inference_mode():
        imgs = vae.decode_tokens(vae_params, tokens).float().cpu().numpy()
    dt = time.time() - t0

    os.makedirs(args.out, exist_ok=True)
    paths = []
    for i, img in enumerate(imgs):
        paths.append(os.path.join(args.out, f"sample_{i}.png"))
        with open(paths[-1], "wb") as f:
            f.write(encode_png(img))
    print(f"wrote {len(imgs)} images to {args.out} ({dt:.2f}s total incl. capture, "
          f"{dalle.cfg.image_seq_len} tokens each, {mesh})")
    return paths


if __name__ == "__main__":
    main()
