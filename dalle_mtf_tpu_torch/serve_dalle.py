"""Batching HTTP inference server for DALLE + VAE on one GPU (port of the
root ``serve_dalle.py``, whole-batch engine).

    python -m dalle_mtf_tpu_torch.serve_dalle --model dalle_coco \
        --weights dalle.npz --vae-weights vae.npz --port 8000 --batch-size 4

    curl -s localhost:8000/generate -d '{"text": "a red cube", "n": 2}'
    # -> {"images": ["<base64 png>", ...], "latency_s": ...}

Weights are ``.npz`` files as ``utils/convert.py::save_npz`` writes them,
keyed by the JAX tree's paths. Without ``--weights``/``--vae-weights`` the
model is initialized from ``--seed`` (random weights: for trying the server
out, not for real images).
"""

from __future__ import annotations

import argparse
import logging

import torch

from dalle_mtf_tpu_torch.data.tokenizer import get_tokenizer
from dalle_mtf_tpu_torch.quantize import cast_decode_weights
from dalle_mtf_tpu_torch.serve import BatchingSampler, make_server
from dalle_mtf_tpu_torch.train.tasks import make_dalle_models
from dalle_mtf_tpu_torch.utils.config import fetch_model_params
from dalle_mtf_tpu_torch.utils.convert import (
    dalle_params_from_numpy,
    load_npz,
    vae_params_from_numpy,
)

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
                   help="continuous batching (not yet ported)")
    p.add_argument("--int8", action="store_true",
                   help="int8 decode weights (not yet ported)")
    p.add_argument("--quantize", choices=("none", "int8", "int4"),
                   default=None, help="decode-weight quantization "
                   "(only 'none' is ported)")
    return p.parse_args(argv)


def load_models(params, args):
    """(dalle, dalle_params, vae, vae_params) for serving on args.device."""
    dalle, vae = make_dalle_models(params, args.device)
    if args.weights:
        dalle_params = dalle_params_from_numpy(load_npz(args.weights), dalle)
    else:
        logger.warning("no --weights: DALLE initialized from seed %d", args.seed)
        dalle_params = dalle.init(torch.Generator().manual_seed(args.seed))
    if args.vae_weights:
        vae_params = vae_params_from_numpy(load_npz(args.vae_weights), vae)
    else:
        logger.warning("no --vae-weights: VAE initialized from seed %d", args.seed + 1)
        vae_params = vae.init(torch.Generator().manual_seed(args.seed + 1))
    # unquantized serving casts the fp32 masters to the compute dtype ONCE,
    # so the decode loop streams bf16 and converts nothing per token
    dalle_params = cast_decode_weights(dalle_params, dalle.cfg.policy.compute_dtype)
    return dalle, dalle_params, vae, vae_params


def main(argv=None):
    args = parse_args(argv)
    if args.continuous:
        raise NotImplementedError("--continuous: not yet ported")
    if args.int8 or args.quantize not in (None, "none"):
        raise NotImplementedError("--int8/--quantize: not yet ported")
    logging.basicConfig(level=logging.INFO)
    params = fetch_model_params(args.model)
    if params["model_type"] != "dalle":
        raise ValueError(f"{args.model} is not a dalle config")
    tokenizer = get_tokenizer()
    dalle, dalle_params, vae, vae_params = load_models(params, args)
    batch = args.batch_size or params["predict_batch_size"] or 4
    sampler = BatchingSampler(
        dalle, dalle_params, vae, vae_params,
        batch_size=batch, temperature=args.temperature, top_k=args.top_k,
        linger_ms=args.linger_ms, seed=args.seed,
    )
    # first request builds the kernels, so a client's first call doesn't
    warm = sampler.submit([tokenizer.pad_token_id] * dalle.cfg.text_seq_len, 1)
    warm.result()
    logger.info("sampler warm on %s, batch=%d", args.device, batch)
    server = make_server(
        sampler, tokenizer, dalle.cfg.text_seq_len, host=args.host, port=args.port,
    )
    logger.info("serving on %s:%d", args.host, args.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        # graceful: resolve every already-accepted request before exiting
        sampler.drain(timeout=300)


if __name__ == "__main__":
    main()
