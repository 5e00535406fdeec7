"""The dataset CLI (port of ``dalle_mtf_tpu/data/create_tfrecords.py``):

    python -m dalle_mtf_tpu_torch.data.create_tfrecords encode \
        --input '<image tfrecords glob>' --out <dir> --name <name> \
        --encode-with <vae config> [--vae-checkpoint-path <dir or .npz>] \
        [--batch-size 64] [--examples-per-file 10000] [--device cuda|cpu]

``encode`` runs a trained VAE over image + caption tfrecords and writes the
``{tokens, caption}`` records that tokens mode trains on
(``data/encode_dataset.py``), on ``--device`` (default ``cuda``; without a
card it raises unless ``--device cpu``).
"""

from __future__ import annotations

import argparse

from dalle_mtf_tpu_torch.data.encode_dataset import encode_with_config
from dalle_mtf_tpu_torch.utils.distributed import rank_device

UNPORTED = ("paired", "random")  # ROADMAP.md queue 1 item 6


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="create_tfrecords",
        description="encode: image + caption tfrecords -> {tokens, caption} tfrecords "
                    "through a trained VAE. paired and random are not ported yet.")
    sub = p.add_subparsers(dest="cmd", required=True)
    for cmd in UNPORTED:
        sub.add_parser(cmd, help="not ported yet")
    pe = sub.add_parser("encode", help="images -> VAE token tfrecords")
    pe.add_argument("--input", required=True, help="image tfrecords glob")
    pe.add_argument("--out", required=True)
    pe.add_argument("--name", required=True)
    pe.add_argument("--encode-with", required=True, metavar="VAE_CONFIG",
                    help="VAE config name/path; its model_path supplies the checkpoint")
    pe.add_argument("--vae-checkpoint-path", default=None,
                    help="the VAE's model_path (or an .npz of its tree) instead of the config's")
    pe.add_argument("--batch-size", type=int, default=64)
    pe.add_argument("--examples-per-file", type=int, default=10_000)
    pe.add_argument("--device", default="cuda",
                    help="torch device to encode on ('cpu' only when asked for)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Run the subcommand; ``encode`` returns the number of files written."""
    args = parse_args(argv)
    if args.cmd in UNPORTED:
        raise NotImplementedError(f"create_tfrecords {args.cmd} is not ported yet")
    return encode_with_config(
        args.input, args.out, args.name, args.encode_with,
        vae_checkpoint_path=args.vae_checkpoint_path,
        batch_size=args.batch_size,
        examples_per_file=args.examples_per_file,
        device=rank_device(None, args.device),
    )


if __name__ == "__main__":
    main()
