"""Dataset builder and CLI (port of ``dalle_mtf_tpu/data/create_tfrecords.py``):
tfrecord shards of ``{image: jpeg bytes, caption: token ids}``.

Parity with the reference's src/data/create_tfrecords.py: jsonl helpers
(:16-35), Example serialization (:38-56), ``create_random_dataset``, which
gives an image glob random captions for smoke tests (:59-97), and
``create_paired_dataset``, which shards a captions jsonl into .tfrecords
files (:100-178). Two reference bugs are fixed, as in the JAX package: the
whole caption is tokenized (the reference took ``item["caption"][0]``, its
first character, :171), and a full shard rolls over to a new file name (the
reference reopened the same name before counting up, :160-163, overwriting
the first rollover shard).

    python -m dalle_mtf_tpu_torch.data.create_tfrecords paired <jsonl> \
        --name <name> --out <dir or URL> [--examples-per-file 1000] [--reencode]
    python -m dalle_mtf_tpu_torch.data.create_tfrecords random '<image glob>' \
        --out <dir>
    python -m dalle_mtf_tpu_torch.data.create_tfrecords encode \
        --input '<image tfrecords glob>' --out <dir or URL> --name <name> \
        --encode-with <vae config> [--vae-checkpoint-path <dir or .npz>] \
        [--batch-size 64] [--examples-per-file 10000] [--device cuda|cpu]

``paired`` writes ``<name>_<i>.tfrecords`` from a jsonl of ``{caption,
image_path}`` (image paths relative to the jsonl; ``--reencode``: each image
decoded and written again as a quality-94 JPEG); ``--out`` may be a URL
(gs://..., memory://...), the jsonl and the images are read locally.
``random`` copies an image glob into ``--out`` and writes
``captions_data.jsonl`` beside it with random captions from a fixed word
pool, seeded. ``encode`` runs a trained VAE over image + caption tfrecords and
writes the ``{tokens, caption}`` records that tokens mode trains on
(``data/encode_dataset.py``), on ``--device`` (default ``cuda``; without a
card it raises unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import glob as globlib
import io
import json
import os
import random
import shutil
from pathlib import Path
from typing import Iterable

from dalle_mtf_tpu_torch.data import fs
from dalle_mtf_tpu_torch.data.tfrecord import TFRecordWriter, serialize_example
from dalle_mtf_tpu_torch.data.tokenizer import get_tokenizer

# a small word pool for create_random_dataset (the reference fetched a 10k
# word list over HTTP, create_tfrecords.py:70-73; the pool keeps smoke
# datasets offline and deterministic)
_WORDS = (
    "time year people way day man thing woman life child world school state "
    "family student group country problem hand part place case week company "
    "system program question work government number night point home water "
    "room mother area money story fact month lot right study book eye job "
    "word business issue side kind head house service friend father power "
    "hour game line end member law car city community name president team "
    "minute idea body information back parent face others level office door "
    "health person art war history party result change morning reason "
    "research girl guy moment air teacher force education"
).split()


def dump_jsonl(data: Iterable[dict], path: str | Path, append: bool = False):
    with open(path, "a" if append else "w") as f:
        for item in data:
            f.write(json.dumps(item) + "\n")


def load_jsonl(path: str | Path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _reencode_jpeg(path: str, quality: int = 94) -> bytes:
    """The image at ``path`` as RGB JPEG bytes at ``quality`` (the
    reference re-encoded with cv2 at 94, create_tfrecords.py:164-169)."""
    from PIL import Image  # noqa: PLC0415

    img = Image.open(path).convert("RGB")
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def create_random_dataset(path_to_images: str, out_dir: str, max_images_per_folder: int = 1000,
                          words_per_caption: int = 50, seed: int = 0) -> str:
    """Copy the images of a glob into ``out_dir``/<i // max_images_per_folder>/
    and write ``out_dir``/captions_data.jsonl with a random caption of
    ``words_per_caption`` words for each (seeded); returns the jsonl's path."""
    rng = random.Random(seed)
    out = Path(out_dir)
    os.makedirs(out, exist_ok=True)
    jsonl_path = out / "captions_data.jsonl"
    images = sorted(globlib.glob(path_to_images, recursive=True))
    print(f"{len(images)} images found")
    items = []
    for i, image in enumerate(images):
        folder = str(i // max_images_per_folder)
        os.makedirs(out / folder, exist_ok=True)
        dst = out / folder / Path(image).name
        if not dst.exists():
            shutil.copy(image, dst)
        items.append({
            "caption": " ".join(rng.choice(_WORDS) for _ in range(words_per_caption)),
            "image_path": str(Path(folder) / Path(image).name),
        })
    dump_jsonl(items, jsonl_path)
    return str(jsonl_path)


def create_paired_dataset(path_to_jsonl: str, name: str, out_dir: str,
                          examples_per_file: int = 1000, reencode: bool = False,
                          tokenizer=None) -> int:
    """jsonl [{caption, image_path}] -> ``out_dir``/<name>_<i>.tfrecords,
    ``examples_per_file`` records a file; returns the number of files.
    ``out_dir`` may be a URL (the shards stream through fsspec); the jsonl
    and the images (paths relative to the jsonl) are read locally."""
    out_dir = str(out_dir)
    base_dir = Path(path_to_jsonl).parent
    fs.makedirs(out_dir)
    if tokenizer is None:
        tokenizer = get_tokenizer()
    items = load_jsonl(path_to_jsonl)

    writer, shard, written = None, 0, 0
    try:
        for item in items:
            if writer is None or written >= examples_per_file:
                if writer is not None:
                    writer.close()
                    shard += 1
                writer = TFRecordWriter(f"{out_dir.rstrip('/')}/{name}_{shard}.tfrecords")
                written = 0
            image_path = str(base_dir / item["image_path"])
            if reencode:
                image_bytes = _reencode_jpeg(image_path)
            else:
                with open(image_path, "rb") as f:
                    image_bytes = f.read()
            writer.write(serialize_example({"image": image_bytes,
                                            "caption": tokenizer.encode(item["caption"])}))
            written += 1
    finally:
        if writer is not None:
            writer.close()
    total_shards = shard + (1 if written else 0)
    print(f"wrote {len(items)} examples into {total_shards} shard(s) in {out_dir}")
    return total_shards


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="create_tfrecords", description=(
        "paired: jsonl -> image + caption tfrecords; random: captions for an image glob; "
        "encode: image + caption tfrecords -> {tokens, caption} tfrecords through a "
        "trained VAE."))
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("paired", help="jsonl -> sharded image tfrecords")
    pp.add_argument("jsonl")
    pp.add_argument("--name", required=True)
    pp.add_argument("--out", required=True, help="a directory or a URL (gs://, memory://...)")
    pp.add_argument("--examples-per-file", type=int, default=1000)
    pp.add_argument("--reencode", action="store_true",
                    help="write each image again as a quality-94 JPEG")

    pr = sub.add_parser("random", help="random captions for an image glob")
    pr.add_argument("glob")
    pr.add_argument("--out", required=True)

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


def main(argv=None):
    """Run the subcommand: ``paired`` and ``encode`` return the number of
    files written, ``random`` the jsonl's path."""
    args = parse_args(argv)
    if args.cmd == "paired":
        return create_paired_dataset(args.jsonl, args.name, args.out,
                                     examples_per_file=args.examples_per_file,
                                     reencode=args.reencode)
    if args.cmd == "random":
        return create_random_dataset(args.glob, args.out)
    from dalle_mtf_tpu_torch.data.encode_dataset import encode_with_config  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.distributed import rank_device  # noqa: PLC0415

    return encode_with_config(
        args.input, args.out, args.name, args.encode_with,
        vae_checkpoint_path=args.vae_checkpoint_path,
        batch_size=args.batch_size,
        examples_per_file=args.examples_per_file,
        device=rank_device(None, args.device),
    )


if __name__ == "__main__":
    main()
