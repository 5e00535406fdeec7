"""Synthetic smoke-test dataset (port of ``dalle_mtf_tpu/data/smoke_data.py``):
colored-quadrant images.

Each image is four quadrants with independent random base colors plus
per-pixel noise, so a working VAE must learn spatial structure rather than a
constant. The reference validated with random-caption CIFAR smoke runs
(reference src/data/create_tfrecords.py:59-97); this is the offline
generator, seeded, and the same images as the JAX package's.

Usage:
    python -m dalle_mtf_tpu_torch.data.smoke_data            # writes data/smoke_imgs
    python -m dalle_mtf_tpu_torch.data.smoke_data --tfrecords  # + data/smoke_tfrecords
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def make_quadrant_images(out_dir: str = "data/smoke_imgs", n_images: int = 64, size: int = 32,
                         noise: float = 0.45, seed: int = 0) -> list[str]:
    """Write ``n_images`` colored-quadrant JPEGs (quality 95) of ``size``²
    to ``out_dir``; returns their paths."""
    from PIL import Image  # noqa: PLC0415

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    half = size // 2
    paths = []
    for i in range(n_images):
        img = np.zeros((size, size, 3), np.float32)
        for qy in (0, 1):
            for qx in (0, 1):
                base = rng.uniform(0.15, 0.85, size=(1, 1, 3))
                block = base + rng.normal(0.0, noise, (half, half, 3))
                img[qy * half:(qy + 1) * half, qx * half:(qx + 1) * half] = block
        arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        path = os.path.join(out_dir, f"smoke_{i:03d}.jpg")
        Image.fromarray(arr).save(path, quality=95)
        paths.append(path)
    return paths


def make_smoke_tfrecords(img_glob: str = "data/smoke_imgs/*.jpg",
                         out_dir: str = "data/smoke_tfrecords",
                         words_per_caption: int = 8) -> None:
    """Random-caption paired tfrecords over the smoke images, 32 a file
    (``create_random_dataset`` into data/smoke_paired, then
    ``create_paired_dataset``)."""
    from dalle_mtf_tpu_torch.data.create_tfrecords import (  # noqa: PLC0415
        create_paired_dataset,
        create_random_dataset,
    )

    jsonl = create_random_dataset(img_glob, "data/smoke_paired",
                                  words_per_caption=words_per_caption)
    create_paired_dataset(jsonl, "smoke", out_dir, examples_per_file=32)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/smoke_imgs")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--tfrecords", action="store_true")
    args = ap.parse_args()
    paths = make_quadrant_images(args.out, args.n, args.size)
    print(f"wrote {len(paths)} images to {args.out}")
    if args.tfrecords:
        make_smoke_tfrecords(os.path.join(args.out, "*.jpg"))
        print("wrote data/smoke_tfrecords")
