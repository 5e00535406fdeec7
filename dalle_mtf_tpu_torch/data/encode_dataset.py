"""Offline image → token encoding (port of
``dalle_mtf_tpu/data/encode_dataset.py``): run the frozen stage-1 VAE over
an image + caption tfrecord dataset once and write ``{tokens, caption}``
records, which tokens mode (``dataset.tokens: true``) trains on without a
VAE forward a step.

Captions are copied verbatim (the raw, unpadded ids of the source record)
and the tokens are the raw codebook ids of the same ``encode_tokens``
argmax the image mode computes in the step; the text-vocab offset is
applied when training reads them (``train/tasks.py``), so a tokens-mode
batch is the image-mode batch.

CLI: ``python -m dalle_mtf_tpu_torch.data.create_tfrecords encode
--encode-with <vae_config> --input '<glob>' --out <dir or URL> --name <name>``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from dalle_mtf_tpu_torch.data import fs
from dalle_mtf_tpu_torch.data.pipeline import decode_img
from dalle_mtf_tpu_torch.data.tfrecord import (
    TFRecordWriter,
    parse_example,
    read_tfrecord_file,
    serialize_example,
)

logger = logging.getLogger(__name__)


def encode_dataset(
    input_glob: str,
    out_dir: str,
    name: str,
    vae,
    vae_params,
    image_size: int,
    channels: int = 3,
    batch_size: int = 64,
    examples_per_file: int = 10_000,
) -> int:
    """Encode every record of ``input_glob`` through ``vae`` (on
    ``vae.device``) and write ``<name>_N.tfrecords`` of ``{tokens, caption}``
    to ``out_dir``, in record order, a new file every ``examples_per_file``
    records (``out_dir`` may be a URL). The last partial batch is padded to ``batch_size`` with copies
    of its last image for the device call, and trimmed after. Returns the
    number of files."""
    files = fs.list_files(input_glob)
    if not files:
        raise FileNotFoundError(f"no input files match {input_glob!r}")
    fs.makedirs(out_dir)
    writer, shard, written, total = None, 0, 0, 0
    images: list[np.ndarray] = []
    captions: list[list[int]] = []

    def flush():
        nonlocal writer, shard, written, total
        if not images:
            return
        n = len(images)
        batch = np.stack(images + images[-1:] * (batch_size - n))
        with torch.no_grad():
            tokens = vae.encode_tokens(vae_params, torch.from_numpy(batch).to(vae.device))
        for t, cap in zip(tokens[:n].cpu().numpy(), captions):
            if writer is None or written >= examples_per_file:
                if writer is not None:
                    writer.close()
                    shard += 1
                writer = TFRecordWriter(fs.join(out_dir, f"{name}_{shard}.tfrecords"))
                written = 0
            writer.write(serialize_example({"tokens": t.tolist(), "caption": cap}))
            written += 1
            total += 1
        images.clear()
        captions.clear()

    try:
        for f in files:
            for record in read_tfrecord_file(f):
                ex = parse_example(record)
                images.append(decode_img(ex["image"][0], image_size, channels))
                captions.append([int(c) for c in ex.get("caption", [])])
                if len(images) == batch_size:
                    flush()
        flush()
    finally:
        if writer is not None:
            writer.close()
    shards = shard + (1 if written else 0)
    logger.info("encoded %d examples (%d tokens each) into %d file(s) in %s",
                total, vae.cfg.image_seq_len, shards, out_dir)
    return shards


def encode_with_config(
    input_glob: str,
    out_dir: str,
    name: str,
    vae_config: str,
    vae_checkpoint_path: str | None = None,
    batch_size: int = 64,
    examples_per_file: int = 10_000,
    device: torch.device | str = "cuda",
) -> int:
    """The CLI's form: the VAE of config ``vae_config`` on ``device``,
    restored from ``vae_checkpoint_path`` (a directory or an ``.npz``) or
    else the config's ``model_path``, then ``encode_dataset``."""
    from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.restore import restore_vae_params  # noqa: PLC0415

    vparams = fetch_model_params(vae_config)
    vae = DiscreteVAE(VAEConfig.from_params(vparams), device)
    vae_params = restore_vae_params(vae, vae_checkpoint_path or vparams["model_path"])
    return encode_dataset(
        input_glob, out_dir, name, vae, vae_params,
        image_size=vparams["dataset"]["image_size"],
        channels=vparams.get("n_channels") or 3,
        batch_size=batch_size,
        examples_per_file=examples_per_file,
    )
