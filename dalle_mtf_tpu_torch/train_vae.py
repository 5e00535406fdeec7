"""Train the discrete VAE (stage 1): the port of ``train_vae.py``, with the
same CLI.

    python -m dalle_mtf_tpu_torch.train_vae --model <config name or path> \
        [--new [--yes]] [--gpu_ids 0] [--device cuda|cpu]

One process on one device: ``cuda:<first --gpu_ids>``, else ``--device``
(default ``cuda``). Without a CUDA device it raises: it runs on the CPU only
when asked to with ``--device cpu``. The config's ``mesh_shape`` is resized
to the one process (``parallel.mesh.resize_axes``, the JAX ``build_mesh`` rule:
``vae_example``'s ``data:16,model:2`` trains on one device); a launch over
several processes raises (VAE data parallelism is not ported: ROADMAP
queue 1 item 5b).

Training resumes from the latest checkpoint in ``model_path``, and the data
stream skips the batches already trained on. ``--new`` wipes
``model_path`` first (asking unless ``--yes``). At every checkpoint, after
its eval, input and reconstruction images of a batch from a pipeline of
their own are written to the event file.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from dalle_mtf_tpu_torch.data.pipeline import vae_input_fn
from dalle_mtf_tpu_torch.models.vae import temperature_schedule
from dalle_mtf_tpu_torch.parallel.mesh import parse_mesh_shape, resize_axes
from dalle_mtf_tpu_torch.train.tasks import make_vae_task
from dalle_mtf_tpu_torch.train.trainer import Trainer
from dalle_mtf_tpu_torch.utils.config import fetch_model_params
from dalle_mtf_tpu_torch.utils.distributed import rank_device
from dalle_mtf_tpu_torch.utils.logging_utils import remove_model_dir, setup_logging

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tpu", type=str, help="(compat; unused)")
    parser.add_argument("--gpu_ids", nargs="+", type=str,
                        help="GPU ids; the first one trains (default: --device)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on when --gpu_ids is not given "
                             "('cpu' only when asked for)")
    parser.add_argument("--model", type=str, required=True, help="JSON model config name or path")
    parser.add_argument("--new", action="store_true", help="If set, deletes previous checkpoint, if it exists, and "
                                                           "starts a new training run")
    parser.add_argument("--yes", action="store_true", help="skip the --new confirmation prompt")
    return parser.parse_args(argv)


def _normalize_summary_batch(batch: dict) -> dict:
    """uint8 batches (``dataset.uint8_images``) are normalized by the task
    on the device; the image summaries bypass the task, so normalize here
    with the same (x - 127.5) / 127.5."""
    if batch["image"].dtype == np.uint8:
        batch = dict(batch)
        batch["image"] = (batch["image"].astype(np.float32) - 127.5) / 127.5
    return batch


def main(argv=None) -> Trainer:
    """Run the training the config asks for; returns the closed Trainer
    (its ``history`` and ``eval_history`` hold what was logged, ``state``
    the last step's state)."""
    args = parse_args(argv)
    params = fetch_model_params(args.model)
    if params["model_type"] not in (None, "vae"):
        raise ValueError(f"config {args.model} is not a vae config")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(
            f"VAE data parallelism is not ported yet ({world} processes, mesh_shape "
            f"{params.get('mesh_shape')!r}; ROADMAP.md queue 1 item 5b): train on one process"
        )
    resize_axes(parse_mesh_shape(params.get("mesh_shape")), world)  # logs the resize
    device = rank_device(args.gpu_ids, args.device)
    setup_logging(params["config_name"] or args.model)
    if args.new:
        remove_model_dir(params["model_path"], interactive=not args.yes)

    vae, init_fn, loss_fn, eval_loss_fn = make_vae_task(params, device)
    trainer = Trainer(
        params, init_fn, loss_fn,
        model_dir=params["model_path"],
        seq_len=vae.cfg.image_seq_len,
        device=device,
        eval_loss_fn=eval_loss_fn,
    )
    # the image summaries' batch comes from a pipeline of its own: one taken
    # from the training stream would shift it
    summary_iter = iter(vae_input_fn(params, eval=False))
    summary_batch = _normalize_summary_batch(next(summary_iter))
    summary_iter.close()
    # deterministic data resume: skip the already-trained prefix of the stream
    start_step = trainer.latest_step()
    if start_step:
        logger.info("resume at step %d: data stream skips trained prefix", start_step)
    train_iter = iter(vae_input_fn(params, eval=False, skip_steps=start_step))
    eval_steps = params.get("eval_steps") or 0
    eval_iter = iter(vae_input_fn(params, eval=True)) if eval_steps else None

    @torch.no_grad()
    def summary_fn(tr: Trainer, state, step):
        img = torch.as_tensor(summary_batch["image"]).to(device)
        _loss, recon = vae.forward(
            state["params"], img, torch.Generator().manual_seed(step),
            temperature_schedule(params, step), hard_gumbel=True, train=False,
        )
        tr.writer.images(step, {
            "input_image": (summary_batch["image"] + 1.0) / 2.0,
            "reconstruction_image": (recon.cpu().numpy() + 1.0) / 2.0,
        })

    logger.info("starting VAE training: %s on %s (image_seq_len=%d)",
                params["config_name"], device, vae.cfg.image_seq_len)
    try:
        trainer.run(train_iter, params.get("seed") or 0, eval_data_iter=eval_iter,
                    summary_fn=summary_fn)
    finally:
        trainer.close()
        for it in (train_iter, eval_iter):
            if it is not None:
                it.close()  # stops the pipeline's prefetch thread
    return trainer


if __name__ == "__main__":
    main()
