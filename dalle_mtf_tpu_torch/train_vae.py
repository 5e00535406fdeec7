"""Train the discrete VAE (stage 1): the port of ``train_vae.py``, with the
same CLI.

    python -m dalle_mtf_tpu_torch.train_vae --model <config name or path> \
        [--new [--yes]] [--gpu_ids 0] [--device cuda|cpu]

Over several processes, started by ``torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m dalle_mtf_tpu_torch.train_vae --model <config> [--gpu_ids 0 | --device cpu]

the config's ``mesh_shape`` (resized to the world: ``parallel.mesh.resize_axes``,
the JAX ``build_mesh`` rule, so ``vae_coco``'s ``data:1`` trains on every
rank) and ``layout`` place the ranks: data parallelism over the
``batch_dim`` axis (each rank reads its files and rows, and its losses and
gradients are summed over the axis), tensor parallelism over an axis
carrying ``tokens_dim`` or ``vae_hid_dim`` (the codebook's columns or rows)
and the conv dims ``conv_cout``, ``conv_cin``, ``conv_kh``, ``conv_kw``
(models/vae.py), and an axis no rule names only replicates
(``vae_example``'s ``data:16,model:2``). ``utils/distributed.py`` picks each
rank's device and the backend: ranks that share a card talk over gloo, so
their step times are not multi-GPU numbers. A layout that would put one
axis on two dims of a leaf raises before the group is joined, and so does
a ``layers`` rule (the VAE has no layer stack to pipeline). Each rank runs on
``cuda:<--gpu_ids>`` (ranks share the cards evenly), else ``--device``
(default ``cuda``). Without a CUDA device it raises: it runs on the CPU
only when asked to with ``--device cpu``. Rank 0 alone writes summaries
and checkpoints.

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
import torch.distributed as dist

from dalle_mtf_tpu_torch.data.pipeline import vae_input_fn
from dalle_mtf_tpu_torch.models.vae import temperature_schedule
from dalle_mtf_tpu_torch.parallel.mesh import (
    BATCH,
    build_mesh,
    check_layout,
    parse_layout,
    parse_mesh_shape,
    refuse_layers,
    resize_axes,
)
from dalle_mtf_tpu_torch.train.tasks import make_vae_task
from dalle_mtf_tpu_torch.train.trainer import Trainer
from dalle_mtf_tpu_torch.utils.config import fetch_model_params
from dalle_mtf_tpu_torch.utils.distributed import init_distributed
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
    the last step's state). A process group this call joined is left
    before it returns."""
    args = parse_args(argv)
    params = fetch_model_params(args.model)
    if params["model_type"] not in (None, "vae"):
        raise ValueError(f"config {args.model} is not a vae config")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:  # refuse a layout before joining the group
        axes = resize_axes(parse_mesh_shape(params.get("mesh_shape")), world)
        rules = parse_layout(params.get("layout"))
        refuse_layers(axes, rules, "VAE training (the VAE has no layer stack)")
        check_layout(axes, rules)
    owns_group = not (dist.is_available() and dist.is_initialized())
    proc = init_distributed(args.gpu_ids, args.device)
    try:
        return _train(args, params, proc)
    finally:
        if owns_group and proc.world > 1:
            dist.destroy_process_group()


def _train(args, params, proc) -> Trainer:
    device = proc.device
    setup_logging(params["config_name"] or args.model, rank=proc.rank)
    mesh = build_mesh(params.get("mesh_shape"), params.get("layout"), "global", proc.rank,
                      proc.world)
    if args.new:
        if proc.rank == 0:
            remove_model_dir(params["model_path"], interactive=not args.yes)
        if proc.world > 1:
            dist.barrier()

    vae, init_fn, loss_fn, eval_loss_fn = make_vae_task(params, device, mesh)
    trainer = Trainer(
        params, init_fn, loss_fn,
        model_dir=params["model_path"],
        seq_len=vae.cfg.image_seq_len,
        device=device,
        eval_loss_fn=eval_loss_fn,
        mesh=mesh,
        sharding=vae.sharding,
    )
    # the image summaries' batch comes from a pipeline of its own: one taken
    # from the training stream would shift it
    summary_iter = iter(vae_input_fn(params, eval=False))
    summary_batch = _normalize_summary_batch(next(summary_iter))
    summary_iter.close()
    # this rank's data: its files and rows on the batch axis (the ranks of a
    # model or replicate-only axis read the same ones)
    dp_axis = mesh.rules.get(BATCH) or "data"
    shard = (mesh.index(dp_axis), mesh.size(dp_axis))
    # deterministic data resume: skip the already-trained prefix of the stream
    start_step = trainer.latest_step()
    if start_step:
        logger.info("resume at step %d: data stream skips trained prefix", start_step)
    train_iter = iter(vae_input_fn(params, eval=False, shard=shard, skip_steps=start_step))
    eval_steps = params.get("eval_steps") or 0
    eval_iter = iter(vae_input_fn(params, eval=True, shard=shard)) if eval_steps else None

    @torch.no_grad()
    def summary_fn(tr: Trainer, state, step):
        # every rank runs the forward (a codebook split needs its whole
        # model group); rank 0, at global row 0 as one process, writes
        img = torch.as_tensor(summary_batch["image"]).to(device)
        _loss, recon = vae.forward(
            state["params"], img, torch.Generator().manual_seed(step),
            temperature_schedule(params, step), hard_gumbel=True, train=False,
        )
        tr.writer.images(step, {
            "input_image": (summary_batch["image"] + 1.0) / 2.0,
            "reconstruction_image": (recon.cpu().numpy() + 1.0) / 2.0,
        })

    logger.info("starting VAE training: %s on %s, %s (image_seq_len=%d)",
                params["config_name"], device, mesh, vae.cfg.image_seq_len)
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
