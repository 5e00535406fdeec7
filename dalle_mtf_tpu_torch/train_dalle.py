"""Train DALLE (stage 2) on [text ; image-token] sequences: the port of
``train_dalle.py``, with the same CLI.

    python -m dalle_mtf_tpu_torch.train_dalle --model <config name or path> \
        [--new [--yes]] [--gpu_ids 0] [--device cuda|cpu]

Over several processes, started by ``torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m dalle_mtf_tpu_torch.train_dalle --model <config> [--device cpu]

the config's ``mesh_shape`` and ``layout`` place the ranks: data parallelism
over the ``batch_dim`` axis, with ``attention_type`` "ring" or "local_ring"
sequence parallelism over the ``total_seq_dim`` axis, tensor
parallelism over an axis carrying ``heads_dim``, ``intermediate_expanded``
and ``vocab_dim`` (``configs/dalle_coco.json``'s ``data:16,model:2`` runs on
2 ranks as ``data:1,model:2``; ``utils/distributed.py`` picks each rank's
device and the backend), and pipeline parallelism over an axis carrying
``layers`` (``mesh_shape: "pipe:2,data:2"``, ``layout:
"batch_dim:data,layers:pipe"`` on 4 ranks: each stage holds half the
layers; ``pipeline_microbatches``, default the pipe size). Tensor
parallelism composes with the ring's sequence axis (``mesh_shape:
"data:1,seq:2,model:2"``, ``layout: "batch_dim:data,total_seq_dim:seq,
heads_dim:model,intermediate_expanded:model,vocab_dim:model"`` on 4 ranks:
each rank runs the ring on its 4 of 8 heads over half the sequence) and
with the pipe axis (``mesh_shape: "data:16,pipe:2,model:2"``, dalle_coco's
``layout`` plus ``layers:pipe``: ``data:1,pipe:2,model:2`` on 4 ranks, each
rank its stage's half of the layers on its 4 of 8 heads, half the MLP width
and its block of the vocabulary). ``layers`` on the axis of a
tensor-parallel dim is refused before the group is joined. Under tensor
parallelism ``predict_steps`` samples on the blocks of rank 0's model group
(``train/predict.py``); under pipeline parallelism it raises at start-up
(ROADMAP queue 1 item 5c-iv).

In image mode (``dataset.tokens`` unset: JPEG + caption records) the
frozen VAE (``vae_model``, trained by ``train_vae``) is restored from
``vae_checkpoint_path``, else from the VAE config's ``model_path``
(``utils/restore.py``: its latest checkpoint, or an ``.npz``), and its
encoder tokenizes every batch on the device; ``dataset.uint8_images`` moves
the pixels as uint8. In tokens mode (``dataset.tokens: true``: records of
VAE token ids, ``python -m dalle_mtf_tpu_torch.data.create_tfrecords
encode``) the VAE is loaded only when ``predict_steps`` needs its decoder.
The DALLE checkpoints never hold the VAE. With ``predict_steps > 0`` the
golden captions of a dedicated pipeline are sampled into images at every
checkpoint (``train/predict.py``: summaries, and PNGs under
``<model_path>/predict/step_<N>/``).
Training resumes from the latest checkpoint in ``model_path``, and the data
stream skips the batches already trained on. ``--new`` wipes
``model_path`` first (asking unless ``--yes``). Training runs on
``cuda:<first --gpu_ids>``, else on ``--device`` (default ``cuda``); ranks
share the cards evenly. Without a CUDA device it raises: it runs on the CPU
only when asked to with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch.distributed as dist

from dalle_mtf_tpu_torch.data.pipeline import dalle_input_fn
from dalle_mtf_tpu_torch.data.tokenizer import get_tokenizer
from dalle_mtf_tpu_torch.parallel.mesh import (
    build_mesh,
    check_layout,
    parse_layout,
    parse_mesh_shape,
    refuse_layers,
    resize_axes,
)
from dalle_mtf_tpu_torch.train.predict import make_predict_summary_fn
from dalle_mtf_tpu_torch.train.tasks import make_dalle_task
from dalle_mtf_tpu_torch.train.trainer import Trainer
from dalle_mtf_tpu_torch.utils.config import fetch_model_params
from dalle_mtf_tpu_torch.utils.distributed import init_distributed
from dalle_mtf_tpu_torch.utils.logging_utils import remove_model_dir, setup_logging
from dalle_mtf_tpu_torch.utils.restore import restore_vae_params

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


def load_vae_params(params, vae) -> dict:
    """The frozen stage-1 VAE's parameters on ``vae.device``: from the
    config's ``vae_checkpoint_path``, else the VAE config's ``model_path``
    (reference model_fns.py:36-41)."""
    return restore_vae_params(
        vae, params.get("vae_checkpoint_path") or params["vae_params"]["model_path"])


def main(argv=None) -> Trainer:
    """Run the training the config asks for; returns the closed Trainer
    (its ``history`` and ``eval_history`` hold what was logged, ``state``
    the last step's state). A process group this call joined is left
    before it returns."""
    args = parse_args(argv)
    params = fetch_model_params(args.model)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:  # a layout the port does not run raises before the group is joined
        check_layout(resize_axes(parse_mesh_shape(params.get("mesh_shape")), world),
                     parse_layout(params.get("layout")),
                     params.get("attention_type") or "global")
    owns_group = not (dist.is_available() and dist.is_initialized())
    proc = init_distributed(args.gpu_ids, args.device)
    try:
        return _train(args, proc, params)
    finally:
        if owns_group and proc.world > 1:
            dist.destroy_process_group()


def _train(args, proc, params) -> Trainer:
    device = proc.device
    if params["model_type"] != "dalle":
        raise ValueError(f"config {args.model} is not a dalle config")
    if params["vae_params"] is None:
        raise ValueError("vae model config must be supplied (vae_model key)")
    setup_logging(params["config_name"] or args.model, rank=proc.rank)
    # the ranks' layout (checked before the group was joined)
    mesh = build_mesh(params.get("mesh_shape"), params.get("layout"),
                      params.get("attention_type") or "global", proc.rank, proc.world)
    if params.get("predict_steps"):
        refuse_layers(mesh.axes, mesh.rules, "predict_steps", "5c-iv")

    if args.new:
        if proc.rank == 0:
            remove_model_dir(params["model_path"], interactive=not args.yes)
        if proc.world > 1:
            dist.barrier()

    # tokenizer vocab check + padding id (reference train_dalle.py:47-49)
    tokenizer = get_tokenizer()
    if params["text_vocab_size"] != len(tokenizer):
        raise ValueError(
            f"config text_vocab_size {params['text_vocab_size']} != tokenizer "
            f"vocab {len(tokenizer)}"
        )
    params["padding_id"] = tokenizer.pad_token_id

    dalle, vae, init_fn, loss_fn, eval_loss_fn = make_dalle_task(params, device, mesh)
    # image mode: every rank restores the frozen VAE and encodes its own
    # rows; tokens mode needs its decoder only to predict at checkpoints
    tokens_mode = bool(params["dataset"].get("tokens"))
    if tokens_mode and not params.get("predict_steps"):
        vae_params = None
    else:
        vae_params = load_vae_params(params, vae)
    trainer = Trainer(
        params, init_fn, loss_fn,
        model_dir=params["model_path"],
        seq_len=dalle.cfg.total_seq_len,
        device=device,
        frozen_params=None if tokens_mode else vae_params,
        eval_loss_fn=eval_loss_fn,
        mesh=mesh,
        sharding=dalle.sharding,
    )
    # this rank's data: its group on the batch axis (the sequence-parallel
    # ranks of one group read the same rows)
    dp_axis = dalle.cfg.ring_batch_axis
    shard = (mesh.index(dp_axis), mesh.size(dp_axis))
    # deterministic data resume: skip the already-trained prefix of the stream
    start_step = trainer.latest_step()
    if start_step:
        logger.info("resume at step %d: data stream skips trained prefix", start_step)
    train_iter = iter(dalle_input_fn(params, eval=False, shard=shard, skip_steps=start_step))
    eval_steps = params.get("eval_steps") or 0
    eval_iter = iter(dalle_input_fn(params, eval=True, shard=shard)) if eval_steps else None
    # predict_steps > 0: a dedicated pipeline (never train_iter, whose
    # resume accounting it would shift) supplies the golden captions
    predict_iter = predict_fn = None
    if params.get("predict_steps"):
        predict_iter = iter(dalle_input_fn(params, eval=bool(params["dataset"].get("eval_path"))))
        predict_fn = make_predict_summary_fn(params, dalle, vae, vae_params, predict_iter,
                                             tokenizer=tokenizer)

    logger.info(
        "starting DALLE training: %s on %s, %s (total_seq_len=%d, image_seq_len=%d)",
        params["config_name"], device, mesh, dalle.cfg.total_seq_len, dalle.cfg.image_seq_len,
    )
    try:
        trainer.run(train_iter, params.get("seed") or 0, eval_data_iter=eval_iter,
                    summary_fn=predict_fn)
    finally:
        trainer.close()
        for it in (train_iter, eval_iter, predict_iter):
            if it is not None:
                it.close()  # stops the pipeline's prefetch thread
    return trainer


if __name__ == "__main__":
    main()
