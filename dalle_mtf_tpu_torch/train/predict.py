"""Predict-every-checkpoint for DALLE training (port of
``dalle_mtf_tpu/train/predict.py``).

When ``predict_steps > 0``, a fixed set of golden captions (the first
``predict_steps`` batches of a pipeline, taken once at startup, so the
summaries show the same prompts converging) is sampled into images at every
checkpoint. Image grids go to the trainer's event file and PNGs to
``<model_path>/predict/step_<N>/`` with ``prompts.txt`` beside them.

Optional config keys: ``predict_batch_size`` (rows per predict batch; else
``eval_batch_size``, else 4), ``predict_temperature`` (default 1.0) and
``predict_top_k`` (default 64).

Sampling reads the live training parameters through one
``sample.CapturedDecoder`` for the whole run, the counterpart of the JAX
predict fn's single jit: AdamW (``train/optim.py``, torch's foreach and fused
paths) and the checkpoint restore update every leaf in place, so the graph
captured at the first checkpoint reads each later checkpoint's values.

Under tensor parallelism every rank of rank 0's model group decodes on its
live blocks (the decoder's step functions run eagerly there: the group's
collectives run in each step, ``sample.capture_rule``), and rank 0 alone
decodes the pixels and writes the summaries and PNGs. Without a
tensor-parallel split every rank holds the whole parameters, and rank 0
samples alone.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from dalle_mtf_tpu_torch.utils.png import encode_png

logger = logging.getLogger(__name__)


def predict_seed(step: int, batch: int) -> int:
    """The generator seed of predict batch ``batch`` at checkpoint ``step``
    (the JAX fn folds the batch index into PRNGKey(step))."""
    return int(np.random.SeedSequence([step, batch]).generate_state(1, np.uint64)[0] >> 1)


def decodes(dalle, rank: int) -> bool:
    """Whether ``rank`` takes part in the predict batches: rank 0, and where
    ``dalle`` is split over a tensor-parallel axis the other ranks of its
    model group (those at 0 on every other axis of the mesh)."""
    mesh = dalle.mesh
    if rank == 0:
        return True
    if dalle.sharding is None:
        return False
    return all(mesh.index(n) == 0 for n in mesh.names if n != mesh.tp_axis)


def make_predict_summary_fn(params, dalle, vae, vae_params, data_iter, tokenizer=None):
    """Build a ``summary_fn(trainer, state, step)`` for ``Trainer.run``, or
    return None when ``predict_steps`` is unset or 0.

    ``data_iter`` supplies the golden captions (its first ``predict_steps``
    batches are consumed once, here): pass a dedicated pipeline, never the
    training stream, whose resume accounting it would shift."""
    from dalle_mtf_tpu_torch.sample import CapturedDecoder  # noqa: PLC0415

    predict_steps = int(params.get("predict_steps") or 0)
    if predict_steps <= 0:
        return None
    rows = int(params.get("predict_batch_size") or params.get("eval_batch_size") or 4)
    temperature = float(params["predict_temperature"]
                        if params.get("predict_temperature") is not None else 1.0)
    top_k = int(params["predict_top_k"] if params.get("predict_top_k") is not None else 64)
    captions = [np.asarray(next(data_iter)["caption"])[:rows].astype(np.int64)
                for _ in range(predict_steps)]

    # prompts decoded once for the sidecar text file (cosmetic: a tokenizer
    # that cannot decode leaves the line empty)
    prompt_lines: list[str] = []
    for i, cap in enumerate(captions):
        for j, row in enumerate(cap):
            text = ""
            if tokenizer is not None:
                ids = [t for t in row.tolist() if t != tokenizer.pad_token_id]
                try:
                    text = tokenizer.decode(ids)
                except Exception:  # noqa: BLE001 — prompts are cosmetic
                    text = ""
            prompt_lines.append(f"batch{i}_row{j}: {text}")

    model_path = params.get("model_path") or "."
    decoder: CapturedDecoder | None = None  # made at the first checkpoint

    def summary_fn(trainer, state, step):
        nonlocal decoder
        if not decodes(dalle, trainer.rank):
            return
        out_dir = os.path.join(model_path, "predict", f"step_{step:07d}")
        remote = "://" in out_dir
        if not remote and trainer.rank == 0:
            os.makedirs(out_dir, exist_ok=True)
        for i, text in enumerate(captions):
            if decoder is None:
                decoder = CapturedDecoder(dalle, state["params"], text.shape[0])
            if decoder.params is not state["params"]:
                raise ValueError("predict: the trainer's parameter tree was replaced; the "
                                 "decoder reads the one it was built on")
            decoder.generator.manual_seed(predict_seed(step, i))
            with torch.inference_mode():
                tokens = decoder.generate(torch.from_numpy(text).to(dalle.device),
                                          temperature, top_k)
                if trainer.rank != 0:  # a rank of rank 0's model group: its blocks only
                    continue
                imgs = vae.decode_tokens(vae_params, tokens).float().cpu().numpy()
            trainer.writer.images(step, {f"predict/batch_{i}": imgs}, max_outputs=rows)
            if not remote:  # a remote model_path keeps the images in the summaries only
                for j, img in enumerate(imgs):
                    with open(os.path.join(out_dir, f"batch{i}_row{j}.png"), "wb") as f:
                        f.write(encode_png(img))
        if trainer.rank != 0:
            return
        if not remote:
            with open(os.path.join(out_dir, "prompts.txt"), "w") as f:
                f.write("\n".join(prompt_lines) + "\n")
        logger.info("predict: %d batch(es) of %d image(s) at step %d -> %s",
                    len(captions), rows, step, out_dir)

    return summary_fn
