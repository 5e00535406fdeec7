"""Cross-model restore (port of ``dalle_mtf_tpu/utils/restore.py``): the
frozen stage-1 VAE's parameters, read out of its training checkpoint for use
in another program (DALLE training in image mode, the offline dataset
encoder).

The port's VAE checkpoints are ``train_vae``'s files in ``torch.save``'s
format, ``<model_path>/checkpoints/ckpt_<step>.pt`` (``Trainer.save``: the
whole tree under ``"params"`` with ``/``-joined keys); the latest is
restored. A VAE
trained by the JAX package comes across as an ``.npz`` in
``utils/convert.py::save_npz``'s format (``tools/export_vae_npz.py`` writes
one from its orbax checkpoint), given in place of the directory.
"""

from __future__ import annotations

import logging
import os

import torch

from dalle_mtf_tpu_torch.data.fs import is_remote
from dalle_mtf_tpu_torch.train.trainer import checkpoint_steps
from dalle_mtf_tpu_torch.utils import convert

logger = logging.getLogger(__name__)


def _ckpt_dir(model_dir: str) -> str:
    d = model_dir if "://" in model_dir else os.path.abspath(os.path.expanduser(model_dir))
    return os.path.join(d, "checkpoints")


def restore_vae_params(vae, vae_dir: str) -> dict:
    """The VAE parameter tree of the latest checkpoint under ``vae_dir`` (a
    ``model_path`` whose ``checkpoints/`` holds ``train_vae``'s files), or of
    the ``.npz`` that ``vae_dir`` names, on ``vae.device``; every name and
    shape checked against ``vae`` (a tree that does not match the config
    raises ``ValueError``)."""
    npz = str(vae_dir).endswith(".npz")
    if npz:
        tree, where = convert.load_npz(vae_dir), vae_dir
    else:
        d = _ckpt_dir(vae_dir)
        if is_remote(d):
            raise NotImplementedError(f"remote paths are not ported yet: {d}")
        steps = checkpoint_steps(d)
        if not steps:
            raise FileNotFoundError(f"no VAE checkpoint found under {vae_dir} — train the VAE first")
        obj = torch.load(os.path.join(d, f"ckpt_{steps[-1]}.pt"), map_location=vae.device,
                         weights_only=True)
        tree, where = convert.nest(obj["params"]), f"{vae_dir} @ step {steps[-1]}"
    want = vae.param_shapes()
    try:
        convert._check(tree, want)
    except (KeyError, ValueError) as e:
        raise ValueError(f"VAE checkpoint at {where} does not match the vae config: {e}") from None
    extra = set(dict(convert._flatten(tree))) - set(dict(convert._flatten(want)))
    if extra:
        raise ValueError(f"VAE checkpoint at {where} does not match the vae config: "
                         f"parameters {sorted(extra)} are not the model's")
    logger.info("restored frozen VAE from %s", where)
    return convert._to_torch(tree, vae.device) if npz else tree
