"""Cross-model restore (port of ``dalle_mtf_tpu/utils/restore.py``): the
frozen stage-1 VAE's parameters, read out of its training checkpoint for use
in another program (DALLE training in image mode, the offline dataset
encoder).

The port's VAE checkpoints are ``train_vae``'s files in ``torch.save``'s
format, ``<model_path>/checkpoints/ckpt_<step>.pt`` (``Trainer.save``: the
whole tree under ``"params"`` with ``/``-joined keys; ``model_path`` may be
a URL); the latest is restored. A VAE
trained by the JAX package comes across as an ``.npz`` in
``utils/convert.py::save_npz``'s format (``tools/export_vae_npz.py`` writes
one from its orbax checkpoint), given in place of the directory.
"""

from __future__ import annotations

import logging

from dalle_mtf_tpu_torch.data import fs
from dalle_mtf_tpu_torch.train.trainer import checkpoint_steps, model_dir_path
from dalle_mtf_tpu_torch.utils import checkpoint, convert

logger = logging.getLogger(__name__)


def _ckpt_dir(model_dir: str) -> str:
    return fs.join(model_dir_path(model_dir), "checkpoints")


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
        steps = checkpoint_steps(d)
        if not steps:
            raise FileNotFoundError(f"no VAE checkpoint found under {vae_dir} — train the VAE first")
        obj = checkpoint.read(fs.join(d, f"ckpt_{steps[-1]}.pt"))
        tree = convert.nest({k: v.to(vae.device) for k, v in obj["params"].items()})
        where = f"{vae_dir} @ step {steps[-1]}"
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
