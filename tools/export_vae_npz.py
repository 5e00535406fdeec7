#!/usr/bin/env python3
"""Carry a VAE trained by the JAX package across to the PyTorch port.

    python3 tools/export_vae_npz.py --model <vae config> --out vae.npz \
        [--vae-checkpoint-path <model_path>]

Restores the latest orbax checkpoint under the VAE's ``model_path`` (or
``--vae-checkpoint-path``) with ``dalle_mtf_tpu.utils.restore.restore_vae_params``
and writes its parameter tree as an ``.npz`` keyed by ``/``-joined paths
(``dalle_mtf_tpu_torch/utils/convert.py::save_npz``'s format, bf16 leaves as
float32). The port takes that file wherever it takes a VAE directory: a DALLE
config's ``vae_checkpoint_path``, or ``create_tfrecords encode
--vae-checkpoint-path``. Imports JAX; run it where the JAX package runs.
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dalle_mtf_tpu.models.vae import DiscreteVAE, VAEConfig  # noqa: E402
from dalle_mtf_tpu.utils.config import fetch_model_params  # noqa: E402
from dalle_mtf_tpu.utils.restore import restore_vae_params  # noqa: E402


def _flat(tree, prefix=""):
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{name}/")
        else:
            a = np.asarray(v)
            yield f"{prefix}{name}", a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def export(vae_config: str, out: str, vae_dir: str | None = None) -> dict:
    """Write the restored tree of ``vae_config``'s VAE to ``out``; returns
    the flat {path: array} written."""
    params = fetch_model_params(vae_config)
    vae = DiscreteVAE(VAEConfig.from_params(params))
    tree = jax.device_get(restore_vae_params(vae, vae_dir or params["model_path"]))
    flat = dict(_flat(tree))
    np.savez(out, **flat)
    return flat


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", required=True, help="VAE config name or path")
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--vae-checkpoint-path", default=None,
                   help="the VAE's model_path, if not the config's")
    args = p.parse_args(argv)
    flat = export(args.model, args.out, args.vae_checkpoint_path)
    print(f"wrote {len(flat)} arrays ({sum(a.size for a in flat.values()):,} parameters) "
          f"to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
