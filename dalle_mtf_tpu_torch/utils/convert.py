"""Weights carried across between the JAX package and the port.

Both packages use one parameter tree: the same nested names and shapes. So
the exchange is a plain mapping of numpy arrays, checked against the model's
``param_shapes``. On disk a tree is an ``.npz`` keyed by its ``/``-joined
path (``layers/wq``, ``decoder/block_0/up/w``).

numpy has no bfloat16: bf16 tensors leave as float32 (exact), and arrays
whose dtype is named ``bfloat16`` (ml_dtypes, as JAX hands them over) are
widened to float32 on the way in.
"""

from __future__ import annotations

import numpy as np
import torch


def _check(tree, shapes, path=""):
    for name, want in shapes.items():
        if name not in tree:
            raise KeyError(f"parameter {path}{name} missing")
        if isinstance(want, dict):
            _check(tree[name], want, f"{path}{name}/")
        elif tuple(tree[name].shape) != tuple(want):
            raise ValueError(
                f"parameter {path}{name} has shape {tuple(tree[name].shape)}, "
                f"the model expects {tuple(want)}"
            )


def _to_torch(tree, device):
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out[name] = _to_torch(v, device)
        else:
            a = np.asarray(v)
            if a.dtype.name == "bfloat16":
                a = a.astype(np.float32)
            out[name] = torch.tensor(a, device=device)  # a copy: never aliases
    return out


def _leaf_to_numpy(v) -> np.ndarray:
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    t = v.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(tree) -> dict:
    """Torch parameter tree -> the same tree of numpy arrays (bf16 as f32)."""
    return {
        name: params_to_numpy(v) if isinstance(v, dict) else _leaf_to_numpy(v)
        for name, v in tree.items()
    }


def dalle_params_from_numpy(tree, dalle) -> dict:
    """A DALLE parameter tree of numpy arrays (e.g. a JAX tree through
    ``jax.device_get``) -> torch tensors on ``dalle.device``, after checking
    every name and shape against ``dalle``."""
    _check(tree, dalle.param_shapes())
    return _to_torch(tree, dalle.device)


def vae_params_from_numpy(tree, vae) -> dict:
    """A VAE parameter tree of numpy arrays -> torch tensors on
    ``vae.device``, checked against the codebook and decoder ``vae`` reads
    (an ``encoder`` subtree is carried along unchecked)."""
    _check(tree, vae.param_shapes())
    return _to_torch(tree, vae.device)


dalle_params_to_numpy = vae_params_to_numpy = params_to_numpy


def _flatten(tree, prefix=""):
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", v


def save_npz(path, tree) -> None:
    """Write a parameter tree (torch or numpy leaves) to ``path`` as npz."""
    np.savez(path, **{k: _leaf_to_numpy(v) for k, v in _flatten(tree)})


def load_npz(path) -> dict:
    """Read an npz written by ``save_npz`` back into a nested numpy tree."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree
