"""Weights carried across between the JAX package and the port.

Both packages use one parameter tree: the same nested names and shapes. So
the exchange is a plain mapping of numpy arrays, checked against the model's
``param_shapes``. On disk a tree is an ``.npz`` keyed by its ``/``-joined
path (``layers/wq``, ``decoder/block_0/up/w``).

numpy has no bfloat16: bf16 tensors leave as float32 (exact), and arrays
whose dtype is named ``bfloat16`` (ml_dtypes, as JAX hands them over) are
widened to float32 on the way in. Quantized serving trees (quantize.py in
either package: int8 or packed int4 leaves, ``<name>_scale``, the
``<name>_int4`` markers) cross the same way, int8 staying int8.
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
            a = v.numpy() if isinstance(v, torch.Tensor) else _widen(v)
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


def quantize_mode(tree) -> str:
    """"int4", "int8" or "none": how a DALLE tree's weights are stored."""
    if "w_out_int4" in tree:
        return "int4"
    return "int8" if "w_out_scale" in tree else "none"


def dalle_params_from_numpy(tree, dalle) -> dict:
    """A DALLE parameter tree of numpy arrays (e.g. a JAX tree through
    ``jax.device_get``), master or quantized -> torch tensors on
    ``dalle.device``, after checking every name and shape against
    ``dalle``."""
    _check(tree, dalle.param_shapes(quantize_mode(tree)))
    return _to_torch(tree, dalle.device)


def shard_dalle_params(tree, dalle) -> dict:
    """A whole DALLE master tree of numpy arrays (e.g. a JAX tree through
    ``jax.device_get``) -> this rank's blocks on a tensor-parallel mesh
    (``dalle.sharding``), as torch tensors on ``dalle.device``, after
    checking every name and whole shape. Without a split, the whole tree
    (``dalle_params_from_numpy``)."""
    _check(tree, dalle.param_shapes(whole=True))
    if dalle.sharding is None:
        return _to_torch(tree, dalle.device)
    blocks = dalle.sharding.shard_tree(
        {k: ({n: torch.from_numpy(np.asarray(_widen(a))) for n, a in v.items()}
             if isinstance(v, dict) else torch.from_numpy(np.asarray(_widen(v))))
         for k, v in tree.items()})
    return _to_torch(blocks, dalle.device)


def gather_dalle_params(tree, dalle) -> dict:
    """The inverse of ``shard_dalle_params``: every rank's blocks of a
    DALLE tree (torch) gathered over the model group (a collective: every
    rank of the group calls it) -> the whole tree of numpy arrays."""
    if dalle.sharding is not None:
        tree = dalle.sharding.gather_tree(tree)
    return params_to_numpy(tree)


def _widen(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def vae_params_from_numpy(tree, vae) -> dict:
    """A whole VAE parameter tree of numpy arrays (e.g. a JAX tree through
    ``jax.device_get``) -> torch tensors on ``vae.device``, after checking
    every name and shape of the whole tree (``encoder``, ``codebook``,
    ``decoder``) against ``vae``: on a mesh that splits the VAE
    (``vae.sharding``), this rank's blocks."""
    _check(tree, vae.param_shapes())
    if vae.sharding is None:
        return _to_torch(tree, vae.device)
    return _to_torch(vae.sharding.shard_tree(_to_torch(tree, "cpu")), vae.device)


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


def nest(flat) -> dict:
    """{``/``-joined path: leaf} -> the nested tree."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_npz(path) -> dict:
    """Read an npz written by ``save_npz`` back into a nested numpy tree."""
    with np.load(path) as z:
        return nest({key: z[key] for key in z.files})


def grads_to_numpy(tree) -> dict:
    """The ``.grad`` of every leaf of a torch parameter tree, as the same
    tree of numpy arrays (a leaf without a gradient raises)."""
    def grad(name, t):
        if t.grad is None:
            raise ValueError(f"parameter {name} has no gradient")
        return _leaf_to_numpy(t.grad)

    return {
        name: grads_to_numpy(v) if isinstance(v, dict) else grad(name, v)
        for name, v in tree.items()
    }


def _at(tree, path):
    for name in path:
        tree = tree[name]
    return tree


def _set(tree: dict, path, value) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


def adam_state_to_numpy(opt) -> dict:
    """An ``optim.AdamW`` -> ``{"count", "mu", "nu"}`` with the moments as
    numpy trees shaped like its parameter tree (optax's ScaleByAdamState
    fields; a leaf not updated yet has zero moments)."""
    out = {"count": opt.count, "mu": {}, "nu": {}}
    for path, t in opt.named:
        s = opt.opt.state.get(t)
        for key, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            _set(out[key], path, _leaf_to_numpy(s[name]) if s else
                 np.zeros(tuple(t.shape), np.float32))
    return out


def adam_state_from_numpy(opt, state) -> None:
    """Load ``{"count", "mu", "nu"}`` (numpy trees keyed like the
    optimizer's parameter tree, e.g. optax's moments through
    ``jax.device_get``) into an ``optim.AdamW``."""
    count = int(state["count"])
    fused = bool(opt.opt.defaults.get("fused"))
    for path, t in opt.named:
        opt.opt.state[t] = {
            # torch keeps the step on the card only for its fused kernel
            "step": torch.tensor(float(count), device=t.device if fused else "cpu"),
            "exp_avg": torch.tensor(np.asarray(_at(state["mu"], path), np.float32),
                                    device=t.device),
            "exp_avg_sq": torch.tensor(np.asarray(_at(state["nu"], path), np.float32),
                                       device=t.device),
        }
    opt.count = count
