"""Optimizer (port of ``dalle_mtf_tpu/train/optim.py``).

The JAX default is the optax chain ``clip_by_global_norm(clip)`` +
``adamw(schedule, mask=decay_mask)``; its opt-in ``fused_adamw`` is the same
math in one pass. Here both are ``torch.optim.AdamW`` over the parameter
tree's leaves (``fused_optimizer`` selects its fused implementation) with
the chain's conventions kept:

- the global-norm clip scales by clip / norm only when norm >= clip;
- the learning rate of an update is the schedule at the PRE-increment count
  (optax's scale_by_schedule), so the first update under warmup is 0, while
  bias correction uses the post-increment count;
- eps defaults to 1e-6, not torch's 1e-8;
- weight decay applies only where ``decay_mask`` is True (not to norms or
  biases), as -lr * wd * p (torch's p * (1 - lr * wd) is the same update).

Adafactor and ``skip_nonfinite_updates`` are not ported and raise.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import numpy as np
import torch


def lr_schedule(params: Mapping[str, Any]) -> Callable[[int], float]:
    """step -> learning rate: decay first (linear to 10% of base, or cosine
    with alpha 0.1, over ``lr_decay_end``/``train_steps``), then during
    warmup multiply the *decayed* LR by step / warmup_steps. Computed in
    float32 like the JAX schedule."""
    base_lr = np.float32(params["lr"])
    end_step = params.get("lr_decay_end") or params.get("train_steps") or 10_000
    decay = params.get("lr_decay") if params.get("lr_decay") is not None else "cosine"
    warmup_steps = params.get("warmup_steps")
    if warmup_steps is None:
        warmup_steps = 3000
    if decay not in ("linear", "cosine", None, "none", "constant"):
        raise ValueError(f"unknown lr_decay {decay!r}")
    f32 = np.float32

    def schedule(step: int) -> float:
        step_f = f32(step)
        frac = min(step_f / f32(end_step), f32(1.0))
        if decay == "linear":
            lr = base_lr - (base_lr - base_lr * f32(0.1)) * frac
        elif decay == "cosine":
            cosine = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * frac))
            lr = base_lr * ((f32(1.0) - f32(0.1)) * cosine + f32(0.1))
        else:
            lr = base_lr
        if warmup_steps and warmup_steps > 0 and step_f < warmup_steps:
            lr = lr * (step_f / f32(warmup_steps))
        return float(f32(lr))

    return schedule


def _no_weight_decay(path: tuple[str, ...]) -> bool:
    """True if a parameter at ``path`` is excluded from weight decay: mtf
    excluded names matching r"norm|bias" (optimizers.py:89); the trees name
    norm parameters ln*_g/ln*_b and biases b/o_b/b_*."""
    return any(
        "ln" in name or "norm" in name or "bias" in name
        or name in ("b", "o_b") or name.startswith("b_")
        for name in path
    )


def named_leaves(tree, prefix: tuple[str, ...] = ()):
    """(path, leaf) pairs of a nested dict, in insertion order."""
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from named_leaves(v, prefix + (name,))
        else:
            yield prefix + (name,), v


def decay_mask(tree, prefix: tuple[str, ...] = ()) -> dict:
    """The tree with True where weight decay applies."""
    return {
        k: decay_mask(v, prefix + (k,)) if isinstance(v, dict)
        else not _no_weight_decay(prefix + (k,))
        for k, v in tree.items()
    }


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over fp32 copies of ``tensors`` (a 0-dim tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


class AdamW:
    """Global-norm clip + AdamW over the leaves of a parameter tree.

    ``step()`` reads each leaf's ``.grad`` and updates the leaves in place.
    ``count`` is the number of updates made (optax's count); ``named`` the
    (path, leaf) pairs it updates."""

    def __init__(self, tree, schedule: Callable[[int], float], b1: float, b2: float,
                 eps: float, weight_decay: float, clip: float | None, fused: bool):
        self.named = list(named_leaves(tree))
        self.leaves = [t for _, t in self.named]
        decay = [t for p, t in self.named if not _no_weight_decay(p)]
        keep = [t for p, t in self.named if _no_weight_decay(p)]
        groups = [{"params": ts, "weight_decay": wd}
                  for ts, wd in ((decay, weight_decay), (keep, 0.0)) if ts]
        impl = {"fused": True} if fused else {"foreach": True}
        self.opt = torch.optim.AdamW(groups, lr=0.0, betas=(b1, b2), eps=eps, **impl)
        self.schedule = schedule
        self.clip = clip
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, update, count; returns the global norm of the gradients
        before clipping (a 0-dim tensor, not waited for)."""
        grads = [t.grad for t in self.leaves]
        if any(g is None for g in grads):
            raise RuntimeError("AdamW.step: a parameter has no gradient")
        norm = global_norm(grads)
        if self.clip:
            # optax: unchanged below the clip, else g / norm * clip
            scale = torch.where(norm < self.clip, 1.0, self.clip / norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "adamw": self.opt.state_dict()}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.count = int(state["count"])
        self.opt.load_state_dict(state["adamw"])


def get_optimizer(params: Mapping[str, Any], tree) -> tuple[AdamW, Callable[[int], float]]:
    """(optimizer over ``tree``'s leaves, lr schedule), from the config keys
    the JAX factory honours: ``optimizer``, ``lr``, ``lr_decay``,
    ``lr_decay_end``, ``warmup_steps``, ``gradient_clipping``,
    ``weight_decay``, ``beta_1``, ``beta_2``, ``epsilon``,
    ``fused_optimizer``."""
    schedule = lr_schedule(params)
    name = (params.get("optimizer") or "adam").lower()
    if name == "adafactor":
        raise NotImplementedError("the Adafactor optimizer is not ported yet")
    if name != "adam":
        raise ValueError(f"{name} not recognized")
    if params.get("skip_nonfinite_updates"):
        raise NotImplementedError("skip_nonfinite_updates is not ported yet")
    clip = params.get("gradient_clipping")
    if clip is None:
        clip = 1.0
    opt = AdamW(
        tree, schedule,
        b1=params.get("beta_1") or 0.9,
        b2=params.get("beta_2") or 0.999,
        eps=params.get("epsilon") or 1e-6,
        weight_decay=params.get("weight_decay") or 0.0,
        clip=clip or None,
        fused=bool(params.get("fused_optimizer")),
    )
    return opt, schedule
