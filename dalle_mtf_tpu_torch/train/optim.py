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

``optimizer: adafactor`` is the chain ``clip_by_global_norm(clip)`` +
optax 0.2.6's ``adafactor`` with the JAX factory's arguments, written out in
``Adafactor``. ``skip_nonfinite_updates: N`` wraps either optimizer in
``SkipNonfinite``, optax's ``apply_if_finite``. Each optimizer's
``state_dict`` names it, and a state of another optimizer refuses to load.

On a tensor-parallel mesh (a ``parallel.tensor.Sharding`` of the tree) each
rank updates its blocks of the split leaves, and every statistic over a
split dim is summed over the model group so that it is the whole leaf's (on
a pipe mesh, the same over the pipeline, whose stages split the layers; under
both, over each split's own group): the global norm (each leaf's squares
summed over the groups it is split over, so each element counts once),
Adafactor's row and column means, its update and parameter RMS, and the
finiteness test of ``SkipNonfinite``. Each leaf's ``splits`` entry is its
placement (``Sharding.placed``: its splits with their groups, empty where
it is whole). ``state_dict(transform)``/``load_state_dict(state,
transform)`` pass every moment through ``transform(tensor, placement)``
(the trainer gathers them into the whole state a single process writes,
and slices them back).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from dalle_mtf_tpu_torch.parallel.tensor import all_reduce, moment_split


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


def _square_sum(tensors) -> torch.Tensor:
    return sum(torch.sum(torch.square(t.float())) for t in tensors)


def global_norm(tensors, placements=None) -> torch.Tensor:
    """sqrt(sum of squares) over fp32 copies of ``tensors`` (a 0-dim
    tensor). With ``placements`` (each tensor's, ``Sharding.placed``), the
    squares of the tensors split over the same groups are summed together
    and then over those groups, the innermost first; the whole tensors'
    are added last."""
    if not placements or not any(placements):
        return torch.sqrt(_square_sum(tensors))
    kinds: dict[tuple, tuple] = {}  # (placement, tensors) by the groups split over, in first use
    for t, placed in zip(tensors, placements):
        key = tuple(id(p.group) for p in placed)
        kinds.setdefault(key, (placed, []))[1].append(t)
    total = None
    for key, (placed, ts) in sorted(kinds.items(), key=lambda kv: not kv[0]):
        part = _square_sum(ts)
        for p in reversed(placed):
            part = all_reduce(part, p.group)
        total = part if total is None else total + part
    return torch.sqrt(total)


def _clip_by_global_norm(grads, clip: float | None, placements=None) -> torch.Tensor:
    """The global norm of ``grads`` (a 0-dim tensor, not waited for); with
    ``clip``, the grads scaled in place as optax does: unchanged below the
    clip, else g / norm * clip."""
    norm = global_norm(grads, placements)
    if clip:
        scale = torch.where(norm < clip, 1.0, clip / norm)
        torch._foreach_mul_(grads, scale)
    return norm


def _grads(leaves, who: str) -> list:
    grads = [t.grad for t in leaves]
    if any(g is None for g in grads):
        raise RuntimeError(f"{who}.step: a parameter has no gradient")
    return grads


def _check_state(state: Mapping[str, Any], key: str, who: str) -> None:
    if key not in state:
        raise ValueError(f"{who}.load_state_dict: not a {who} state (keys {sorted(state)})")


def _splits(named, sharding) -> tuple[list, list]:
    """(each leaf's placement, the groups they split over in first use) of a
    sharded tree."""
    if sharding is None:
        return [()] * len(named), []
    placements = [sharding.placed(path) for path, _ in named]
    groups = {id(p.group): p.group for placed in placements for p in placed}
    return placements, list(groups.values())


class AdamW:
    """Global-norm clip + AdamW over the leaves of a parameter tree.

    ``step()`` reads each leaf's ``.grad`` and updates the leaves in place.
    ``count`` is the number of updates made (optax's count); ``named`` the
    (path, leaf) pairs it updates."""

    def __init__(self, tree, schedule: Callable[[int], float], b1: float, b2: float,
                 eps: float, weight_decay: float, clip: float | None, fused: bool,
                 sharding=None):
        self.named = list(named_leaves(tree))
        self.leaves = [t for _, t in self.named]
        self.splits, self.groups = _splits(self.named, sharding)
        decay = [t for p, t in self.named if not _no_weight_decay(p)]
        keep = [t for p, t in self.named if _no_weight_decay(p)]
        # the split of each parameter in the torch optimizer's order
        order = ([sp for (p, _), sp in zip(self.named, self.splits) if not _no_weight_decay(p)]
                 + [sp for (p, _), sp in zip(self.named, self.splits) if _no_weight_decay(p)])
        self._state_splits = order
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
        norm = _clip_by_global_norm(_grads(self.leaves, "AdamW"), self.clip, self.splits)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
        return norm

    def _moments(self, sd: Mapping[str, Any], transform) -> dict:
        if transform is None:
            return sd
        state = {i: {k: (transform(v, self._state_splits[i])
                         if k in ("exp_avg", "exp_avg_sq") else v) for k, v in st.items()}
                 for i, st in sd["state"].items()}
        return {**sd, "state": state}

    def state_dict(self, transform=None) -> dict:
        return {"count": self.count, "adamw": self._moments(self.opt.state_dict(), transform)}

    def load_state_dict(self, state: Mapping[str, Any], transform=None) -> None:
        _check_state(state, "adamw", "AdamW")
        self.count = int(state["count"])
        self.opt.load_state_dict(self._moments(state["adamw"], transform))


def _factored_dims(shape, min_dim_size_to_factor: int) -> tuple[int, int] | None:
    """optax's ``_factored_dims``: the second-largest and the largest axis
    of ``shape`` (numpy's argsort order), or None below two axes or where
    the second largest is under ``min_dim_size_to_factor``. A stacked leaf
    ([L, E, H, D]) factors over its own two largest axes, as in JAX."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """Global-norm clip + optax 0.2.6's ``adafactor`` over the leaves of a
    parameter tree, with the JAX factory's arguments: factored second
    moments (``min_dim_size_to_factor`` 128), the decay 1 - (count + 1) **
    -decay_rate with offset 0, ``eps`` added to the squared gradient, the
    update clipped to a block RMS of ``clipping_threshold``, scaled by the
    schedule at the pre-increment count and by the parameter's RMS (floored
    at 1e-3), negated. No momentum and no weight decay: the JAX factory
    passes neither to optax, even where the config sets ``weight_decay``.

    The same interface as ``AdamW`` (``leaves``, ``named``, ``count``,
    ``zero_grad``, ``step``, ``state_dict``)."""

    MIN_DIM_SIZE_TO_FACTOR = 128
    MIN_SCALE = 1e-3

    def __init__(self, tree, schedule: Callable[[int], float], decay_rate: float,
                 clipping_threshold: float, eps: float, clip: float | None, sharding=None):
        self.named = list(named_leaves(tree))
        self.leaves = [t for _, t in self.named]
        self.splits, self.groups = _splits(self.named, sharding)
        self.schedule = schedule
        self.decay_rate, self.threshold, self.eps, self.clip = (
            decay_rate, clipping_threshold, eps, clip)
        self.count = 0
        # factored over the whole leaf's two largest dims, as one process
        self.dims = [_factored_dims(sharding.whole_shape(p, t.shape) if sharding else t.shape,
                                    self.MIN_DIM_SIZE_TO_FACTOR) for p, t in self.named]
        # per leaf: (v_row, v_col) where factored (the shape without the
        # largest axis, without the second largest), else v (the shape)
        self.v = []
        for t, dims in zip(self.leaves, self.dims):
            def zeros(drop):
                shape = [n for i, n in enumerate(t.shape) if i != drop]
                return torch.zeros(shape, dtype=torch.float32, device=t.device)
            self.v.append((zeros(dims[1]), zeros(dims[0])) if dims else
                          torch.zeros(t.shape, dtype=torch.float32, device=t.device))

    def zero_grad(self) -> None:
        for t in self.leaves:
            t.grad = None

    @staticmethod
    def _mean(t: torch.Tensor, dim: int, placed, keepdim: bool = False) -> torch.Tensor:
        """``t.mean(dim)``; over a split dim, the whole leaf's (summed over
        that split's group)."""
        for p in placed or ():
            if p.split.dim == dim:
                return all_reduce(t.sum(dim=dim, keepdim=keepdim), p.group) / p.split.size
        return t.mean(dim=dim, keepdim=keepdim)

    @staticmethod
    def _rms(t: torch.Tensor, placed) -> torch.Tensor:
        """sqrt(mean(t²)) over the whole leaf."""
        if not placed:
            return t.square().mean().sqrt()
        n, total = t.numel(), t.square().sum()
        for p in reversed(placed):
            n = n // (p.split.stop - p.split.start) * p.split.size
            total = all_reduce(total, p.group)
        return (total / n).sqrt()

    def _moment_splits(self, i: int) -> tuple:
        """The splits of leaf i's moments: (v,) or (v_row, v_col)."""
        split, dims = self.splits[i], self.dims[i]
        if dims is None:
            return (split,)
        return moment_split(split, dims[1]), moment_split(split, dims[0])

    def _scale_by_factored_rms(self, i: int, g: torch.Tensor, decay: float) -> torch.Tensor:
        """optax's ``scale_by_factored_rms`` on leaf i; updates its moments."""
        g2 = g.square() + self.eps
        keep = float(np.float32(1.0) - np.float32(decay))
        dims = self.dims[i]
        if dims is None:
            v = decay * self.v[i] + keep * g2
            self.v[i] = v
            return g * v.pow(-0.5)
        d1, d0 = dims
        split = self.splits[i]
        v_row, v_col = self.v[i]
        v_row = decay * v_row + keep * self._mean(g2, d0, split)
        v_col = decay * v_col + keep * self._mean(g2, d1, split)
        self.v[i] = (v_row, v_col)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_mean = self._mean(v_row, reduced_d1, self._moment_splits(i)[0], keepdim=True)
        row_factor = (v_row / row_mean).pow(-0.5)
        return g * row_factor.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, update, count; returns the global norm of the gradients
        before clipping (a 0-dim tensor, not waited for)."""
        grads = _grads(self.leaves, "Adafactor")
        norm = _clip_by_global_norm(grads, self.clip, self.splits)
        t = np.float32(self.count + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-self.decay_rate))
        lr = self.schedule(self.count)
        for i, (p, g) in enumerate(zip(self.leaves, grads)):
            u = self._scale_by_factored_rms(i, g.float(), decay)
            u = u / torch.clamp_min(self._rms(u, self.splits[i]) / self.threshold, 1.0)
            u = u * lr
            p_rms = self._rms(p, self.splits[i])
            u = u * torch.where(p_rms <= self.MIN_SCALE, self.MIN_SCALE, p_rms)
            p.add_(u * -1.0)
        self.count += 1
        return norm

    def state_dict(self, transform=None) -> dict:
        def out(t, split):
            return t if transform is None else transform(t, split)

        moments = {}
        for i, ((path, _), dims, v) in enumerate(zip(self.named, self.dims, self.v)):
            name = "/".join(path)
            splits = self._moment_splits(i)
            if dims is None:
                moments[name] = out(v, splits[0])
            else:
                moments[name + "/v_row"], moments[name + "/v_col"] = (
                    out(v[0], splits[0]), out(v[1], splits[1]))
        return {"count": self.count, "adafactor": moments}

    def load_state_dict(self, state: Mapping[str, Any], transform=None) -> None:
        _check_state(state, "adafactor", "Adafactor")
        moments = state["adafactor"]
        for i, ((path, _), dims) in enumerate(zip(self.named, self.dims)):
            name = "/".join(path)
            names = [name] if dims is None else [name + "/v_row", name + "/v_col"]
            loaded = []
            for n, want, split in zip(names, [self.v[i]] if dims is None else self.v[i],
                                      self._moment_splits(i)):
                t = moments[n] if transform is None else transform(moments[n], split)
                if t.shape != want.shape:
                    raise ValueError(f"Adafactor.load_state_dict: {n} has shape "
                                     f"{tuple(t.shape)}, expected {tuple(want.shape)}")
                loaded.append(t.to(device=want.device, dtype=torch.float32))
            self.v[i] = loaded[0] if dims is None else tuple(loaded)
        self.count = int(state["count"])


class SkipNonfinite:
    """optax's ``apply_if_finite`` around ``inner`` (``AdamW`` or
    ``Adafactor``): a step whose gradients hold a NaN or an inf leaves the
    parameters and the inner state untouched (its count too, so the
    learning-rate schedule does not advance), unless it is the
    (``max_consecutive_errors`` + 1)-th such step in a row, which is applied.
    ``notfinite_count`` (the current run of such steps), ``last_finite`` and
    ``total_notfinite`` are kept as optax keeps them. Deciding costs the
    step one wait for the gradients on the host."""

    def __init__(self, inner, max_consecutive_errors: int):
        self.inner = inner
        self.max_consecutive_errors = int(max_consecutive_errors)
        self.notfinite_count = 0
        self.last_finite = True
        self.total_notfinite = 0

    @property
    def leaves(self):
        return self.inner.leaves

    @property
    def named(self):
        return self.inner.named

    @property
    def count(self) -> int:
        return self.inner.count

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    def step(self) -> torch.Tensor:
        """The inner step, or none; returns the global norm of the
        gradients before clipping either way. On a tensor-parallel mesh the
        test covers every rank's blocks (all_reduced over every group a leaf
        is split over), so every rank skips the same steps."""
        grads = _grads(self.leaves, "SkipNonfinite")
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all().int()
        for group in self.inner.groups:
            all_reduce(finite, group, dist.ReduceOp.MIN)
        finite = bool(finite)
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        self.total_notfinite += 0 if finite else 1
        self.last_finite = finite
        if finite or self.notfinite_count > self.max_consecutive_errors:
            return self.inner.step()
        return global_norm(grads, self.inner.splits)

    def state_dict(self, transform=None) -> dict:
        return {"apply_if_finite": {"notfinite_count": self.notfinite_count,
                                    "last_finite": self.last_finite,
                                    "total_notfinite": self.total_notfinite},
                "inner": self.inner.state_dict(transform)}

    def load_state_dict(self, state: Mapping[str, Any], transform=None) -> None:
        _check_state(state, "apply_if_finite", "SkipNonfinite")
        self.inner.load_state_dict(state["inner"], transform)
        skip = state["apply_if_finite"]
        self.notfinite_count = int(skip["notfinite_count"])
        self.last_finite = bool(skip["last_finite"])
        self.total_notfinite = int(skip["total_notfinite"])


def get_optimizer(params: Mapping[str, Any], tree, sharding=None):
    """(optimizer over ``tree``'s leaves, lr schedule), from the config keys
    the JAX factory honours: ``optimizer`` ("adam" or "adafactor"), ``lr``,
    ``lr_decay``, ``lr_decay_end``, ``warmup_steps``, ``gradient_clipping``,
    ``weight_decay``, ``beta_1``, ``beta_2``, ``epsilon``,
    ``fused_optimizer`` (AdamW); ``adafactor_decay_rate``,
    ``adafactor_clipping``, ``epsilon_1`` (Adafactor); and
    ``skip_nonfinite_updates``. ``sharding``: the tree's split over a
    tensor-parallel or a pipe axis, or both (a ``parallel.tensor.Sharding``),
    or None."""
    schedule = lr_schedule(params)
    name = (params.get("optimizer") or "adam").lower()
    clip = params.get("gradient_clipping")
    if clip is None:
        clip = 1.0
    if name == "adam":
        opt = AdamW(
            tree, schedule,
            b1=params.get("beta_1") or 0.9,
            b2=params.get("beta_2") or 0.999,
            eps=params.get("epsilon") or 1e-6,
            weight_decay=params.get("weight_decay") or 0.0,
            clip=clip or None,
            fused=bool(params.get("fused_optimizer")),
            sharding=sharding,
        )
    elif name == "adafactor":
        opt = Adafactor(
            tree, schedule,
            decay_rate=params.get("adafactor_decay_rate") or 0.8,
            clipping_threshold=params.get("adafactor_clipping") or 1.0,
            eps=params.get("epsilon_1") or 1e-30,
            clip=clip or None,
            sharding=sharding,
        )
    else:
        raise ValueError(f"{name} not recognized")
    skip = params.get("skip_nonfinite_updates")
    if skip:
        opt = SkipNonfinite(opt, int(skip))
    return opt, schedule
