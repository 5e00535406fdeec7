"""Training loop (port of ``dalle_mtf_tpu/train/trainer.py``).

The JAX trainer jit-compiles a sharded step and can run ``iterations``
steps as one device loop. Here each step is dispatched eagerly: forward
and backward by autograd, then the clip + AdamW update in place on the
fp32 master parameters. Over several processes (a ``parallel.mesh.Mesh``)
every rank holds the parameter tree (on a tensor-parallel axis, its blocks
of the split leaves: ``sharding``) and its own rows and sequence shard of
the batch; its loss is its share of the global mean, so the gradients are
summed over the mesh's replicas (``Mesh.replica_group``: the ranks that
differ only on the data axes, ``Mesh.data_axes``) before the clip; the
ranks that differ only on a tensor-parallel or a replicate-only axis hold
copies of a leaf, which each compute its gradient on their own (cuDNN's
default algorithms are not bit-reproducible), so the first of them
broadcasts its gradient to the others (``Trainer._agree``) and every copy
takes the same step. The metrics are summed over the replicas too. Under
pipeline parallelism (a mesh with a pipe axis) a stage's layers are summed
over the replicas alone, while the replicated leaves (the embeddings, the
final LN and the loss head), of which each stage holds a part of the
gradient (the first stage the embeddings', each stage its head rows'; a
leaf a stage does not use has a zero gradient), and the metrics are summed
over the replicas and the stages (``Mesh.share_group``). Under both (PP x
TP) a rank holds its stage's block of each stacked split leaf; the sums are
the same, each within the rank's model index.
Rank 0 alone writes checkpoints and summaries, behind a barrier; every rank
restores. Kept from the JAX loop:

- microbatch gradient accumulation (``tokens_per_mb_per_replica``) with the
  same minor-stride split (row b of microbatch i is batch row b*n + i);
- metrics ``loss``, ``grad_norm`` (before clipping), ``lr`` and the task's
  aux losses, fetched only on log steps;
- checkpoints every ``steps_per_checkpoint`` and at ``train_steps``, with
  ``max_to_keep`` retention and, with ``keep_checkpoint_every_n_hours``
  set, one checkpoint an interval kept out of it (``kept_checkpoints``, the
  rule of orbax's ``keep_time_interval``), atomic writes, restore of the
  latest, an eval over ``eval_steps`` batches at each checkpoint, and then
  the caller's ``summary_fn(trainer, state, step)`` (the VAE's image
  summaries);
- a data stream that runs out between checkpoints saves its tail.

Checkpoints are files in ``torch.save``'s format,
``<model_dir>/checkpoints/ckpt_<step>.pt`` (a ``model_dir`` that is a URL,
gs:// or memory://, is kept as given and written through fsspec:
``data/fs.py``), holding the step, its save time
(``now()``, seconds since the epoch: the retention reads it back after a
restart), the parameter tree and the optimizer state (under
``skip_nonfinite_updates``, with the skip state of
``optim.SkipNonfinite``). A checkpoint is always the whole,
unpadded tree and state a single process writes, so it moves between
layouts. Rank 0 writes it one leaf at a time (``utils/checkpoint.py``):
under tensor parallelism each leaf's blocks are sent to rank 0's host by
the ranks of its model group when the leaf's turn comes
(``gather_to_host``), under pipeline parallelism each stage's layers
by the ranks of its pipeline, and under both each block of a stacked split
leaf by the rank of rank 0's pipe x model plane that holds it, so no card
holds a block it does not own and rank 0's host one leaf. On restore every
rank maps the file and copies out its own blocks (``restored_bytes`` counts
them).
A step the optimizer skips (non-finite gradients) is counted and logged as
any other, as in the JAX loop: its loss and ``grad_norm`` are not finite,
``lr`` is the schedule at the step; the optimizer's own count, and so the
schedule it applies, stays where it was.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import re
import time
from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch
import torch.distributed as dist

from dalle_mtf_tpu_torch.data import fs
from dalle_mtf_tpu_torch.parallel.mesh import BATCH, parse_layout
from dalle_mtf_tpu_torch.parallel.tensor import all_reduce, block_to, broadcast, gather_to_host
from dalle_mtf_tpu_torch.train.optim import get_optimizer, named_leaves
from dalle_mtf_tpu_torch.utils import checkpoint
from dalle_mtf_tpu_torch.utils.summaries import MetricsWriter

logger = logging.getLogger(__name__)

# loss_fn(params, frozen_params, batch, generator, step) -> (loss, aux_scalars)
LossFn = Callable[[Any, Any, Any, torch.Generator, int], tuple[torch.Tensor, Mapping]]

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


def num_microbatches(
    params: Mapping[str, Any], global_batch: int, seq_len: int, data_parallelism: int
) -> int:
    """Microbatch count from ``tokens_per_mb_per_replica`` (mtf's
    serialize_num_microbatches, model_fns.py:141-154); None/0 disables
    accumulation. Rounded up to a divisor of the global batch."""
    tokens_per_mb = params.get("tokens_per_mb_per_replica")
    if not tokens_per_mb:
        return 1
    batch_per_replica = max(1, global_batch // max(1, data_parallelism))
    n = max(1, int(np.ceil(batch_per_replica * seq_len / tokens_per_mb)))
    n0 = n
    while global_batch % n != 0:
        n += 1
    if n != n0:
        logger.warning(
            "num_microbatches rounded %d -> %d to divide global batch %d: "
            "realized %d rows (%d tokens) per microbatch per replica vs "
            "tokens_per_mb_per_replica=%d",
            n0, n, global_batch, max(1, batch_per_replica // n),
            max(1, batch_per_replica // n) * seq_len, tokens_per_mb,
        )
    return n


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    """The steps of the ``ckpt_<step>.pt`` files in ``ckpt_dir`` (a path or
    a URL), ascending."""
    return sorted(int(m.group(1)) for f in fs.listdir(ckpt_dir) if (m := _CKPT.fullmatch(f)))


def model_dir_path(model_dir: str) -> str:
    """``model_dir`` made absolute, or as given where it is a URL (gs://...:
    the JAX trainer hands those to orbax untouched)."""
    if fs.is_remote(model_dir):
        return model_dir
    return os.path.abspath(os.path.expanduser(model_dir))


def now() -> float:
    """The clock a checkpoint's save time is read from (seconds since the
    epoch); the one place a test replaces it."""
    return time.time()


def keep_interval_s(hours) -> int | None:
    """``keep_checkpoint_every_n_hours`` as orbax's ``EveryNSeconds`` takes
    it from the JAX trainer's ``keep_time_interval``: whole seconds of the
    timedelta; None where unset."""
    return int(datetime.timedelta(hours=float(hours)).total_seconds()) if hours else None


def kept_checkpoints(stamps, max_to_keep: int, interval_s: int | None) -> list[bool]:
    """Which of the checkpoints ``stamps`` [(step, save time)], ascending,
    to keep: the newest ``max_to_keep`` (orbax's ``LatestN``) and, with
    ``interval_s``, the first and each later one saved at least
    ``interval_s`` after the last one this rule kept (orbax's
    ``EveryNSeconds``); either rule keeps a checkpoint."""
    keep = [i >= len(stamps) - max_to_keep for i in range(len(stamps))]
    if interval_s is not None and stamps:
        last = stamps[0][1]
        keep[0] = True
        for i, (_step, t) in enumerate(stamps[1:], 1):
            if t - last >= interval_s:
                keep[i], last = True, t
    return keep


def step_generator(seed: int, stream: int, index: int) -> torch.Generator:
    """A CPU generator for (seed, stream, index): the counterpart of the JAX
    loop's ``fold_in(fold_in(rng, stream), index)``."""
    state = np.random.SeedSequence([seed, stream, index]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _flat_collective(tensors, collective) -> None:
    """``collective`` in place on fp32 ``tensors`` as one flat buffer (one
    collective instead of one a leaf)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    torch._foreach_copy_(tensors, [c.view_as(t) for c, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])


def _all_reduce_sum(tensors, group=None) -> None:
    """Sum fp32 ``tensors`` over ``group`` (None: the world) in place."""
    _flat_collective(tensors, lambda flat: all_reduce(flat, group))


class Trainer:
    def __init__(
        self,
        params: Mapping[str, Any],
        init_fn: Callable[[torch.Generator], Any],
        loss_fn: LossFn,
        model_dir: str,
        seq_len: int,
        device: torch.device | str,
        frozen_params: Any = None,
        eval_loss_fn: LossFn | None = None,
        mesh=None,
        sharding=None,
    ):
        self.params = params
        self.init_fn = init_fn
        self.loss_fn = loss_fn
        self.eval_loss_fn = eval_loss_fn or loss_fn
        self.model_dir = model_dir_path(model_dir)
        self.device = torch.device(device)
        self.frozen_params = frozen_params
        self.batch_size = params["train_batch_size"]
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.sharding = sharding if self.mesh else None
        self.rank = self.mesh.rank if self.mesh else 0
        dp = mesh.size(parse_layout(params.get("layout")).get(BATCH) or "data") if mesh else 1
        self.num_mb = num_microbatches(params, self.batch_size, seq_len, dp)
        self.max_to_keep = params.get("max_to_keep") or 5
        self.keep_interval_s = keep_interval_s(params.get("keep_checkpoint_every_n_hours"))
        self._stamps: dict[int, float] = {}  # save times of the checkpoints seen
        self.writer = MetricsWriter(self.model_dir, enabled=self.rank == 0)
        # what run() logged: one dict per log step / per checkpoint eval
        self.history: list[dict] = []
        self.eval_history: list[dict] = []
        self.state: dict | None = None  # after run(): the state of the last step
        self.restored_bytes = 0  # what the last restore copied out of the file
        logger.info("trainer: device=%s microbatches=%d", self.device, self.num_mb)

    # ----------------------------------------------------------------- state

    def init_state(self, generator: torch.Generator) -> dict:
        """{"step": 0, "params": fp32 tree (leaves require grad), "opt":
        its optimizer}."""
        params = self.init_fn(generator)
        for _, t in named_leaves(params):
            t.requires_grad_(True)
        opt, self.schedule = get_optimizer(self.params, params, self.sharding)
        return {"step": 0, "params": params, "opt": opt}

    def param_count(self, state: dict) -> int:
        """The whole model's parameters (not this rank's blocks)."""
        if self.sharding is None:
            return sum(t.numel() for _, t in named_leaves(state["params"]))
        return sum(math.prod(self.sharding.whole_shape(p, t.shape))
                   for p, t in named_leaves(state["params"]))

    # ------------------------------------------------------------ train step

    def _put_batch(self, batch: Mapping[str, Any]) -> dict:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def train_step(self, state: dict, batch, generator: torch.Generator):
        """One update in place; returns (state, metrics as 0-dim tensors)."""
        params, opt, step = state["params"], state["opt"], state["step"]
        batch = self._put_batch(batch)
        opt.zero_grad()
        n = self.num_mb
        if n > 1:
            loss, aux = torch.zeros((), device=self.device), {}
            for i in range(n):
                mb = {k: v[i::n] for k, v in batch.items()}
                loss_i, aux_i = self.loss_fn(params, self.frozen_params, mb, generator, step)
                loss_i.backward()
                loss = loss + loss_i.detach().float()
                for k, v in aux_i.items():
                    aux[k] = aux.get(k, 0.0) + v.detach().float()
            self._fill_unused(opt)
            torch._foreach_div_([t.grad for t in opt.leaves], float(n))
            loss = loss / n
            aux = {k: v / n for k, v in aux.items()}
        else:
            loss, aux = self.loss_fn(params, self.frozen_params, batch, generator, step)
            loss.backward()
        if self.mesh:
            self._sum_shares(opt)
        if self.mesh and self.mesh.copies > 1:
            self._agree(opt)
        grad_norm = opt.step()
        state["step"] = step + 1
        metrics = self._reduce({"loss": loss.detach().float(),
                                **{k: v.detach().float() for k, v in aux.items()}})
        return state, {**metrics, "grad_norm": grad_norm,
                       "lr": torch.tensor(self.schedule(step))}

    def _placed(self, path) -> tuple:
        """The placement of the leaf at ``path`` (``Sharding.placed``; empty
        where it is whole)."""
        return self.sharding.placed(path) if self.sharding is not None else ()

    def _pipe_split(self, path) -> bool:
        """Whether the leaf at ``path`` is split over the pipe axis (a
        stage's layers)."""
        pipe = self.mesh.pipe_axis
        return pipe is not None and any(p.axis == pipe for p in self._placed(path))

    def _model_split(self, path) -> bool:
        """Whether the leaf at ``path`` is split over an axis other than the
        pipe axis (a tensor-parallel block)."""
        return any(p.axis != self.mesh.pipe_axis for p in self._placed(path))

    def _fill_unused(self, opt) -> None:
        """A zero gradient for each leaf this rank's pipeline stage did not
        use (the embeddings beyond the first stage)."""
        if self.mesh is not None and self.mesh.pipe_axis is not None:
            for t in opt.leaves:
                if t.grad is None:
                    t.grad = torch.zeros_like(t)

    def _sum_shares(self, opt) -> None:
        """Sum the gradients' shares: a stage's layers over the replicas
        (``Mesh.replica_group``), every other leaf over the shares
        (``Mesh.share_group``, the replicas without a pipe axis); a leaf this
        rank's stage did not use takes a zero gradient first. One flat
        all_reduce a group."""
        mesh = self.mesh
        self._fill_unused(opt)
        split = [self._pipe_split(p) for p, _ in opt.named]
        for of_split, n, group in ((True, mesh.replicas, mesh.replica_group),
                                   (False, mesh.shares, mesh.share_group)):
            grads = [t.grad for (_, t), s in zip(opt.named, split) if s == of_split]
            if n > 1 and grads:
                _all_reduce_sum(grads, group)

    def _agree(self, opt) -> None:
        """Every copy of a leaf takes the gradient of the first: a leaf
        whole on its model group (replicated, or a stage's layers of it)
        over ``Mesh.copy_group``, a tensor-parallel block over
        ``Mesh.block_copy_group`` (one flat broadcast each)."""
        mesh = self.mesh
        split = [self._model_split(p) for p, _ in opt.named]
        for ranks, group, of_split in ((mesh.copy_ranks, mesh.copy_group, False),
                                       (mesh.block_copy_ranks, mesh.block_copy_group, True)):
            grads = [t.grad for (_, t), s in zip(opt.named, split) if s == of_split]
            if ranks and grads:
                _flat_collective(grads, lambda flat: broadcast(flat, ranks[0], group))

    def _reduce(self, metrics: dict) -> dict:
        """Each rank's shares of the metrics, summed over the shares (the
        replicas, and the stages of a pipeline)."""
        if not self.mesh or self.mesh.shares == 1:
            return metrics
        names = list(metrics)
        flat = torch.stack([metrics[n].reshape(()) for n in names])
        _all_reduce_sum([flat], self.mesh.share_group)
        return dict(zip(names, flat.unbind(0)))

    @torch.no_grad()
    def eval_step(self, state: dict, batch, generator: torch.Generator) -> dict:
        loss, aux = self.eval_loss_fn(
            state["params"], self.frozen_params, self._put_batch(batch), generator,
            state["step"],
        )
        return self._reduce({"loss": loss.float(), **{k: v.float() for k, v in aux.items()}})

    # ------------------------------------------------------------ checkpoint

    @property
    def ckpt_dir(self) -> str:
        return fs.join(self.model_dir, "checkpoints")

    def checkpoint_steps(self) -> list[int]:
        return checkpoint_steps(self.ckpt_dir)

    def latest_step(self) -> int:
        steps = self.checkpoint_steps()
        return steps[-1] if steps else 0

    def _writers(self) -> bool:
        """Whether this rank takes part in writing a checkpoint: it is rank
        0, or in rank 0's slice over the axes the sharding splits leaves over
        (``Mesh.plane``: its model group, its pipeline, or its pipe x model
        plane)."""
        if self.sharding is None:
            return self.rank == 0
        axes = [a for a in (self.mesh.pipe_axis, self.mesh.tp_axis) if a is not None]
        return self.rank in np.asarray(self.mesh.plane(axes))

    def _lazy(self):
        """The checkpoint leaf of a tensor and its placement: the tensor
        where it is whole (rank 0 copies it to its host at its turn), else a
        Lazy whole leaf gathered to rank 0's host at its turn, each block
        from the rank of rank 0's slice over its axes that holds it."""
        def leaf(t, placed):
            if not placed:
                return t
            shape = list(t.shape)
            for p in placed:
                shape[p.split.dim] = p.split.size
            ranks = self.mesh.plane([p.axis for p in placed])
            return checkpoint.Lazy(tuple(shape), t.dtype,
                                   lambda: gather_to_host(t, placed, ranks))
        return leaf

    def save(self, state: dict, step: int | None = None) -> None:
        """Write ckpt_<step>.pt atomically with its save time, then delete
        what the retention drops (``_retire``). On a mesh rank 0 writes
        (every replica holds the same state), leaf by leaf, the ranks of
        its model group sending their blocks of each split leaf at its
        turn, and every rank waits for it."""
        step = state["step"] if step is None else step
        if self._writers():
            leaf = self._lazy()
            stamp = now()
            tree = {
                "step": step,
                "time": stamp,
                "params": {"/".join(p): leaf(t, self._placed(p))
                           for p, t in named_leaves(state["params"])},
                "opt_state": state["opt"].state_dict(leaf),
            }
            if self.rank == 0:
                fs.makedirs(self.ckpt_dir)
                checkpoint.write(fs.join(self.ckpt_dir, f"ckpt_{step}.pt"), tree)
                self._stamps[step] = stamp
                self._retire()
            else:
                checkpoint.write(None, tree)
        if self.mesh:
            dist.barrier()

    def _retire(self) -> None:
        """Delete the checkpoints ``kept_checkpoints`` does not keep. The
        save times count only with ``keep_checkpoint_every_n_hours`` set,
        and only then are those of files a run did not write read back (a
        local file without one is judged by its mtime; every checkpoint
        under a URL has one); unset, the newest ``max_to_keep`` stay."""
        steps = self.checkpoint_steps()
        if self.keep_interval_s is not None:
            for s in sorted(set(steps) - set(self._stamps)):
                path = fs.join(self.ckpt_dir, f"ckpt_{s}.pt")
                stamp = checkpoint.read(path).get("time")
                self._stamps[s] = os.path.getmtime(path) if stamp is None else stamp
        keep = kept_checkpoints([(s, self._stamps.get(s, 0.0)) for s in steps], self.max_to_keep,
                                self.keep_interval_s)
        for old, kept in zip(steps, keep):
            if not kept:
                fs.remove(fs.join(self.ckpt_dir, f"ckpt_{old}.pt"))

    def _block(self, t: torch.Tensor, split) -> torch.Tensor:
        """This rank's block of a mapped whole leaf (``split``: its
        placement), copied to the device (counted in ``restored_bytes``)."""
        out = block_to(t, split, self.device)
        self.restored_bytes += out.numel() * out.element_size()
        return out

    def restore(self, state: dict) -> dict:
        """Load the latest checkpoint into ``state`` in place (unchanged when
        there is none). Every rank maps the file and copies its blocks."""
        steps = self.checkpoint_steps()
        if not steps:
            return state
        self.restored_bytes = 0
        obj = checkpoint.read(fs.join(self.ckpt_dir, f"ckpt_{steps[-1]}.pt"))
        with torch.no_grad():
            for path, t in named_leaves(state["params"]):
                t.copy_(self._block(obj["params"]["/".join(path)], self._placed(path)))
        state["opt"].load_state_dict(obj["opt_state"], self._block)
        state["step"] = int(obj["step"])
        logger.info("restored checkpoint at step %d", state["step"])
        return state

    # ------------------------------------------------------------- main loop

    def run(
        self,
        data_iter: Iterator[Any],
        seed: int,
        eval_data_iter: Iterator[Any] | None = None,
        summary_fn: Callable[["Trainer", dict, int], None] | None = None,
    ) -> dict:
        """Train until ``train_steps``, checkpointing and resuming from the
        latest checkpoint; ``summary_fn(self, state, step)`` runs after each
        checkpoint's eval."""
        p = self.params
        train_steps = p["train_steps"]
        steps_per_ckpt = p.get("steps_per_checkpoint") or 1000
        # "iterations" was the reference's device-loop length and so its log
        # cadence (train_dalle.py:62); kept as the default log cadence
        log_every = p.get("log_every") or min(p.get("iterations") or 100, steps_per_ckpt)
        eval_steps = p.get("eval_steps") or 0

        state = self.restore(self.init_state(torch.Generator().manual_seed(seed)))
        start = state["step"]
        logger.info("training %s from step %d to %d (%.2fM params)",
                    p.get("config_name"), start, train_steps,
                    self.param_count(state) / 1e6)

        t0, window_start = time.perf_counter(), start
        step, first, last_saved, data_done = start, True, None, False
        while step < train_steps:
            batch = next(data_iter, None)
            if batch is None:
                data_done = True
                logger.info("data stream exhausted after step %d; stopping early", step)
                break
            state, metrics = self.train_step(state, batch, step_generator(seed, 1, step))
            step += 1
            if step // log_every > (step - 1) // log_every or first:
                first = False
                m = {k: float(v) for k, v in metrics.items()}  # waits for the step
                now = time.perf_counter()
                sps = (step - window_start) / max(now - t0, 1e-9)
                t0, window_start = now, step
                self.writer.scalars(step, {**m, "steps_per_sec": sps})
                self.history.append({"step": step, **m, "steps_per_sec": sps})
                logger.info("step %d loss %.5f lr %.2e grad_norm %.3f %.2f steps/s",
                            step, m["loss"], m["lr"], m["grad_norm"], sps)
            if step // steps_per_ckpt > (step - 1) // steps_per_ckpt or step == train_steps:
                self.save(state, step)
                last_saved = step
                if eval_steps and eval_data_iter is not None:
                    self._evaluate(state, step, seed, eval_data_iter, eval_steps)
                if summary_fn is not None:
                    summary_fn(self, state, step)
                # the next log window times training steps only
                t0, window_start = time.perf_counter(), step
        if data_done and step > start and last_saved != step:
            # the stream ran out between checkpoints: keep the trained tail
            self.save(state, step)
        self.state = state
        return state

    def _evaluate(self, state, step, seed, eval_data_iter, eval_steps) -> None:
        sums: dict[str, list[float]] = {}
        for i in range(eval_steps):
            em = self.eval_step(state, next(eval_data_iter), step_generator(seed, 2, i))
            for k, v in em.items():
                sums.setdefault(k, []).append(float(v))
        means = {f"eval_{k}": float(np.mean(v)) for k, v in sums.items()}
        self.writer.scalars(step, means)
        self.eval_history.append({"step": step, **means})
        logger.info("step %d %s", step,
                    " ".join(f"{k} {v:.5f}" for k, v in sorted(means.items())))

    def close(self):
        self.writer.close()
