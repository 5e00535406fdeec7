"""Pipeline parallelism: the layer stack split over a pipe mesh axis, run
as a GPipe schedule (port of ``dalle_mtf_tpu/parallel/pipeline.py``).

A ``layers:<axis>`` layout rule splits every stacked ``[L, ...]`` leaf on
its layer dim over the axis: stage ``s`` of ``P`` holds layers
``[s * L/P, (s + 1) * L/P)``. A data rank's ``b`` rows are cut into ``M``
contiguous microbatches of ``b/M`` rows (JAX ``pipeline_apply``), and stage
``s`` runs its layers on microbatch ``t - s`` at step ``t``, ``M + P - 1``
steps in all: every forward first, then autograd runs the backwards in
reverse.

Where JAX has one program over the pipe axis, the port has one process a
stage, and the activations hop to the next stage point to point
(``ppermute``'s counterpart). Each hop is an ``autograd.Function`` whose
backward is the reverse hop of the gradient, as ``ppermute``'s transpose is:

- ``_Send``: sends a tensor to a peer; its backward receives the tensor's
  gradient back from there;
- ``_Recv``: receives a tensor from a peer; its backward sends its gradient
  back there.

A stage that is not the last sends each microbatch's output to the next
stage, and one that is not the first receives each microbatch's input from
the previous one. Then the last stage's output, the whole ``[b, S, E]``, is
split by rows over the stages, so that each stage runs the loss head on its
own rows (JAX ``_shard_head_rows``): stage ``j`` takes rows
``[j * b/P, (j + 1) * b/P)`` (``head_bounds``), which the last stage sends
it; their gradients come back to the last stage in the backward, and
autograd sums them into the whole output's.

Every hop also takes and gives a zero-size ``token``, and the hops of a
stage are chained through it in the order they run; the last token joins
the stage's head rows. So a stage's graph is one chain from its first hop
to its head rows, and the backward makes its point-to-point calls in
exactly the reverse order of the forward's, on every stage, by data
dependency alone: a mismatched order would be a hang, not an error. The
peers' orders agree: stage ``s`` receives microbatch ``i``'s input after
stage ``s - 1`` sent it, in ``i`` order forward and in reverse order
backward, and the head rows come last forward and first backward. An empty
message (a stage with no head rows) is skipped at both ends.

Beside a tensor-parallel axis (PP x TP) a rank's pipe group is the ranks
of its model index on every stage: each hop carries its whole ``[b/M, S,
E]`` microbatch (the ranks of a model group hold the same activations
between the blocks) to the rank of its model index on the next stage, and
the blocks' collectives inside ``stage_fn`` run over the stage's model
group. The calls keep one order there too. The ranks of a model group run
the same stage on the same microbatches, so they build the same graph:
the same hops, and the same collectives in the same places. Autograd runs
a graph's nodes in an order fixed by its structure (a node once every
gradient it takes is in, ready nodes by their creation order, all on the
one device's thread: every tensor of a pass lies on the rank's card, or
on the CPU). So the ranks of a model group make their backward
collectives, and each its hops, in one order, and a block under
``recompute_grad`` reruns its forward, with its collectives, at the same
point on each, when the first gradient of its output arrives. The hops
pair up as without the model axis, one model index at a time. A
mismatched order would be a hang over gloo, not an error.

Over gloo a CUDA tensor is staged through host memory (gloo sends CPU
tensors), counted in ``STAGED_BYTES``; over NCCL it is sent from the card.
``SENT_BYTES`` counts every message a rank sends, by kind.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# the bytes this rank sent: microbatch activations forward, their gradients
# backward, the head rows forward and their gradients backward
SENT_BYTES = {"activations": 0, "gradients": 0, "head_rows": 0, "head_grads": 0}
# the kind of a forward message's gradient, sent back in the backward
_GRADIENT = {"activations": "gradients", "head_rows": "head_grads"}
# the bytes that crossed host memory on this rank (sent and received)
STAGED_BYTES = {"pipeline": 0}


class Pipe:
    """This rank's place in its pipeline: the process group, the global
    ranks in stage order and this rank's stage."""

    def __init__(self, group, ranks: list[int], stage: int):
        self.group, self.ranks, self.stage, self.n = group, list(ranks), stage, len(ranks)
        self.through_host = dist.get_backend(group) == "gloo"

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.n - 1


def stage_layers(n_layers: int, stages: int, stage: int) -> tuple[int, int]:
    """[start, stop) of the layers stage ``stage`` of ``stages`` runs;
    ValueError where they do not divide (JAX ``_pipe_mesh``)."""
    if n_layers % stages:
        raise ValueError(f"pipeline: n_layers {n_layers} not divisible by the pipe axis of "
                         f"size {stages}")
    per = n_layers // stages
    return stage * per, (stage + 1) * per


def microbatch_rows(rows: int, microbatches: int) -> int:
    """The rows of a microbatch; ValueError where ``microbatches`` does not
    divide ``rows`` (JAX ``pipeline_apply``)."""
    if rows % microbatches:
        raise ValueError(f"pipeline: batch {rows} not divisible by {microbatches} microbatches")
    return rows // microbatches


def head_bounds(rows: int, stages: int, warn: bool = True) -> list[tuple[int, int]]:
    """Every stage's [start, stop) of a data rank's ``rows`` for the loss
    head: ``rows / stages`` contiguous rows each; where they do not divide,
    a warning (with ``warn``), and the last stage takes every row (the
    others none)."""
    if rows % stages == 0:
        per = rows // stages
        return [(j * per, (j + 1) * per) for j in range(stages)]
    if warn:
        logger.warning("pipeline head: batch %d does not divide over the %d pipeline stages: the "
                       "head could not be split, so the last stage runs it on every row (%dx "
                       "the head's work on one rank). Use a batch a multiple of %d to split it.",
                       rows, stages, stages, stages)
    return [(0, 0)] * (stages - 1) + [(0, rows)]


def _send(t: torch.Tensor, dst: int, pipe: Pipe, kind: str) -> None:
    if not t.numel():
        return
    t = t.detach().contiguous()
    nbytes = t.numel() * t.element_size()
    SENT_BYTES[kind] += nbytes
    if pipe.through_host and t.device.type != "cpu":
        t = t.cpu()
        STAGED_BYTES["pipeline"] += nbytes
    dist.send(t, dst, group=pipe.group)


def _recv(shape, dtype, device, src: int, pipe: Pipe) -> torch.Tensor:
    staged = pipe.through_host and torch.device(device).type != "cpu"
    buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else device)
    if not buf.numel():
        return buf.to(device)
    dist.recv(buf, src, group=pipe.group)
    if not staged:
        return buf
    STAGED_BYTES["pipeline"] += buf.numel() * buf.element_size()
    return buf.to(device)


def _token(like: torch.Tensor) -> torch.Tensor:
    return like.new_zeros(0)


class _Send(torch.autograd.Function):
    """(y, token) -> token: y to global rank ``peer`` (a ``kind`` of
    ``SENT_BYTES``); backward: its gradient from there."""

    @staticmethod
    def forward(ctx, y, token, pipe, peer, kind):
        ctx.pipe, ctx.peer = pipe, peer
        ctx.shape, ctx.dtype, ctx.device = y.shape, y.dtype, y.device
        _send(y, peer, pipe, kind)
        return _token(token)

    @staticmethod
    def backward(ctx, g_token):
        g = _recv(ctx.shape, ctx.dtype, ctx.device, ctx.peer, ctx.pipe)
        return g, _token(g_token), None, None, None


class _Recv(torch.autograd.Function):
    """token -> (x, token): x of ``shape`` from global rank ``peer``;
    backward: its gradient back there (the ``kind``'s gradient in
    ``SENT_BYTES``)."""

    @staticmethod
    def forward(ctx, token, pipe, peer, kind, shape, dtype):
        ctx.pipe, ctx.peer, ctx.kind = pipe, peer, _GRADIENT[kind]
        return _recv(shape, dtype, token.device, peer, pipe), _token(token)

    @staticmethod
    def backward(ctx, g, g_token):
        _send(g, ctx.peer, ctx.pipe, ctx.kind)
        return _token(g_token), None, None, None, None, None


def pipeline_apply(stage_fn, x, pipe: Pipe, rows: int, microbatches: int, tail, dtype,
                   device) -> torch.Tensor:
    """This rank's part of the GPipe schedule over a data rank's ``rows``
    rows, and its rows of the result for the loss head.

    ``stage_fn(h, i)``: this stage's layers on microbatch ``i`` (``h``: its
    ``[rows / microbatches, *tail]`` activations). ``x``: the embedded
    ``[rows, *tail]`` on the first stage (None on the others). Returns the
    last stage's output rows ``head_bounds(rows, pipe.n)[pipe.stage]``."""
    mb = microbatch_rows(rows, microbatches)
    bounds = head_bounds(rows, pipe.n)
    token = torch.zeros(0, dtype=dtype, device=device, requires_grad=torch.is_grad_enabled())
    ranks, s = pipe.ranks, pipe.stage
    outs = []
    for i in range(microbatches):
        if pipe.first:
            h = x[i * mb:(i + 1) * mb]
        else:
            h, token = _Recv.apply(token, pipe, ranks[s - 1], "activations", (mb, *tail), dtype)
        h = stage_fn(h, i)
        if pipe.last:
            outs.append(h)
        else:
            token = _Send.apply(h, token, pipe, ranks[s + 1], "activations")
    a, b = bounds[s]
    if not pipe.last:
        return _Recv.apply(token, pipe, ranks[-1], "head_rows", (b - a, *tail), dtype)[0]
    whole = torch.cat(outs)
    for j, (c, d) in enumerate(bounds[:-1]):
        token = _Send.apply(whole[c:d], token, pipe, ranks[j], "head_rows")
    # + the empty token's sum (0): the sends' backwards, which receive the
    # other stages' gradients, join the head rows' graph
    return whole[a:b] + token.sum()
