"""One rank of the port's tensor-parallel runs in the CPU tests
(tests/test_torch_tp_xent.py, tests/test_torch_tp_dalle.py), on the gloo
backend:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tests/torch_tp_worker.py <mode> <inputs.pt> <out_dir>

Every mode reads its cases from the inputs (a list, so that one launch
serves several) and rank 0 writes ``<out_dir>/out.pt``, one result a case.

``xent``: ``chunked_softmax_xent_auto`` (loss, dx, and dw/db gathered over
the model group) and ``chunked_xent_eval_auto`` on this rank's block of the
vocabulary, on a ``data:1,model:m`` mesh of the whole world.
``dalle_step``: the DALLE loss and the gradients of every leaf (this rank's
blocks, gathered over the model group and summed over the replicas) on the
case's mesh and layout, the batch rows split over the data axis; with
``steps``, that many optimizer steps instead (the config's optimizer with
its clip and ``skip_nonfinite_updates``), and the whole parameters and
losses after them. ``train``: ``train_dalle.main`` on each case's argv in
turn, in one process group (a case with ``raises`` must raise
NotImplementedError naming it); rank 0's logged history and eval history.
Imports torch and the port only.
"""

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dalle_mtf_tpu_torch.models.dalle import DALLE, DalleConfig  # noqa: E402
from dalle_mtf_tpu_torch.ops import xent_fused  # noqa: E402
from dalle_mtf_tpu_torch.parallel.mesh import Split, build_mesh, split_bounds  # noqa: E402
from dalle_mtf_tpu_torch.parallel.tensor import gather  # noqa: E402
from dalle_mtf_tpu_torch.train.optim import get_optimizer, named_leaves  # noqa: E402
from dalle_mtf_tpu_torch.utils import convert  # noqa: E402
from dalle_mtf_tpu_torch.utils.distributed import init_distributed  # noqa: E402


def xent(case, proc):
    mesh = build_mesh(f"data:1,model:{proc.world}", "vocab_dim:model", "global", proc.rank,
                      proc.world)
    x, w, b, t = case["x"], case["w"], case["b"], case["t"]
    v = w.shape[1]
    split = Split(1, split_bounds("vocab_dim", v, proc.world), mesh.index("model"))
    lo, hi = split.start, split.stop
    xl = x.clone().requires_grad_(True)
    wl = w[:, lo:hi].clone().requires_grad_(True)
    bl = b[lo:hi].clone().requires_grad_(True)
    args = (case["z_loss"], case["chunks"], "model", mesh, v)
    loss = xent_fused.chunked_softmax_xent_auto(xl, wl, bl, t, *args)
    loss.backward(case["g"])
    el, correct = xent_fused.chunked_xent_eval_auto(x, wl.detach(), bl.detach(), t, *args)
    group = mesh.model_group
    return {"loss": loss.detach(), "dx": xl.grad, "dw": gather(wl.grad, split, group),
            "db": gather(bl.grad, split._replace(dim=0), group), "eval_loss": el,
            "correct": correct}


def _whole_grads(model, mesh, tree):
    """Every leaf's gradient, the blocks gathered over the model group and
    the shares summed over the replicas."""
    grads = {p: t.grad for p, t in named_leaves(tree)}
    if model.sharding is not None:
        grads = {p: gather(g, model.sharding.of(p), model.sharding.group)
                 for p, g in grads.items()}
    if mesh.replicas > 1:
        for g in grads.values():
            dist.all_reduce(g, group=mesh.replica_group)
    return {"/".join(p): g for p, g in grads.items()}


def _sum_replicas(mesh, t):
    t = t.detach().clone()
    if mesh.replicas > 1:
        dist.all_reduce(t, group=mesh.replica_group)
    return t


def dalle_step(case, proc):
    cfg = DalleConfig(**case["config"])
    mesh = build_mesh(case["mesh_shape"], case["layout"], cfg.attention_type, proc.rank,
                      proc.world)
    model = DALLE(cfg, "cpu", mesh)
    assert model.sharding is not None  # every case splits something
    tree = convert.shard_dalle_params(case["params"], model)
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    n, i = mesh.size(cfg.ring_batch_axis), mesh.index(cfg.ring_batch_axis)
    tokens = case["tokens"]
    rows = tokens.shape[0] // n
    tokens = tokens[i * rows:(i + 1) * rows]
    fused = case.get("fused_xent", False)
    steps = case.get("steps")
    if not steps:
        gen = torch.Generator().manual_seed(case["seed"])
        loss, _ = model.loss(tree, tokens, gen, train=True, fused_xent=fused)
        loss.backward()
        out = {"loss": _sum_replicas(mesh, loss), "grads": _whole_grads(model, mesh, tree)}
        if case.get("eval"):
            evaluate = model.fused_eval if fused else model.dense_eval
            el, correct = evaluate(tree, tokens, torch.Generator().manual_seed(1))
            out["eval"] = (_sum_replicas(mesh, model.global_mean(el)),
                           _sum_replicas(mesh, model.global_mean(correct)))
        return out
    opt, _ = get_optimizer(case["opt_params"], tree, model.sharding)
    losses = []
    for step in range(steps):
        opt.zero_grad()
        loss, _ = model.loss(tree, tokens, torch.Generator().manual_seed(step), train=True,
                             fused_xent=fused)
        loss.backward()
        if mesh.replicas > 1:
            for t in opt.leaves:
                dist.all_reduce(t.grad, group=mesh.replica_group)
        if step == case.get("nan_step"):
            opt.leaves[-1].grad[0] = float("nan")  # b_out: a split leaf
        norm = opt.step()
        losses.append((float(_sum_replicas(mesh, loss)), float(norm)))
    final = convert.gather_dalle_params(tree, model)  # the whole tree, numpy
    return {"losses": losses, "params": {"/".join(p): a for p, a in named_leaves(final)}}


def train(case, proc):
    from dalle_mtf_tpu_torch import train_dalle  # noqa: PLC0415

    if case.get("raises"):
        try:
            train_dalle.main(case["argv"])
        except NotImplementedError as e:
            assert case["raises"] in str(e), e
            return {"raised": str(e)}
        raise AssertionError(f"{case['argv']} did not raise")
    trainer = train_dalle.main(case["argv"])
    return {"history": trainer.history, "eval_history": trainer.eval_history}


def main():
    mode, inputs, out_dir = sys.argv[1:4]
    proc = init_distributed(None, "cpu")
    try:
        torch.set_num_threads(1)
        cases = torch.load(inputs, weights_only=False)
        fn = {"xent": xent, "dalle_step": dalle_step, "train": train}[mode]
        results = [fn(case, proc) for case in cases]
        if proc.rank == 0:
            torch.save(results, os.path.join(out_dir, "out.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
