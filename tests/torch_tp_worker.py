"""One rank of the port's tensor-parallel runs in the CPU tests
(tests/test_torch_tp_xent.py, tests/test_torch_tp_dalle.py), on the gloo
backend:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tests/torch_tp_worker.py <mode> <inputs.pt> <out_dir>

Every mode reads its cases from the inputs (a list, so that one launch
serves several; a case's own ``mode`` overrides the launch's) and rank 0
writes ``<out_dir>/out.pt``, one result a case.

``xent``: ``chunked_softmax_xent_auto`` (loss, dx, and dw/db gathered over
the model group) and ``chunked_xent_eval_auto`` on this rank's block of the
vocabulary, on a ``data:1,model:m`` mesh of the whole world.
``dalle_step``: the DALLE loss and the gradients of every leaf (this rank's
blocks, gathered over the model group and summed over the replicas) on the
case's mesh and layout, the batch rows split over the data axis; with
``steps``, that many optimizer steps instead (the config's optimizer with
its clip and ``skip_nonfinite_updates``), and the whole parameters and
losses after them (a ``replicated`` case's layout splits nothing).
``train``: ``train_dalle.main`` on each case's argv in turn, in one process
group (a case with ``raises`` must raise NotImplementedError naming it);
rank 0's logged history and eval history. ``train_vae``: the same through
``train_vae.main``. ``vae_step``: ``steps`` ``Trainer.train_step``s of the
VAE task on the case's mesh and layout from the whole tree ``params``, the
rows of ``images`` split over the batch axis and the Gumbel draw the
rows and columns of ``u`` the rank holds (with ``perturb``, every copy
but the first of a leaf or a block scales its gradient by 1 + perturb);
the losses, the first and the last step's gradients and the final
parameters (whole), the eval metrics of ``Trainer.eval_step`` after, and
every rank's copy groups (``Mesh.copy_ranks``, ``block_copy_ranks``) and
digests of its replicated leaves and its blocks. ``ckpt``: a DALLE ``Trainer`` on
``data:1,model:<world>`` takes one step and saves (rank 0 writes the whole
tree); then a Trainer on ``data:<world/2>,model:2`` restores it, every rank
checking that it holds the file's blocks bit for bit and that it copied
only them (``restored_bytes``); rank 0 returns every rank's figures.
Imports torch and the port only.
"""

import hashlib
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dalle_mtf_tpu_torch.models.dalle import DALLE, DalleConfig  # noqa: E402
from dalle_mtf_tpu_torch.ops import xent_fused  # noqa: E402
from dalle_mtf_tpu_torch.parallel.mesh import Split, build_mesh, split_bounds  # noqa: E402
from dalle_mtf_tpu_torch.parallel.tensor import gather, shard  # noqa: E402
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
    # every case splits something, but an axis that only replicates
    assert (model.sharding is None) == bool(case.get("replicated"))
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


def train(case, proc, cli="train_dalle"):
    import importlib  # noqa: PLC0415

    main_ = importlib.import_module(f"dalle_mtf_tpu_torch.{cli}").main
    if case.get("raises"):
        try:
            main_(case["argv"])
        except NotImplementedError as e:
            assert case["raises"] in str(e), e
            return {"raised": str(e)}
        raise AssertionError(f"{case['argv']} did not raise")
    trainer = main_(case["argv"])
    return {"history": trainer.history, "eval_history": trainer.eval_history}


def _vae_whole(vae, tree):
    """The whole VAE tree (numpy) from this rank's: the codebook gathered."""
    out = {}
    for p, t in named_leaves(tree):
        split = vae.sharding.of(p) if vae.sharding else None
        out["/".join(p)] = gather(t.detach(), split, vae._tp).numpy()
    return out


def vae_step(case, proc, out_dir):
    from dalle_mtf_tpu_torch.ops import gumbel  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_vae_task  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.trainer import Trainer  # noqa: PLC0415

    u = torch.as_tensor(case["u"])

    def same_u(shape, generator, device, block=None):
        row0, col0, _ = block
        return u[row0:row0 + shape[0], ..., col0:col0 + shape[-1]].to(device)

    gumbel.gumbel_uniform = same_u
    params = case["params"]
    mesh = build_mesh(case["mesh_shape"], case["layout"], "global", proc.rank, proc.world)
    vae, init_fn, loss_fn, eval_fn = make_vae_task(params, "cpu", mesh)
    assert (vae.sharding is not None) == ("tokens_dim" in case["layout"])
    tree = {k: v for k, v in convert.vae_params_from_numpy(case["tree"], vae).items()}
    if vae.sharding is not None:
        tree = {k: (shard(v, vae.sharding.of((k,))).clone() if k == "codebook" else v)
                for k, v in tree.items()}
    split = {p: vae.sharding is not None and vae.sharding.of(p) is not None
             for p, _ in named_leaves(tree)}
    for p, t in named_leaves(tree):
        t.requires_grad_(True)
        copies = mesh.block_copy_ranks if split[p] else mesh.copy_ranks
        if case.get("perturb") and copies and copies.index(proc.rank):
            # as a non-reproducible kernel would: this copy's gradient differs
            t.register_hook(lambda g: g * (1 + case["perturb"]))
    trainer = Trainer(params, init_fn, loss_fn, os.path.join(out_dir, f"vae_{proc.rank}"),
                      vae.cfg.image_seq_len, "cpu", eval_loss_fn=eval_fn, mesh=mesh,
                      sharding=vae.sharding)
    opt, trainer.schedule = get_optimizer(params, tree, vae.sharding)
    state = {"step": 0, "params": tree, "opt": opt}
    n = mesh.size("data")
    rows = case["images"].shape[0] // n
    i = mesh.index("data")
    batch = {"image": case["images"][i * rows:(i + 1) * rows]}
    losses, grads = [], []
    for step in range(case["steps"]):
        state, metrics = trainer.train_step(state, batch, torch.Generator().manual_seed(step))
        losses.append(float(metrics["loss"]))
        grads.append({"/".join(p): gather(t.grad, vae.sharding.of(p) if vae.sharding else None,
                                          vae._tp).numpy() for p, t in named_leaves(tree)})
    metrics = trainer.eval_step(state, batch, torch.Generator().manual_seed(0))
    trainer.close()
    digests = [hashlib.sha256(b"".join(t.detach().numpy().tobytes()
                                       for p, t in named_leaves(tree) if split[p] == of_split))
               .hexdigest() for of_split in (False, True)]
    copies = [None] * proc.world
    dist.all_gather_object(copies, (mesh.copy_ranks, mesh.block_copy_ranks, *digests))
    return {"losses": losses, "grads": grads, "params": _vae_whole(vae, tree),
            "eval": {k: float(v) for k, v in metrics.items()}, "replicas": mesh.replicas,
            "copies": copies}


def ckpt(case, proc, out_dir):
    from dalle_mtf_tpu_torch.train.trainer import Trainer  # noqa: PLC0415

    cfg = DalleConfig(**case["config"])
    model_dir = os.path.join(out_dir, "ckpt_run")
    figures = {}
    for phase, shape in (("save", f"data:1,model:{proc.world}"),
                         ("restore", f"data:{proc.world // 2},model:2")):
        mesh = build_mesh(shape, case["layout"], "global", proc.rank, proc.world)
        model = DALLE(cfg, "cpu", mesh)
        trainer = Trainer(case["opt_params"], model.init, lambda p, _f, b, g, s: (
            model.loss(p, b["tokens"], g, train=True)[0], {}), model_dir, cfg.total_seq_len,
            "cpu", mesh=mesh, sharding=model.sharding)
        state = trainer.init_state(torch.Generator().manual_seed(case["seed"]))
        if phase == "save":
            figures["drawn_elements"] = model.drawn_elements
            state, _ = trainer.train_step(state, {"tokens": case["tokens"]},
                                          torch.Generator().manual_seed(1))
            trainer.save(state)
            continue
        state = trainer.restore(state)
        saved = torch.load(os.path.join(trainer.ckpt_dir, "ckpt_1.pt"), weights_only=True)
        for p, t in named_leaves(state["params"]):
            want = shard(saved["params"]["/".join(p)], model.sharding.of(p))
            assert torch.equal(t.detach(), want), p
        moments = state["opt"].state_dict()["adamw"]["state"]
        saved_moments = saved["opt_state"]["adamw"]["state"]
        for i, split in enumerate(state["opt"]._state_splits):
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(moments[i][k], shard(saved_moments[i][k], split)), (i, k)
        local = sum(t.numel() * t.element_size() for _, t in named_leaves(state["params"]))
        figures.update(restored_bytes=trainer.restored_bytes, local_param_bytes=local,
                       step=state["step"])
        trainer.close()
    everyone = [None] * proc.world
    dist.all_gather_object(everyone, figures)
    return everyone


def main():
    mode, inputs, out_dir = sys.argv[1:4]
    proc = init_distributed(None, "cpu")
    try:
        torch.set_num_threads(1)
        cases = torch.load(inputs, weights_only=False)
        modes = {"xent": xent, "dalle_step": dalle_step, "train": train,
                 "train_vae": lambda case, proc: train(case, proc, "train_vae"),
                 "vae_step": lambda case, proc: vae_step(case, proc, out_dir),
                 "ckpt": lambda case, proc: ckpt(case, proc, out_dir)}
        # a case may name its own mode: one launch serves several
        results = [modes[case.get("mode", mode)](case, proc) for case in cases]
        if proc.rank == 0:
            torch.save(results, os.path.join(out_dir, "out.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
