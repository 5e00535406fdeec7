"""One rank of the port's sequence-parallel runs in the CPU tests
(tests/test_torch_ring_attention.py, tests/test_torch_ring_dalle.py), on the
gloo backend:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tests/torch_ring_worker.py <attention|dalle_step> <inputs.pt> <out_dir>

``attention``: ``ring_attention_auto`` forward and backward on this rank's
rows and sequence shard of the global q, k, v, g in the inputs (with the
inputs' ``plain`` choice, if any); writes its
out, dq, dk, dv and kernel counts to ``<out_dir>/rank<r>.pt``.
``dalle_step``: the DALLE loss and gradients of this rank's share on the
global tokens (through the fused head where the inputs set ``fused_xent``),
summed over the world; rank 0 writes them to ``<out_dir>/step.pt``. ``image_step``: the same for an image-mode batch
through ``make_dalle_task``'s train loss, the frozen VAE encoding this
rank's rows. Imports torch and the port only.
"""

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dalle_mtf_tpu_torch.models.dalle import DALLE, DalleConfig  # noqa: E402
from dalle_mtf_tpu_torch.ops import ring_attention as ring  # noqa: E402
from dalle_mtf_tpu_torch.parallel.mesh import build_mesh  # noqa: E402
from dalle_mtf_tpu_torch.train.optim import named_leaves  # noqa: E402
from dalle_mtf_tpu_torch.train.tasks import make_dalle_task  # noqa: E402
from dalle_mtf_tpu_torch.utils.config import Config  # noqa: E402
from dalle_mtf_tpu_torch.utils.distributed import init_distributed  # noqa: E402


def _rows(mesh, axis, t, dim):
    """This rank's block of ``t`` along ``dim`` on mesh axis ``axis``."""
    n, i = mesh.size(axis), mesh.index(axis)
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def attention(inp, out_dir, proc):
    mesh = build_mesh(inp["mesh_shape"], "batch_dim:data,total_seq_dim:seq", "ring",
                      proc.rank, proc.world)
    leaves = []
    for name in ("q", "k", "v"):
        t = _rows(mesh, "seq", _rows(mesh, "data", inp[name], 0), 2)
        leaves.append(t.clone().requires_grad_(True))
    g = _rows(mesh, "seq", _rows(mesh, "data", inp["g"], 0), 2)
    out = ring.ring_attention_auto(*leaves, mesh, "seq", "data", inp["window"], inp["rate"],
                                   inp["seed"] if inp["rate"] else None,
                                   plain=inp.get("plain", False))
    out.backward(g)
    torch.save({"out": out.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad,
                "dv": leaves[2].grad, "coords": mesh.coords,
                "launches": dict(ring.KERNEL_LAUNCHES)},
               os.path.join(out_dir, f"rank{proc.rank}.pt"))


def _trainable(params):
    """A copy of the parameter tree whose leaves require grad."""
    tree = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v.clone())
            for k, v in params.items()}
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    return tree


def _save_summed(loss, tree, out_dir, proc):
    """Backward, then the loss and grads summed over the world; rank 0
    writes them to ``<out_dir>/step.pt``."""
    loss.backward()
    grads = {"/".join(p): t.grad for p, t in named_leaves(tree)}
    for t in (loss.detach(), *grads.values()):
        dist.all_reduce(t)
    if proc.rank == 0:
        torch.save({"loss": loss.detach(), "grads": grads}, os.path.join(out_dir, "step.pt"))


def dalle_step(inp, out_dir, proc):
    cfg = DalleConfig(**inp["config"])
    mesh = build_mesh(inp["mesh_shape"], inp["layout"], cfg.attention_type, proc.rank,
                      proc.world)
    model = DALLE(cfg, "cpu", mesh)
    params = _trainable(inp["params"])
    tokens = _rows(mesh, cfg.ring_batch_axis, inp["tokens"], 0)
    loss, _ = model.loss(params, tokens, torch.Generator().manual_seed(inp["seed"]),
                         train=True, fused_xent=inp.get("fused_xent", False))
    _save_summed(loss, params, out_dir, proc)


def image_step(inp, out_dir, proc):
    params = Config.from_mapping(inp["config"])
    mesh = build_mesh(params["mesh_shape"], params["layout"], params["attention_type"],
                      proc.rank, proc.world)
    dalle, _vae, _init, train_loss, _eval = make_dalle_task(params, "cpu", mesh)
    tree = _trainable(inp["params"])
    batch = {k: _rows(mesh, dalle.cfg.ring_batch_axis, v, 0) for k, v in inp["batch"].items()}
    loss, _ = train_loss(tree, inp["vae_params"], batch,
                         torch.Generator().manual_seed(inp["seed"]), 0)
    _save_summed(loss, tree, out_dir, proc)


def main():
    mode, inputs, out_dir = sys.argv[1:4]
    proc = init_distributed(None, "cpu")
    try:
        inp = torch.load(inputs, weights_only=False)
        {"attention": attention, "dalle_step": dalle_step,
         "image_step": image_step}[mode](inp, out_dir, proc)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
