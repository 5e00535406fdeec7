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
blocks, gathered over the model group or the pipeline and summed over the
shares: a stage's layers over the replicas, the other leaves over the
replicas and the stages) on the case's mesh and layout, the batch rows split
over the data axis (with ``draws``, the model's dropout seeds are those
numbers in turn instead of its generator's; with ``copies``, every rank's
model group and a digest of its loss and gradients); with ``steps``, that many
optimizer steps instead (the config's optimizer with its clip and
``skip_nonfinite_updates``), and the whole parameters and losses after them
(a ``replicated`` case's layout splits nothing); with ``trainer``, the
steps are ``Trainer.train_step``s of ``make_dalle_task``'s train loss on
the case's ``task`` config (its mesh, layout and attention type) and
``tokens``/``caption`` batch (or ``image``/``caption`` with the frozen
VAE's tree ``vae``), and the eval metrics of ``Trainer.eval_step`` after
them and every rank's shapes of its blocks and of their optimizer moments
come back too. On a pipe mesh every rank's stage, layers and
head rows come back, and whether it logged the head's warning.
``train``: ``train_dalle.main`` on each case's argv in turn, in one process
group (a case with ``raises`` must raise NotImplementedError naming it);
rank 0's logged history and eval history (with ``gathered``, also the
final parameters gathered whole from every rank's blocks). ``train_vae``: the same through
``train_vae.main``. ``vae_step``: ``steps`` ``Trainer.train_step``s of the
VAE task on the case's mesh and layout from the whole tree ``params``, the
rows of ``images`` split over the batch axis and the Gumbel draw the
rows and columns of ``u`` the rank holds (with ``perturb``, every copy
but the first of a leaf or a block scales its gradient by 1 + perturb);
the losses, the first and the last step's gradients and the final
parameters (whole), the eval metrics of ``Trainer.eval_step`` after, and
every rank's copy groups (``Mesh.copy_ranks``, ``block_copy_ranks``),
digests of its replicated leaves and its blocks, the shapes it holds of
each leaf and its two AdamW moments, the kernel shape of each conv of its
first step's forward, and its blocks of ``init_fn``'s tree. ``ckpt``: a DALLE ``Trainer`` on
``data:1,model:<world>`` takes one step and saves (rank 0 writes the whole
tree); then a Trainer on ``data:<world/2>,model:2`` restores it, every rank
checking that it holds the file's blocks bit for bit and that it copied
only them (``restored_bytes``); rank 0 returns every rank's figures. A case
with ``phases`` [(mesh_shape, layout, what)] runs those instead in its own
``model_dir``: "save" (one step, then a save), "restore" (a restore checked
as above) or "restore_step" (a restore, then one step and a save).
``sample``: the KV-cache path on the case's mesh and layout from the whole
tree ``params``, each of the case's ``runs`` on the same blocks: whole-batch
generation (``generate_image_tokens``, or the ``CapturedDecoder``, which
runs eagerly on the CPU), the continuous engine's ``admit_rows`` +
``decode_chunk``, or teacher-forced logits (prefill, then ``decode_step``
on the given tokens), after ``cast_decode_weights`` or the quantizers on
the rank's blocks; every rank's tokens, logits and scales (with the split
of each scale) come back. ``sample_cli``: ``sample_dalle.main`` on each
argv in turn, the checkpoint reads and the block bytes each rank copied
counted, rank 0's PNGs read back. ``serve``: ``serve_dalle.build_server``
on each argv in turn; rank 0 posts the case's requests over HTTP and
drains, the other ranks follow until the stop; a case with ``raises``
must raise ValueError naming it on every rank.
Imports torch and the port only.
"""

import hashlib
import logging
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
    the pipeline and the shares summed: a stage's layers over the
    replicas, every other leaf over the replicas and the stages (a leaf a
    stage did not use has no gradient: zeros)."""
    grads = {p: torch.zeros_like(t) if t.grad is None else t.grad for p, t in named_leaves(tree)}
    placed = {p: model.sharding.placed(p) if model.sharding else () for p in grads}
    pipe = {p: any(x.axis == mesh.pipe_axis for x in placed[p]) and mesh.pipe_axis is not None
            for p in grads}
    grads = {p: gather(g, placed[p], None) for p, g in grads.items()}
    for p, g in grads.items():
        n, group = ((mesh.replicas, mesh.replica_group) if pipe[p]
                    else (mesh.shares, mesh.share_group))
        if n > 1:
            dist.all_reduce(g, group=group)
    return {"/".join(p): g for p, g in grads.items()}


def _sum_replicas(mesh, t):
    """A share summed over the mesh's shares (the replicas, and the stages
    of a pipeline)."""
    t = t.detach().clone()
    if mesh.shares > 1:
        dist.all_reduce(t, group=mesh.share_group)
    return t


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _pipe_report(model, loss_batch, warnings):
    """Every rank's (stage, layers, head rows, whether it warned), on a pipe
    mesh."""
    mine = dict(stage=model.pipe.stage, layers=model.layers, head_rows=loss_batch.shape[0],
                warned=any("could not be split" in m for m in warnings.messages))
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    return everyone


def dalle_step(case, proc):
    if case.get("trainer"):
        return trainer_steps(case, proc)
    draws = case.get("draws")
    if draws is None:
        return _dalle_step(case, proc)
    # the dropout seeds the case gives, in the order the model draws them
    from dalle_mtf_tpu_torch.models import dalle as tdalle  # noqa: PLC0415

    given, draw = iter(draws), tdalle._draw_seed
    tdalle._draw_seed = lambda _gen: next(given)
    try:
        return _dalle_step(case, proc)
    finally:
        tdalle._draw_seed = draw


def _dalle_step(case, proc):
    cfg = DalleConfig(**case["config"])
    mesh = build_mesh(case["mesh_shape"], case["layout"], cfg.attention_type, proc.rank,
                      proc.world)
    warnings = _Warnings()
    logging.getLogger("dalle_mtf_tpu_torch.parallel.pipeline").addHandler(warnings)
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
        loss, loss_batch = model.loss(tree, tokens, gen, train=True, fused_xent=fused)
        loss.backward()
        out = {"loss": _sum_replicas(mesh, loss), "grads": _whole_grads(model, mesh, tree)}
        if model.pipe is not None:
            out["pipe"] = _pipe_report(model, loss_batch, warnings)
            # the text and image shares of the loss (the task's split)
            t = cfg.text_seq_len - 1
            out["split"] = tuple(float(_sum_replicas(mesh, model.global_mean(
                loss_batch, lo, hi, rows=rows))) for lo, hi in ((0, t), (t, None)))
        if case.get("eval"):
            evaluate = model.fused_eval if fused else model.dense_eval
            el, correct = evaluate(tree, tokens, torch.Generator().manual_seed(1))
            out["eval"] = (_sum_replicas(mesh, model.global_mean(el, rows=rows)),
                           _sum_replicas(mesh, model.global_mean(correct, rows=rows)))
        if case.get("copies"):  # every rank's model group and digest of its loss and grads
            digest = hashlib.sha256(b"".join(t.detach().numpy().tobytes() for t in (
                out["loss"], *out["grads"].values()))).hexdigest()
            out["copies"] = [None] * proc.world
            dist.all_gather_object(out["copies"], (mesh.copy_ranks, digest))
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


def trainer_steps(case, proc):
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_task  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.trainer import Trainer  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import Config  # noqa: PLC0415

    params = Config.from_mapping(case["task"])
    mesh = build_mesh(params["mesh_shape"], params["layout"],
                      params.get("attention_type") or "global", proc.rank, proc.world)
    dalle, vae, init_fn, loss_fn, eval_fn = make_dalle_task(params, "cpu", mesh)
    tree = convert.shard_dalle_params(case["params"], dalle)
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    frozen = convert.vae_params_from_numpy(case["vae"], vae) if "vae" in case else None
    trainer = Trainer(params, init_fn, loss_fn, os.path.join(case["out_dir"], str(proc.rank)),
                      dalle.cfg.total_seq_len, "cpu", frozen_params=frozen, eval_loss_fn=eval_fn,
                      mesh=mesh, sharding=dalle.sharding)
    opt, trainer.schedule = get_optimizer(params, tree, dalle.sharding)
    state = {"step": 0, "params": tree, "opt": opt}
    n, i = mesh.size("data"), mesh.index("data")
    rows = case["caption"].shape[0] // n
    batch = {k: case[k][i * rows:(i + 1) * rows] for k in ("tokens", "image", "caption")
             if k in case}
    metrics = []
    for step in range(case["steps"]):
        state, m = trainer.train_step(state, batch, torch.Generator().manual_seed(step))
        metrics.append({k: float(v) for k, v in m.items()})
    evals = {k: float(v) for k, v in trainer.eval_step(
        state, batch, torch.Generator().manual_seed(0)).items()}
    trainer.close()
    final = convert.gather_dalle_params(tree, dalle)
    everyone = [None] * proc.world
    dist.all_gather_object(everyone, dict(coords=mesh.coords, held=_held(opt, tree)))
    return {"metrics": metrics, "params": {"/".join(p): a for p, a in named_leaves(final)},
            "held": everyone, "eval": evals}


def _held(opt, tree):
    """The shape of this rank's block of every leaf and of its optimizer
    moments (AdamW's two, or Adafactor's v or v_row and v_col)."""
    inner = getattr(opt, "inner", opt)
    out = {}
    for i, (p, t) in enumerate(named_leaves(tree)):
        if hasattr(inner, "opt"):  # AdamW
            moments = [inner.opt.state[t][k] for k in ("exp_avg", "exp_avg_sq")]
        else:
            v = inner.v[i]
            moments = list(v) if isinstance(v, tuple) else [v]
        out["/".join(p)] = (tuple(t.shape), *(tuple(m.shape) for m in moments))
    return out


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
    out = {"history": trainer.history, "eval_history": trainer.eval_history}
    if case.get("gathered"):  # every rank's blocks at the end, whole
        out["params"] = {"/".join(p): t.detach().clone() for p, t in named_leaves(
            trainer.sharding.gather_tree(trainer.state["params"]))}
    return out


def _vae_whole(vae, tree):
    """The whole VAE tree (numpy) from this rank's: the split leaves
    gathered."""
    out = {}
    for p, t in named_leaves(tree):
        split = vae.sharding.of(p) if vae.sharding else None
        group = vae.sharding.group if vae.sharding else None
        out["/".join(p)] = gather(t.detach(), split, group).numpy()
    return out


def vae_step(case, proc, out_dir):
    from dalle_mtf_tpu_torch.models import vae as vae_mod  # noqa: PLC0415
    from dalle_mtf_tpu_torch.ops import gumbel  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.tasks import make_vae_task  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.trainer import Trainer  # noqa: PLC0415

    u = torch.as_tensor(case["u"])

    def same_u(shape, generator, device, block=None):
        row0, col0, _ = block
        return u[row0:row0 + shape[0], ..., col0:col0 + shape[-1]].to(device)

    gumbel.gumbel_uniform = same_u
    convs, conv = [], vae_mod._Conv

    class RecordedConv(conv):  # the kernel each conv of the first step runs with
        @classmethod
        def apply(cls, x, w, stride, padding, transposed):
            if recording:
                convs.append((bool(transposed), tuple(w.shape)))
            return conv.apply(x, w, stride, padding, transposed)

    vae_mod._Conv, recording = RecordedConv, False
    params = case["params"]
    mesh = build_mesh(case["mesh_shape"], case["layout"], "global", proc.rank, proc.world)
    vae, init_fn, loss_fn, eval_fn = make_vae_task(params, "cpu", mesh)
    tree = convert.vae_params_from_numpy(case["tree"], vae)
    group = vae.sharding.group if vae.sharding else None
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
        recording = step == 0
        state, metrics = trainer.train_step(state, batch, torch.Generator().manual_seed(step))
        recording = False
        losses.append(float(metrics["loss"]))
        grads.append({"/".join(p): gather(t.grad, vae.sharding.of(p) if vae.sharding else None,
                                          group).numpy() for p, t in named_leaves(tree)})
    metrics = trainer.eval_step(state, batch, torch.Generator().manual_seed(0))
    trainer.close()
    vae_mod._Conv = conv
    # what this rank holds: each leaf's block and its two moments
    held = {"/".join(p): (tuple(t.shape),) + tuple(tuple(opt.opt.state[t][k].shape)
                                                   for k in ("exp_avg", "exp_avg_sq"))
            for p, t in named_leaves(tree)}
    # this rank's blocks of the init (keyed: the single process's values there)
    init = {"/".join(p): t.numpy() for p, t in named_leaves(
        init_fn(torch.Generator().manual_seed(case.get("init_seed", 0))))}
    digests = [hashlib.sha256(b"".join(t.detach().numpy().tobytes()
                                       for p, t in named_leaves(tree) if split[p] == of_split))
               .hexdigest() for of_split in (False, True)]
    everyone = [None] * proc.world
    dist.all_gather_object(everyone, (mesh.copy_ranks, mesh.block_copy_ranks, *digests, held,
                                      convs, init))
    return {"losses": losses, "grads": grads, "params": _vae_whole(vae, tree),
            "eval": {k: float(v) for k, v in metrics.items()}, "replicas": mesh.replicas,
            "copies": [e[:4] for e in everyone], "held": [e[4] for e in everyone],
            "convs": [e[5] for e in everyone], "init": [e[6] for e in everyone]}


def ckpt(case, proc, out_dir):
    from dalle_mtf_tpu_torch.train.trainer import Trainer  # noqa: PLC0415

    cfg = DalleConfig(**case["config"])
    model_dir = case.get("model_dir") or os.path.join(out_dir, "ckpt_run")
    phases = case.get("phases") or [(f"data:1,model:{proc.world}", case["layout"], "save"),
                                    (f"data:{proc.world // 2},model:2", case["layout"], "restore")]
    figures = {}
    for shape, layout, phase in phases:
        mesh = build_mesh(shape, layout, "global", proc.rank, proc.world)
        model = DALLE(cfg, "cpu", mesh)
        trainer = Trainer(case["opt_params"], model.init, lambda p, _f, b, g, s: (
            model.loss(p, b["tokens"], g, train=True)[0], {}), model_dir, cfg.total_seq_len,
            "cpu", mesh=mesh, sharding=model.sharding)
        state = trainer.init_state(torch.Generator().manual_seed(case["seed"]))
        rows = case["tokens"].shape[0] // mesh.size("data")
        tokens = case["tokens"][mesh.index("data") * rows:][:rows]
        if phase == "save":
            figures["drawn_elements"] = model.drawn_elements
            state, _ = trainer.train_step(state, {"tokens": tokens},
                                          torch.Generator().manual_seed(1))
            trainer.save(state)
            trainer.close()
            continue
        step = trainer.latest_step()
        state = trainer.restore(state)
        saved = torch.load(os.path.join(trainer.ckpt_dir, f"ckpt_{step}.pt"), weights_only=True)
        for p, t in named_leaves(state["params"]):
            want = shard(saved["params"]["/".join(p)], model.sharding.placed(p))
            assert torch.equal(t.detach(), want), p
        moments = state["opt"].state_dict()["adamw"]["state"]
        saved_moments = saved["opt_state"]["adamw"]["state"]
        for i, split in enumerate(state["opt"]._state_splits):
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(moments[i][k], shard(saved_moments[i][k], split)), (i, k)
        local = sum(t.numel() * t.element_size() for _, t in named_leaves(state["params"]))
        figures.update(restored_bytes=trainer.restored_bytes, local_param_bytes=local,
                       step=state["step"])
        if phase == "restore_step":
            state, _ = trainer.train_step(state, {"tokens": tokens},
                                          torch.Generator().manual_seed(1))
            trainer.save(state)
        trainer.close()
    everyone = [None] * proc.world
    dist.all_gather_object(everyone, figures)
    return everyone


_SCALED = {"wq": (1,), "wk": (1,), "wv": (1,), "wo": (1, 2), "w_mlp1": (1,), "w_mlp2": (1,)}


def _scales(model, params):
    """Every ``<name>_scale`` of a quantized tree of this rank's blocks, with
    the (dim, start, stop) of the whole scale it is (None: all of it)."""
    out = {}
    for name, axes in _SCALED.items():
        split = model.sharding.of(("layers", name)) if model.sharding else None
        where = (split.dim, split.start, split.stop) if split and split.dim not in axes else None
        out[f"layers/{name}_scale"] = (params["layers"][name + "_scale"], where)
    split = model.sharding.of(("w_out",)) if model.sharding else None
    out["w_out_scale"] = (params["w_out_scale"],
                          (1, split.start, split.stop) if split else None)
    return out


def _decode_run(run, model, params, text):
    from dalle_mtf_tpu_torch import sample as tsample  # noqa: PLC0415

    cfg = model.cfg
    gen = torch.Generator().manual_seed(run.get("seed", 0))
    temp, top_k, top_p = run.get("temperature", 0.0), run.get("top_k", 0), run.get("top_p")
    engine = run["engine"]
    if engine == "whole":
        return {"tokens": tsample.generate_image_tokens(model, params, text, gen, temp, top_k,
                                                        top_p)}
    if engine == "decoder":
        dec = tsample.CapturedDecoder(model, params, text.shape[0])
        with dec.drawing_from(gen):
            tokens = dec.generate(text, temp, top_k, top_p).clone()
        return {"tokens": tokens, "captures": dec.captures}
    b = text.shape[0]
    lo = cfg.text_vocab_size
    band = (lo, lo + cfg.image_vocab_size)
    with torch.inference_mode():
        if engine == "logits":  # prefill, then the given tokens teacher-forced
            cache = model.init_cache(b)
            head = model.logits_head(params, band)
            logits = [model.prefill(params, text, cache, head=head)]
            for i, tok in enumerate(torch.as_tensor(run["forced"]).T):
                logits.append(model.decode_step(params, cache, tok + lo, cfg.text_seq_len + i,
                                                head=head))
            return {"logits": torch.stack(logits), "cache_heads": cache["k"].shape[2]}
        # continuous: every row admitted at once, then chunks (the JAX test's)
        end = cfg.text_seq_len + cfg.image_seq_len
        cache = model.init_cache(b)
        logits = torch.zeros((b, cfg.image_vocab_size))
        positions = torch.full((b,), end, dtype=torch.long)
        logits, positions = tsample.admit_rows(model, params, cache, logits, positions, text,
                                               torch.ones((b,), dtype=torch.bool))
        rows = [[] for _ in range(b)]
        temps = torch.full((b,), float(temp))
        topks = torch.full((b,), int(top_k), dtype=torch.long)
        for _ in range(run["chunks"]):
            logits, positions, tokens, active = tsample.decode_chunk(
                model, params, cache, logits, positions, gen, temps, topks,
                chunk=run["chunk"], k_max=run["k_max"])
            for i in range(b):
                rows[i].extend(tokens[active[:, i], i].tolist())
        return {"tokens": torch.tensor(rows)}


def sample(case, proc):
    from dalle_mtf_tpu_torch import quantize as tq  # noqa: PLC0415

    cfg = DalleConfig(**case["config"])
    mesh = build_mesh(case["mesh_shape"], case["layout"], "global", proc.rank, proc.world)
    model = DALLE(cfg, "cpu", mesh)
    masters = convert.shard_dalle_params(case["params"], model)
    text = torch.as_tensor(case["texts"])
    results = []
    for run in case["runs"]:
        mode = run.get("quantize", "none")
        if mode == "none":
            params = tq.cast_decode_weights(masters, cfg.policy.compute_dtype)
        else:
            quantizer = tq.quantize_layers_int8 if mode == "int8" else tq.quantize_layers_int4
            params = quantizer(masters, model.sharding)
        res = _decode_run(run, model, params, text)
        if mode != "none":
            res["scales"] = _scales(model, params)
        res.update(rank=proc.rank, coords=mesh.coords)
        everyone = [None] * proc.world
        dist.all_gather_object(everyone, res)
        results.append(everyone)
    return results


def save_checkpoint(path, seed, mesh=None):
    """A ``Trainer``'s checkpoint of the seeded init of the config at
    ``path``, on ``mesh`` (rank 0 writes the whole tree)."""
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_task  # noqa: PLC0415
    from dalle_mtf_tpu_torch.train.trainer import Trainer  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    params = fetch_model_params(path)
    dalle, _, init_fn, loss_fn, _ = make_dalle_task(params, "cpu", mesh)
    trainer = Trainer(params, init_fn, loss_fn, params["model_path"], dalle.cfg.total_seq_len,
                      "cpu", mesh=mesh, sharding=dalle.sharding)
    trainer.save(trainer.init_state(torch.Generator().manual_seed(seed)))
    trainer.close()


def sample_cli(case, proc):
    from dalle_mtf_tpu_torch import sample_dalle  # noqa: PLC0415
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params  # noqa: PLC0415

    if case.get("save"):  # the checkpoint written on the config's own mesh
        params = fetch_model_params(case["save"]["config"])
        mesh = build_mesh(params["mesh_shape"], params["layout"], "global", proc.rank,
                          proc.world)
        save_checkpoint(case["save"]["config"], case["save"]["seed"], mesh)

    counts = {"block_bytes": 0, "loads": []}
    block_to, load = sample_dalle.block_to, torch.load

    def counted(t, split, device):
        out = block_to(t, split, device)
        counts["block_bytes"] += out.numel() * out.element_size()
        return out

    def recorded(*args, **kw):
        counts["loads"].append(bool(kw.get("mmap")))
        return load(*args, **kw)

    sample_dalle.block_to, torch.load = counted, recorded
    try:
        out = []
        for argv in case["argvs"]:
            counts.update(block_bytes=0, loads=[])
            paths = sample_dalle.main(argv)
            pixels = [_png_pixels(p) for p in paths]
            everyone = [None] * proc.world
            dist.all_gather_object(everyone, dict(counts, rank=proc.rank, paths=paths,
                                                  pixels=pixels))
            out.append(everyone)
        return out
    finally:
        sample_dalle.block_to, torch.load = block_to, load


def _png_pixels(path):
    from PIL import Image  # noqa: PLC0415
    import numpy as np  # noqa: PLC0415

    return np.asarray(Image.open(path))


def _post(port, body):
    import json  # noqa: PLC0415
    import urllib.request  # noqa: PLC0415

    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.load(r)


def _break_rank0(sampler, requests):
    """Submit ``requests`` (token lists, n = 2) at once on rank 0 with its
    VAE decode made to raise: what each future raised, whether a later
    submit is refused, and whether the engine's worker ended."""
    def boom(*args, **kw):
        raise RuntimeError("planted VAE failure")

    sampler.vae.decode_tokens = boom
    futures = [sampler.submit(ids, 2, temperature=0.0, top_k=0) for ids in requests]
    raised = []
    for fut in futures:
        try:
            fut.result(timeout=300)
            raised.append(None)
        except Exception as e:  # noqa: BLE001
            raised.append(str(e))
    sampler._worker.join(timeout=300)
    try:
        sampler.submit(requests[0], 1)
        refused = False
    except RuntimeError:
        refused = True
    sampler.drain(timeout=30)
    return dict(raised=raised, refused=refused, worker_alive=sampler._worker.is_alive())


def serve(case, proc):
    import threading  # noqa: PLC0415

    from dalle_mtf_tpu_torch import serve_dalle  # noqa: PLC0415
    from dalle_mtf_tpu_torch.parallel.tensor import COLLECTIVES  # noqa: PLC0415
    from dalle_mtf_tpu_torch.serve import follow  # noqa: PLC0415

    out = []
    for run in case["runs"]:
        argv = run["argv"] + ["--device", "cpu", "--host", "127.0.0.1", "--port", "0"]
        if run.get("raises"):
            try:
                serve_dalle.build_server(argv)
            except ValueError as e:
                assert run["raises"] in str(e), e
                everyone = [None] * proc.world
                dist.all_gather_object(everyone, {"rank": proc.rank, "raised": str(e)})
                out.append(everyone)
                continue
            raise AssertionError(f"{argv} did not raise")
        before = dict(COLLECTIVES)
        sampler, server = serve_dalle.build_server(argv)
        res = {"rank": proc.rank}
        if server is None:
            follow(sampler)  # returns on rank 0's stop
            res["followed"] = True
        elif run.get("broken"):  # rank 0's VAE decode fails: rank 0 alone
            server.server_close()
            res.update(_break_rank0(sampler, run["broken"]), sent=sampler._commands.sent)
        else:
            port = server.server_address[1]
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            replies = [None] * len(run["requests"])

            def send(i):
                replies[i] = _post(port, run["requests"][i])

            senders = [threading.Thread(target=send, args=(i,)) for i in range(len(replies))]
            for t in senders:
                t.start()
            for t in senders:
                t.join(timeout=300)
            res["later"] = [_post(port, body) for body in run.get("later", [])]
            server.shutdown()
            server.server_close()
            sampler.drain(timeout=300)
            res.update(replies=replies, worker_alive=sampler._worker.is_alive(),
                       sent=sampler._commands.sent, stats=sampler.stats())
        res["collective_calls"] = COLLECTIVES["calls"] - before["calls"]
        res["captures"] = sampler._decoder.captures
        everyone = [None] * proc.world
        dist.all_gather_object(everyone, res)
        out.append(everyone)
    return out


def main():
    mode, inputs, out_dir = sys.argv[1:4]
    proc = init_distributed(None, "cpu")
    try:
        torch.set_num_threads(1)
        cases = torch.load(inputs, weights_only=False)
        modes = {"xent": xent, "dalle_step": dalle_step, "train": train,
                 "train_vae": lambda case, proc: train(case, proc, "train_vae"),
                 "vae_step": lambda case, proc: vae_step(case, proc, out_dir),
                 "ckpt": lambda case, proc: ckpt(case, proc, out_dir),
                 "sample": sample, "sample_cli": sample_cli, "serve": serve}
        # a case may name its own mode: one launch serves several
        results = [modes[case.get("mode", mode)](case, proc) for case in cases]
        if proc.rank == 0:
            torch.save(results, os.path.join(out_dir, "out.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
