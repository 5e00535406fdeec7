"""Pipeline-parallel DALLE in the port (``layers:pipe``,
dalle_mtf_tpu_torch/parallel/pipeline.py) against the JAX package and one
process, on the CPU with 4 gloo ranks (tests/torch_tp_worker.py
``dalle_step`` under ``torch.distributed.run``, one launch for every case).

- Against live JAX ``DALLE`` with ``pipe_axis="pipe"`` under a ``Mesh`` of
  the suite's fake CPU devices (``pipeline_hidden``), dropout off, at
  tests/test_pipeline.py's model and tolerances: the loss at (P, M) = (2, 2),
  (4, 4) and (2, 4), rtol 1e-5; every gradient at atol 3e-5; two
  ``Trainer.train_step``s on ``pipe:2,data:2`` (the loss, its text and
  image means, and the updated parameters) against JAX's single-device
  steps at 2e-5.
- Against one process with the embedding, residual and attention dropout
  on (the packed and the [B, H, S, D] attention, and under a remat policy),
  and with the fused head: the loss, its text and image means and every
  gradient within fp32 rounding (loss and means 1e-6 relative, each
  gradient 1e-5 of its leaf's largest).
- The head rows: each stage's ``b/P`` rows; a batch that does not divide
  warns, the last stage takes every row and the loss is unchanged.
- Without a launch (a fake process group, or pure functions): the layouts
  that build a pipe mesh, beside a tensor-parallel axis too (PP x TP: every
  rank's stage, model index, pipeline, model, share, copy and block-copy
  groups on ``data:2,pipe:2,model:2``), and those refused (PP x SP,
  ``layers`` beside another dim, ``layers`` beside ``heads_dim`` or
  ``intermediate_expanded`` on one axis as JAX's ``logical_to_pspec``
  refuses it, ``layers`` beside ``vocab_dim`` alone on one axis (ROADMAP
  5c-vi), sampling, serving, ``predict_steps`` and VAE training on a
  ``layers`` rule), the sharded init on a pipe mesh, and on
  ``data:1,pipe:2,model:2``, bit-equal to one process's tree with
  ``drawn_elements`` a stage's (tensor-parallel) share, the ValueErrors for
  ``b % M`` and ``n_layers % P``.

``train_dalle`` and checkpoints on a pipe mesh: tests/test_torch_pp_train.py;
PP x TP against JAX and one process: tests/test_torch_pptp_dalle.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JaxMesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu.parallel import mesh as jmesh
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.parallel import mesh as tmesh
from dalle_mtf_tpu_torch.parallel import pipeline as tpipe
from dalle_mtf_tpu_torch.parallel.tensor import shard
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.utils import convert
from test_torch_tp_xent import torchrun

PP = "batch_dim:data,layers:pipe"
# tests/test_pipeline.py's model
KW = dict(n_embd=64, text_vocab_size=48, image_vocab_size=32, text_seq_len=8,
          image_seq_len=16, n_layers=4, n_heads=2)
DROPOUT = dict(embed_dropout=0.1, residual_dropout=0.1, attention_dropout=0.1)
# (name, mesh_shape, batch, config fields): the cases held to JAX
JAX_CASES = [("p2m2", "pipe:2,data:2", 8, dict(pipeline_microbatches=2)),
             ("p4m4", "pipe:4", 8, dict(pipeline_microbatches=4)),
             ("p2m4", "pipe:2,data:2", 8, dict(pipeline_microbatches=4)),
             ("grads", "pipe:2,data:2", 4, {})]
# (name, batch, config fields, fused head): the cases held to one process
ONE_CASES = [("dropout_packed", 8, DROPOUT, False),
             ("dropout_bhsd", 8, dict(DROPOUT, attn_packed=False), False),
             ("dropout_remat", 8, dict(DROPOUT, recompute_grad=True,
                                       remat_policy="nothing_saveable"), False),
             ("fused_head", 8, {}, True),
             # b = 3 rows a data rank: the head cannot be split over 2 stages
             ("ragged_head", 6, dict(pipeline_microbatches=3), False)]
TASK = {"config_name": "pp_steps", "model_type": "dalle", "dataset": {"image_size": 16},
        "n_embd": 64, "text_vocab_size": 40, "image_vocab_size": 32, "text_seq_len": 8,
        "n_layers": 4, "n_heads": 4, "train_batch_size": 8, "train_steps": 2, "lr": 1e-3,
        "warmup_steps": 0,
        "vae_params": {"dataset": {"image_size": 16}, "num_tokens": 32,
                       "convblocks": [[1, 8], [1, 16]]}}


def _tokens(kw, rows, seed=1):
    cfg = tdalle.DalleConfig(**kw)
    return np.random.default_rng(seed).integers(0, cfg.total_tokens, (rows, cfg.total_seq_len))


def _jax_mesh(mesh_shape):
    axes = dict(tmesh.parse_mesh_shape(mesh_shape))
    pipe, data = axes["pipe"], axes.get("data", 1)
    return JaxMesh(np.array(jax.devices()[:pipe * data]).reshape(pipe, data), ("pipe", "data"))


def _jax_loss(jparams, mesh_shape, tokens, grads=False, **over):
    """JAX's pipelined loss (and its gradients) on its own mesh."""
    model = jdalle.DALLE(jdalle.DalleConfig(**KW, pipe_axis="pipe", **over))
    toks = jnp.asarray(tokens, jnp.int32)
    with _jax_mesh(mesh_shape):
        if not grads:
            loss, _ = jax.jit(lambda p: model.loss(p, toks, train=False))(jparams)
            return float(loss), None
        loss, g = jax.jit(jax.value_and_grad(lambda p: model.loss(
            p, toks, jax.random.PRNGKey(2), train=True)[0]))(jparams)
    return float(loss), dict(convert._flatten(jax.device_get(g)))


def _single(kw, params, tokens, fused=False, split=False):
    """The single-process port's loss and gradients (dropout generator seed
    5, as the ranks); with ``split``, also the loss's text and image
    means."""
    model = tdalle.DALLE(tdalle.DalleConfig(**kw), "cpu")
    tree = convert.dalle_params_from_numpy(params, model)
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    loss, loss_batch = model.loss(tree, torch.from_numpy(tokens),
                                  torch.Generator().manual_seed(5), train=True, fused_xent=fused)
    loss.backward()
    grads = {"/".join(p): t.grad.numpy() for p, t in named_leaves(tree)}
    if not split:
        return loss.item(), grads
    t = model.cfg.text_seq_len - 1
    means = tuple(float(model.global_mean(loss_batch.detach(), lo, hi))
                  for lo, hi in ((0, t), (t, None)))
    return loss.item(), grads, means


def _jax_trainer_steps(tmp_path, tokens, caption):
    """JAX's Trainer on one device: its init (numpy), the losses of two
    steps (the loss and its text and image means) and the parameters after
    them."""
    from dalle_mtf_tpu.models.vae import DiscreteVAE, VAEConfig
    from dalle_mtf_tpu.train.tasks import make_dalle_task
    from dalle_mtf_tpu.train.trainer import Trainer
    from dalle_mtf_tpu.utils.config import Config

    params = Config.from_mapping({**TASK, "mesh_shape": "data:1", "layout": "batch_dim:data"})
    vae_params = DiscreteVAE(VAEConfig.from_params(params["vae_params"])).init(
        jax.random.PRNGKey(7))
    _d, _v, init_fn, loss_fn, _e, axes = make_dalle_task(params)
    trainer = Trainer(params, init_fn, loss_fn, axes, model_dir=str(tmp_path / "jax_steps"),
                      seq_len=24, frozen_params=vae_params)
    state = trainer.init_state(jax.random.PRNGKey(0))
    init = jax.device_get(state["params"])
    losses = []
    for i in range(2):
        state, m = trainer.train_step(state, {"tokens": tokens, "caption": caption},
                                      jax.random.PRNGKey(1 + i))
        losses.append({k: float(jax.device_get(m[k]))
                       for k in ("loss", "loss_text", "loss_image")})
    final = dict(convert._flatten(jax.device_get(state["params"])))
    trainer.close()
    return init, losses, final


@pytest.fixture(scope="module")
def pp_run(tmp_path_factory):
    """One 4-rank launch of every case: ({name: result}, JAX parameters)."""
    tmp = tmp_path_factory.mktemp("pp_steps")
    jparams = jax.device_get(jdalle.DALLE(jdalle.DalleConfig(**KW)).init(jax.random.PRNGKey(0)))
    cases, names = [], []
    for name, mesh_shape, rows, over in JAX_CASES:
        names.append(name)
        cases.append({"config": dict(KW, **over), "mesh_shape": mesh_shape, "layout": PP,
                      "params": jparams, "tokens": torch.from_numpy(_tokens(KW, rows)),
                      "seed": 5})
    for name, rows, over, fused in ONE_CASES:
        names.append(name)
        cases.append({"config": dict(KW, **over), "mesh_shape": "pipe:2,data:2", "layout": PP,
                      "params": jparams, "tokens": torch.from_numpy(_tokens(KW, rows)),
                      "seed": 5, "fused_xent": fused})
    names.append("trainer")
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 32, (8, 16)).astype(np.int32)
    caption = rng.randint(0, 40, (8, 8)).astype(np.int32)
    tparams, *jax_trainer = _jax_trainer_steps(tmp, tokens, caption)
    cases.append({"trainer": True, "task": {**TASK, "mesh_shape": "pipe:2,data:2", "layout": PP},
                  "params": tparams, "tokens": torch.from_numpy(tokens),
                  "caption": torch.from_numpy(caption), "steps": 2, "out_dir": str(tmp)})
    results = dict(zip(names, torchrun(4, "dalle_step", cases, tmp, timeout=400)))
    results["jax_trainer"] = jax_trainer
    return results, jparams


@pytest.mark.parametrize("name,mesh_shape,rows,over", JAX_CASES[:3])
def test_pp_loss_matches_jax_pipeline(pp_run, name, mesh_shape, rows, over):
    results, jparams = pp_run
    want, _ = _jax_loss(jparams, mesh_shape, _tokens(KW, rows), **over)
    np.testing.assert_allclose(float(results[name]["loss"]), want, rtol=1e-5)
    stages = dict(tmesh.parse_mesh_shape(mesh_shape))["pipe"]
    report = results[name]["pipe"]
    data = 4 // stages
    assert [r["stage"] for r in report] == [r // data for r in range(4)]
    assert [r["layers"] for r in report] == [(4 // stages * (r // data),
                                             4 // stages * (r // data + 1)) for r in range(4)]
    # each stage ran the head on b / P of its data rank's b rows
    assert [r["head_rows"] for r in report] == [rows // data // stages] * 4
    assert not any(r["warned"] for r in report)


def test_pp_grads_match_jax_pipeline(pp_run):
    results, jparams = pp_run
    got = results["grads"]
    loss, grads = _jax_loss(jparams, "pipe:2,data:2", _tokens(KW, 4), grads=True)
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
    assert set(got["grads"]) == set(grads)
    for name, want in grads.items():
        np.testing.assert_allclose(got["grads"][name].numpy(), np.asarray(want), atol=3e-5,
                                   err_msg=name)


@pytest.mark.parametrize("name,rows,over,fused", ONE_CASES)
def test_pp_matches_one_process(pp_run, name, rows, over, fused):
    """With every dropout on the stages draw the single process's masks (the
    seeds of all layers drawn on every rank, each at its microbatch's global
    rows); the fused head and a head that cannot be split change nothing."""
    results, jparams = pp_run
    got = results[name]
    tokens = _tokens(KW, rows)
    loss, grads, split = _single(dict(KW, **over), jparams, tokens, fused, split=True)
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-6)
    # the text and image means: each stage's share of its rows over the
    # data rank's whole batch
    np.testing.assert_allclose(got["split"], split, rtol=1e-6)
    for key, want in grads.items():
        np.testing.assert_allclose(got["grads"][key].numpy(), want,
                                   atol=1e-5 * np.abs(want).max() + 1e-12, rtol=0, err_msg=key)
    if "dropout" in name:  # and the masks matter: without dropout the loss differs
        assert abs(float(got["loss"]) - _single(KW, jparams, tokens)[0]) > 1e-4
    report = got["pipe"]
    if name == "ragged_head":
        assert [r["head_rows"] for r in report] == [0, 0, 3, 3]  # the last stage's ranks
        assert all(r["warned"] for r in report)
        # and JAX's sequential loss is the same
        jloss, _ = jdalle.DALLE(jdalle.DalleConfig(**KW)).loss(
            jparams, jnp.asarray(tokens, jnp.int32), train=False)
        np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=1e-5)
    else:
        assert [r["head_rows"] for r in report] == [rows // 4] * 4


def test_pp_trainer_steps_match_jax_single_device(pp_run):
    results, _ = pp_run
    got = results["trainer"]
    losses, final = results["jax_trainer"]
    for key in ("loss", "loss_text", "loss_image"):
        np.testing.assert_allclose([m[key] for m in got["metrics"]], [m[key] for m in losses],
                                   rtol=2e-5, err_msg=key)
    assert set(got["params"]) == set(final)
    for name, want in final.items():
        np.testing.assert_allclose(got["params"][name], np.asarray(want), atol=2e-5,
                                   err_msg=name)


# ------------------------------------------------------- without a launch


def _fake_world(rank, n):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)


@pytest.mark.parametrize("mesh_shape,rank,coords,stage,pipe_ranks,replicas", [
    ("pipe:2,data:2", 0, {"pipe": 0, "data": 0}, 0, [0, 2], 2),
    ("pipe:2,data:2", 3, {"pipe": 1, "data": 1}, 1, [1, 3], 2),
    ("pipe:4", 2, {"pipe": 2}, 2, [0, 1, 2, 3], 1),
    ("data:2,pipe:2", 1, {"data": 0, "pipe": 1}, 1, [0, 1], 2),
])
def test_pipe_layout_builds_a_mesh(mesh_shape, rank, coords, stage, pipe_ranks, replicas):
    _fake_world(rank, 4)
    try:
        mesh = tmesh.build_mesh(mesh_shape, PP, "global", rank, 4)
        assert (mesh.pipe_axis, mesh.tp_axis, mesh.coords) == ("pipe", None, coords)
        assert (mesh.stage, mesh.stages, mesh.pipe_ranks) == (stage, 4 // replicas, pipe_ranks)
        assert (mesh.replicas, mesh.shares, mesh.copies) == (replicas, 4, 1)
        model = tdalle.DALLE(tdalle.DalleConfig(**KW), "cpu", mesh)
        per = 4 // mesh.stages
        assert model.layers == (stage * per, (stage + 1) * per)
        assert model.heads == (0, KW["n_heads"])  # no head is split
        shapes = model.param_shapes()
        assert shapes["layers"]["wq"] == (per, 64, 2, 32)
        assert shapes["layers"]["ln1_g"] == (per, 64)
        assert shapes["wte"] == model.param_shapes(whole=True)["wte"]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_shape,layout,attention,match", [
    ("data:2,model:2", "batch_dim:data,layers:model,vocab_dim:model", "global",
     "layers and vocab_dim.*5c-vi"),
    ("pipe:2,model:2", PP + ",intermediate_expanded:pipe", "global",
     "on layers and intermediate_expanded"),
    ("pipe:2,data:2", PP, "ring", "PP x SP.*5c-iii"),
    ("pipe:2,seq:2", PP + ",total_seq_dim:seq", "local_ring", "PP x SP.*5c-iii"),
    ("pipe:2,data:2", "batch_dim:data,layers:pipe,heads_dim:pipe", "global", "another layout dim"),
    ("data:4", "batch_dim:data,layers:data", "global", "another layout dim"),
])
def test_pipe_layouts_the_port_refuses(mesh_shape, layout, attention, match):
    axes = tmesh.resize_axes(tmesh.parse_mesh_shape(mesh_shape), 4)
    with pytest.raises(NotImplementedError, match=match):
        tmesh.check_layout(axes, tmesh.parse_layout(layout), attention)
    # one process: every axis resizes to 1, accepted
    assert tmesh.build_mesh(mesh_shape, layout, attention).world == 1


PPTP = PP + ",heads_dim:model,intermediate_expanded:model,vocab_dim:model"
PPTP_KW = dict(KW, text_vocab_size=200, n_heads=4)  # a vocabulary of 233: 128 + 105 rows


@pytest.mark.parametrize("layout", [PPTP, PP + ",heads_dim:model", PP + ",vocab_dim:model"])
@pytest.mark.parametrize("rank", [0, 3, 5, 6])
def test_pptp_layout_builds_a_mesh(layout, rank):
    """``data:2,pipe:2,model:2`` (8 ranks, row-major: rank = 4d + 2p + m):
    the rank's stage and model index, its pipeline (its model index on
    each stage), its model group, the shares (its model index over the data
    and pipe axes), the copies (its model group) and no block copy; the
    model holds its stage's layers of its model index's blocks."""
    _fake_world(rank, 8)
    try:
        mesh = tmesh.build_mesh("data:2,pipe:2,model:2", layout, "global", rank, 8)
        d, p, m = rank // 4, rank // 2 % 2, rank % 2
        assert (mesh.pipe_axis, mesh.tp_axis) == ("pipe", "model")
        assert (mesh.stage, mesh.stages, mesh.index("model")) == (p, 2, m)
        assert mesh.pipe_ranks == [4 * d + m, 4 * d + 2 + m]
        assert mesh.ranks("model") == [4 * d + 2 * p, 4 * d + 2 * p + 1]
        assert mesh.ranks("data") == [2 * p + m, 4 + 2 * p + m]
        assert (mesh.replicas, mesh.shares, mesh.copies) == (2, 4, 2)
        assert dist.get_process_group_ranks(mesh.share_group) == [m, 2 + m, 4 + m, 6 + m]
        assert dist.get_process_group_ranks(mesh.replica_group) == mesh.ranks("data")
        assert mesh.copy_ranks == mesh.ranks("model")
        assert (mesh.block_copy_ranks, mesh.block_copy_group) == (None, None)
        assert mesh.plane(["pipe", "model"]) == [[0, 1], [2, 3]]
        model = tdalle.DALLE(tdalle.DalleConfig(**PPTP_KW), "cpu", mesh)
        assert model.layers == (2 * p, 2 * p + 2)
        heads = (2 * m, 2) if "heads_dim" in layout else (0, 4)
        assert model.heads == heads
        assert model.param_shapes()["layers"]["wq"] == (2, 64, heads[1], 16)
        placed = model.sharding.placed(("layers", "wq"))
        assert [x.axis for x in placed] == ["pipe", "model"][:len(placed)]
        assert model.param_shapes()["w_out"] == (64, (128 if m == 0 else 105)
                                                 if "vocab_dim" in layout else 233)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dim", ["heads_dim", "intermediate_expanded"])
def test_layers_beside_a_stacked_tensor_dim_on_one_axis_is_refused_as_jax_refuses(dim):
    """One axis on ``layers`` and on ``heads_dim`` or
    ``intermediate_expanded`` would put the axis twice on a stacked leaf:
    JAX's ``logical_to_pspec`` raises, and ``check_layout`` refuses it by
    name before any group is joined (``train_dalle`` builds the mesh after
    it)."""
    layout = f"batch_dim:data,layers:model,{dim}:model"
    leaf = {"heads_dim": ("layers", "embed_dim", "heads_dim", "kv_dim"),
            "intermediate_expanded": ("layers", "embed_dim", "intermediate_expanded")}[dim]
    with pytest.raises(ValueError, match="mesh axis 'model' used twice"):
        jmesh.logical_to_pspec(leaf, jmesh.parse_layout(layout))
    with pytest.raises(NotImplementedError, match=f"'model' on layers and {dim}"):
        tmesh.check_layout([("data", 4), ("model", 2)], tmesh.parse_layout(layout))
    # JAX places a layers:model beside vocab_dim:model (different leaves);
    # the port refuses it by name (ROADMAP 5c-vi)
    jmesh.logical_to_pspec(("embed_dim", "vocab_dim"),
                           jmesh.parse_layout("layers:model,vocab_dim:model"))
    with pytest.raises(NotImplementedError, match="layers and vocab_dim.*5c-vi"):
        tmesh.check_layout([("data", 4), ("model", 2)],
                           tmesh.parse_layout("batch_dim:data,layers:model,vocab_dim:model"))


def test_sharded_init_on_pipe_and_model_draws_a_stage_block():
    """On ``data:1,pipe:2,model:2`` each rank draws its stage's block of each
    stacked split leaf (and its vocabulary block), bit-equal to one
    process's tree there; ``drawn_elements`` is the rank's share."""
    cfg = tdalle.DalleConfig(**PPTP_KW)
    whole = dict(named_leaves(tdalle.DALLE(cfg, "cpu").init(torch.Generator().manual_seed(0))))
    random = ("wq", "wk", "wv", "wo", "w_mlp1", "w_mlp2", "wte", "wpe", "w_out")
    blocks = {}
    for rank in range(4):
        _fake_world(rank, 4)
        try:
            mesh = tmesh.build_mesh("data:1,pipe:2,model:2", PPTP, "global", rank, 4)
            model = tdalle.DALLE(cfg, "cpu", mesh)
            tree = dict(named_leaves(model.init(torch.Generator().manual_seed(0))))
            assert model.drawn_elements == sum(t.numel() for p, t in tree.items()
                                               if p[-1] in random)
            for p, t in tree.items():
                assert torch.equal(t, shard(whole[p], model.sharding.placed(p))), (rank, p)
                blocks[(rank // 2, rank % 2, p)] = t
        finally:
            dist.destroy_process_group()
    assert blocks[(1, 1, ("layers", "wq"))].shape == (2, 64, 2, 16)
    for p, want in whole.items():
        split = [i for i, a in enumerate(dict(named_leaves(tdalle.DALLE.logical_axes()))[p])
                 if a in ("heads_dim", "intermediate_expanded", "vocab_dim")]
        stages = []
        for s in range(2):
            parts = [blocks[(s, m, p)] for m in range(2)]
            stages.append(torch.cat(parts, split[0]) if split else parts[0])
        got = torch.cat(stages) if p[0] == "layers" else stages[0]
        assert torch.equal(got, want), p


@pytest.mark.parametrize("what", ["sampling and serving", "predict_steps"])
def test_a_layers_rule_is_refused_where_no_pipeline_runs(what):
    axes = tmesh.parse_mesh_shape("pipe:2,data:2")
    with pytest.raises(NotImplementedError, match=f"{what}.*5c-iv"):
        tmesh.refuse_layers(axes, tmesh.parse_layout(PP), what, "5c-iv")
    tmesh.refuse_layers([("pipe", 1), ("data", 4)], tmesh.parse_layout(PP), what, "5c-iv")


def test_train_vae_refuses_a_layers_rule(tmp_path, monkeypatch):
    """The VAE has no layer stack: over ranks a ``layers`` rule raises
    before the process group is joined."""
    import json

    from dalle_mtf_tpu_torch import train_vae

    path = tmp_path / "vae.json"
    path.write_text(json.dumps({"model_type": "vae", "dataset": {"image_size": 16},
                                "num_tokens": 32, "convblocks": [[1, 8], [1, 16]],
                                "mesh_shape": "pipe:2,data:2", "layout": PP,
                                "model_path": str(tmp_path / "run")}))
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(NotImplementedError, match="VAE training.*'layers'"):
        train_vae.main(["--model", str(path), "--device", "cpu"])


@pytest.mark.parametrize("layout,match", [
    ("batch_dim:data,layers:model,heads_dim:model", "'model' on layers and heads_dim"),
    ("batch_dim:data,layers:model,vocab_dim:model", "layers and vocab_dim.*5c-vi")])
def test_train_dalle_refuses_layers_on_a_tensor_axis_before_joining(tmp_path, monkeypatch,
                                                                   layout, match):
    """Over ranks ``train_dalle`` checks the layout before it joins the
    process group (no launcher here: joining would fail on the missing
    rendezvous)."""
    import json

    from dalle_mtf_tpu_torch import train_dalle

    path = tmp_path / "dalle.json"
    path.write_text(json.dumps({"model_type": "dalle", **TASK, "mesh_shape": "data:2,model:2",
                                "layout": layout, "model_path": str(tmp_path / "run")}))
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(NotImplementedError, match=match):
        train_dalle.main(["--model", str(path), "--device", "cpu"])


@pytest.mark.parametrize("stages", [2, 4])
def test_sharded_init_on_a_pipe_mesh_draws_a_stage(stages):
    cfg = tdalle.DalleConfig(**KW)
    whole = dict(named_leaves(tdalle.DALLE(cfg, "cpu").init(torch.Generator().manual_seed(0))))
    drawn_whole = tdalle.DALLE(cfg, "cpu")
    drawn_whole.init(torch.Generator().manual_seed(0))
    layers = sum(t.numel() for p, t in whole.items()
                 if p[0] == "layers" and p[-1] in ("wq", "wk", "wv", "wo", "w_mlp1", "w_mlp2"))
    parts = {p: [] for p in whole}
    for rank in range(stages):
        _fake_world(rank, stages)
        try:
            mesh = tmesh.build_mesh(f"pipe:{stages}", PP, "global", rank, stages)
            model = tdalle.DALLE(cfg, "cpu", mesh)
            tree = dict(named_leaves(model.init(torch.Generator().manual_seed(0))))
            assert model.drawn_elements == drawn_whole.drawn_elements - layers + layers // stages
            for p, t in tree.items():
                split = model.sharding.of(p)
                assert (split is not None) == (p[0] == "layers")
                assert torch.equal(t, shard(whole[p], split)), (rank, p)
                parts[p].append(t)
        finally:
            dist.destroy_process_group()
    for p, ts in parts.items():
        got = torch.cat(ts) if p[0] == "layers" else ts[0]
        assert torch.equal(got, whole[p]), p


def test_layers_and_microbatches_must_divide():
    _fake_world(0, 2)
    try:
        mesh = tmesh.build_mesh("pipe:2", PP, "global", 0, 2)
        with pytest.raises(ValueError, match="n_layers 3 not divisible"):
            tdalle.DALLE(tdalle.DalleConfig(**dict(KW, n_layers=3)), "cpu", mesh)
        model = tdalle.DALLE(tdalle.DalleConfig(**KW, pipeline_microbatches=3), "cpu", mesh)
        tree = model.init(torch.Generator().manual_seed(0))
        # stage 0 embeds, then refuses the split before any hop
        with pytest.raises(ValueError, match="batch 4 not divisible by 3 microbatches"):
            model.loss(tree, torch.from_numpy(_tokens(KW, 4)))
    finally:
        dist.destroy_process_group()


def test_head_bounds(caplog):
    assert tpipe.head_bounds(8, 2) == [(0, 4), (4, 8)]
    assert tpipe.head_bounds(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert "could not be split" not in caplog.text
    assert tpipe.head_bounds(6, 4) == [(0, 0), (0, 0), (0, 0), (0, 6)]
    assert "could not be split" in caplog.text
    assert tpipe.stage_layers(12, 2, 1) == (6, 12)
    assert tpipe.microbatch_rows(8, 2) == 4
    assert math.prod(s for _, s in tmesh.parse_mesh_shape("pipe:2,data:2")) == 4
