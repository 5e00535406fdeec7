"""Pipeline beside tensor parallelism (PP x TP: ``layers:pipe`` with
``heads_dim``, ``intermediate_expanded`` and ``vocab_dim`` on ``model``)
in the port against the JAX package and one process, on the CPU with 4 gloo
ranks on ``data:1,pipe:2,model:2`` (tests/torch_tp_worker.py
``dalle_step`` under ``torch.distributed.run``, one launch for every case).

- Against live JAX ``DALLE`` on ``data:2,pipe:2,model:2`` with the same
  rules (its params placed by ``shard_params``, its activations by
  ``make_constrain``, its stack by ``pipeline_hidden``) on the suite's fake
  CPU devices, dropout off, at tests/test_pipeline.py's model (its text
  vocabulary widened to 200, so that the vocabulary has rows on both model
  ranks in blocks of 128): the loss at M = 2 and M = 4, rtol 1e-5; every
  gathered gradient at atol 3e-5; two ``Trainer.train_step``s (the loss,
  its text and image means, and the updated parameters) against JAX's
  trainer on the same mesh at 2e-5, each rank holding only its stage's
  block of every stacked split leaf and of both AdamW moments.
- Against one process with the embedding, residual and attention dropout
  on (the packed and the [B, H, S, D] attention, a remat policy, the fused
  head, a head that does not divide over the stages, and two Adafactor
  ``Trainer`` steps at n_embd 128 in image mode on uint8 pixels through
  the frozen VAE, whose factored moments sum over the model group, and
  the eval after them): within fp32 rounding (the loss and its means 1e-6
  relative, each gradient 1e-5 of its leaf's largest, the parameters after
  two steps 1e-5 of their leaf's largest, the steps' and the eval's
  metrics 1e-5 relative).

The layouts, the mesh's groups and the sharded init without a launch:
tests/test_torch_pp_dalle.py; ``train_dalle`` on this layout:
tests/test_torch_pp_train.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu.parallel import mesh as jmesh
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.utils import convert
from test_torch_pp_dalle import DROPOUT, _single, _tokens
from test_torch_tp_xent import torchrun

PPTP = "batch_dim:data,layers:pipe,heads_dim:model,intermediate_expanded:model,vocab_dim:model"
PORT_MESH, JAX_MESH = "data:1,pipe:2,model:2", "data:2,pipe:2,model:2"
KW = dict(n_embd=64, text_vocab_size=200, image_vocab_size=32, text_seq_len=8,
          image_seq_len=16, n_layers=4, n_heads=4)
# (name, config fields): the cases held to JAX, 8 rows
JAX_CASES = [("m2", dict(pipeline_microbatches=2)), ("m4", dict(pipeline_microbatches=4))]
# (name, rows, config fields, fused head): the cases held to one process
ONE_CASES = [("dropout_packed", 8, DROPOUT, False),
             ("dropout_bhsd", 8, dict(DROPOUT, attn_packed=False), False),
             ("dropout_remat", 8, dict(DROPOUT, recompute_grad=True,
                                       remat_policy="nothing_saveable"), False),
             ("dropout_fused_head", 8, DROPOUT, True),
             # 3 rows: the head cannot be split over 2 stages
             ("dropout_ragged_head", 3, dict(DROPOUT, pipeline_microbatches=3), False)]
TASK = {"config_name": "pptp_steps", "model_type": "dalle", "dataset": {"image_size": 16},
        "n_embd": 64, "text_vocab_size": 200, "image_vocab_size": 32, "text_seq_len": 8,
        "n_layers": 4, "n_heads": 4, "train_batch_size": 8, "train_steps": 2, "lr": 1e-3,
        "warmup_steps": 0,
        "vae_params": {"dataset": {"image_size": 16}, "num_tokens": 32,
                       "convblocks": [[1, 8], [1, 16]]}}
# Adafactor at a width where it factors w_mlp1, w_mlp2, wte and w_out (the
# second largest dim reaches 128), dropout on, image mode on uint8 pixels
ADAFACTOR = dict(TASK, n_embd=128, optimizer="adafactor", embed_dropout=0.1,
                 residual_dropout=0.1, attention_dropout=0.1,
                 dataset={"image_size": 16, "uint8_images": True})


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 32, (8, 16)).astype(np.int32),
            rng.randint(0, 200, (8, 8)).astype(np.int32))


def _vae_and_images():
    """The frozen VAE's tree (numpy, seeded) and 8 uint8 images for it."""
    from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig

    vae = DiscreteVAE(VAEConfig.from_params(TASK["vae_params"]), "cpu")
    tree = convert.params_to_numpy(vae.init(torch.Generator().manual_seed(7)))
    images = np.random.RandomState(1).randint(0, 256, (8, 16, 16, 3)).astype(np.uint8)
    return tree, images


def _jax_loss(jparams, tokens, grads=False, **over):
    """JAX's loss (and its gradients) on ``JAX_MESH`` with the PPTP rules."""
    model = jdalle.DALLE(jdalle.DalleConfig(**KW, pipe_axis="pipe", vocab_axis="model",
                                            **over))
    mesh = jmesh.build_mesh(JAX_MESH)
    _, constrain = jmesh.make_constrain({"layout": PPTP}, mesh)
    toks = jnp.asarray(tokens, jnp.int32)
    with mesh:
        placed = jmesh.shard_params(jparams, mesh, jmesh.parse_layout(PPTP),
                                    model.logical_axes())
        if not grads:
            loss, _ = jax.jit(lambda p: model.loss(p, toks, train=False,
                                                   constrain=constrain))(placed)
            return float(loss), None
        loss, g = jax.jit(jax.value_and_grad(lambda p: model.loss(
            p, toks, jax.random.PRNGKey(2), train=True, constrain=constrain)[0]))(placed)
    return float(loss), dict(convert._flatten(jax.device_get(g)))


def _jax_trainer_steps(tmp_path, tokens, caption):
    """JAX's Trainer on ``JAX_MESH`` with the PPTP rules: its init (numpy),
    the losses of two steps (the loss and its text and image means) and the
    parameters after them."""
    from dalle_mtf_tpu.models.vae import DiscreteVAE, VAEConfig
    from dalle_mtf_tpu.train.tasks import make_dalle_task
    from dalle_mtf_tpu.train.trainer import Trainer
    from dalle_mtf_tpu.utils.config import Config

    params = Config.from_mapping({**TASK, "mesh_shape": JAX_MESH, "layout": PPTP})
    vae_params = DiscreteVAE(VAEConfig.from_params(params["vae_params"])).init(
        jax.random.PRNGKey(7))
    _d, _v, init_fn, loss_fn, _e, axes = make_dalle_task(params)
    trainer = Trainer(params, init_fn, loss_fn, axes, model_dir=str(tmp_path / "jax_steps"),
                      seq_len=24, frozen_params=vae_params)
    state = trainer.init_state(jax.random.PRNGKey(0))
    assert tuple(state["params"]["layers"]["wq"].sharding.spec)[:3] == ("pipe", None, "model")
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


def _one_process_steps(task, tree, batch, model_dir, vae_tree=None):
    """The port's Trainer on one process: two steps of ``task`` on
    ``batch`` (numpy) from the numpy ``tree`` (and the frozen VAE's
    ``vae_tree``), the dropout generator seeded with the step as the
    ranks'; (metrics, the eval's metrics after them, final parameters)."""
    from dalle_mtf_tpu_torch.train.optim import get_optimizer
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_task
    from dalle_mtf_tpu_torch.train.trainer import Trainer
    from dalle_mtf_tpu_torch.utils.config import Config

    params = Config.from_mapping({**task, "mesh_shape": "data:1", "layout": "batch_dim:data"})
    dalle, vae, init_fn, loss_fn, eval_fn = make_dalle_task(params, "cpu")
    tree = convert.shard_dalle_params(tree, dalle)
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    frozen = None if vae_tree is None else convert.vae_params_from_numpy(vae_tree, vae)
    trainer = Trainer(params, init_fn, loss_fn, model_dir, dalle.cfg.total_seq_len, "cpu",
                      frozen_params=frozen, eval_loss_fn=eval_fn)
    opt, trainer.schedule = get_optimizer(params, tree)
    state = {"step": 0, "params": tree, "opt": opt}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = []
    for step in range(2):
        state, m = trainer.train_step(state, batch, torch.Generator().manual_seed(step))
        metrics.append({k: float(v) for k, v in m.items()})
    evals = {k: float(v) for k, v in trainer.eval_step(
        state, batch, torch.Generator().manual_seed(0)).items()}
    trainer.close()
    return metrics, evals, {"/".join(p): t.detach().numpy() for p, t in named_leaves(tree)}


@pytest.fixture(scope="module")
def pptp_run(tmp_path_factory):
    """One 4-rank launch of every case: ({name: result}, JAX parameters)."""
    tmp = tmp_path_factory.mktemp("pptp_steps")
    jparams = jax.device_get(jdalle.DALLE(jdalle.DalleConfig(**KW)).init(jax.random.PRNGKey(0)))
    cases, names = [], []
    for name, over in JAX_CASES:
        names.append(name)
        cases.append({"config": dict(KW, **over), "mesh_shape": PORT_MESH, "layout": PPTP,
                      "params": jparams, "tokens": torch.from_numpy(_tokens(KW, 8)), "seed": 5})
    for name, rows, over, fused in ONE_CASES:
        names.append(name)
        cases.append({"config": dict(KW, **over), "mesh_shape": PORT_MESH, "layout": PPTP,
                      "params": jparams, "tokens": torch.from_numpy(_tokens(KW, rows)),
                      "seed": 5, "fused_xent": fused, "eval": name == "dropout_packed"})
    tokens, caption = _batch()
    tparams, *jax_trainer = _jax_trainer_steps(tmp, tokens, caption)
    names.append("trainer")
    cases.append({"trainer": True, "task": {**TASK, "mesh_shape": PORT_MESH, "layout": PPTP},
                  "params": tparams, "tokens": torch.from_numpy(tokens),
                  "caption": torch.from_numpy(caption), "steps": 2, "out_dir": str(tmp)})
    wide = {"config": dict(KW, n_embd=128)}
    aparams = jax.device_get(jdalle.DALLE(jdalle.DalleConfig(**wide["config"])).init(
        jax.random.PRNGKey(3)))
    vae_tree, images = _vae_and_images()
    names.append("adafactor")
    cases.append({"trainer": True, "task": {**ADAFACTOR, "mesh_shape": PORT_MESH,
                                            "layout": PPTP},
                  "params": aparams, "vae": vae_tree, "image": torch.from_numpy(images),
                  "caption": torch.from_numpy(caption), "steps": 2, "out_dir": str(tmp)})
    results = dict(zip(names, torchrun(4, "dalle_step", cases, tmp, timeout=400)))
    results["jax_trainer"] = jax_trainer
    results["adafactor_params"] = aparams
    return results, jparams


def _held_blocks(whole: dict, coords: dict) -> dict:
    """Each leaf's block on the rank at ``coords`` by JAX's logical axes:
    half the layers over ``pipe``, half the heads and the MLP width and a
    vocabulary block of 128 rows over ``model``."""
    axes = dict(convert._flatten(jdalle.DALLE(jdalle.DalleConfig(**KW)).logical_axes()))
    out = {}
    for name, shape in whole.items():
        block = []
        for logical, n in zip(axes[name], shape):
            if logical == "layers":
                n //= 2
            elif logical in ("heads_dim", "intermediate_expanded"):
                n //= 2
            elif logical == "vocab_dim":
                n = min(128, n - 128 * coords["model"])
            block.append(n)
        out[name] = tuple(block)
    return out


@pytest.mark.parametrize("name,over", JAX_CASES)
def test_pptp_loss_matches_jax(pptp_run, name, over):
    results, jparams = pptp_run
    want, _ = _jax_loss(jparams, _tokens(KW, 8), **over)
    np.testing.assert_allclose(float(results[name]["loss"]), want, rtol=1e-5)
    report = results[name]["pipe"]
    # ranks (pipe, model) in row-major order: each stage's two model ranks
    assert [r["stage"] for r in report] == [0, 0, 1, 1]
    assert [r["layers"] for r in report] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    assert [r["head_rows"] for r in report] == [4] * 4


def test_pptp_grads_match_jax(pptp_run):
    results, jparams = pptp_run
    got = results["m2"]
    loss, grads = _jax_loss(jparams, _tokens(KW, 8), grads=True, pipeline_microbatches=2)
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
    assert set(got["grads"]) == set(grads)
    for name, want in grads.items():
        np.testing.assert_allclose(got["grads"][name].numpy(), np.asarray(want), atol=3e-5,
                                   err_msg=name)


def test_pptp_trainer_steps_match_jax(pptp_run):
    """Two steps on ``data:1,pipe:2,model:2`` equal JAX's trainer on
    ``data:2,pipe:2,model:2``; every rank holds only its stage's block of
    each stacked split leaf and of both AdamW moments."""
    results, _ = pptp_run
    got = results["trainer"]
    losses, final = results["jax_trainer"]
    for key in ("loss", "loss_text", "loss_image"):
        np.testing.assert_allclose([m[key] for m in got["metrics"]], [m[key] for m in losses],
                                   rtol=2e-5, err_msg=key)
    assert set(got["params"]) == set(final)
    for name, want in final.items():
        np.testing.assert_allclose(got["params"][name], np.asarray(want), atol=2e-5,
                                   err_msg=name)
    whole = {name: tuple(np.shape(a)) for name, a in final.items()}
    for r in got["held"]:
        blocks = _held_blocks(whole, r["coords"])
        assert {name: held[0] for name, held in r["held"].items()} == blocks, r["coords"]
        assert all(held[1:] == (held[0], held[0]) for held in r["held"].values())
        assert r["held"]["layers/wq"][0] == (2, 64, 2, 16)


@pytest.mark.parametrize("name,rows,over,fused", ONE_CASES)
def test_pptp_matches_one_process(pptp_run, name, rows, over, fused):
    """With every dropout on, the ranks draw the single process's masks:
    the attention hash at the microbatch's global rows and the rank's head
    block, the residual and embedding masks at the rows; the fused head and
    a head that cannot be split change nothing."""
    results, jparams = pptp_run
    got = results[name]
    tokens = _tokens(KW, rows)
    kw = dict(KW, **over)
    loss, grads, split = _single(kw, jparams, tokens, fused, split=True)
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-6)
    np.testing.assert_allclose(got["split"], split, rtol=1e-6)
    for key, want in grads.items():
        np.testing.assert_allclose(got["grads"][key].numpy(), want,
                                   atol=1e-5 * np.abs(want).max() + 1e-12, rtol=0, err_msg=key)
    assert abs(float(got["loss"]) - _single(KW, jparams, tokens)[0]) > 1e-4  # masks matter
    report = got["pipe"]
    if name == "dropout_ragged_head":
        assert [r["head_rows"] for r in report] == [0, 0, 3, 3]  # the last stage's ranks
        assert all(r["warned"] for r in report)
    else:
        assert [r["head_rows"] for r in report] == [4] * 4
    if "eval" in got:  # the dense eval's loss and accuracy, the vocabulary joined
        model = tdalle.DALLE(tdalle.DalleConfig(**kw), "cpu")
        tree = convert.dalle_params_from_numpy(jparams, model)
        el, correct = model.dense_eval(tree, torch.from_numpy(tokens))
        np.testing.assert_allclose([float(x) for x in got["eval"]],
                                   [float(el.mean()), float(correct.mean())], rtol=1e-6)


def test_pptp_adafactor_steps_match_one_process(pptp_run, tmp_path):
    """Two Adafactor steps with dropout on, in image mode on uint8 pixels
    (the frozen VAE whole on every rank), equal one process's, and so does
    the eval after them: the factored moments' means over a split dim (the
    MLP width, the vocabulary) summed over the model group, the norm and
    the RMS over both groups; every rank holds its block of each moment."""
    results, _ = pptp_run
    got = results["adafactor"]
    _, caption = _batch()
    vae_tree, images = _vae_and_images()
    metrics, evals, final = _one_process_steps(
        ADAFACTOR, results["adafactor_params"], {"image": images, "caption": caption},
        str(tmp_path / "one"), vae_tree)
    for key in ("loss", "loss_text", "loss_image", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in got["metrics"]], [m[key] for m in metrics],
                                   rtol=1e-5, err_msg=key)
    assert set(got["eval"]) == set(evals)
    for key, want in evals.items():
        np.testing.assert_allclose(got["eval"][key], want, rtol=1e-5, atol=1e-7, err_msg=key)
    for name, want in final.items():
        np.testing.assert_allclose(got["params"][name], want,
                                   atol=1e-5 * np.abs(want).max() + 1e-12, rtol=0, err_msg=name)
    for r in got["held"]:
        mlp1 = r["held"]["layers/w_mlp1"]  # [L/P, E, 4E/m]: v_row [L/P, E], v_col [L/P, 4E/m]
        assert mlp1 == ((2, 128, 256), (2, 128), (2, 256)), r
        rows = min(128, 233 - 128 * r["coords"]["model"])
        assert r["held"]["w_out"] == ((128, rows), (128,), (rows,)), r
        assert r["held"]["layers/wq"] == ((2, 128, 2, 32), (2, 128, 2, 32)), r
    assert math.isfinite(got["metrics"][-1]["loss"])
