"""VAE data parallelism, the codebook split over ``tokens_dim`` and an axis
that only replicates, on 4 gloo ranks (one launch of
tests/torch_tp_worker.py), against one process and the live JAX package.

From one JAX init and one Gumbel draw ``u`` (``jax.random.uniform`` and the
port's ``gumbel_uniform`` patched: a rank's draw is the rows and columns of
``u`` it holds), two AdamW steps of the JAX test's VAE
(tests/test_graft_and_vae_tp.py) on a batch of 8:

- ``data:4``; ``data:2,model:2`` with ``tokens_dim:model`` (the codebook by
  columns); ``data:16,model:2`` with ``batch_dim:data`` (configs/
  vae_example.json's layout: the model axis only replicates), against the
  port on one process and JAX's ``data:8`` and ``data:4,model:2`` runs:
  losses, the first and the second step's gradients, the parameters after;
  the eval metrics (PSNR, codebook perplexity, Fréchet feature distance)
  against JAX's eval on the whole batch at the same parameters;
- configs/dalle_example.json's layout (``data:16,model:2``,
  ``batch_dim:data``) on a small DALLE: loss and gradients of one process;
- ``data:1,model:2,rep:2`` with the codebook split beside an axis that
  only replicates, against one process;
- every copy of a replicated leaf and of a codebook block holds one value
  after the steps, though each copy but the first perturbs its gradients
  (the trainer broadcasts the first's);
- ``train_vae.main`` on ``data:2,model:2`` with the codebook split trains,
  evaluates, checkpoints and resumes bit-equal to the unbroken run.

Tolerances, each with its reason (fp32 throughout): losses and eval
metrics rtol 1e-5 and gradients within 1e-4 of each leaf's largest |grad|
(the same arithmetic summed in another order, as
tests/test_torch_vae_train.py); parameters after two AdamW steps within
2e-5 (the JAX test's own bound between its two meshes); the codebook
perplexity exactly where the hard tokens agree.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.train.tasks import make_vae_task as jax_vae_task
from dalle_mtf_tpu.train.trainer import Trainer as JaxTrainer
from dalle_mtf_tpu.utils.config import Config
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.ops import gumbel as tgumbel
from dalle_mtf_tpu_torch.parallel import mesh as tmesh
from dalle_mtf_tpu_torch.train import tasks as ttasks
from dalle_mtf_tpu_torch.train.optim import get_optimizer, named_leaves
from dalle_mtf_tpu_torch.train.trainer import Trainer
from dalle_mtf_tpu_torch.utils import convert
from test_torch_tp_xent import torchrun
from test_torch_vae_train import _config as vae_cli_config

PARAMS = {
    "config_name": "vae_dp", "dataset": {"image_size": 16}, "num_tokens": 64,
    "convblocks": [[1, 8], [2, 16]], "train_batch_size": 8, "eval_batch_size": 8,
    "train_steps": 2, "lr": 1e-3, "warmup_steps": 0, "temp": 1.0,
}
B, GRID, STEPS = 8, 4, 2
# (port mesh, port layout, JAX mesh, JAX layout)
LAYOUTS = {
    "dp": ("data:4", "batch_dim:data", "data:8", "batch_dim:data"),
    "codebook": ("data:2,model:2", "batch_dim:data,tokens_dim:model", "data:4,model:2",
                 "batch_dim:data,tokens_dim:model"),
    "vae_example": ("data:16,model:2", "batch_dim:data", "data:8", "batch_dim:data"),
    # the codebook split beside an axis that only replicates (no JAX run)
    "codebook_rep": ("data:1,model:2,rep:2", "batch_dim:data,tokens_dim:model", None, None),
}
REPLICAS = {"dp": 4, "codebook": 2, "vae_example": 2, "codebook_rep": 1}
# the ranks holding copies of the replicated leaves, and of a codebook block
COPIES = {"codebook": ({(0, 1), (2, 3)}, set()), "vae_example": ({(0, 1), (2, 3)}, set()),
          "codebook_rep": ({(0, 1, 2, 3)}, {(0, 1), (2, 3)})}
DALLE_KW = dict(n_embd=32, text_vocab_size=300, image_vocab_size=64, text_seq_len=8,
                image_seq_len=16, n_layers=2, n_heads=2)


def _inputs():
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    u = rng.uniform(1e-9, 1.0, (B, GRID, GRID, 64)).astype(np.float32)
    return images, u


def _flat(tree):
    return {"/".join(p): np.asarray(t.detach()) for p, t in named_leaves(tree)}


def _jax_run(monkeypatch, tmp_path, mesh_shape, layout, images, u):
    """JAX's trainer on its mesh: the init (shared with the port), the
    losses of two steps and the parameters after."""
    params = Config.from_mapping({**PARAMS, "mesh_shape": mesh_shape, "layout": layout})
    _v, init_fn, loss_fn, _e, axes = jax_vae_task(params)
    tr = JaxTrainer(params, init_fn, loss_fn, axes, model_dir=str(tmp_path / mesh_shape),
                    seq_len=GRID * GRID)
    state = tr.init_state(jax.random.PRNGKey(0))
    init = jax.device_get(state["params"])
    losses = []
    with monkeypatch.context() as m:
        m.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(u))
        for i in range(STEPS):
            state, metrics = tr.train_step(state, {"image": images}, jax.random.PRNGKey(5 + i))
            losses.append(float(jax.device_get(metrics["loss"])))
    final = jax.device_get(state["params"])
    tr.close()
    return init, losses, final


def _jax_grads_and_eval(monkeypatch, init, final, images, u):
    """JAX's gradient of the train loss at ``init`` and its eval metrics on
    the whole batch at ``final`` (numpy trees), with the draw ``u``."""
    _v, _i, loss_fn, eval_fn, _a = jax_vae_task(Config.from_mapping(PARAMS))
    with monkeypatch.context() as m:
        m.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(u))
        grads = jax.grad(lambda p: loss_fn(p, None, {"image": jnp.asarray(images)},
                                           jax.random.PRNGKey(0), jnp.asarray(0))[0])(init)
        loss, metrics = eval_fn(jax.tree.map(jnp.asarray, final), None,
                                {"image": jnp.asarray(images)}, jax.random.PRNGKey(0),
                                jnp.asarray(STEPS))
    flat = dict(convert._flatten(jax.device_get(grads)))
    return flat, {"loss": float(loss), **{k: float(v) for k, v in metrics.items()}}


def _port_one_process(monkeypatch, tmp_path, init, images, u):
    """The port's task and Trainer on one process: losses, each step's
    gradients, the parameters after, and the eval metrics."""
    vae, init_fn, loss_fn, eval_fn = ttasks.make_vae_task(PARAMS, "cpu")
    tree = convert.vae_params_from_numpy(init, vae)
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    tr = Trainer(PARAMS, init_fn, loss_fn, str(tmp_path / "one"), GRID * GRID, "cpu",
                 eval_loss_fn=eval_fn)
    opt, tr.schedule = get_optimizer(PARAMS, tree)
    state = {"step": 0, "params": tree, "opt": opt}
    batch = {"image": torch.from_numpy(images)}
    losses, grads = [], []
    with monkeypatch.context() as m:
        m.setattr(tgumbel, "gumbel_uniform",
                  lambda shape, generator, device: torch.from_numpy(u).to(device))
        for step in range(STEPS):
            state, metrics = tr.train_step(state, batch, torch.Generator().manual_seed(step))
            losses.append(float(metrics["loss"]))
            grads.append({"/".join(p): t.grad.numpy().copy() for p, t in named_leaves(tree)})
        metrics = tr.eval_step(state, batch, torch.Generator().manual_seed(0))
    tr.close()
    return losses, grads, _flat(tree), {k: float(v) for k, v in metrics.items()}


def _close_grads(got, want, label):
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{label} {name}")


def _close_metrics(got, want, label):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, err_msg=f"{label} {k}")


def _dalle_reference(params, tokens):
    """One process: the DALLE loss and every gradient."""
    model = tdalle.DALLE(tdalle.DalleConfig(**DALLE_KW), "cpu")
    tree = convert.shard_dalle_params(params, model)
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    loss, _ = model.loss(tree, tokens, torch.Generator().manual_seed(3), train=True)
    loss.backward()
    return float(loss), {"/".join(p): t.grad.numpy() for p, t in named_leaves(tree)}


def _vae_cli(tmp_path, name, train_steps, run):
    return ["--model", vae_cli_config(
        tmp_path, name, train_steps, train_batch_size=4, eval_batch_size=4,
        steps_per_checkpoint=2, mesh_shape="data:2,model:2",
        layout="batch_dim:data,tokens_dim:model", model_path=str(tmp_path / run)),
        "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the tests below read: JAX's two meshes, the port on one
    process, and one 4-rank launch of every port case."""
    tmp_path = tmp_path_factory.mktemp("vae_dp")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    mp = pytest.MonkeyPatch()
    try:
        images, u = _inputs()
        jax_runs = {key: _jax_run(mp, tmp_path, *LAYOUTS[key][2:], images, u)
                    for key in ("dp", "codebook")}
        init = jax_runs["dp"][0]
        one = _port_one_process(mp, tmp_path, init, images, u)
        jax_grads, jax_eval = _jax_grads_and_eval(mp, init, convert.nest(one[2]), images, u)
        dparams = convert.params_to_numpy(
            tdalle.DALLE(tdalle.DalleConfig(**DALLE_KW), "cpu").init(
                torch.Generator().manual_seed(0)))
        tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 365, (4, 24)))
        vae_cases = [{"mode": "vae_step", "params": PARAMS, "mesh_shape": LAYOUTS[k][0],
                      "layout": LAYOUTS[k][1], "tree": init, "images": torch.from_numpy(images),
                      "u": u, "steps": STEPS, "perturb": 1e-3} for k in LAYOUTS]
        dalle_case = {"mode": "dalle_step", "config": DALLE_KW, "mesh_shape": "data:16,model:2",
                      "layout": "batch_dim:data", "params": dparams, "tokens": tokens, "seed": 3,
                      "replicated": True}
        cli = [{"mode": "train_vae", "argv": _vae_cli(tmp_path, name, steps, run)}
               for name, steps, run in (("unbroken", 4, "run_unbroken"),
                                        ("split", 2, "run_split"), ("resume", 4, "run_split"))]
        results = torchrun(4, "vae_step", vae_cases + [dalle_case] + cli, tmp_path, timeout=400)
        yield dict(tmp_path=tmp_path, jax=jax_runs, init=init, one=one, jax_grads=jax_grads,
                   jax_eval=jax_eval, ranks=dict(zip(LAYOUTS, results[:4])),
                   dalle=(dparams, tokens, results[4]), cli=results[5:])
    finally:
        mp.undo()
        os.chdir(cwd)


def test_one_process_matches_jax(runs):
    losses, grads, _params, metrics = runs["one"]
    np.testing.assert_allclose(losses, runs["jax"]["dp"][1], rtol=1e-5)
    _close_grads(grads[0], runs["jax_grads"], "one process vs jax.grad")
    _close_metrics(metrics, runs["jax_eval"], "one process vs JAX eval")
    # one init on both JAX meshes
    for name, a in convert._flatten(runs["jax"]["codebook"][0]):
        np.testing.assert_array_equal(a, dict(convert._flatten(runs["init"]))[name])


@pytest.mark.parametrize("key", list(LAYOUTS))
def test_layout_matches_one_process_and_jax(runs, key):
    """Losses, both steps' gradients, the parameters after and the eval
    metrics (PSNR of the whole batch's squared error, the perplexity of its
    token counts, the feature distance of its moments) of ``key``'s layout
    on 4 ranks."""
    losses, grads, params, metrics = runs["one"]
    got = runs["ranks"][key]
    assert got["replicas"] == REPLICAS[key]
    jax_losses, jax_final = runs["jax"]["codebook" if key == "codebook" else "dp"][1:]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-5, err_msg=key)
    _close_grads(got["grads"][0], runs["jax_grads"], f"{key} step 1 vs jax.grad")
    for step in range(STEPS):
        _close_grads(got["grads"][step], grads[step], f"{key} step {step + 1}")
    for name, w in dict(convert._flatten(jax_final)).items():
        np.testing.assert_allclose(got["params"][name], w, rtol=0, atol=2e-5,
                                   err_msg=f"{key} {name} vs JAX")
        np.testing.assert_allclose(got["params"][name], params[name], rtol=0, atol=2e-5,
                                   err_msg=f"{key} {name}")
    _close_metrics(got["eval"], metrics, f"{key} eval vs one process")
    _close_metrics(got["eval"], runs["jax_eval"], f"{key} eval vs JAX")
    assert got["eval"]["codebook_perplexity"] == pytest.approx(
        metrics["codebook_perplexity"], rel=1e-6)


@pytest.mark.parametrize("key", list(COPIES))
def test_copies_of_a_replicated_leaf_agree(runs, key):
    """The ranks that differ only on the model axis (the codebook split, or
    an axis that only replicates) compute the replicated convs' gradients
    each on its own, and beside the split, the ranks that differ only on
    the replicating axis a codebook block's; every copy but the first
    scaled them by 1 + 1e-3, as a non-reproducible kernel would make them
    differ. The trainer's broadcasts leave one value in every copy group,
    the first's (so the layout still matches one process above)."""
    copies = runs["ranks"][key]["copies"]
    whole, blocks = COPIES[key]
    assert {tuple(c[0]) for c in copies} == whole
    assert {tuple(c[1]) for c in copies if c[1]} == blocks
    for r, (whole_ranks, block_ranks, whole_digest, block_digest) in enumerate(copies):
        assert all(copies[q][2] == whole_digest for q in whole_ranks), (key, r, copies)
        assert all(copies[q][3] == block_digest for q in block_ranks or ()), (key, r, copies)


def test_dalle_example_layout_matches_one_process(runs):
    """configs/dalle_example.json's data:16,model:2 with batch_dim:data on 4
    ranks (data:2,model:2, the model axis only replicating)."""
    dparams, tokens, got = runs["dalle"]
    want_loss, want_grads = _dalle_reference(dparams, tokens)
    assert float(got["loss"]) == pytest.approx(want_loss, rel=1e-5)
    _close_grads({k: v.numpy() for k, v in got["grads"].items()}, want_grads,
                 "dalle_example layout")


def test_train_vae_main_over_ranks_resumes_bit_equal(runs):
    """``train_vae.main`` on data:2,model:2 with the codebook split: an
    unbroken run of 4 steps, and 2 steps then a resume to 4, in one process
    group."""
    unbroken, split, resumed = (r["history"] for r in runs["cli"])
    assert [h["step"] for h in unbroken] == [1, 2, 3, 4]
    assert [h["step"] for h in split + resumed] == [1, 2, 3, 4]

    def logged(history):
        return [{k: v for k, v in h.items() if k != "steps_per_sec"} for h in history]

    assert logged(split + resumed) == logged(unbroken)
    evals = runs["cli"][0]["eval_history"]
    assert [e["step"] for e in evals] == [2, 4]
    for e in evals:
        assert all(np.isfinite(v) for v in e.values())
        assert 1.0 < e["eval_codebook_perplexity"] <= 32
    root = runs["tmp_path"] / "run_unbroken" / "checkpoints"
    assert sorted(os.listdir(root)) == ["ckpt_2.pt", "ckpt_4.pt"]
    ckpt = torch.load(root / "ckpt_4.pt", weights_only=True)
    assert ckpt["params"]["codebook"].shape == (16, 32)  # the whole codebook


@pytest.mark.parametrize("block", [(0, 0, 300), (1, 150, 300), (3, 250, 300), (2, 0, 300)])
def test_gumbel_draw_does_not_depend_on_the_layout(block):
    """A block of rows and columns draws the whole tensor's values there."""
    whole = tgumbel.gumbel_uniform((4, 2, 3, 300), torch.Generator().manual_seed(0), "cpu")
    row0, col0, cols = block
    rows, width = (4 - row0, 300 - col0) if col0 < 250 else (1, 50)
    got = tgumbel.gumbel_uniform((rows, 2, 3, width), torch.Generator().manual_seed(0), "cpu",
                                 block)
    assert torch.equal(got, whole[row0:row0 + rows, ..., col0:col0 + width])


@pytest.mark.parametrize("layout,what", [
    ("batch_dim:data,vae_hid_dim:model", "5h"),
    ("batch_dim:data,conv_cout:model", "5h"),
    ("batch_dim:data,conv_cin:model,tokens_dim:model", "5h"),
    # pipeline parallelism is ported (tests/test_torch_pp_dalle.py): what
    # stays refused of it is a layers rule beside a tensor dim (PP x TP)
    pytest.param("batch_dim:data,layers:model,tokens_dim:model", "5c-ii",
                 id="batch_dim:data,layers:model-5c"),
])
def test_check_layout_refuses_what_stays_in_the_roadmap(layout, what):
    with pytest.raises(NotImplementedError, match=f"queue 1 item {what}"):
        tmesh.check_layout([("data", 2), ("model", 2)], tmesh.parse_layout(layout))
    # accepted: the codebook split, an axis no rule names, and a tensor-parallel
    # axis beside the ring's sequence axis (TP x SP, ported)
    tmesh.check_layout([("data", 1), ("seq", 2), ("model", 2)],
                       tmesh.parse_layout("total_seq_dim:seq,tokens_dim:model"), "ring")
    for ok in ("batch_dim:data,tokens_dim:model", "batch_dim:data"):
        tmesh.check_layout([("data", 2), ("model", 2)], tmesh.parse_layout(ok))
