"""VAE data parallelism, tensor parallelism over the codebook (``tokens_dim``,
``vae_hid_dim``) and the convs (``conv_cout``, ``conv_cin``, ``conv_kh``),
and an axis that only replicates, on 4 gloo ranks (one launch of
tests/torch_tp_worker.py), against one process and the live JAX package.

From one JAX init and one Gumbel draw ``u`` (``jax.random.uniform`` and the
port's ``gumbel_uniform`` patched: a rank's draw is the rows and columns of
``u`` it holds), two AdamW steps of the JAX test's VAE
(tests/test_graft_and_vae_tp.py) on a batch of 8:

- ``data:4``; ``data:2,model:2`` with ``tokens_dim:model`` (the codebook by
  columns), with ``conv_cout`` + ``tokens_dim``, ``conv_cin`` +
  ``vae_hid_dim`` (with ``recompute_grad``: the recompute reruns the
  block's collectives), ``conv_cout`` + ``vae_hid_dim`` (the encoder's
  channel blocks into the codebook's row blocks), ``vae_hid_dim`` alone
  and ``conv_kh``;
  ``data:16,model:2`` with ``batch_dim:data`` (configs/vae_example.json's
  layout: the model axis only replicates), against the port on one process
  and JAX's ``data:8`` and ``data:4,model:2`` runs on the same layout:
  losses, the first and the second step's gradients (gathered), the
  parameters after; the eval metrics (PSNR, codebook perplexity, Fréchet
  feature distance) against JAX's eval on the whole batch at the same
  parameters;
- under each split every rank holds of each leaf and of its two AdamW
  moments only the block JAX's ``shard_params`` gives a device of
  ``data:4,model:2`` (a dim that does not divide stays whole), each conv of
  a step runs with the rank's channel block as its kernel (a gathered
  whole kernel only under ``conv_kh``), and the sharded init is the single
  process's tree there;
- a layout that puts one axis on two dims of a leaf is refused by the port
  by name, where JAX's ``shard_params`` refuses it;
- configs/dalle_example.json's layout (``data:16,model:2``,
  ``batch_dim:data``) and ``data:2,model:2`` with ``conv_cout:model`` (a
  VAE rule, which splits no DALLE leaf) on a small DALLE: loss and
  gradients of one process, one value in each model group;
- ``data:1,model:2,rep:2`` with the codebook split beside an axis that
  only replicates, against one process;
- every copy of a replicated leaf and of a codebook block holds one value
  after the steps, though each copy but the first perturbs its gradients
  (the trainer broadcasts the first's);
- ``train_vae.main`` on ``data:2,model:2`` with ``conv_cout`` +
  ``tokens_dim`` (and ``recompute_grad``) trains, evaluates, checkpoints
  and resumes bit-equal to the unbroken run, and its checkpoint restores
  whole on one process.

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

from dalle_mtf_tpu.models.vae import DiscreteVAE as JaxVAE
from dalle_mtf_tpu.models.vae import VAEConfig as JaxVAEConfig
from dalle_mtf_tpu.parallel import mesh as jmesh
from dalle_mtf_tpu.train.tasks import make_vae_task as jax_vae_task
from dalle_mtf_tpu.train.trainer import Trainer as JaxTrainer
from dalle_mtf_tpu.utils.config import Config
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.models import vae as tvae
from dalle_mtf_tpu_torch.ops import gumbel as tgumbel
from dalle_mtf_tpu_torch.parallel import mesh as tmesh
from dalle_mtf_tpu_torch.train import tasks as ttasks
from dalle_mtf_tpu_torch.train.optim import get_optimizer, named_leaves
from dalle_mtf_tpu_torch.train.trainer import Trainer
from dalle_mtf_tpu_torch.utils import convert
from dalle_mtf_tpu_torch.utils.restore import restore_vae_params
from test_torch_tp_xent import torchrun
from test_torch_vae_train import TASK_PARAMS
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
    # the conv splits: each rank's output channels, input channels or
    # kernel rows (conv_kh: the 4-row kernels; the 3-row ones and the 1x1
    # do not divide and stay whole)
    **{key: ("data:2,model:2", layout, "data:4,model:2", layout) for key, layout in (
        ("conv_cout", "batch_dim:data,conv_cout:model,tokens_dim:model"),
        ("conv_cin", "batch_dim:data,conv_cin:model,vae_hid_dim:model"),
        # the encoder's output-channel blocks straight into the codebook's
        # row blocks, the decoder's row blocks into the first up conv
        ("conv_cout_hid", "batch_dim:data,conv_cout:model,vae_hid_dim:model"),
        ("vae_hid", "batch_dim:data,vae_hid_dim:model"),
        ("conv_kh", "batch_dim:data,conv_kh:model"))},
}
TP_KEYS = ("codebook", "conv_cout", "conv_cin", "conv_cout_hid", "vae_hid", "conv_kh")
CONV_KEYS = TP_KEYS[1:]
# a case's own config changes: the recompute reruns the blocks' collectives
OVER = {"conv_cin": {"recompute_grad": True}}
REPLICAS = {"dp": 4, "codebook": 2, "vae_example": 2, "codebook_rep": 1,
            **{k: 2 for k in CONV_KEYS}}
# the ranks holding copies of the replicated leaves, and of a codebook block
COPIES = {"codebook": ({(0, 1), (2, 3)}, set()), "vae_example": ({(0, 1), (2, 3)}, set()),
          "codebook_rep": ({(0, 1, 2, 3)}, {(0, 1), (2, 3)}),
          **{k: ({(0, 1), (2, 3)}, set()) for k in CONV_KEYS}}
# one axis on two dims of a leaf: refused (JAX: DuplicateSpecError)
DUPLICATES = {
    "batch_dim:data,conv_cin:model,conv_cout:model": "conv_cin and conv_cout",
    "batch_dim:data,vae_hid_dim:model,tokens_dim:model": "vae_hid_dim and tokens_dim",
    "batch_dim:data,conv_kh:model,conv_kw:model": "conv_kh and conv_kw",
    "batch_dim:data,conv_kw:model,conv_cout:model": "conv_kw and conv_cout",
}
# a DALLE layout with a rule on the VAE's dims: the model axis becomes the
# tensor-parallel axis, but no DALLE leaf carries such a dim (nor does JAX
# split one), so it only copies
DALLE_CONV_LAYOUT = ("data:2,model:2", "batch_dim:data,conv_cout:model")
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
        layout=LAYOUTS["conv_cout"][1], model_path=str(tmp_path / run)),
        "--device", "cpu"]


def _jax_blocks(key, init):
    """The block shape of each leaf on a device of JAX's mesh for ``key``
    (``shard_params``: a dim that does not divide stays whole)."""
    _, _, shape, layout = LAYOUTS[key]
    axes = JaxVAE(JaxVAEConfig.from_params(Config.from_mapping(PARAMS))).logical_axes()
    tree = jmesh.shard_params(jax.tree.map(jnp.asarray, init), jmesh.build_mesh(shape),
                              jmesh.parse_layout(layout), axes)
    return {"/".join(str(k.key) for k in path): leaf.sharding.shard_shape(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


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
        meshes = {LAYOUTS[k][2:] for k in LAYOUTS if LAYOUTS[k][2]}
        jax_runs = {m: _jax_run(mp, tmp_path, *m, images, u) for m in sorted(meshes)}
        jax_runs = {k: jax_runs[LAYOUTS[k][2:]] for k in LAYOUTS if LAYOUTS[k][2]}
        init = jax_runs["dp"][0]
        one = _port_one_process(mp, tmp_path, init, images, u)
        jax_grads, jax_eval = _jax_grads_and_eval(mp, init, convert.nest(one[2]), images, u)
        dparams = convert.params_to_numpy(
            tdalle.DALLE(tdalle.DalleConfig(**DALLE_KW), "cpu").init(
                torch.Generator().manual_seed(0)))
        tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 365, (4, 24)))
        vae_cases = [{"mode": "vae_step", "params": {**PARAMS, **OVER.get(k, {})},
                      "mesh_shape": LAYOUTS[k][0], "layout": LAYOUTS[k][1], "tree": init,
                      "images": torch.from_numpy(images), "u": u, "steps": STEPS,
                      "perturb": 1e-3} for k in LAYOUTS]
        dalle_cases = [{"mode": "dalle_step", "config": DALLE_KW, "mesh_shape": shape,
                        "layout": layout, "params": dparams, "tokens": tokens, "seed": 3,
                        "replicated": True, "copies": True}
                       for shape, layout in (("data:16,model:2", "batch_dim:data"),
                                             DALLE_CONV_LAYOUT)]
        cli = [{"mode": "train_vae", "argv": _vae_cli(tmp_path, name, steps, run)}
               for name, steps, run in (("unbroken", 4, "run_unbroken"),
                                        ("split", 2, "run_split"), ("resume", 4, "run_split"))]
        results = torchrun(4, "vae_step", vae_cases + dalle_cases + cli, tmp_path, timeout=400)
        n = len(LAYOUTS)
        yield dict(tmp_path=tmp_path, jax=jax_runs, init=init, one=one, jax_grads=jax_grads,
                   jax_eval=jax_eval, ranks=dict(zip(LAYOUTS, results[:n])),
                   dalle=(dparams, tokens, results[n]), dalle_conv=results[n + 1],
                   cli=results[n + 2:])
    finally:
        mp.undo()
        os.chdir(cwd)


def test_one_process_matches_jax(runs):
    losses, grads, _params, metrics = runs["one"]
    np.testing.assert_allclose(losses, runs["jax"]["dp"][1], rtol=1e-5)
    _close_grads(grads[0], runs["jax_grads"], "one process vs jax.grad")
    _close_metrics(metrics, runs["jax_eval"], "one process vs JAX eval")
    # one init on both JAX meshes
    for key in TP_KEYS:
        for name, a in convert._flatten(runs["jax"][key][0]):
            np.testing.assert_array_equal(a, dict(convert._flatten(runs["init"]))[name])


@pytest.mark.parametrize("key", list(LAYOUTS))
def test_layout_matches_one_process_and_jax(runs, key):
    """Losses, both steps' gradients, the parameters after and the eval
    metrics (PSNR of the whole batch's squared error, the perplexity of its
    token counts, the feature distance of its moments) of ``key``'s layout
    on 4 ranks, against one process and JAX on the same layout (the
    replicate-only layouts against JAX's ``data:8``)."""
    losses, grads, params, metrics = runs["one"]
    got = runs["ranks"][key]
    assert got["replicas"] == REPLICAS[key]
    jax_losses, jax_final = runs["jax"][key if key in runs["jax"] else "dp"][1:]
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


def test_dalle_layout_with_a_conv_rule_matches_one_process(runs):
    """A DALLE on data:2,model:2 with ``conv_cout:model`` (a VAE rule): JAX
    splits no DALLE leaf by it (its logical axes name no VAE dim), and the
    port's model axis, the tensor-parallel one, only copies: the loss and
    every gradient of 4 ranks equal one process's, and the two ranks of
    each model group hold one loss and one set of gradients."""
    from dalle_mtf_tpu.models.dalle import DALLE as JaxDALLE  # noqa: PLC0415
    from dalle_mtf_tpu.models.dalle import DalleConfig as JaxDalleConfig  # noqa: PLC0415

    shape, layout = DALLE_CONV_LAYOUT
    dparams, tokens, _ = runs["dalle"]
    jax_model = JaxDALLE(JaxDalleConfig(**DALLE_KW))
    placed = jmesh.shard_params(jax_model.init(jax.random.PRNGKey(0)),
                                jmesh.build_mesh("data:4,model:2"), jmesh.parse_layout(layout),
                                jax_model.logical_axes())
    assert all(leaf.sharding.shard_shape(leaf.shape) == leaf.shape
               for leaf in jax.tree_util.tree_leaves(placed))
    got = runs["dalle_conv"]
    assert tmesh.tensor_axis(tmesh.parse_mesh_shape(shape),
                             tmesh.parse_layout(layout)) == "model"
    want_loss, want_grads = _dalle_reference(dparams, tokens)
    assert float(got["loss"]) == pytest.approx(want_loss, rel=1e-5)
    _close_grads({k: v.numpy() for k, v in got["grads"].items()}, want_grads,
                 "dalle conv_cout layout")
    groups = {tuple(g) for g, _ in got["copies"]}
    assert groups == {(0, 1), (2, 3)}
    for g in groups:
        assert len({got["copies"][r][1] for r in g}) == 1, got["copies"]


def test_train_vae_main_over_ranks_resumes_bit_equal(runs):
    """``train_vae.main`` on data:2,model:2 with the convs split by output
    channels and the codebook by columns (``recompute_grad`` on): an
    unbroken run of 4 steps, and 2 steps then a resume to 4, in one process
    group; the checkpoint holds the whole tree and restores on one
    process."""
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
    assert ckpt["params"]["encoder/block_1/res_1/conv_in/w"].shape == (3, 3, 16, 16)
    vae = tvae.DiscreteVAE(tvae.VAEConfig.from_params(TASK_PARAMS), "cpu")
    restored = restore_vae_params(vae, str(runs["tmp_path"] / "run_unbroken"))
    for path, t in named_leaves(restored):
        assert torch.equal(t, ckpt["params"]["/".join(path)]), path


@pytest.mark.parametrize("key", TP_KEYS)
def test_each_rank_holds_only_its_blocks(runs, key):
    """Every rank holds of each leaf, and of both its AdamW moments, the
    block a device of JAX's data:4,model:2 holds under ``shard_params``."""
    want = _jax_blocks(key, runs["init"])
    held = runs["ranks"][key]["held"]
    assert len(held) == 4
    split = 0
    for rank in held:
        assert set(rank) == set(want)
        for name, shapes in rank.items():
            assert shapes == (want[name],) * 3, (key, name, shapes, want[name])
            split += shapes[0] != dict(convert._flatten(runs["init"]))[name].shape
    assert split  # the layout splits something on every rank


@pytest.mark.parametrize("key", CONV_KEYS)
def test_channel_split_convs_run_on_the_ranks_block(runs, key):
    """Each conv of a step's forward runs with the rank's block of its
    kernel (permuted to torch's layout: OIHW, a transposed conv's IOHW): a
    block of its output or input channels under ``conv_cout`` and
    ``conv_cin``; a kernel split by rows (``conv_kh``) is gathered whole
    first, and under ``vae_hid_dim`` alone no kernel is split."""
    init = dict(convert._flatten(runs["init"]))
    blocks = _jax_blocks(key, runs["init"])
    shapes = tvae.DiscreteVAE(tvae.VAEConfig.from_params(PARAMS), "cpu").param_shapes()
    kernels = ["/".join(p) for p, _ in named_leaves(shapes) if p[-1] == "w"]  # forward order
    for rank_convs in runs["ranks"][key]["convs"]:
        want = []
        for name in kernels:
            kh, kw, cin, cout = init[name].shape if key == "conv_kh" else blocks[name]
            up = "/up/" in name
            want.append((up, (cin, cout, kh, kw) if up else (cout, cin, kh, kw)))
        # the forward's convs, then the res blocks' recompute in the backward
        assert rank_convs[:len(want)] == want, key
        assert set(rank_convs[len(want):]) <= set(want), key
    split = [n for n in kernels if blocks[n] != init[n].shape]
    if key in ("conv_cout", "conv_cin", "conv_cout_hid"):
        assert len(split) == len(kernels) - 1  # all but a 3-channel end
    elif key == "conv_kh":
        assert split == [n for n in kernels if init[n].shape[0] == 4]
    else:
        assert not split


@pytest.mark.parametrize("key", TP_KEYS)
def test_sharded_init_is_the_single_process_tree(runs, key):
    """``init`` on each rank draws the single process's values on its
    blocks (hashed on each value's index in the whole leaf)."""
    whole = dict(named_leaves(tvae.DiscreteVAE(tvae.VAEConfig.from_params(PARAMS), "cpu")
                              .init(torch.Generator().manual_seed(0))))
    for rank, blocks in enumerate(runs["ranks"][key]["init"]):
        m = rank % 2  # data:2,model:2: the model index
        for name, got in blocks.items():
            w = whole[tuple(name.split("/"))].numpy()
            dims = [d for d, (a, b) in enumerate(zip(got.shape, w.shape)) if a != b]
            if dims:
                n = got.shape[dims[0]]
                w = np.take(w, range(m * n, (m + 1) * n), axis=dims[0])
            np.testing.assert_array_equal(got, w, err_msg=f"{key} rank {rank} {name}")


@pytest.mark.parametrize("layout", [*DUPLICATES, *(LAYOUTS[k][1] for k in TP_KEYS)])
def test_duplicate_axes_refused_where_jax_refuses(layout):
    """A layout that puts the model axis on two dims of one leaf: JAX's
    ``shard_params`` raises (``DuplicateSpecError``), and the port's
    ``check_layout`` refuses it by name before a group is joined. The
    layouts the port runs place in JAX as well."""
    init = convert.params_to_numpy(tvae.DiscreteVAE(tvae.VAEConfig.from_params(PARAMS), "cpu")
                                   .init(torch.Generator().manual_seed(0)))
    axes = JaxVAE(JaxVAEConfig.from_params(Config.from_mapping(PARAMS))).logical_axes()
    rules = tmesh.parse_layout(layout)

    def jax_place():
        jmesh.shard_params(jax.tree.map(jnp.asarray, init), jmesh.build_mesh("data:4,model:2"),
                           rules, axes)

    def port_check():
        tmesh.check_layout([("data", 2), ("model", 2)], rules)

    if layout in DUPLICATES:
        with pytest.raises(Exception, match="(?i)duplicate|twice"):
            jax_place()
        with pytest.raises(NotImplementedError, match=f"'model' on {DUPLICATES[layout]}"):
            port_check()
        # on an axis of size 1 too, as JAX
        with pytest.raises(NotImplementedError, match="twice"):
            tmesh.check_layout([("data", 4), ("model", 1)], rules)
    else:
        jax_place()
        port_check()


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
    # pipeline parallelism is ported, beside tensor parallelism too
    # (tests/test_torch_pp_dalle.py, tests/test_torch_pptp_dalle.py): what
    # stays refused of it is a layers rule beside vocab_dim alone on one axis
    pytest.param("batch_dim:data,layers:model,vocab_dim:model", "5c-vi",
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


@pytest.mark.parametrize("layout", ["batch_dim:data,vae_hid_dim:model",
                                    "batch_dim:data,conv_cout:model",
                                    "batch_dim:data,conv_cin:model,tokens_dim:model"])
def test_check_layout_accepts_the_vae_splits(layout):
    """The VAE's rules on vae_hid_dim and the conv dims, once refused, run
    on one tensor-parallel axis; a second such axis is still refused."""
    rules = tmesh.parse_layout(layout)
    tmesh.check_layout([("data", 2), ("model", 2)], rules)
    assert tmesh.tensor_axis([("data", 2), ("model", 2)], rules) == "model"
    two = {**rules, "conv_kw": "data"}
    with pytest.raises(NotImplementedError, match="more than one mesh axis"):
        tmesh.check_layout([("data", 2), ("model", 2)], {**two, "batch_dim": "other"})
