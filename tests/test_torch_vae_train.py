"""Stage-1 VAE training in the port against the JAX package, on the CPU at
tiny shapes: the convs' "SAME" padding at stride 2, the encoder, the
training forward (loss and every parameter gradient, with the residual
recompute on and off), ``make_vae_task``'s train and eval losses and
metrics, the temperature schedule, three optimizer steps against optax,
the weight exchange's check of the encoder, image summaries, and
``train_vae.main`` end to end with a resume.

The same Gumbel draw goes through both packages (``jax.random.uniform`` and
the port's ``gumbel_uniform`` patched to return one ``u``). Tolerances,
each with its reason:
- fp32: logits and features atol 1e-5, losses rtol 1e-5, grads within 1e-4
  of each leaf's largest |grad|: the same math, summed in another order;
  hard token ids equal (the logits' gaps at these seeds are far above
  rounding).
- bf16: losses atol 2e-2 and logits within 2e-2 of max |logit|: both
  packages round activations to bf16 at the same points, from fp32 sums
  taken in another order.
- three AdamW steps: losses within 1e-5 (float32 rounding of the same
  arithmetic in another order).
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_mtf_tpu.models import vae as jvae
from dalle_mtf_tpu.train import optim as joptim
from dalle_mtf_tpu.train import tasks as jtasks
from dalle_mtf_tpu_torch.models import vae as tvae
from dalle_mtf_tpu_torch.ops import gumbel as tgumbel
from dalle_mtf_tpu_torch.train import optim as toptim
from dalle_mtf_tpu_torch.train import tasks as ttasks
from dalle_mtf_tpu_torch.utils import convert

KW = dict(num_tokens=32, image_size=16, convblocks=((1, 8), (2, 16)))


def _models(stack_factor=1, image_size=16, **over):
    kw = {**KW, "stack_factor": stack_factor, "image_size": image_size, **over}
    jm = jvae.DiscreteVAE(jvae.VAEConfig(**kw))
    tm = tvae.DiscreteVAE(tvae.VAEConfig(**kw), "cpu")
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    return jm, tm, jparams, convert.vae_params_from_numpy(jparams, tm)


def _images(b, size, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


def _u(shape, seed=1):
    return np.random.default_rng(seed).uniform(1e-9, 1.0, shape).astype(np.float32)


def same_u(monkeypatch, u):
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **k: jnp.asarray(u))
    monkeypatch.setattr(tgumbel, "gumbel_uniform",
                        lambda shape, generator, device: torch.from_numpy(u).to(device))


def _requires_grad(tree):
    for _, t in toptim.named_leaves(tree):
        t.requires_grad_(True)
    return tree


def _flat(tree):
    return dict(convert._flatten(tree))


# ------------------------------------------------------------------ convs

@pytest.mark.parametrize("size,k,stride", [(8, 4, 2), (7, 4, 2), (9, 4, 2), (7, 3, 1), (5, 1, 1)])
def test_same_padding_matches_jax(size, k, stride):
    """Even sizes pad (1, 1) at k=4 stride 2 (passed to the conv), odd ones
    (1, 2) (through F.pad first), as XLA's "SAME"."""
    rng = np.random.default_rng(size + k)
    x = rng.standard_normal((2, size, size + 1, 5)).astype(np.float32)
    p = {"w": rng.standard_normal((k, k, 5, 6)).astype(np.float32),
         "b": rng.standard_normal((6,)).astype(np.float32)}
    want = np.asarray(jvae._conv(jnp.asarray(x), jax.tree.map(jnp.asarray, p), stride))
    got = tvae._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                     {n: torch.from_numpy(v) for n, v in p.items()}, stride).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if (size, stride) == (7, 2):
        assert tvae._same_pads(size, k, stride) == (1, 2)


def test_conv_grads_match_autograd_conv2d():
    """``_Conv``'s own backward against torch's conv2d under autograd."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 4, 9, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 4, 4, 4)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 6, 4, 4)).astype(np.float32))
    grads = []
    for fn in (lambda a, b: tvae._Conv.apply(a, b, 2, (1, 1), False),
               lambda a, b: torch.nn.functional.conv2d(a, b, stride=2, padding=1)):
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        (fn(a, b) * g).sum().backward()
        grads.append((a.grad, b.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_space_to_depth_matches_jax():
    x = np.arange(2 * 8 * 8 * 3, dtype=np.float32).reshape(2, 8, 8, 3)
    want = np.asarray(jvae.space_to_depth(jnp.asarray(x), 2))
    got = tvae.space_to_depth(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tvae.depth_to_space(got, 2).numpy(), x)


# ---------------------------------------------------------------- encoder

@pytest.mark.parametrize("stack_factor,image_size", [(1, 16), (2, 32)])
def test_encoder_matches_jax_fp32(stack_factor, image_size):
    jm, tm, jparams, tparams = _models(stack_factor, image_size)
    img = _images(3, image_size)
    with torch.no_grad():
        got = tm.encoder(tparams, torch.from_numpy(img))
        feats = tm.encoder_features(tparams, torch.from_numpy(img))
        tokens = tm.encode_tokens(tparams, torch.from_numpy(img))
    want = np.asarray(jm.encoder(jparams, jnp.asarray(img)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jm.encoder_features(jparams, jnp.asarray(img))),
                               atol=1e-5)
    want_tokens = np.asarray(jm.encode_tokens(jparams, jnp.asarray(img)))
    assert tokens.dtype == torch.int32 and tokens.shape == (3, jm.cfg.image_seq_len)
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)


def test_encoder_matches_jax_bf16():
    jm, tm, jparams, tparams = _models(use_bf16=True)
    img = _images(3, 16)
    with torch.no_grad():
        got = tm.encoder(tparams, torch.from_numpy(img))
        feats = tm.encoder_features(tparams, torch.from_numpy(img))
    want = np.asarray(jm.encoder(jparams, jnp.asarray(img)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2 * np.abs(want).max())
    want_f = np.asarray(jm.encoder_features(jparams, jnp.asarray(img)))
    np.testing.assert_allclose(feats.numpy(), want_f, atol=2e-2 * np.abs(want_f).max())


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("hard,stack_factor", [(False, 1), (True, 1), (False, 2)])
def test_forward_loss_and_grads_match_jax(monkeypatch, recompute, hard, stack_factor):
    size = 16 * stack_factor
    jm, tm, jparams, tparams = _models(stack_factor, size, recompute_grad=recompute)
    img = _images(2, size)
    g = jm.cfg.grid_size
    same_u(monkeypatch, _u((2, g, g, 32)))
    temp = 0.6

    def jloss(p):
        return jm.forward(p, jnp.asarray(img), jax.random.PRNGKey(0), temp, hard, train=True)

    (want, want_out), want_grads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, jparams))
    _requires_grad(tparams)
    got, out = tm.forward(tparams, torch.from_numpy(img), torch.Generator(), temp, hard, train=True)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=1e-5)
    want_grads = _flat(jax.device_get(want_grads))
    got_grads = _flat(convert.grads_to_numpy(tparams))
    assert got_grads.keys() == want_grads.keys()
    for name, w in want_grads.items():
        np.testing.assert_allclose(got_grads[name], w, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_recompute_keeps_loss_and_grads():
    """The checkpointed residual blocks give the port's own loss and grads
    bit for bit."""
    results = []
    for recompute in (False, True):
        _, tm, _, tparams = _models(recompute_grad=recompute)
        _requires_grad(tparams)
        loss, _ = tm.forward(tparams, torch.from_numpy(_images(2, 16)),
                             torch.Generator().manual_seed(5), 0.5, False, train=True)
        loss.backward()
        results.append((loss.item(), _flat(convert.grads_to_numpy(tparams))))
    assert results[0][0] == results[1][0]
    for name, g in results[0][1].items():
        np.testing.assert_array_equal(results[1][1][name], g, err_msg=name)


def test_forward_matches_jax_bf16(monkeypatch):
    jm, tm, jparams, tparams = _models(use_bf16=True, recompute_grad=True)
    img = _images(2, 16)
    same_u(monkeypatch, _u((2, 4, 4, 32)))
    want, _ = jm.forward(jparams, jnp.asarray(img), jax.random.PRNGKey(0), 1.0, False, train=True)
    with torch.no_grad():
        got, out = tm.forward(tparams, torch.from_numpy(img), torch.Generator(), 1.0, False,
                              train=True)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), atol=2e-2)


# ------------------------------------------------------------------ tasks

TASK_PARAMS = {
    "dataset": {"image_size": 16}, "num_tokens": 32, "convblocks": [[1, 8], [2, 16]],
    "temp_start": 1.0, "temp": 0.2, "temp_anneal_steps": 10,
    "train_gumbel_hard": False, "eval_gumbel_hard": True, "recompute_grad": True,
}


@pytest.mark.parametrize("step", [0, 4, 25])
def test_temperature_schedule_matches_jax(step):
    """At the start, mid-anneal and past it, with and without an anneal:
    the same float32 value."""
    for params in (TASK_PARAMS, {**TASK_PARAMS, "temp_anneal_steps": None},
                   {"temp_anneal_steps": 7, "temp_start": 2, "temp": 0.05}, {}):
        want = float(jvae.temperature_schedule(params, jnp.asarray(step)))
        got = tvae.temperature_schedule(params, step)
        assert got == want, (params, step)
    want = {0: 1.0, 4: 1.0 - 0.4 * 0.8, 25: 0.2}[step]
    assert tvae.temperature_schedule(TASK_PARAMS, step) == pytest.approx(want, abs=1e-7)


@pytest.mark.parametrize("uint8", [False, True])
def test_vae_task_losses_and_metrics_match_jax(monkeypatch, uint8):
    _, jinit, jtrain, jeval, _ = jtasks.make_vae_task(TASK_PARAMS)
    vae, _, ttrain, teval = ttasks.make_vae_task(TASK_PARAMS, "cpu")
    jparams = jax.device_get(jinit(jax.random.PRNGKey(3)))
    tparams = convert.vae_params_from_numpy(jparams, vae)
    pixels = np.random.default_rng(2).integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    img = pixels if uint8 else (pixels.astype(np.float32) - 127.5) / 127.5
    same_u(monkeypatch, _u((4, 4, 4, 32)))
    for step in (3, 40):
        want, _ = jtrain(jparams, None, {"image": jnp.asarray(img)}, jax.random.PRNGKey(0),
                         jnp.asarray(step))
        with torch.no_grad():
            got, aux = ttrain(tparams, None, {"image": torch.from_numpy(img)},
                              torch.Generator(), step)
        assert aux == {}
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        want, want_aux = jeval(jparams, None, {"image": jnp.asarray(img)},
                               jax.random.PRNGKey(0), jnp.asarray(step))
        with torch.no_grad():
            got, got_aux = teval(tparams, None, {"image": torch.from_numpy(img)},
                                 torch.Generator(), step)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        assert sorted(got_aux) == sorted(want_aux) == [
            "codebook_perplexity", "frechet_feature_distance", "psnr"]
        for name, w in want_aux.items():
            np.testing.assert_allclose(got_aux[name].item(), float(w), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        assert 1.0 < got_aux["codebook_perplexity"].item() <= 32


def test_three_optimizer_steps_match_optax(monkeypatch):
    """Loss, grads and AdamW (the port's ``get_optimizer`` against the
    optax chain) over 3 steps on one batch, through the tasks' train
    losses: the trajectories' losses within 1e-5."""
    cfg = {**TASK_PARAMS, "lr": 3e-3, "warmup_steps": 1, "train_steps": 10,
           "weight_decay": 0.01}
    _, jinit, jtrain, _, _ = jtasks.make_vae_task(cfg)
    vae, _, ttrain, _ = ttasks.make_vae_task(cfg, "cpu")
    jparams = jax.tree.map(jnp.asarray, jax.device_get(jinit(jax.random.PRNGKey(4))))
    tparams = _requires_grad(convert.vae_params_from_numpy(jax.device_get(jparams), vae))
    img = _images(2, 16, seed=3)
    same_u(monkeypatch, _u((2, 4, 4, 32), seed=9))
    tx, _ = joptim.get_optimizer(cfg)
    jstate = tx.init(jparams)
    topt, _ = toptim.get_optimizer(cfg, tparams)
    got, want = [], []
    for step in range(3):
        loss, grads = jax.value_and_grad(
            lambda p: jtrain(p, None, {"image": jnp.asarray(img)}, jax.random.PRNGKey(0),
                             jnp.asarray(step))[0])(jparams)
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want.append(float(loss))
        topt.zero_grad()
        tloss, _ = ttrain(tparams, None, {"image": torch.from_numpy(img)}, torch.Generator(), step)
        tloss.backward()
        topt.step()
        got.append(tloss.item())
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[2] < got[0]  # the steps train


def test_weight_exchange_checks_the_encoder():
    jm, tm, jparams, _ = _models()
    tree = jax.tree.map(np.array, jparams)
    tree["encoder"]["block_1"]["res_1"]["conv_in"]["w"] = np.zeros((3, 3, 16, 8), np.float32)
    with pytest.raises(ValueError, match="encoder/block_1/res_1/conv_in/w"):
        convert.vae_params_from_numpy(tree, tm)
    del tree["encoder"]["block_0"]["down"]
    with pytest.raises(KeyError, match="encoder/block_0/down"):
        convert.vae_params_from_numpy(tree, tm)
    shapes = jax.tree.map(np.shape, jparams)
    assert _flat(tm.param_shapes()) == _flat(shapes)


# ---------------------------------------------------------------- summaries

def summary_images(logdir):
    """{(step, tag): (height, width, colorspace, PNG bytes)} of the images
    written under ``logdir``."""
    from dalle_mtf_tpu_torch.utils.summaries import read_summaries

    return {(step, tag): v for step, tag, v in read_summaries(logdir) if isinstance(v, tuple)}


def test_metrics_writer_images_decode_to_their_pixels(tmp_path):
    from PIL import Image

    from dalle_mtf_tpu_torch.utils.summaries import MetricsWriter, read_summaries

    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, (3, 5, 7, 3)).astype(np.float32) / 255.0
    grey = rng.integers(0, 256, (1, 4, 4, 1)).astype(np.float32) / 255.0
    writer = MetricsWriter(str(tmp_path))
    writer.scalars(2, {"loss": 0.5})
    writer.images(2, {"input_image": batch, "grey": grey}, max_outputs=2)
    writer.close()
    assert (2, "loss", 0.5) in read_summaries(str(tmp_path))
    images = summary_images(str(tmp_path))
    assert sorted(images) == [(2, "grey/image/0"), (2, "input_image/image/0"),
                              (2, "input_image/image/1")]
    for i in range(2):
        h, w, c, png = images[(2, f"input_image/image/{i}")]
        assert (h, w, c) == (5, 7, 3)
        pixels = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
        np.testing.assert_array_equal(pixels, np.round(batch[i] * 255).astype(np.uint8))
    h, w, c, png = images[(2, "grey/image/0")]
    assert c == 1
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  np.round(grey[0, :, :, 0] * 255).astype(np.uint8))


# ---------------------------------------------------------------- the CLI

def _write_jpgs(root, n=12, size=(20, 24), seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(
            os.path.join(root, f"img_{i:02d}.jpg"))
    return os.path.join(root, "*.jpg")


def _config(tmp_path, name, train_steps, **over):
    pattern = _write_jpgs(str(tmp_path / "imgs"))
    cfg = {
        **TASK_PARAMS, "model_type": "vae",
        "dataset": {"train_path": pattern, "eval_path": pattern, "image_size": 16},
        "train_batch_size": 2, "eval_batch_size": 2, "steps_per_checkpoint": 3,
        "train_steps": train_steps, "eval_steps": 1, "log_every": 1, "lr": 1e-3,
        "warmup_steps": 0, "lr_decay_end": 6, "model_path": str(tmp_path / f"run_{name}"),
        **over,
    }
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_train_vae_main_trains_evaluates_checkpoints_and_resumes(tmp_path):
    from dalle_mtf_tpu_torch import train_vae

    whole = train_vae.main(["--model", _config(tmp_path, "whole", 6), "--device", "cpu",
                            "--new", "--yes"])
    assert [h["step"] for h in whole.history] == list(range(1, 7))
    assert whole.checkpoint_steps() == [3, 6]
    assert [e["step"] for e in whole.eval_history] == [3, 6]
    for e in whole.eval_history:
        assert all(np.isfinite(v) for v in e.values())
        assert 1.0 < e["eval_codebook_perplexity"] <= 32
        assert {"eval_loss", "eval_psnr", "eval_frechet_feature_distance"} <= e.keys()
    images = summary_images(whole.model_dir)
    for step in (3, 6):
        for name in ("input_image", "reconstruction_image"):
            for i in range(2):
                h, w, c, png = images[(step, f"{name}/image/{i}")]
                assert (h, w, c) == (16, 16, 3) and png.startswith(b"\x89PNG")

    first = train_vae.main(["--model", _config(tmp_path, "split", 3), "--device", "cpu",
                            "--new", "--yes"])
    resumed = train_vae.main(["--model", _config(tmp_path, "split", 6), "--device", "cpu"])
    assert [h["step"] for h in first.history] == [1, 2, 3]
    assert [h["step"] for h in resumed.history] == [4, 5, 6]
    # the same data, noise and optimizer state: the unbroken run's losses
    want = [h["loss"] for h in whole.history]
    got = [h["loss"] for h in first.history + resumed.history]
    assert got == want
    # the eval stream restarts with each main (as in the JAX train_vae.py), so the
    # evals at step 3 read the same batch, the resumed one at 6 another
    assert first.eval_history == whole.eval_history[:1]
    assert [e["step"] for e in resumed.eval_history] == [6]


def test_train_vae_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    from dalle_mtf_tpu_torch import train_vae

    # a mesh of several ranks resizes to the one process and trains (the JAX
    # build_mesh rule: vae_example's data:16,model:2)
    for shape in ("data:2", "data:16,model:2"):
        path = _config(tmp_path, shape.replace(":", "").replace(",", "_"), 1, mesh_shape=shape,
                       layout="batch_dim:data", eval_steps=0)
        trained = train_vae.main(["--model", path, "--device", "cpu"])
        assert [h["step"] for h in trained.history] == [1]
    # several processes: VAE data parallelism and the splits of the codebook
    # and the convs train (tests/test_torch_vae_dp.py); a layout that puts
    # one axis on two dims of a leaf (JAX's DuplicateSpecError) raises
    # before the process group is joined, naming them
    monkeypatch.setenv("WORLD_SIZE", "2")
    for layout, dims in (("batch_dim:data,conv_cin:model,conv_cout:model",
                          "conv_cin and conv_cout"),
                         ("batch_dim:data,vae_hid_dim:model,tokens_dim:model",
                          "vae_hid_dim and tokens_dim")):
        with pytest.raises(NotImplementedError, match=f"'model' on {dims}"):
            train_vae.main(["--model", _config(tmp_path, "tp", 2, mesh_shape="data:1,model:2",
                                               layout=layout), "--device", "cpu"])
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="not a vae config"):
        train_vae.main(["--model", _config(tmp_path, "dalle", 2, model_type="dalle"),
                        "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_vae.main(["--model", _config(tmp_path, "card", 2)])
