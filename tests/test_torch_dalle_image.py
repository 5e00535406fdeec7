"""DALLE image mode and uint8 mode in the port against the JAX package, on
the CPU at tiny shapes (tests/test_tokens_mode.py's test VAE: 16 px,
convblocks ((1, 8), (1, 16)), 32 tokens; a 1-2 layer DALLE), with weights
carried across as numpy through ``utils/convert.py``:

- the frozen VAE's fp32 tokens equal JAX's ``encode_tokens``;
- ``make_dalle_task``'s image-mode train loss and every grad, and its eval
  loss and metrics, against JAX's image mode, f32 and uint8 batches;
- uint8 batches give the loss of f32 batches of the same PIL pixels, bit
  for bit; image mode gives tokens mode's loss and 2-step ``Trainer``
  trajectory, bit for bit, on records the port's ``encode_dataset`` wrote;
- ``dalle_input_fn``'s image batches (f32 and uint8, resume, shards) equal
  JAX's, and ``encode_dataset``'s files are JAX's byte for byte (the CLI's
  too, from an ``.npz``);
- ``restore_vae_params`` on ``train_vae``'s checkpoints and on an ``.npz``
  exported from a JAX orbax checkpoint by ``tools/export_vae_npz.py``;
- ``train_dalle.main --device cpu`` in image mode end to end with a resume,
  and one image-mode step on a ``data:1,seq:2`` gloo mesh.

Both packages are held to their PIL decode (each one's
``data.native.get_lib`` returns None here, as in
tests/test_torch_vae_data.py). Tolerances, as in
tests/test_torch_train.py: losses and metrics atol 1e-5, grads within 1e-4
of each leaf's largest |grad| (the same fp32 math summed in another order);
tokens, records and the port's own mode-to-mode comparisons exact.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.data import native as jnative
from dalle_mtf_tpu.data import pipeline as jpipe
from dalle_mtf_tpu.train import tasks as jtasks
from dalle_mtf_tpu_torch.data import native as tnative
from dalle_mtf_tpu_torch.data import pipeline as tpipe
from dalle_mtf_tpu_torch.data import tfrecord as ttfr
from dalle_mtf_tpu_torch.train import tasks as ttasks
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.utils import convert
from dalle_mtf_tpu_torch.utils.config import Config
from dalle_mtf_tpu_torch.utils.restore import restore_vae_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE = {"model_type": "vae", "dataset": {"image_size": 16}, "num_tokens": 32,
       "convblocks": [[1, 8], [1, 16]]}
TEXT_LEN, IMAGE_LEN = 8, 16


def _params(n_layers=1, **over):
    return Config.from_mapping({
        "model_type": "dalle", "n_embd": 32, "text_vocab_size": 48, "image_vocab_size": 32,
        "text_seq_len": TEXT_LEN, "n_layers": n_layers, "n_heads": 2,
        "train_batch_size": 4, "eval_batch_size": 4, "train_steps": 2,
        "steps_per_checkpoint": 100, "lr": 1e-3, "warmup_steps": 0, "padding_id": 47,
        "vae_params": VAE, **over,
    })


@pytest.fixture(autouse=True)
def jax_pil_path(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)


def _models(n_layers=1):
    """JAX and port tasks over one numpy weight draw: (jax task, port task,
    jax dalle params, jax vae params, port dalle params, port vae params)."""
    p = _params(n_layers)
    jt = jtasks.make_dalle_task(p)
    tt = ttasks.make_dalle_task(p, "cpu")
    jdp = jax.device_get(jt[0].init(jax.random.PRNGKey(0)))
    jvp = jax.device_get(jt[1].init(jax.random.PRNGKey(7)))
    return (jt, tt, jdp, jvp, convert.dalle_params_from_numpy(jdp, tt[0]),
            convert.vae_params_from_numpy(jvp, tt[1]))


def _batch(b, dtype, seed=3):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        image = rng.integers(0, 256, (b, 16, 16, 3), dtype=np.uint8)
    else:
        image = rng.uniform(-1, 1, (b, 16, 16, 3)).astype(np.float32)
    return {"image": image, "caption": rng.integers(0, 40, (b, TEXT_LEN)).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree):
    return dict(convert._flatten(tree))


# ------------------------------------------------------------ the tokenizer

@pytest.mark.parametrize("b,seed", [(2, 0), (8, 1), (5, 2)])
def test_fp32_image_tokens_equal_jax(b, seed):
    jt, tt, _, jvp, _, tvp = _models()
    img = _batch(b, "f32", seed)["image"]
    want = np.asarray(jt[1].encode_tokens(jvp, img))
    got = tt[1].encode_tokens(tvp, torch.from_numpy(img))
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, IMAGE_LEN)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("dtype", ["f32", "uint8"])
def test_image_mode_loss_and_grads_match_jax(n_layers, dtype):
    jt, tt, jdp, jvp, tdp, tvp = _models(n_layers)
    batch = _batch(4, dtype)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jt[3](p, jvp, batch, jax.random.PRNGKey(1), np.int32(0)), has_aux=True)(jdp)
    for t in _flat(tdp).values():
        t.requires_grad_(True)
    tl, taux = tt[3](tdp, tvp, _torch(batch), torch.Generator().manual_seed(1), 0)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-5
    assert set(taux) == set(jaux)
    for k in jaux:
        assert abs(taux[k].item() - float(jaux[k])) <= 1e-5, k
    jg, tg = _flat(jax.device_get(jg)), _flat(convert.grads_to_numpy(tdp))
    assert set(tg) == set(jg)
    for name, want in jg.items():
        np.testing.assert_allclose(tg[name], want, atol=1e-4 * np.abs(want).max() + 1e-9,
                                   err_msg=name)
    assert all(t.grad is None for t in _flat(tvp).values())  # the VAE stays frozen


@pytest.mark.parametrize("dtype", ["f32", "uint8"])
def test_image_mode_eval_metrics_match_jax(dtype):
    jt, tt, jdp, jvp, tdp, tvp = _models(2)
    batch = _batch(4, dtype, seed=5)
    jl, jm = jt[4](jdp, jvp, batch, jax.random.PRNGKey(2), np.int32(0))
    with torch.no_grad():
        tl, tm = tt[4](tdp, tvp, _torch(batch), torch.Generator().manual_seed(2), 0)
    assert set(tm) == set(jm) == {"loss_text", "loss_image", "acc", "acc_image"}
    assert abs(tl.item() - float(jl)) <= 1e-5
    for k in jm:
        assert abs(tm[k].item() - float(jm[k])) <= 1e-5, k


def test_image_batches_need_the_frozen_vae():
    tt = ttasks.make_dalle_task(_params(), "cpu")
    params = tt[2](torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="frozen"):
        tt[3](params, None, _torch(_batch(2, "f32")), torch.Generator(), 0)


# ------------------------------------------------------------------ records

def _jpeg(rng, h, w) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def write_image_records(root, files=3, per_file=7, seed=0):
    """JPEG + caption records: assorted sizes, captions of 0-12 ids."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for f in range(files):
        with ttfr.TFRecordWriter(os.path.join(root, f"imgs_{f}.tfrecords")) as w:
            for _ in range(per_file):
                jpeg = _jpeg(rng, int(rng.integers(12, 30)), int(rng.integers(12, 30)))
                caption = rng.integers(0, 48, int(rng.integers(0, 13))).tolist()
                w.write(ttfr.serialize_example({"image": jpeg, "caption": caption}))
    return os.path.join(root, "*.tfrecords")


def _data_params(pattern, batch=4, **ds):
    return _params(dataset={"train_path": pattern, "eval_path": pattern, "image_size": 16, **ds},
                   train_batch_size=batch, eval_batch_size=batch)


def _assert_streams_equal(want, got, n, keys):
    for _ in range(n):
        w, g = next(want), next(got)
        assert set(g) == set(keys)
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("uint8", [False, True])
@pytest.mark.parametrize("skip_steps", [0, 3])
def test_image_pipeline_matches_jax(tmp_path, uint8, skip_steps):
    params = _data_params(write_image_records(str(tmp_path)), uint8_images=uint8)
    for eval_ in (False, True):
        want = iter(jpipe.dalle_input_fn(params, eval=eval_, shard=(0, 1),
                                         skip_steps=skip_steps))
        got = iter(tpipe.dalle_input_fn(params, eval=eval_, skip_steps=skip_steps))
        b = next(got)
        assert b["image"].dtype == (np.uint8 if uint8 else np.float32)
        assert b["image"].shape == (4, 16, 16, 3) and b["caption"].shape == (4, TEXT_LEN)
        np.testing.assert_array_equal(b["image"], next(want)["image"])
        # 8 batches: past one pass over the 21 records, the repeat too
        _assert_streams_equal(want, got, 7, ("image", "caption"))
        got.close()


@pytest.mark.parametrize("index", [0, 1])
def test_image_pipeline_shards_match_jax(tmp_path, index):
    params = _data_params(write_image_records(str(tmp_path), files=4, per_file=5))
    want = iter(jpipe.dalle_input_fn(params, shard=(index, 2)))
    got = iter(tpipe.dalle_input_fn(params, shard=(index, 2)))
    assert next(got)["image"].shape == (2, 16, 16, 3)  # half the global batch
    next(want)
    _assert_streams_equal(want, got, 6, ("image", "caption"))
    got.close()


@pytest.mark.parametrize("batch_size,per_file", [(4, 6), (3, 4)])
def test_encode_dataset_records_byte_equal_jax(tmp_path, batch_size, per_file):
    from dalle_mtf_tpu.data.encode_dataset import encode_dataset as jencode
    from dalle_mtf_tpu_torch.data.encode_dataset import encode_dataset as tencode

    jt, tt, _, jvp, _, tvp = _models()
    src = write_image_records(str(tmp_path / "src"), files=2, per_file=5)
    n = jencode(src, str(tmp_path / "jax"), "tok", jt[1], jvp, image_size=16,
                batch_size=batch_size, examples_per_file=per_file)
    got = tencode(src, str(tmp_path / "port"), "tok", tt[1], tvp, image_size=16,
                  batch_size=batch_size, examples_per_file=per_file)
    assert got == n == -(-10 // per_file)  # the rollover exercised
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_encode_cli_restores_an_npz_and_writes_the_records(tmp_path):
    from dalle_mtf_tpu_torch.data import create_tfrecords
    from dalle_mtf_tpu_torch.data.encode_dataset import encode_dataset

    _, tt, _, _, _, tvp = _models()
    src = write_image_records(str(tmp_path / "src"), files=2, per_file=5)
    convert.save_npz(tmp_path / "vae.npz", tvp)
    (tmp_path / "vae.json").write_text(json.dumps(VAE))
    n = create_tfrecords.main([
        "encode", "--input", src, "--out", str(tmp_path / "cli"), "--name", "tok",
        "--encode-with", str(tmp_path / "vae.json"),
        "--vae-checkpoint-path", str(tmp_path / "vae.npz"),
        "--batch-size", "4", "--examples-per-file", "6", "--device", "cpu"])
    assert n == 2
    encode_dataset(src, str(tmp_path / "direct"), "tok", tt[1], tvp, image_size=16,
                   batch_size=4, examples_per_file=6)
    for i in range(2):
        name = f"tok_{i}.tfrecords"
        assert (tmp_path / "cli" / name).read_bytes() == (tmp_path / "direct" / name).read_bytes()
    with pytest.raises(SystemExit):  # paired needs its jsonl, --name and --out
        create_tfrecords.main(["paired"])


# ---------------------------------------------------- the modes against each other

def test_uint8_loss_bit_equal_to_f32_of_the_same_pixels(tmp_path):
    _, tt, _, _, tdp, tvp = _models(2)
    params = _data_params(write_image_records(str(tmp_path)))
    f32 = next(iter(tpipe.dalle_input_fn(params, eval=True)))
    u8 = next(iter(tpipe.dalle_input_fn(
        _data_params(params["dataset"]["train_path"], uint8_images=True), eval=True)))
    assert u8["image"].dtype == np.uint8
    for fn in (tt[3], tt[4]):  # train and eval
        with torch.no_grad():
            a = fn(tdp, tvp, _torch(f32), torch.Generator().manual_seed(0), 0)
            b = fn(tdp, tvp, _torch(u8), torch.Generator().manual_seed(0), 0)
        assert a[0].item() == b[0].item()
        assert {k: v.item() for k, v in a[1].items()} == {k: v.item() for k, v in b[1].items()}


@pytest.fixture
def encoded(tmp_path):
    """(port task, dalle params, vae params, image params, tokens params):
    one file of 10 JPEG records and the port's encode of it."""
    from dalle_mtf_tpu_torch.data.encode_dataset import encode_dataset

    _, tt, _, _, tdp, tvp = _models(2)
    src = write_image_records(str(tmp_path / "src"), files=1, per_file=10)
    encode_dataset(src, str(tmp_path / "tok"), "tok", tt[1], tvp, image_size=16, batch_size=4)
    tok = str(tmp_path / "tok" / "*.tfrecords")
    return tt, tdp, tvp, _data_params(src), _data_params(tok, tokens=True)


def test_image_mode_loss_equals_tokens_mode_on_encoded_records(encoded):
    tt, tdp, tvp, image_params, tokens_params = encoded
    images = iter(tpipe.dalle_input_fn(image_params))
    tokens = iter(tpipe.dalle_input_fn(tokens_params))
    for step in range(3):
        ib, tb = next(images), next(tokens)
        np.testing.assert_array_equal(ib["caption"], tb["caption"])
        for fn in (tt[3], tt[4]):
            with torch.no_grad():
                a = fn(tdp, tvp, _torch(ib), torch.Generator().manual_seed(step), step)
                b = fn(tdp, None, _torch(tb), torch.Generator().manual_seed(step), step)
            assert a[0].item() == b[0].item()
            assert {k: v.item() for k, v in a[1].items()} == {k: v.item() for k, v in b[1].items()}


def test_trainer_trajectory_image_equals_tokens_mode(encoded, tmp_path):
    from dalle_mtf_tpu_torch.train.trainer import Trainer, step_generator

    tt, _, tvp, image_params, tokens_params = encoded

    def run(tag, params, frozen):
        trainer = Trainer(params, tt[2], tt[3], str(tmp_path / tag), TEXT_LEN + IMAGE_LEN, "cpu",
                          frozen_params=frozen)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        data = iter(tpipe.dalle_input_fn(params))
        for i in range(2):
            state, metrics = trainer.train_step(state, next(data), step_generator(0, 1, i))
        data.close()
        trainer.close()
        return state, float(metrics["loss"])

    (a, la), (b, lb) = run("img", image_params, tvp), run("tok", tokens_params, None)
    assert la == lb
    for (name, x), (_, y) in zip(named_leaves(a["params"]), named_leaves(b["params"])):
        torch.testing.assert_close(y, x, rtol=0, atol=0, msg=name)


# ------------------------------------------------------------------ restore

def _write_jpgs(root, n=8, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (20, 18, 3), dtype=np.uint8)).save(
            os.path.join(root, f"img_{i}.jpg"))
    return os.path.join(root, "*.jpg")


@pytest.fixture(scope="module")
def trained_vae(tmp_path_factory):
    """A 2-step ``train_vae.main --device cpu`` run of the test VAE:
    (config path, model_path, the trainer's last parameters)."""
    from dalle_mtf_tpu_torch import train_vae

    tmp = tmp_path_factory.mktemp("vae")
    pattern = _write_jpgs(str(tmp / "imgs"))
    cfg = {**VAE, "dataset": {"train_path": pattern, "eval_path": pattern, "image_size": 16},
           "train_batch_size": 2, "eval_batch_size": 2, "train_steps": 2,
           "steps_per_checkpoint": 1, "eval_steps": 0, "log_every": 1, "lr": 1e-3,
           "warmup_steps": 0, "model_path": str(tmp / "run")}
    (tmp / "vae.json").write_text(json.dumps(cfg))
    trainer = train_vae.main(["--model", str(tmp / "vae.json"), "--device", "cpu"])
    assert trainer.checkpoint_steps() == [1, 2]
    return str(tmp / "vae.json"), str(tmp / "run"), trainer.state["params"]


def test_restore_reads_the_latest_train_vae_checkpoint(trained_vae):
    _, model_path, want = trained_vae
    _, tt, *_ = _models()
    got = restore_vae_params(tt[1], model_path)
    assert set(_flat(got)) == set(_flat(want))
    for name, t in _flat(want).items():
        torch.testing.assert_close(_flat(got)[name], t.detach(), rtol=0, atol=0, msg=name)
        assert not _flat(got)[name].requires_grad


def test_restore_without_a_checkpoint_raises(tmp_path):
    _, tt, *_ = _models()
    with pytest.raises(FileNotFoundError, match="train the VAE first"):
        restore_vae_params(tt[1], str(tmp_path / "nothing"))


@pytest.mark.parametrize("over", [{"num_tokens": 64}, {"convblocks": [[1, 8], [2, 16]]},
                                  {"convblocks": [[1, 8]]}])
def test_restore_refuses_a_tree_of_another_config(trained_vae, over):
    from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig

    _, model_path, _ = trained_vae
    other = DiscreteVAE(VAEConfig.from_params({**VAE, **over}), "cpu")
    with pytest.raises(ValueError, match="does not match the vae config"):
        restore_vae_params(other, model_path)


def test_jax_orbax_vae_carries_across_through_the_npz_export(tmp_path):
    import orbax.checkpoint as ocp

    spec = importlib.util.spec_from_file_location(
        "export_vae_npz", os.path.join(ROOT, "tools", "export_vae_npz.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    jt, tt, *_ = _models()
    jvp = jt[1].init(jax.random.PRNGKey(11))
    mngr = ocp.CheckpointManager(str(tmp_path / "jax_vae" / "checkpoints"),
                                 options=ocp.CheckpointManagerOptions(create=True))
    mngr.save(5, args=ocp.args.StandardSave({"step": np.int32(5), "params": jvp}))
    mngr.wait_until_finished()
    mngr.close()
    (tmp_path / "vae.json").write_text(json.dumps(VAE))
    tool.main(["--model", str(tmp_path / "vae.json"), "--out", str(tmp_path / "vae.npz"),
               "--vae-checkpoint-path", str(tmp_path / "jax_vae")])
    tvp = restore_vae_params(tt[1], str(tmp_path / "vae.npz"))
    img = _batch(6, "f32", seed=9)["image"]
    np.testing.assert_array_equal(tt[1].encode_tokens(tvp, torch.from_numpy(img)).numpy(),
                                  np.asarray(jt[1].encode_tokens(jvp, img)))
    with pytest.raises(ValueError, match="are not the model's"):
        convert.save_npz(tmp_path / "extra.npz", {**_flat(tvp), "extra/w": np.zeros(2)})
        restore_vae_params(tt[1], str(tmp_path / "extra.npz"))


# --------------------------------------------------------------- train_dalle

def _train_config(tmp_path, trained_vae, run, train_steps, **over):
    vae_config, vae_dir, _ = trained_vae
    pattern = write_image_records(str(tmp_path / "data"))
    cfg = {
        **{k: v for k, v in _params(2).items() if k != "vae_params"},
        "vae_model": vae_config, "vae_checkpoint_path": vae_dir,
        "dataset": {"train_path": pattern, "eval_path": pattern, "image_size": 16, **over},
        "text_vocab_size": 50258, "train_steps": train_steps, "steps_per_checkpoint": 2,
        "eval_steps": 1, "log_every": 1, "max_to_keep": 1, "lr_decay_end": 4,
        "warmup_steps": 1, "model_path": str(tmp_path / run),
    }
    path = tmp_path / f"{run}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("uint8", [False, True])
def test_train_dalle_image_mode_trains_evaluates_checkpoints_and_resumes(
        tmp_path, monkeypatch, trained_vae, uint8):
    from dalle_mtf_tpu_torch import train_dalle

    monkeypatch.chdir(tmp_path)
    ds = {"uint8_images": True} if uint8 else {}
    whole = train_dalle.main(["--model", _train_config(tmp_path, trained_vae, "whole", 4, **ds),
                              "--device", "cpu"])
    assert [h["step"] for h in whole.history] == [1, 2, 3, 4]
    assert [e["step"] for e in whole.eval_history] == [2, 4]
    assert set(whole.eval_history[0]) >= {"eval_loss", "eval_acc", "eval_acc_image",
                                          "eval_loss_text", "eval_loss_image"}
    assert abs(whole.history[0]["loss"] - np.log(50258 + 32 + 1)) < 0.1
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in whole.history)
    want = torch.load(os.path.join(whole.ckpt_dir, "ckpt_4.pt"), weights_only=True)["params"]
    dalle = ttasks.make_dalle_task(_params(2, text_vocab_size=50258), "cpu")[0]
    assert set(want) == set(_flat(dalle.param_shapes()))  # no VAE in the checkpoint

    train_dalle.main(["--model", _train_config(tmp_path, trained_vae, "split", 2, **ds),
                      "--device", "cpu"])
    resumed = train_dalle.main(["--model", _train_config(tmp_path, trained_vae, "split", 4, **ds),
                                "--device", "cpu"])
    assert [h["step"] for h in resumed.history] == [3, 4]
    got = torch.load(os.path.join(resumed.ckpt_dir, "ckpt_4.pt"), weights_only=True)["params"]
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0, msg=name)


def test_image_step_on_a_gloo_mesh_matches_one_process(tmp_path):
    """One image-mode loss and its grads on ``data:1,seq:2`` (each rank
    encodes the group's rows and takes its sequence shard; the shares summed)
    against the single process."""
    cfg = dict(_params(2, attention_type="ring", mesh_shape="data:1,seq:2",
                       layout="batch_dim:data,total_seq_dim:seq"))
    _, tt, jdp, jvp, tdp, tvp = _models(2)
    batch = _batch(4, "uint8", seed=8)
    torch.save({"config": cfg, "params": tdp, "vae_params": tvp, "batch": _torch(batch),
                "seed": 3}, tmp_path / "in.pt")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", os.path.join(ROOT, "tests", "torch_ring_worker.py"), "image_step",
           str(tmp_path / "in.pt"), str(tmp_path)]
    res = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    got = torch.load(tmp_path / "step.pt", weights_only=False)

    for t in _flat(tdp).values():
        t.requires_grad_(True)
    loss, _ = tt[3](tdp, tvp, _torch(batch), torch.Generator().manual_seed(3), 0)
    loss.backward()
    assert abs(got["loss"].item() - loss.item()) <= 1e-5
    for name, t in _flat(tdp).items():
        want = t.grad
        torch.testing.assert_close(got["grads"][name], want, rtol=0,
                                   atol=1e-4 * want.abs().max().item() + 1e-9, msg=name)
