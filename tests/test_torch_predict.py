"""Predict-every-checkpoint in the port (train/predict.py) against the JAX
package's ``make_predict_summary_fn``, on the CPU at tiny shapes (a 2-layer
DALLE over tests/test_torch_dalle_image.py's 16 px VAE, 16 image tokens),
with weights carried across as numpy through ``utils/convert.py``:

- at ``predict_temperature: 0`` the image summaries equal JAX's within atol
  1e-5 (the same greedy tokens, then the same fp32 VAE decode summed in
  another order), and the PNGs under ``<model_path>/predict/step_<N>/``
  hold JAX's PNG pixels within one 8-bit step (an fp32 value a hair either
  side of a rounding edge may round to the neighbour), with ``prompts.txt``;
- one decoder serves every checkpoint of a run and reads the live
  parameters: after an in-place AdamW update it samples what a fresh
  predict fn samples on the updated weights (torch's foreach and fused
  AdamW update the leaves in place, checked by address);
- ``train_dalle.main --device cpu`` with ``predict_steps: 1`` in tokens mode
  loads the frozen VAE, trains, checkpoints and predicts at each checkpoint.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dalle_mtf_tpu.train import predict as jpredict
from dalle_mtf_tpu.train import tasks as jtasks
from dalle_mtf_tpu_torch.train import predict as tpredict
from dalle_mtf_tpu_torch.train import tasks as ttasks
from dalle_mtf_tpu_torch.train.optim import AdamW, named_leaves
from dalle_mtf_tpu_torch.utils import convert
from dalle_mtf_tpu_torch.utils.config import Config
from dalle_mtf_tpu_torch.utils.summaries import MetricsWriter, read_summaries

VAE = {"model_type": "vae", "dataset": {"image_size": 16}, "num_tokens": 32,
       "convblocks": [[1, 8], [1, 16]]}
TEXT_LEN = 8


def _params(model_path, **over):
    return Config.from_mapping({
        "model_type": "dalle", "n_embd": 32, "text_vocab_size": 48, "image_vocab_size": 32,
        "text_seq_len": TEXT_LEN, "n_layers": 2, "n_heads": 2,
        "train_batch_size": 4, "eval_batch_size": 4, "padding_id": 47,
        "predict_steps": 2, "predict_batch_size": 3, "predict_temperature": 0.0,
        "model_path": str(model_path), "vae_params": VAE, **over,
    })


def _models(params):
    """JAX and port (dalle, vae, dalle params, vae params) on one draw."""
    jt = jtasks.make_dalle_task(params)
    tt = ttasks.make_dalle_task(params, "cpu")
    jdp = jax.device_get(jt[0].init(jax.random.PRNGKey(0)))
    jvp = jax.device_get(jt[1].init(jax.random.PRNGKey(7)))
    return ((jt[0], jt[1], jdp, jvp),
            (tt[0], tt[1], convert.dalle_params_from_numpy(jdp, tt[0]),
             convert.vae_params_from_numpy(jvp, tt[1])))


def _captions(n=2, b=4, seed=5):
    rng = np.random.default_rng(seed)
    return [{"caption": rng.integers(0, 47, (b, TEXT_LEN)).astype(np.int32)} for _ in range(n)]


class _Tok:
    pad_token_id = 47

    def decode(self, ids):
        return " ".join(f"w{i}" for i in ids)


class _Writer:
    def __init__(self):
        self.images = {}

    def images_(self, step, images, max_outputs=4):
        for name, batch in images.items():
            self.images[(step, name)] = np.asarray(batch)[:max_outputs]


class _Trainer:
    rank = 0

    def __init__(self):
        self.recorder = _Writer()
        self.writer = type("W", (), {"images": staticmethod(self.recorder.images_)})()


def test_predict_summary_matches_jax_at_temperature_0(tmp_path):
    (jd, jv, jdp, jvp), (td, tv, tdp, tvp) = _models(_params(tmp_path / "jax"))
    jfn = jpredict.make_predict_summary_fn(_params(tmp_path / "jax"), jd, jv, jvp,
                                           iter(_captions()), tokenizer=_Tok())
    tfn = tpredict.make_predict_summary_fn(_params(tmp_path / "port"), td, tv, tvp,
                                           iter(_captions()), tokenizer=_Tok())
    jt, tt = _Trainer(), _Trainer()
    jfn(jt, {"params": jdp}, 10)
    tfn(tt, {"params": tdp}, 10)
    assert set(tt.recorder.images) == set(jt.recorder.images) == {
        (10, "predict/batch_0"), (10, "predict/batch_1")}
    for key, want in jt.recorder.images.items():
        got = tt.recorder.images[key]
        assert got.shape == want.shape == (3, 16, 16, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=str(key))
    jdir = tmp_path / "jax" / "predict" / "step_0000010"
    tdir = tmp_path / "port" / "predict" / "step_0000010"
    for i in range(2):
        for j in range(3):
            got = np.asarray(Image.open(tdir / f"batch{i}_row{j}.png"))
            want = np.asarray(Image.open(jdir / f"batch{i}_row{j}.png"))
            assert got.shape == want.shape == (16, 16, 3)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (tdir / "prompts.txt").read_text() == (jdir / "prompts.txt").read_text()
    assert (tdir / "prompts.txt").read_text().splitlines()[0].startswith("batch0_row0: w")


def test_predict_off_without_predict_steps(tmp_path):
    (_, _, _, _), (td, tv, _, tvp) = _models(_params(tmp_path))
    for steps in (None, 0):
        assert tpredict.make_predict_summary_fn(_params(tmp_path, predict_steps=steps), td, tv,
                                                tvp, iter(())) is None


@pytest.mark.parametrize("fused", [False, True])
def test_adamw_updates_the_leaves_in_place(fused):
    """What lets one captured decoder serve a whole run: the optimizer step
    writes every leaf where it lies."""
    tree = {"a": torch.randn(4, 3, requires_grad=True),
            "layers": {"w": torch.randn(2, 5, requires_grad=True)}}
    where = {p: t.data_ptr() for p, t in named_leaves(tree)}
    before = {p: t.detach().clone() for p, t in named_leaves(tree)}
    opt = AdamW(tree, lambda step: 1e-2, 0.9, 0.999, 1e-6, 0.1, 1.0, fused)
    for t in opt.leaves:
        t.grad = torch.ones_like(t)
    opt.step()
    for p, t in named_leaves(tree):
        assert t.data_ptr() == where[p]
        assert not torch.equal(t.detach(), before[p])


def test_one_decoder_reads_the_live_parameters(tmp_path):
    """The predict fn of a run samples at a later checkpoint from the
    parameters as AdamW left them in place (the banded head, a copy,
    rebuilt): the images a fresh fn gives on the updated weights."""
    params = _params(tmp_path / "run", predict_steps=1)
    (_, _, _, _), (td, tv, tdp, tvp) = _models(params)
    for _, t in named_leaves(tdp):
        t.requires_grad_(True)
    fn = tpredict.make_predict_summary_fn(params, td, tv, tvp, iter(_captions(1)))
    trainer = _Trainer()
    fn(trainer, {"params": tdp}, 1)
    opt = AdamW(tdp, lambda step: 5e-2, 0.9, 0.999, 1e-6, 0.0, None, False)
    for t in opt.leaves:
        t.grad = torch.randn(t.shape, generator=torch.Generator().manual_seed(t.numel()))
    opt.step()
    fn(trainer, {"params": tdp}, 2)
    fresh = tpredict.make_predict_summary_fn(_params(tmp_path / "fresh", predict_steps=1), td,
                                             tv, tvp, iter(_captions(1)))
    other = _Trainer()
    fresh(other, {"params": tdp}, 2)
    got = trainer.recorder.images[(2, "predict/batch_0")]
    np.testing.assert_array_equal(got, other.recorder.images[(2, "predict/batch_0")])
    assert not np.array_equal(got, trainer.recorder.images[(1, "predict/batch_0")])


def test_sampled_predict_seeds_from_step_and_batch(tmp_path):
    """At temperature 1 a checkpoint's images are a function of (step,
    batch): the same for two runs, different at another step."""
    params = _params(tmp_path / "a", predict_steps=1, predict_temperature=1.0,
                     predict_top_k=8)
    (_, _, _, _), (td, tv, tdp, tvp) = _models(params)
    runs = [tpredict.make_predict_summary_fn(params, td, tv, tvp, iter(_captions(1)))
            for _ in range(2)]
    trainers = [_Trainer(), _Trainer()]
    for fn, tr in zip(runs, trainers):
        fn(tr, {"params": tdp}, 3)
    runs[0](trainers[0], {"params": tdp}, 4)
    a, b = (tr.recorder.images[(3, "predict/batch_0")] for tr in trainers)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, trainers[0].recorder.images[(4, "predict/batch_0")])
    assert len({tpredict.predict_seed(s, i) for s in range(4) for i in range(3)}) == 12


def test_train_dalle_predicts_at_checkpoints_in_tokens_mode(tmp_path, monkeypatch):
    """``predict_steps: 1`` in tokens mode: the frozen VAE is restored (an
    .npz here) for its decoder, and every checkpoint writes its PNGs,
    prompts and image summaries."""
    from dalle_mtf_tpu_torch import train_dalle
    from dalle_mtf_tpu_torch.data import tfrecord as ttfr
    from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "data")
    with ttfr.TFRecordWriter(str(tmp_path / "data" / "shard_0.tfrecords")) as w:
        for _ in range(16):
            w.write(ttfr.serialize_example({
                "tokens": rng.integers(0, 32, 16).tolist(),
                "caption": rng.integers(0, 256, rng.integers(3, 12)).tolist()}))
    vae = DiscreteVAE(VAEConfig.from_params(Config.from_mapping(VAE)), "cpu")
    convert.save_npz(tmp_path / "vae.npz", vae.init(torch.Generator().manual_seed(1)))
    (tmp_path / "vae.json").write_text(json.dumps(VAE))
    pattern = str(tmp_path / "data" / "*.tfrecords")
    cfg = {
        "model_type": "dalle", "vae_model": str(tmp_path / "vae.json"),
        "vae_checkpoint_path": str(tmp_path / "vae.npz"),
        "dataset": {"train_path": pattern, "eval_path": pattern, "tokens": True},
        "n_embd": 32, "text_vocab_size": 50258, "image_vocab_size": 32,
        "text_seq_len": TEXT_LEN, "n_layers": 2, "n_heads": 2,
        "train_batch_size": 4, "eval_batch_size": 4, "train_steps": 4,
        "steps_per_checkpoint": 2, "log_every": 1, "lr": 1e-3, "warmup_steps": 1,
        "predict_steps": 1, "predict_batch_size": 2,
        "model_path": str(tmp_path / "run"),
    }
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    trainer = train_dalle.main(["--model", str(tmp_path / "cfg.json"), "--device", "cpu"])
    assert trainer.checkpoint_steps()[-1] == 4
    for step in (2, 4):
        out = tmp_path / "run" / "predict" / f"step_{step:07d}"
        assert sorted(os.listdir(out)) == ["batch0_row0.png", "batch0_row1.png", "prompts.txt"]
        for j in range(2):
            assert np.asarray(Image.open(out / f"batch0_row{j}.png")).shape == (16, 16, 3)
    images = [(s, tag) for s, tag, v in read_summaries(str(tmp_path / "run"))
              if tag.startswith("predict/")]
    assert images == [(s, f"predict/batch_0/image/{j}") for s in (2, 4) for j in range(2)]


def test_metrics_writer_is_what_predict_writes_to(tmp_path):
    """The summary fn's writer call lands as image summaries in the event
    file (the real ``MetricsWriter``, one image a row up to max_outputs)."""
    (_, _, _, _), (td, tv, tdp, tvp) = _models(_params(tmp_path))
    fn = tpredict.make_predict_summary_fn(_params(tmp_path, predict_steps=1), td, tv, tvp,
                                          iter(_captions(1)))
    trainer = type("T", (), {"rank": 0, "writer": MetricsWriter(str(tmp_path))})()
    fn(trainer, {"params": tdp}, 7)
    trainer.writer.close()
    got = [(s, tag, v[:3]) for s, tag, v in read_summaries(str(tmp_path))]
    assert got == [(7, f"predict/batch_0/image/{j}", (16, 16, 3)) for j in range(3)]
