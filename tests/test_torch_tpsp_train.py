"""``train_dalle`` and ``sample_dalle`` with tensor parallelism under ring
attention ("TP x SP"), on the CPU over 4 gloo ranks: one launch of
tests/torch_tp_worker.py (``train`` runs, then a ``sample_cli`` case) on
``data:1,seq:2,model:2`` with the Megatron rules beside the ring's, tokens
mode, attention dropout 0.1, at tests/test_ring_dalle.py's width (E = 64, 4
heads, 2 layers, text 8 + image 16; the tokenizer's text vocabulary).

- The run logs the single process's losses within 1e-5 (the same rows and
  masks), and its checkpoint is the whole, unpadded tree that one process
  restores bit for bit and continues within 1e-5 of the unbroken run; a
  resume on the layout equals the unbroken run bit for bit.
- ``predict_steps: 1`` samples on rank 0's model group and writes the PNGs
  one process's predict writes from the same checkpoint.
- ``sample_dalle.main`` on the layout (the sequence axis only copies the
  model group; no ring) writes one process's greedy PNGs.
"""

import json
import os
import shutil

import numpy as np
import torch

from test_torch_tp_train import _check_predict
from test_torch_tp_xent import torchrun

MESH = "data:1,seq:2,model:2"
TPSP = ("batch_dim:data,total_seq_dim:seq,heads_dim:model,intermediate_expanded:model,"
        "vocab_dim:model")
TEXT = "a red cube on a table"
N_FILES, PER_FILE = 3, 11


def _train_config(tmp_path, name, **over):
    from dalle_mtf_tpu_torch.data import tfrecord
    from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig
    from dalle_mtf_tpu_torch.utils import convert

    root = tmp_path / "data"
    if not root.exists():
        rng = np.random.default_rng(0)
        root.mkdir()
        for f in range(N_FILES):
            with tfrecord.TFRecordWriter(str(root / f"shard_{f}.tfrecords")) as w:
                for _ in range(PER_FILE):
                    w.write(tfrecord.serialize_example({
                        "tokens": rng.integers(0, 32, 16).tolist(),
                        "caption": rng.integers(0, 256, rng.integers(3, 12)).tolist(),
                    }))
        vae = {"model_type": "vae", "dataset": {"image_size": 16}, "num_tokens": 32,
               "convblocks": [[1, 8], [1, 16]]}
        (tmp_path / "vae.json").write_text(json.dumps(vae))
        model = DiscreteVAE(VAEConfig.from_params(vae), "cpu")
        convert.save_npz(tmp_path / "vae.npz", model.init(torch.Generator().manual_seed(2)))
    pattern = str(root / "*.tfrecords")
    cfg = {
        "model_type": "dalle", "vae_model": str(tmp_path / "vae.json"),
        "vae_checkpoint_path": str(tmp_path / "vae.npz"),
        "dataset": {"train_path": pattern, "eval_path": pattern, "tokens": True},
        "n_embd": 64, "text_vocab_size": 50258, "image_vocab_size": 32, "text_seq_len": 8,
        "n_layers": 2, "n_heads": 4, "train_batch_size": 4, "eval_batch_size": 4,
        "train_steps": 3, "steps_per_checkpoint": 2, "eval_steps": 1, "log_every": 1,
        "max_to_keep": 1, "lr": 1e-3, "warmup_steps": 1, "lr_decay_end": 3,
        "attention_type": "ring", "attention_dropout": 0.1, "mesh_shape": MESH,
        "layout": TPSP, "model_path": str(tmp_path / name), **over,
    }
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _argv(path):
    return ["--model", path, "--device", "cpu"]


def _ckpt(tmp_path, name, step=3):
    ckpts = sorted(os.listdir(tmp_path / name / "checkpoints"))
    assert ckpts == [f"ckpt_{step}.pt"]  # max_to_keep 1, one writer
    return torch.load(tmp_path / name / "checkpoints" / ckpts[0], weights_only=True)


def _logged(history):
    return [{k: v for k, v in h.items() if k != "steps_per_sec"} for h in history]


def test_train_and_sample_on_tp_x_sp(tmp_path, monkeypatch):
    from PIL import Image

    from dalle_mtf_tpu_torch import sample_dalle, train_dalle
    from dalle_mtf_tpu_torch.train.optim import named_leaves
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_task
    from dalle_mtf_tpu_torch.train.trainer import Trainer
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params

    monkeypatch.chdir(tmp_path)
    unbroken = _train_config(tmp_path, "unbroken")
    split = _train_config(tmp_path, "split", train_steps=2)
    predict = _train_config(tmp_path, "predict", predict_steps=1, predict_temperature=0.0)
    sample = ["--text", TEXT, "--n", "2", "--temperature", "0", "--device", "cpu"]
    ranks = torchrun(4, "train", [
        {"argv": _argv(unbroken)}, {"argv": _argv(split)},
        {"argv": _argv(_train_config(tmp_path, "split"))},
        {"argv": _argv(predict)},
        {"mode": "sample_cli",
         "argvs": [["--model", unbroken, "--out", str(tmp_path / "out_ranks"), *sample]]},
    ], tmp_path, timeout=400)
    first, short, resumed, predicted, (sampled,) = ranks

    # the single process's losses: the same rows, the same masks
    one = train_dalle.main(_argv(_train_config(tmp_path, "one", mesh_shape="data:1")))
    got = first["history"]
    assert [h["step"] for h in got] == [1, 2, 3]
    for h, w in zip(got, one.history):
        assert abs(h["loss"] - w["loss"]) <= 1e-5
    assert abs(first["eval_history"][0]["eval_loss"] - one.eval_history[0]["eval_loss"]) <= 1e-5
    ckpt, want = _ckpt(tmp_path, "unbroken"), _ckpt(tmp_path, "one")
    # the whole, unpadded tree
    assert ckpt["params"]["w_out"].shape == (64, 50291)
    assert ckpt["params"]["layers/wq"].shape == (2, 64, 4, 16)
    for name in want["params"]:
        torch.testing.assert_close(ckpt["params"][name], want["params"][name], rtol=0,
                                   atol=1e-5, msg=name)
    # a resume on the layout is the unbroken run, bit for bit
    assert _logged(short["history"] + resumed["history"]) == _logged(got)
    for name, t in _ckpt(tmp_path, "split")["params"].items():
        torch.testing.assert_close(t, ckpt["params"][name], rtol=0, atol=0, msg=name)

    # one process restores the layout's checkpoint bit for bit and continues
    restored = _train_config(tmp_path, "restored", mesh_shape="data:1", train_steps=4)
    shutil.copytree(tmp_path / "unbroken" / "checkpoints", tmp_path / "restored" / "checkpoints")
    params = fetch_model_params(restored)
    params["padding_id"] = 50257
    dalle, _, init_fn, loss_fn, _ = make_dalle_task(params, "cpu")
    trainer = Trainer(params, init_fn, loss_fn, params["model_path"], dalle.cfg.total_seq_len,
                      "cpu")
    state = trainer.restore(trainer.init_state(torch.Generator().manual_seed(0)))
    trainer.close()
    assert state["step"] == 3
    for path, t in named_leaves(state["params"]):
        assert torch.equal(t.detach(), ckpt["params"]["/".join(path)]), path
    continued = train_dalle.main(_argv(restored))
    assert [h["step"] for h in continued.history] == [4]
    fresh = train_dalle.main(_argv(_train_config(tmp_path, "fresh", mesh_shape="data:1",
                                                 train_steps=4)))
    assert abs(continued.history[0]["loss"] - fresh.history[3]["loss"]) <= 1e-5

    # predict on rank 0's model group: one process's PNGs from the checkpoint
    _check_predict(tmp_path, predicted)

    # sampling on the layout: rank 0 writes one process's greedy PNGs
    rank0 = sampled[0]
    assert len(rank0["paths"]) == 2 and all(r["paths"] == [] for r in sampled[1:])
    wants = sample_dalle.main(["--model", unbroken, "--out", str(tmp_path / "out_one"),
                               *sample])
    for got_px, path in zip(rank0["pixels"], wants):
        np.testing.assert_array_equal(got_px, np.asarray(Image.open(path)))
