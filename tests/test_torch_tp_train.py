"""``train_dalle`` under ``torch.distributed.run`` on 2 gloo ranks with
dalle_coco's mesh and layout (``data:16,model:2`` resized to
``data:1,model:2``), tokens mode, attention dropout on: a ``model:2``
checkpoint is the whole, unpadded tree and optimizer state; it restores on
one process, and a single process's checkpoint on ``model:2``, each
continuing within 1e-5 of the unbroken run in the other layout; a
``model:2`` resume equals an unbroken ``model:2`` run bit for bit;
``predict_steps: 1`` under tensor parallelism samples greedy on both ranks'
blocks and rank 0 writes the PNGs one process's predict writes from the
same checkpoint. Each launch runs several ``train_dalle.main`` calls in one
process group (tests/torch_tp_worker.py ``train``).
"""

import json
import os
import shutil

import numpy as np
import torch

from test_torch_tp_dalle import TP
from test_torch_tp_xent import torchrun

N_FILES, PER_FILE = 3, 11


def _train_config(tmp_path, name, **over):
    from dalle_mtf_tpu_torch.data import tfrecord

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
        from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig
        from dalle_mtf_tpu_torch.utils import convert

        model = DiscreteVAE(VAEConfig.from_params(vae), "cpu")
        convert.save_npz(tmp_path / "vae.npz", model.init(torch.Generator().manual_seed(2)))
    pattern = str(root / "*.tfrecords")
    cfg = {
        "model_type": "dalle", "vae_model": str(tmp_path / "vae.json"),
        "dataset": {"train_path": pattern, "eval_path": pattern, "tokens": True},
        "n_embd": 32, "text_vocab_size": 50258, "image_vocab_size": 32, "text_seq_len": 8,
        "n_layers": 2, "n_heads": 2, "train_batch_size": 4, "eval_batch_size": 4,
        "train_steps": 3, "steps_per_checkpoint": 2, "eval_steps": 1, "log_every": 1,
        "max_to_keep": 1, "lr": 1e-3, "warmup_steps": 1, "lr_decay_end": 3,
        "attention_dropout": 0.1, "mesh_shape": "data:16,model:2", "layout": TP,
        "model_path": str(tmp_path / name), **over,
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


def _copy_run(tmp_path, src, dst):
    shutil.copytree(tmp_path / src / "checkpoints", tmp_path / dst / "checkpoints")


def test_train_dalle_model2_checkpoints_cross_layouts_and_resume(tmp_path, monkeypatch):
    from dalle_mtf_tpu_torch import train_dalle

    monkeypatch.chdir(tmp_path)
    first = torchrun(2, "train", [
        {"argv": _argv(_train_config(tmp_path, "unbroken"))},
        {"argv": _argv(_train_config(tmp_path, "split", train_steps=2))},
        {"argv": _argv(_train_config(tmp_path, "predict", predict_steps=1,
                                     predict_temperature=0.0,
                                     vae_checkpoint_path=str(tmp_path / "vae.npz")))},
    ], tmp_path)
    unbroken = first[0]["history"]
    assert [h["step"] for h in unbroken] == [1, 2, 3]
    # the checkpoint is the whole, unpadded tree and optimizer state
    ckpt = _ckpt(tmp_path, "unbroken")
    assert ckpt["params"]["w_out"].shape == (32, 50291)
    assert ckpt["params"]["layers/wq"].shape == (2, 32, 2, 16)
    moments = ckpt["opt_state"]["adamw"]["state"]
    assert {tuple(s["exp_avg"].shape) for s in moments.values()} >= {(50291, 32), (32, 50291)}
    # a model:2 checkpoint continues on one process, a single process's on model:2
    _copy_run(tmp_path, "split", "to_one")
    to_one = train_dalle.main(_argv(_train_config(tmp_path, "to_one")))
    one = train_dalle.main(_argv(_train_config(tmp_path, "one", train_steps=2)))
    whole = train_dalle.main(_argv(_train_config(tmp_path, "whole")))
    _copy_run(tmp_path, "one", "to_two")
    second = torchrun(2, "train", [
        {"argv": _argv(_train_config(tmp_path, "split"))},
        {"argv": _argv(_train_config(tmp_path, "to_two"))},
    ], tmp_path)
    # a model:2 resume is the unbroken model:2 run, bit for bit
    def logged(history):
        return [{k: v for k, v in h.items() if k != "steps_per_sec"} for h in history]

    assert logged(first[1]["history"] + second[0]["history"]) == logged(unbroken)
    got, want = _ckpt(tmp_path, "split"), ckpt
    for name in want["params"]:
        torch.testing.assert_close(got["params"][name], want["params"][name], rtol=0, atol=0,
                                   msg=name)
    assert [h["step"] for h in to_one.history] == [3]
    assert abs(to_one.history[0]["loss"] - unbroken[2]["loss"]) <= 1e-5
    assert [h["step"] for h in second[1]["history"]] == [3]
    assert abs(second[1]["history"][0]["loss"] - whole.history[2]["loss"]) <= 1e-5
    assert [h["loss"] for h in one.history] == [h["loss"] for h in whole.history[:2]]
    _check_predict(tmp_path, first[2])
    for a, b in ((_ckpt(tmp_path, "to_one"), ckpt), (_ckpt(tmp_path, "to_two"),
                                                    _ckpt(tmp_path, "whole"))):
        for name in b["params"]:
            torch.testing.assert_close(a["params"][name], b["params"][name], rtol=0,
                                       atol=1e-5, msg=name)


class _Trainer:
    """What the predict summary reads of a single process's Trainer."""

    rank = 0

    class writer:
        @staticmethod
        def images(*_args, **_kw):
            pass


def _check_predict(tmp_path, run):
    """The model:2 run's predict PNGs at its last checkpoint against one
    process's predict on that checkpoint's whole tree."""
    from PIL import Image

    from dalle_mtf_tpu_torch.data.pipeline import dalle_input_fn
    from dalle_mtf_tpu_torch.data.tokenizer import get_tokenizer
    from dalle_mtf_tpu_torch.train.predict import make_predict_summary_fn
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_task
    from dalle_mtf_tpu_torch.train_dalle import load_vae_params
    from dalle_mtf_tpu_torch.utils import convert
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params

    assert [h["step"] for h in run["history"]] == [1, 2, 3]
    params = fetch_model_params(str(tmp_path / "predict.json"))
    params["padding_id"] = 50257
    params["model_path"] = str(tmp_path / "predict_one")
    dalle, vae, *_ = make_dalle_task(params, "cpu")
    tree = convert.dalle_params_from_numpy(
        convert.nest({k: v.numpy() for k, v in _ckpt(tmp_path, "predict")["params"].items()}),
        dalle)
    captions = iter(dalle_input_fn(params, eval=True))
    try:
        summary = make_predict_summary_fn(params, dalle, vae, load_vae_params(params, vae),
                                          captions, tokenizer=get_tokenizer())
        summary(_Trainer, {"params": tree}, 3)
    finally:
        captions.close()
    got_dir = tmp_path / "predict" / "predict" / "step_0000003"
    want_dir = tmp_path / "predict_one" / "predict" / "step_0000003"
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir)) == [
        f"batch0_row{j}.png" for j in range(4)] + ["prompts.txt"]
    assert (got_dir / "prompts.txt").read_text() == (want_dir / "prompts.txt").read_text()
    for name in names[:-1]:
        np.testing.assert_array_equal(np.asarray(Image.open(got_dir / name)),
                                      np.asarray(Image.open(want_dir / name)), err_msg=name)
    # a checkpoint before the last one sampled too
    assert sorted(os.listdir(tmp_path / "predict" / "predict")) == ["step_0000002",
                                                                     "step_0000003"]
