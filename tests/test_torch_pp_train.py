"""``train_dalle`` and checkpoints on a pipeline-parallel mesh
(``mesh_shape: "pipe:2,data:2"``, ``layout: "batch_dim:data,layers:pipe"``)
on 4 gloo ranks, tokens mode, attention dropout on, in one launch of
tests/torch_tp_worker.py (``train`` cases, and a ``ckpt`` case):

- on ``pipe:4`` (4 layers, a layer a stage, no data axis: the single
  process's rows), 3 steps with an eval and a checkpoint equal one
  process's run on the same records within 1e-5 (losses, grad norms, the
  eval, every parameter of the checkpoint): the dropout masks are the
  single process's;
- on ``pipe:2,data:2`` (whose data ranks read their own records), a run of
  2 steps resumed to 3 in the same process group is the unbroken run bit
  for bit;
- ``predict_steps`` on a ``layers`` rule raises at start-up, naming ROADMAP
  queue 1 item 5c-iv;
- a checkpoint one process wrote restores on ``pipe:2,data:2`` (every rank
  holds the file's layers of its stage and the moments bit for bit, and
  copies only them), takes a step there, and rank 0 writes the whole tree
  (each stage's layers sent to it leaf by leaf), which restores on one
  process bit for bit and agrees with one process's step.

Beside a tensor-parallel axis (PP x TP, ``data:1,pipe:2,model:2`` with the
published rules plus ``layers:pipe``), in a launch of its own: a run of 2
steps resumed to 4 is the unbroken run of 4 bit for bit (logs, evals and the
checkpoint), and the checkpoint (each block of a stacked split leaf sent to
rank 0 by the rank of its pipe x model plane that holds it) restores whole
on one process, parameters and moments, equal to the ranks' blocks gathered.
"""

import math

import numpy as np
import torch

from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.train.trainer import Trainer
from test_torch_tp_train import _argv, _ckpt, _train_config
from test_torch_tp_xent import torchrun

PP = "batch_dim:data,layers:pipe"
PP_RUN = dict(mesh_shape="pipe:2,data:2", layout=PP)
PPTP_RUN = dict(mesh_shape="data:1,pipe:2,model:2", n_layers=4, layout=PP + (
    ",heads_dim:model,intermediate_expanded:model,vocab_dim:model"))
DEEP = dict(mesh_shape="pipe:4", layout=PP, n_layers=4)
CKPT_KW = dict(n_embd=64, text_vocab_size=300, image_vocab_size=64, text_seq_len=8,
               image_seq_len=16, n_layers=4, n_heads=2, attention_dropout=0.1)
OPT = {"lr": 1e-3, "warmup_steps": 0, "train_batch_size": 8, "max_to_keep": 2}


def _loss(model):
    def loss(p, _f, b, g, _s):
        return model.loss(p, b["tokens"], g, train=True)[0], {}
    return loss


def _one_process_checkpoint(tmp_path, tokens):
    """One process's Trainer: one step from the seeded init, saved at step
    1 under ``tmp_path / "from_one"``; returns the model."""
    model = tdalle.DALLE(tdalle.DalleConfig(**CKPT_KW), "cpu")
    one = Trainer(OPT, model.init, _loss(model), str(tmp_path / "from_one"),
                  model.cfg.total_seq_len, "cpu")
    state = one.init_state(torch.Generator().manual_seed(4))
    state, _ = one.train_step(state, {"tokens": tokens}, torch.Generator().manual_seed(1))
    one.save(state)
    one.close()
    return model


def test_train_dalle_on_pipe2_data2(tmp_path, monkeypatch):
    from dalle_mtf_tpu_torch import train_dalle

    monkeypatch.chdir(tmp_path)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 365, (8, 24)))
    model = _one_process_checkpoint(tmp_path, tokens)
    runs = torchrun(4, "train", [
        {"argv": _argv(_train_config(tmp_path, "deep", **DEEP))},
        {"argv": _argv(_train_config(tmp_path, "unbroken", **PP_RUN))},
        {"argv": _argv(_train_config(tmp_path, "split", train_steps=2, **PP_RUN))},
        {"argv": _argv(_train_config(tmp_path, "split", **PP_RUN))},
        {"argv": _argv(_train_config(tmp_path, "predict", predict_steps=1, **PP_RUN)),
         "raises": "5c-iv"},
        {"mode": "ckpt", "config": CKPT_KW, "opt_params": OPT, "tokens": tokens, "seed": 9,
         "model_dir": str(tmp_path / "from_one"),
         "phases": [("pipe:2,data:2", PP, "restore_step")]},
    ], tmp_path, timeout=400)
    deep, unbroken, first, second, predict, ranks = runs
    assert [h["step"] for h in deep["history"]] == [1, 2, 3]
    one = train_dalle.main(_argv(_train_config(tmp_path, "one", mesh_shape="data:1",
                                               n_layers=4)))
    for got, want in zip(deep["history"], one.history):
        assert abs(got["loss"] - want["loss"]) <= 1e-5, (got, want)
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-5 * want["grad_norm"]
    assert len(deep["eval_history"]) == len(one.eval_history) == 2
    for got, want in zip(deep["eval_history"], one.eval_history):
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-5, (k, got[k], v)
    pp, single = _ckpt(tmp_path, "deep"), _ckpt(tmp_path, "one")
    assert pp["params"]["layers/wq"].shape == (4, 32, 2, 16)  # the whole stack
    for name, want in single["params"].items():
        torch.testing.assert_close(pp["params"][name], want, rtol=0, atol=1e-5, msg=name)

    # a resume on the pipe mesh is the unbroken run, bit for bit
    def logged(history):
        return [{k: v for k, v in h.items() if k != "steps_per_sec"} for h in history]

    assert [h["step"] for h in unbroken["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in unbroken["history"])
    assert logged(first["history"] + second["history"]) == logged(unbroken["history"])
    split = _ckpt(tmp_path, "split")
    for name, want in _ckpt(tmp_path, "unbroken")["params"].items():
        assert torch.equal(split["params"][name], want), name
    assert "predict_steps" in predict["raised"]

    # one process's checkpoint on the pipe mesh: each rank copied its stage's
    # layers and the whole other leaves, with both AdamW moments
    shapes = dict(named_leaves(model.param_shapes(whole=True)))
    stage_bytes = 4 * sum(math.prod(s) // (2 if p[0] == "layers" else 1)
                          for p, s in shapes.items())
    for r, fig in enumerate(ranks):
        assert fig["step"] == 1 and fig["local_param_bytes"] == stage_bytes, (r, fig)
        assert fig["restored_bytes"] == 3 * stage_bytes, (r, fig)
    # its step, written whole by rank 0, restores on one process bit for bit
    # and is one process's step
    saved = torch.load(tmp_path / "from_one" / "checkpoints" / "ckpt_2.pt", weights_only=True)
    assert {p: tuple(t.shape) for p, t in saved["params"].items()} == {
        "/".join(p): s for p, s in shapes.items()}
    back = Trainer(OPT, model.init, _loss(model), str(tmp_path / "from_one"),
                   model.cfg.total_seq_len, "cpu")
    state = back.restore(back.init_state(torch.Generator().manual_seed(7)))
    assert state["step"] == 2
    for p, t in named_leaves(state["params"]):
        assert torch.equal(t.detach(), saved["params"]["/".join(p)]), p
    moments = state["opt"].state_dict()["adamw"]["state"]
    for i, st in saved["opt_state"]["adamw"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(moments[i][k], st[k]), (i, k)
    back.close()
    ref = Trainer(OPT, model.init, _loss(model), str(tmp_path / "from_one_again"),
                  model.cfg.total_seq_len, "cpu")
    state = ref.init_state(torch.Generator().manual_seed(4))
    for step in (1, 2):
        state, _ = ref.train_step(state, {"tokens": tokens}, torch.Generator().manual_seed(1))
    ref.close()
    for p, t in named_leaves(state["params"]):
        want = t.detach()
        torch.testing.assert_close(saved["params"]["/".join(p)], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()) + 1e-3 * OPT["lr"],
                                   msg=str(p))


def test_train_dalle_on_pipe2_model2(tmp_path, monkeypatch):
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_task
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params

    monkeypatch.chdir(tmp_path)
    unbroken_cfg = _train_config(tmp_path, "unbroken", train_steps=4, **PPTP_RUN)
    unbroken, first, second = torchrun(4, "train", [
        {"argv": _argv(unbroken_cfg), "gathered": True},
        {"argv": _argv(_train_config(tmp_path, "split", train_steps=2, **PPTP_RUN))},
        {"argv": _argv(_train_config(tmp_path, "split", train_steps=4, **PPTP_RUN))},
    ], tmp_path, timeout=400)

    def logged(history):
        return [{k: v for k, v in h.items() if k != "steps_per_sec"} for h in history]

    assert [h["step"] for h in unbroken["history"]] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) for h in unbroken["history"])
    assert logged(first["history"] + second["history"]) == logged(unbroken["history"])
    assert first["eval_history"] + second["eval_history"] == unbroken["eval_history"]
    saved = _ckpt(tmp_path, "unbroken", 4)
    for name, want in saved["params"].items():
        assert torch.equal(_ckpt(tmp_path, "split", 4)["params"][name], want), name
    # one process restores the whole tree: the ranks' blocks, gathered
    assert set(saved["params"]) == set(unbroken["params"])
    params = fetch_model_params(unbroken_cfg)
    dalle, _, init_fn, loss_fn, _ = make_dalle_task(params, "cpu")
    one = Trainer(params, init_fn, loss_fn, params["model_path"], dalle.cfg.total_seq_len, "cpu")
    state = one.restore(one.init_state(torch.Generator().manual_seed(5)))
    assert state["step"] == 4
    for p, t in named_leaves(state["params"]):
        assert torch.equal(t.detach(), unbroken["params"]["/".join(p)]), p
    assert saved["params"]["layers/wq"].shape == (4, 32, 2, 16)  # the whole stack, all heads
    moments = state["opt"].state_dict()["adamw"]["state"]
    for i, st in saved["opt_state"]["adamw"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(moments[i][k], st[k]), (i, k)
    one.close()
