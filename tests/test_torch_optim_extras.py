"""The port's Adafactor and ``skip_nonfinite_updates``
(dalle_mtf_tpu_torch/train/optim.py) against the optax chains that the JAX
package's ``get_optimizer`` builds, on the CPU:

- Adafactor for 5 steps on factored, unfactored and stacked [L, E, H, D]
  leaves (one with tied largest axes, one with an RMS under the 1e-3 floor),
  through the zero first step under warmup and the global clip;
- ``skip_nonfinite_updates`` around AdamW, fused AdamW and Adafactor against
  ``optax.apply_if_finite``: a skip, the reset, N + 1 in a row applied, and a
  resume from a state saved in the middle of a streak;
- each optimizer's state round-trips and refuses the other's;
- ``train_dalle.main --device cpu`` with the fused head, Adafactor and the
  skip wrapper end to end with eval, checkpoint and resume, and a trainer
  step whose loss is NaN: nothing moves, and it is logged as JAX logs it
  (a NaN loss and grad norm, the step's learning rate).

Tolerance: updates within 1e-6 of each leaf's largest |param| (float32
rounding of the same arithmetic in another order), as tests/test_torch_train.py.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_mtf_tpu.train import optim as joptim
from dalle_mtf_tpu_torch.train import optim as toptim
from dalle_mtf_tpu_torch.utils import convert

SHAPES = {
    "wte": (160, 130), "lnf_g": (130,), "b_out": (6,),
    "layers": {"wq": (2, 128, 2, 128), "w_mlp1": (2, 130, 4, 129), "b_mlp1": (2, 8)},
}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def leaf(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    tree = {k: ({n: leaf(s) for n, s in v.items()} if isinstance(v, dict) else leaf(v))
            for k, v in SHAPES.items()}
    return tree


def _params0():
    tree = _tree(0)
    tree["b_out"] *= 1e-4  # RMS under Adafactor's 1e-3 parameter-scale floor
    return tree


def _flat(tree):
    return dict(convert._flatten(tree, ""))


def _grads(step, nan_steps=()):
    grads = _tree(100 + step, 10.0 if step % 2 else 0.1)  # crosses the clip
    if step in nan_steps:
        grads["layers"]["wq"][1, 3, 0, 7] = np.nan if step % 2 else np.inf
    return grads


class _Pair:
    """One config's optax chain and port optimizer on the same tree."""

    def __init__(self, cfg, params=None):
        params = _params0() if params is None else params
        self.jtx, _ = joptim.get_optimizer(cfg)
        self.jupdate = jax.jit(self._jax_step)
        self.jparams = jax.tree_util.tree_map(jnp.asarray, params)
        self.jstate = self.jtx.init(self.jparams)
        self.tparams = convert._to_torch(params, "cpu")
        for t in _flat(self.tparams).values():
            t.requires_grad_(True)
        self.topt, _ = toptim.get_optimizer(cfg, self.tparams)

    def _jax_step(self, grads, state, params):
        updates, state = self.jtx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    def step(self, grads):
        self.jparams, self.jstate = self.jupdate(
            jax.tree_util.tree_map(jnp.asarray, grads), self.jstate, self.jparams)
        for name, t in _flat(self.tparams).items():
            t.grad = torch.from_numpy(_flat(grads)[name].copy())
        return self.topt.step()

    def check(self, label):
        for name, want in _flat(jax.device_get(self.jparams)).items():
            got = _flat(self.tparams)[name].detach().numpy()
            scale = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 1.0
            np.testing.assert_allclose(got, want, atol=1e-6 * scale, rtol=0,
                                       err_msg=f"{label} {name}")


ADAFACTOR = {"lr": 0.05, "warmup_steps": 2, "train_steps": 10, "optimizer": "adafactor",
             "gradient_clipping": 5.0, "weight_decay": 0.01}


def test_adafactor_steps_match_optax():
    pair = _Pair(ADAFACTOR)
    dims = dict(zip(["/".join(p) for p, _ in pair.topt.named], pair.topt.dims))
    # w_mlp1 [2, 130, 4, 129] factors over 129 and 130; wq's tie in
    # numpy's argsort order
    assert dims == {"wte": (1, 0), "lnf_g": None, "b_out": None, "layers/wq": (1, 3),
                    "layers/w_mlp1": (3, 1), "layers/b_mlp1": None}
    for step in range(5):
        norm = pair.step(_grads(step))
        np.testing.assert_allclose(float(norm), float(optax.global_norm(_grads(step))),
                                   rtol=1e-6)
        pair.check(f"step {step}")
        if step == 0:  # lr(0) = 0 under warmup: nothing moves
            for name, want in _flat(_params0()).items():
                np.testing.assert_array_equal(_flat(pair.tparams)[name].detach().numpy(), want)
    assert pair.topt.count == 5


def _skip_state(state):
    """optax's ApplyIfFiniteState fields, found in the chain's state."""
    return (int(state.notfinite_count), bool(state.last_finite), int(state.total_notfinite))


SKIP_CONFIGS = {
    "adamw": {"lr": 0.05, "warmup_steps": 1, "train_steps": 10, "weight_decay": 0.1},
    "fused_adamw": {"lr": 0.05, "warmup_steps": 1, "train_steps": 10, "weight_decay": 0.1,
                    "fused_optimizer": True},
    "adafactor": {**ADAFACTOR, "warmup_steps": 1},
}
# steps 1, 3, 4 and 5 are not finite: a skip, a reset, then a streak whose
# third step (N = 2) is applied
NAN_STEPS = (1, 3, 4, 5)


def _skip_pair(kind, params=None):
    """AdamW's parameters start at unit scale, as in tests/test_torch_train.py:
    optax takes AdamW's bias correction 1 - b2^t in fp32, torch in fp64,
    which moves a first update by ~1e-5 of itself where |g| is near eps."""
    cfg = {**SKIP_CONFIGS[kind], "skip_nonfinite_updates": 2}
    if params is None and kind != "adafactor":
        params = _tree(0)
    return _Pair(cfg, params)


@pytest.mark.parametrize("kind", list(SKIP_CONFIGS))
def test_skip_nonfinite_matches_apply_if_finite(kind):
    pair = _skip_pair(kind)
    applied = 0
    for step in range(6):
        before = {n: t.detach().clone() for n, t in _flat(pair.tparams).items()}
        pair.step(_grads(step, NAN_STEPS))
        topt = pair.topt
        assert (topt.notfinite_count, topt.last_finite, topt.total_notfinite) == \
            _skip_state(pair.jstate), step
        skipped = step in NAN_STEPS and topt.notfinite_count <= 2
        applied += not skipped
        assert topt.count == applied, step
        if skipped:
            for name, t in _flat(pair.tparams).items():
                assert torch.equal(t.detach(), before[name]), (step, name)
        pair.check(f"step {step}")
    assert applied == 3 and pair.topt.total_notfinite == 4
    assert np.isnan(_flat(pair.tparams)["layers/wq"].detach().numpy()).any()  # the applied NaN


@pytest.mark.parametrize("kind", list(SKIP_CONFIGS))
def test_skip_state_resumes_in_the_middle_of_a_streak(kind):
    """A state saved after steps 3 and 4 (two non-finite in a row) and
    loaded into a fresh optimizer continues as the unbroken one does: step
    5's NaN is the third in a row and is applied."""
    unbroken = _skip_pair(kind)
    for step in range(5):
        unbroken.step(_grads(step, NAN_STEPS))
    assert unbroken.topt.notfinite_count == 2
    state = unbroken.topt.state_dict()
    params = {k: ({n: t.detach().numpy().copy() for n, t in v.items()} if isinstance(v, dict)
                  else v.detach().numpy().copy()) for k, v in unbroken.tparams.items()}
    resumed = _skip_pair(kind, params)
    resumed.topt.load_state_dict(state)
    for pair in (unbroken, resumed):
        pair.step(_grads(5, NAN_STEPS))
    assert (resumed.topt.notfinite_count, resumed.topt.count) == (3, unbroken.topt.count)
    for name, t in _flat(unbroken.tparams).items():
        np.testing.assert_array_equal(_flat(resumed.tparams)[name].detach().numpy(),
                                      t.detach().numpy(), err_msg=name)


def test_optimizer_states_round_trip_and_refuse_each_other():
    def make(cfg):
        tree = convert._to_torch(_params0(), "cpu")
        for t in _flat(tree).values():
            t.grad = torch.ones_like(t)
        return toptim.get_optimizer({"lr": 0.1, "warmup_steps": 0, **cfg}, tree)[0]

    kinds = {"adamw": {}, "adafactor": {"optimizer": "adafactor"},
             "skip": {"optimizer": "adafactor", "skip_nonfinite_updates": 3}}
    states = {}
    for kind, cfg in kinds.items():
        opt = make(cfg)
        opt.step()
        states[kind] = opt.state_dict()
        other = make(cfg)
        other.load_state_dict(states[kind])
        assert other.count == 1
        if kind != "adamw":
            inner = other.inner if kind == "skip" else other
            want = opt.inner if kind == "skip" else opt
            for a, b in zip(inner.v, want.v):
                for x, y in zip(a if isinstance(a, tuple) else (a,),
                                b if isinstance(b, tuple) else (b,)):
                    assert torch.equal(x, y)
    for kind, cfg in kinds.items():
        for other_kind, state in states.items():
            if other_kind != kind:
                with pytest.raises(ValueError, match="load_state_dict"):
                    make(cfg).load_state_dict(state)


# --------------------------------------------------------------- end to end

def _train_config(tmp_path, **over):
    """tests/test_torch_train.py's tiny tokens-mode config with the fused
    head, Adafactor under the skip wrapper and a remat policy."""
    from dalle_mtf_tpu_torch.data import tfrecord

    root = tmp_path / "data"
    if not root.exists():
        root.mkdir()
        rng = np.random.default_rng(0)
        for f in range(3):
            with tfrecord.TFRecordWriter(str(root / f"shard_{f}.tfrecords")) as w:
                for _ in range(11):
                    w.write(tfrecord.serialize_example({
                        "tokens": rng.integers(0, 32, 16).tolist(),
                        "caption": rng.integers(0, 256, rng.integers(3, 12)).tolist(),
                    }))
        (tmp_path / "vae.json").write_text(json.dumps({
            "model_type": "vae", "dataset": {"image_size": 16}, "num_tokens": 32,
            "convblocks": [[1, 8], [1, 16]]}))
    pattern = str(root / "*.tfrecords")
    cfg = {
        "model_type": "dalle", "vae_model": str(tmp_path / "vae.json"),
        "dataset": {"train_path": pattern, "eval_path": pattern, "tokens": True},
        "n_embd": 32, "text_vocab_size": 50258, "image_vocab_size": 32, "text_seq_len": 8,
        "n_layers": 2, "n_heads": 2, "train_batch_size": 4, "eval_batch_size": 4,
        "train_steps": 4, "steps_per_checkpoint": 2, "eval_steps": 1, "log_every": 1,
        "max_to_keep": 1, "lr": 1e-3, "warmup_steps": 1, "lr_decay_end": 4,
        "attention_dropout": 0.1, "residual_dropout": 0.1, "model_path": str(tmp_path / "run"),
        "fused_xent": True, "xent_chunks": 4, "optimizer": "adafactor",
        "skip_nonfinite_updates": 3, "recompute_grad": True, "remat_policy": "save_attn_lean",
        "z_loss": 1e-4, **over,
    }
    path = tmp_path / "dalle_lean.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _ckpt(model_path):
    return torch.load(model_path / "checkpoints" / "ckpt_4.pt", weights_only=True)


def test_train_dalle_fused_adafactor_end_to_end(tmp_path, monkeypatch):
    """4 steps in one run == 2 steps, a restore, then 2 more, with the fused
    head, Adafactor under the skip wrapper and a remat policy; the eval's
    metrics are the dense path's schema."""
    from dalle_mtf_tpu_torch import train_dalle

    monkeypatch.chdir(tmp_path)
    path = _train_config(tmp_path)
    unbroken = train_dalle.main(["--model", path, "--device", "cpu"])
    assert [h["step"] for h in unbroken.history] == [1, 2, 3, 4]
    assert abs(unbroken.history[0]["loss"] - math.log(50258 + 32 + 1)) < 0.1
    assert all(np.isfinite(h["loss"]) for h in unbroken.history)
    assert set(unbroken.eval_history[0]) == {"step", "eval_loss", "eval_acc", "eval_acc_image",
                                             "eval_loss_text", "eval_loss_image"}
    want = _ckpt(tmp_path / "run")
    assert "apply_if_finite" in want["opt_state"]

    path = _train_config(tmp_path, train_steps=2, model_path=str(tmp_path / "run2"))
    train_dalle.main(["--model", path, "--device", "cpu"])
    cfg = json.loads(open(path).read())
    cfg["train_steps"] = 4
    open(path, "w").write(json.dumps(cfg))
    resumed = train_dalle.main(["--model", path, "--device", "cpu"])
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in unbroken.history[2:]]
    got = _ckpt(tmp_path / "run2")
    for name, t in want["params"].items():
        torch.testing.assert_close(got["params"][name], t, rtol=0, atol=0, msg=name)


def test_a_nonfinite_step_is_skipped_and_logged(tmp_path):
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_task
    from dalle_mtf_tpu_torch.train.trainer import Trainer, step_generator
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params

    params = fetch_model_params(_train_config(tmp_path))
    _dalle, _vae, init_fn, loss_fn, _ = make_dalle_task(params, "cpu")

    def poisoned(p, frozen, batch, gen, step):
        loss, aux = loss_fn(p, frozen, batch, gen, step)
        return (loss * float("nan") if step == 1 else loss), aux

    trainer = Trainer(params, init_fn, poisoned, str(tmp_path / "skip"), 24, "cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = {"tokens": np.random.default_rng(0).integers(0, 32, (4, 16)),
             "caption": np.random.default_rng(1).integers(0, 256, (4, 8))}
    seen = []
    for step in range(3):
        before = {n: t.detach().clone() for n, t in convert._flatten(state["params"])}
        state, metrics = trainer.train_step(state, batch, step_generator(0, 1, step))
        moved = any(not torch.equal(t.detach(), before[n])
                    for n, t in convert._flatten(state["params"]))
        seen.append((state["step"], state["opt"].count, moved,
                     math.isfinite(float(metrics["loss"])),
                     math.isfinite(float(metrics["grad_norm"])), float(metrics["lr"])))
    lr = trainer.schedule
    assert seen == [(1, 1, False, True, True, lr(0)),  # lr(0) = 0 under warmup
                    (2, 1, False, False, False, lr(1)),
                    (3, 2, True, True, True, lr(2))]
    assert state["opt"].total_notfinite == 1 and state["opt"].notfinite_count == 0
