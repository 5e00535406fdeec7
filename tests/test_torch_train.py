"""The port's training slice against the JAX package, on the CPU at tiny
shapes: the precision policy, the model's loss and every parameter grad
against ``DALLE.loss``, the optimizer against the optax chain, the
tokens-mode input pipeline against the JAX pipeline on the same tfrecords,
and the trainer (checkpoint, resume, eval, microbatches) through
``train_dalle.main``.

Tolerances, each with its reason:
- fp32 loss atol 1e-5 and grads within 1e-4 of each leaf's largest |grad|:
  the same math, summed in another order.
- bf16 loss atol 2e-2; grads within relative L2 error 0.1 of JAX's, and no
  further from the fp32 grads than 1.25x JAX's bf16 grads are: at this init
  both packages' bf16 layer grads lie 3-7% (L2) from the fp32 ones, and the
  two round bf16 at different points (JAX's CPU attention normalizes before
  the bf16 cast, the port's plain attention after it, as the TPU kernel does).
- optimizer updates within 1e-6 of the largest |param| (float32 rounding of
  the same arithmetic in another order).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu.train import optim as joptim
from dalle_mtf_tpu.utils import precision as jprecision
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.train import optim as toptim
from dalle_mtf_tpu_torch.utils import convert
from dalle_mtf_tpu_torch.utils import precision as tprecision

GOLDEN_CFG = dict(  # tests/test_loss_golden.py's CFG
    n_embd=64, text_vocab_size=48, image_vocab_size=32,
    text_seq_len=8, image_seq_len=16, n_layers=2, n_heads=2,
)
BF16_CFG = dict(
    n_embd=256, text_vocab_size=40, image_vocab_size=32, text_seq_len=8,
    image_seq_len=16, n_layers=2, n_heads=2, bf_16=True,
)


def _flat(tree, prefix=""):
    return dict(convert._flatten(tree, prefix))


def test_precision_policy_matches_jax():
    for bf16 in (False, True):
        want, got = jprecision.get_policy(bf16), tprecision.get_policy(bf16)
        for role in ("master_dtype", "compute_dtype", "output_dtype"):
            assert str(getattr(got, role)).split(".")[-1] == jnp.dtype(
                getattr(want, role)).name, (bf16, role)


def _loss_and_grads(kw, window=None, z_loss=0.0, batch=4, seed=0, **over):
    if window:
        over.update(attention_type="local", local_attention_radius=window)
    jm = jdalle.DALLE(jdalle.DalleConfig(**kw, **over))
    tm = tdalle.DALLE(tdalle.DalleConfig(**kw, **over), "cpu")
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    tokens = np.random.default_rng(seed + 1).integers(
        0, jm.cfg.total_tokens, (batch, jm.cfg.total_seq_len))
    (jloss, jbatch), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(tokens, jnp.int32), train=True, z_loss=z_loss),
        has_aux=True)(jparams)
    tparams = convert.dalle_params_from_numpy(jparams, tm)
    for t in _flat(tparams).values():
        t.requires_grad_(True)
    tloss, tbatch = tm.loss(tparams, torch.from_numpy(tokens), train=True, z_loss=z_loss)
    tloss.backward()
    return (float(jloss), np.asarray(jbatch), _flat(jax.device_get(jgrads)),
            tloss.item(), tbatch.detach().numpy(), _flat(convert.grads_to_numpy(tparams)))


@pytest.mark.parametrize("window,z_loss,packed,ln_impl", [
    pytest.param(None, 0.0, True, "xla", id="None-0.0-True"),
    pytest.param(5, 1e-4, True, "xla", id="5-0.0001-True"),
    pytest.param(None, 0.0, False, "xla", id="None-0.0-False"),
    pytest.param(None, 0.0, False, "pallas", id="None-0.0-False-pallas"),
])
def test_loss_and_grads_match_jax_fp32(window, z_loss, packed, ln_impl):
    """The JAX tree converts unchanged under every arm (ln_impl "pallas"
    keeps the LN parameters' names) and gives the same loss and grads."""
    jl, jb, jg, tl, tb, tg = _loss_and_grads(GOLDEN_CFG, window, z_loss, attn_packed=packed,
                                             ln_impl=ln_impl)
    assert abs(tl - jl) <= 1e-5 and abs(jl - math.log(81)) < 0.1
    np.testing.assert_allclose(tb, jb, atol=1e-5)
    assert set(tg) == set(jg)
    for name, want in jg.items():
        scale = np.abs(want).max()
        np.testing.assert_allclose(tg[name], want, atol=1e-4 * scale + 1e-9, err_msg=name)


def test_loss_and_grads_match_jax_bf16():
    _check_bf16_against_jax(BF16_CFG)


def test_loss_and_grads_match_jax_bf16_unpacked_pallas_ln():
    """The [B, H, S, D] attention arm with the fused LN, in bf16."""
    _check_bf16_against_jax({**BF16_CFG, "attn_packed": False, "ln_impl": "pallas"})


def _check_bf16_against_jax(cfg):
    jl, _, jg, tl, _, tg = _loss_and_grads(cfg)
    *_, exact = _loss_and_grads({**cfg, "bf_16": False})
    assert abs(tl - jl) <= 2e-2

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    for name, want in jg.items():
        assert rel(tg[name], want) <= 0.1, name
        assert rel(tg[name], exact[name]) <= 1.25 * rel(want, exact[name]) + 1e-3, name


def test_dropouts_follow_the_generator():
    """Embedding, residual and attention-weight dropout in train mode: the
    same generator seed gives the same loss, another seed another loss, and
    eval mode drops nothing (JAX's masks come from jax.random, so the two
    packages cannot share them)."""
    cfg = tdalle.DalleConfig(**GOLDEN_CFG, embed_dropout=0.2, residual_dropout=0.2,
                             attention_dropout=0.2)
    tm = tdalle.DALLE(cfg, "cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.total_tokens, (2, cfg.total_seq_len),
                           generator=torch.Generator().manual_seed(1))

    def loss(seed, train=True):
        gen = torch.Generator().manual_seed(seed)
        return tm.loss(params, tokens, gen, train=train)[0].item()

    assert loss(3) == loss(3) and loss(3) != loss(4)
    plain = tdalle.DALLE(tdalle.DalleConfig(**GOLDEN_CFG), "cpu")
    assert loss(3, train=False) == plain.loss(params, tokens, train=False)[0].item()


def test_forward_logits_match_jax():
    jm = jdalle.DALLE(jdalle.DalleConfig(**GOLDEN_CFG))
    tm = tdalle.DALLE(tdalle.DalleConfig(**GOLDEN_CFG), "cpu")
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    tokens = np.random.default_rng(4).integers(0, 81, (2, 24))
    want = jm.forward(jparams, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got = tm.forward(convert.dalle_params_from_numpy(jparams, tm), torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(
        tm.shifted_labels(torch.from_numpy(tokens)).numpy(),
        np.asarray(jm.shifted_labels(jnp.asarray(tokens))))


# ----------------------------------------------------------------- optimizer

OPT_TREE_SHAPES = {
    "wte": (6, 4), "lnf_g": (4,), "b_out": (6,),
    "layers": {"wq": (2, 4, 2, 2), "ln1_b": (2, 4), "o_b": (2, 4), "b_mlp1": (2, 8)},
}


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {k: ({n: rng.standard_normal(s).astype(np.float32) for n, s in v.items()}
                if isinstance(v, dict) else rng.standard_normal(v).astype(np.float32))
            for k, v in OPT_TREE_SHAPES.items()}


@pytest.mark.parametrize("fused", [False, True])
def test_optimizer_steps_match_optax(fused):
    """5 updates on identical grads: the zero first step under warmup, the
    decay mask, the clip (grads scaled up on alternate steps to cross it)."""
    cfg = {"lr": 0.05, "warmup_steps": 2, "train_steps": 10, "weight_decay": 0.1,
           "fused_optimizer": fused}
    jtx, _ = joptim.get_optimizer(cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, _opt_tree(0))
    jstate = jtx.init(jparams)
    tparams = convert._to_torch(_opt_tree(0), "cpu")
    for t in _flat(tparams).values():
        t.requires_grad_(True)
    topt, _ = toptim.get_optimizer(cfg, tparams)
    for step in range(5):
        grads = _opt_tree(100 + step)
        if step % 2:
            grads = jax.tree_util.tree_map(lambda g: g * 10.0, grads)
        updates, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, t in _flat(tparams).items():
            t.grad = torch.from_numpy(_flat(grads)[name].copy())
        norm = topt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for name, want in _flat(jax.device_get(jparams)).items():
            got = _flat(tparams)[name].detach().numpy()
            np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"step {step} {name}")
            if step == 0:  # lr(0) = 0 under warmup: nothing moves
                np.testing.assert_array_equal(got, _flat(_opt_tree(0))[name])
    moments = convert.adam_state_to_numpy(topt)
    assert moments["count"] == 5


def test_schedule_and_decay_mask_match_jax():
    for cfg in ({"lr": 1e-3, "warmup_steps": 10, "train_steps": 50},
                {"lr": 1e-3, "warmup_steps": 0, "lr_decay": "linear", "lr_decay_end": 30},
                {"lr": 2e-4, "lr_decay": "constant", "warmup_steps": 5}):
        want, got = joptim.lr_schedule(cfg), toptim.lr_schedule(cfg)
        for step in (0, 1, 5, 9, 10, 11, 29, 30, 49, 50, 80):
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    tree = tdalle.DALLE(tdalle.DalleConfig(**GOLDEN_CFG), "cpu").param_shapes()
    jtree = jax.tree_util.tree_map(lambda s: np.zeros(s), tree, is_leaf=lambda x: isinstance(x, tuple))
    assert _flat(toptim.decay_mask(tree)) == _flat(joptim.decay_mask(jtree))


def test_adam_state_round_trip():
    tparams = convert._to_torch(_opt_tree(0), "cpu")
    for t in _flat(tparams).values():
        t.grad = torch.ones_like(t)
    topt, _ = toptim.get_optimizer({"lr": 0.1, "warmup_steps": 0}, tparams)
    topt.step()
    state = convert.adam_state_to_numpy(topt)
    other, _ = toptim.get_optimizer({"lr": 0.1, "warmup_steps": 0},
                                    convert._to_torch(_opt_tree(0), "cpu"))
    convert.adam_state_from_numpy(other, state)
    again = convert.adam_state_to_numpy(other)
    assert again["count"] == 1
    for key in ("mu", "nu"):
        for name, v in _flat(state[key]).items():
            np.testing.assert_array_equal(_flat(again[key])[name], v)


def test_unported_options_are_refused(tmp_path, monkeypatch):
    base = {"n_embd": 64, "text_vocab_size": 48, "image_vocab_size": 32,
            "text_seq_len": 8, "n_layers": 1, "n_heads": 2}
    # pipeline parallelism is ported (tests/test_torch_pp_dalle.py): the pipe
    # axis and the microbatches come from the layout, as in JAX
    piped = tdalle.DalleConfig.from_params(
        {**base, "layout": "batch_dim:data,layers:pipe", "pipeline_microbatches": 4}, 16)
    assert (piped.pipe_axis, piped.pipeline_microbatches) == ("pipe", 4)
    assert tdalle.DalleConfig.from_params(base, 16).pipe_axis is None
    # remat policies that take arguments are no policy by their name alone
    with pytest.raises(ValueError):
        tdalle.DalleConfig.from_params(
            {**base, "recompute_grad": True, "remat_policy": "save_only_these_names"}, 16)
    # the memory-bound options are ported (tests/test_torch_remat.py,
    # tests/test_torch_xent_fused.py, tests/test_torch_optim_extras.py)
    for ok in ({"fused_xent": True}, {"recompute_grad": True},
               {"recompute_grad": True, "remat_policy": "save_attn"}):
        tdalle.DalleConfig.from_params({**base, **ok}, 16)
    # ring attention is ported; its axes come from the layout, as in JAX
    ring = tdalle.DalleConfig.from_params(
        {**base, "attention_type": "local_ring",
         "layout": "batch_dim:dp,total_seq_dim:sp,heads_dim:model"}, 16)
    assert (ring.ring_seq_axis, ring.ring_batch_axis, ring.ring_heads_axis) == ("sp", "dp", "model")
    ok = tdalle.DalleConfig.from_params(
        {**base, "recompute_grad": True, "remat_policy": "dots_and_attn",
         "scan_unroll": "full"}, 16)
    assert ok.remat_policy == "dots_and_attn"
    assert tdalle.DalleConfig.from_params({**base, "ln_impl": "pallas"}, 16).ln_impl == "pallas"
    tree = {"w": torch.zeros(2, requires_grad=True)}
    for ok in ({"optimizer": "adafactor"}, {"skip_nonfinite_updates": 3}):
        toptim.get_optimizer({"lr": 1e-3, **ok}, tree)
    with pytest.raises(ValueError, match="not recognized"):
        toptim.get_optimizer({"lr": 1e-3, "optimizer": "sgd"}, tree)
    from dalle_mtf_tpu_torch.data import fs

    # remote paths are ported (tests/test_torch_data_remote.py, offline
    # through memory://)
    assert fs.list_files("memory://unported-options-empty/*.tfrecords") == []
    from dalle_mtf_tpu_torch import train_dalle

    # predict_steps is ported (tests/test_torch_predict.py); a layers:pipe
    # config trains on one process, its mesh resized to one rank (over ranks:
    # tests/test_torch_pp_train.py)
    monkeypatch.chdir(tmp_path)
    run = train_dalle.main(["--model", _train_config(
        tmp_path, layout="batch_dim:data,layers:pipe", mesh_shape="pipe:2,data:2"),
        "--device", "cpu"])
    assert [h["step"] for h in run.history] == [1, 2, 3, 4]
    assert run.mesh is None and all(np.isfinite(h["loss"]) for h in run.history)


# ------------------------------------------------------ pipeline and trainer

N_FILES, PER_FILE = 3, 11
TEXT_LEN, IMAGE_LEN = 8, 16


def _write_tokens_dataset(root, tfrecord_mod, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for f in range(N_FILES):
        with tfrecord_mod.TFRecordWriter(os.path.join(root, f"shard_{f}.tfrecords")) as w:
            for _ in range(PER_FILE):
                w.write(tfrecord_mod.serialize_example({
                    "tokens": rng.integers(0, 32, IMAGE_LEN).tolist(),
                    "caption": rng.integers(0, 256, rng.integers(3, 12)).tolist(),
                }))
    return os.path.join(root, "*.tfrecords")


def _data_params(pattern, batch=4):
    from dalle_mtf_tpu_torch.utils.config import Config

    return Config.from_mapping({
        "dataset": {"train_path": pattern, "eval_path": pattern, "tokens": True},
        "train_batch_size": batch, "eval_batch_size": batch,
        "text_seq_len": TEXT_LEN, "padding_id": 50257,
    })


@pytest.mark.parametrize("skip_steps", [0, 3])
def test_tokens_pipeline_matches_jax(tmp_path, skip_steps):
    from dalle_mtf_tpu.data import pipeline as jpipe
    from dalle_mtf_tpu_torch.data import pipeline as tpipe
    from dalle_mtf_tpu_torch.data import tfrecord as ttfr

    params = _data_params(_write_tokens_dataset(str(tmp_path), ttfr))
    for eval_ in (False, True):
        want = iter(jpipe.dalle_input_fn(params, eval=eval_, shard=(0, 1),
                                         skip_steps=skip_steps))
        got = iter(tpipe.dalle_input_fn(params, eval=eval_, skip_steps=skip_steps))
        for _ in range(12):  # past one pass over the 33 records: the repeat too
            w, g = next(want), next(got)
            assert set(g) == {"tokens", "caption"}
            for k in g:
                assert g[k].dtype == np.int32
                np.testing.assert_array_equal(g[k], w[k])


def _train_config(tmp_path, **over):
    from dalle_mtf_tpu_torch.data import tfrecord as ttfr

    pattern = _write_tokens_dataset(str(tmp_path / "data"), ttfr)
    vae = {"model_type": "vae", "dataset": {"image_size": 16}, "num_tokens": 32,
           "convblocks": [[1, 8], [1, 16]]}
    (tmp_path / "vae.json").write_text(json.dumps(vae))
    cfg = {
        "model_type": "dalle", "vae_model": str(tmp_path / "vae.json"),
        "dataset": {"train_path": pattern, "eval_path": pattern, "tokens": True},
        "n_embd": 32, "text_vocab_size": 50258, "image_vocab_size": 32,
        "text_seq_len": TEXT_LEN, "n_layers": 2, "n_heads": 2,
        "train_batch_size": 4, "eval_batch_size": 4, "train_steps": 4,
        "steps_per_checkpoint": 2, "eval_steps": 1, "log_every": 1, "max_to_keep": 1,
        # lr_decay_end fixes the schedule whatever train_steps a run stops at
        "lr": 1e-3, "warmup_steps": 1, "lr_decay_end": 4, "attention_dropout": 0.1,
        "model_path": str(tmp_path / "run"),
        **over,
    }
    path = tmp_path / "dalle_tokens.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _params_of(model_path):
    obj = torch.load(os.path.join(model_path, "checkpoints", "ckpt_4.pt"),
                     weights_only=True)
    return obj["params"]


def test_trainer_resume_equals_unbroken_run(tmp_path, monkeypatch):
    """4 steps in one run == 2 steps, a restore, then 2 more (data resume,
    optimizer state and the attention-dropout seeds included)."""
    from dalle_mtf_tpu_torch import train_dalle

    monkeypatch.chdir(tmp_path)
    path = _train_config(tmp_path)
    unbroken = train_dalle.main(["--model", path, "--device", "cpu"])
    assert [h["step"] for h in unbroken.history] == [1, 2, 3, 4]
    assert [e["step"] for e in unbroken.eval_history] == [2, 4]
    assert set(unbroken.eval_history[0]) >= {"eval_loss", "eval_acc", "eval_acc_image",
                                             "eval_loss_text", "eval_loss_image"}
    first = unbroken.history[0]
    assert abs(first["loss"] - math.log(50258 + 32 + 1)) < 0.1 and first["lr"] == 0.0
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in unbroken.history)
    assert unbroken.checkpoint_steps() == [4]  # max_to_keep 1
    want = _params_of(str(tmp_path / "run"))

    path = _train_config(tmp_path, train_steps=2, model_path=str(tmp_path / "run2"))
    train_dalle.main(["--model", path, "--device", "cpu"])
    cfg = json.loads(open(path).read())
    cfg["train_steps"] = 4
    open(path, "w").write(json.dumps(cfg))
    resumed = train_dalle.main(["--model", path, "--device", "cpu"])
    assert [h["step"] for h in resumed.history] == [3, 4]
    got = _params_of(str(tmp_path / "run2"))
    assert set(got) == set(want)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0, msg=name)

    # --new --yes starts afresh
    again = train_dalle.main(["--model", path, "--new", "--yes", "--device", "cpu"])
    assert [h["step"] for h in again.history] == [1, 2, 3, 4]


def test_train_cli_refuses_the_cpu_unless_asked(tmp_path, monkeypatch):
    """With no CUDA device, ``main`` without ``--device cpu`` raises before
    it trains: the entry point never falls back to the CPU."""
    from dalle_mtf_tpu_torch import train_dalle

    if torch.cuda.is_available():
        pytest.skip("pins the refusal on a machine without a CUDA device")
    monkeypatch.chdir(tmp_path)
    path = _train_config(tmp_path)
    for extra in ([], ["--device", "cuda"], ["--gpu_ids", "0"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_dalle.main(["--model", path, *extra])
    assert not (tmp_path / "run").exists()


def test_microbatches_average_like_one_batch(tmp_path):
    """Two microbatches (minor-stride split) give the full batch's update."""
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_task
    from dalle_mtf_tpu_torch.train.trainer import Trainer, num_microbatches, step_generator
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params

    params = fetch_model_params(_train_config(tmp_path, attention_dropout=0.0))
    assert num_microbatches({"tokens_per_mb_per_replica": 48}, 4, 24, 1) == 2
    states = []
    for mb in (None, 48):
        params["tokens_per_mb_per_replica"] = mb
        dalle, _vae, init_fn, loss_fn, _ = make_dalle_task(params, "cpu")
        trainer = Trainer(params, init_fn, loss_fn, str(tmp_path / "mb"), 24, "cpu")
        assert trainer.num_mb == (2 if mb else 1)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        batch = {"tokens": np.random.default_rng(0).integers(0, 32, (4, 16)),
                 "caption": np.random.default_rng(1).integers(0, 256, (4, 8))}
        for step in range(2):
            state, metrics = trainer.train_step(state, batch, step_generator(0, 1, step))
        states.append((state, metrics))
    (a, ma), (b, mb_) = states
    np.testing.assert_allclose(float(mb_["loss"]), float(ma["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(mb_["grad_norm"]), float(ma["grad_norm"]), rtol=1e-4)
    for (name, x), (_, y) in zip(convert._flatten(a["params"]), convert._flatten(b["params"])):
        torch.testing.assert_close(y, x, rtol=1e-4, atol=1e-6, msg=name)


def test_metrics_writer_writes_tensorboard_events(tmp_path):
    from tensorboard.compat.proto import event_pb2

    from dalle_mtf_tpu_torch.data.tfrecord import read_tfrecord_file
    from dalle_mtf_tpu_torch.utils.summaries import MetricsWriter

    w = MetricsWriter(str(tmp_path))
    w.scalars(3, {"loss": 1.5, "lr": 0.25})
    w.scalars(4, {"loss": 1.25})
    w.close()
    (name,) = os.listdir(tmp_path)
    events = [event_pb2.Event.FromString(r)
              for r in read_tfrecord_file(str(tmp_path / name), verify_crc=True)]
    assert events[0].file_version == "brain.Event:2"
    got = [(e.step, v.tag, v.simple_value) for e in events[1:] for v in e.summary.value]
    assert got == [(3, "loss", 1.5), (3, "lr", 0.25), (4, "loss", 1.25)]
