"""Sequence-parallel DALLE training in the port against one process and
against the JAX package, on the CPU with 4 gloo ranks.

- One loss and its gradients on a ``data:1,seq:4`` and a ``data:2,seq:2``
  mesh (tests/torch_ring_worker.py under ``torch.distributed.run``, the
  ranks' shares summed) against the single-process port and JAX
  ``DALLE.loss`` under its own ring mesh (4 of the suite's fake CPU
  devices), on one numpy parameter tree; and with every dropout on against
  the single-process port (the masks are the single process's, sliced).
  Tolerance: loss 1e-5, each grad 1e-4 of its leaf's max (fp32 sums in
  another order), as tests/test_torch_train.py.
- ``train_dalle`` itself under ``torch.distributed.run --standalone`` with
  ``--device cpu``: rank 0 logs every step and writes one checkpoint
  (``max_to_keep`` 1), a resumed run continues it, and the result equals the
  single-process run (``data:1,seq:4``: the same rows) within 1e-5, or an
  unbroken 4-rank run bit for bit (``data:2,seq:2``).
- Layouts the port cannot honour raise at world size > 1; tensor-parallel
  and pipeline ones build a mesh, and tensor parallelism beside the ring's
  sequence axis (TP x SP) does, and so does PP beside TP (PP x SP raises).
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.parallel import mesh as tmesh
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.utils import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_ring_worker.py")
LAYOUT = "batch_dim:data,total_seq_dim:seq"
# tests/test_ring_dalle.py's _params model: S = 8 + 16 = 24, 6 positions a
# rank on seq:4
KW = dict(n_embd=64, text_vocab_size=40, image_vocab_size=32, text_seq_len=8,
          image_seq_len=16, n_layers=2, n_heads=4, attention_type="ring")


def _torchrun(args, cwd, timeout=300):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "4", *args]
    env = {**os.environ, "PYTHONPATH": ROOT}
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    return res.stdout + res.stderr


def _flat(tree):
    return {"/".join(p): t for p, t in named_leaves(tree)}


@pytest.mark.parametrize("mesh_shape,dropout", [("data:1,seq:4", False),
                                                ("data:2,seq:2", False),
                                                ("data:2,seq:2", True)])
def test_ring_step_matches_single_process_and_jax(tmp_path, mesh_shape, dropout):
    kw = dict(KW, **({"embed_dropout": 0.1, "residual_dropout": 0.1,
                      "attention_dropout": 0.1} if dropout else {}))
    jm = jdalle.DALLE(jdalle.DalleConfig(**kw))
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, jm.cfg.total_tokens,
                                               (8, jm.cfg.total_seq_len))
    tm = tdalle.DALLE(tdalle.DalleConfig(**kw), "cpu")
    params = convert.dalle_params_from_numpy(jparams, tm)
    torch.save({"config": kw, "mesh_shape": mesh_shape, "layout": LAYOUT, "params": params,
                "tokens": torch.from_numpy(tokens), "seed": 5}, tmp_path / "in.pt")
    _torchrun([WORKER, "dalle_step", str(tmp_path / "in.pt"), str(tmp_path)], ROOT)
    got = torch.load(tmp_path / "step.pt", weights_only=False)

    for t in _flat(params).values():
        t.requires_grad_(True)
    loss, _ = tm.loss(params, torch.from_numpy(tokens), torch.Generator().manual_seed(5))
    loss.backward()
    wants = [(loss.item(), {n: t.grad.numpy() for n, t in _flat(params).items()})]
    if not dropout:  # JAX's embedding and residual masks come from jax.random
        axes = tmesh.parse_mesh_shape(mesh_shape)
        mesh = JaxMesh(np.array(jax.devices()[:4]).reshape([n for _, n in axes]),
                       ("data", "seq"))
        with mesh:
            jl, jg = jax.jit(jax.value_and_grad(
                lambda p: jm.loss(p, jnp.asarray(tokens, jnp.int32), train=True)[0]))(jparams)
        wants.append((float(jl), dict(convert._flatten(jax.device_get(jg)))))
    for want_loss, want_grads in wants:
        assert abs(got["loss"].item() - want_loss) <= 1e-5
        assert set(got["grads"]) == set(want_grads)
        for name, want in want_grads.items():
            np.testing.assert_allclose(got["grads"][name].numpy(), want,
                                       atol=1e-4 * np.abs(want).max() + 1e-9, err_msg=name)


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
    pattern = str(root / "*.tfrecords")
    cfg = {
        "model_type": "dalle", "vae_model": str(tmp_path / "vae.json"),
        "dataset": {"train_path": pattern, "eval_path": pattern, "tokens": True},
        "n_embd": 32, "text_vocab_size": 50258, "image_vocab_size": 32, "text_seq_len": 8,
        "n_layers": 2, "n_heads": 2, "train_batch_size": 4, "eval_batch_size": 4,
        "train_steps": 3, "steps_per_checkpoint": 2, "eval_steps": 1, "log_every": 1,
        "max_to_keep": 1, "lr": 1e-3, "warmup_steps": 1, "lr_decay_end": 3,
        "attention_type": "ring", "attention_dropout": 0.1, "mesh_shape": "data:1,seq:4",
        "layout": LAYOUT, "model_path": str(tmp_path / name), **over,
    }
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _train(tmp_path, path):
    """train_dalle on 4 gloo ranks; returns rank 0's logged (step, loss)."""
    out = _torchrun(["-m", "dalle_mtf_tpu_torch.train_dalle", "--model", path,
                     "--device", "cpu"], tmp_path)
    return [(int(s), float(v)) for s, v in re.findall(r"step (\d+) loss ([0-9.]+)", out)]


def _final(tmp_path, name, step=3):
    ckpts = sorted(os.listdir(tmp_path / name / "checkpoints"))
    assert ckpts == [f"ckpt_{step}.pt"]  # max_to_keep 1, one writer
    return torch.load(tmp_path / name / "checkpoints" / ckpts[0], weights_only=True)["params"]


def test_train_dalle_seq4_resumes_and_equals_one_process(tmp_path, monkeypatch):
    from dalle_mtf_tpu_torch import train_dalle

    monkeypatch.chdir(tmp_path)
    one = train_dalle.main(["--model", _train_config(tmp_path, "one", mesh_shape="data:1"),
                            "--device", "cpu"])
    path = _train_config(tmp_path, "ring", train_steps=2)
    logged = _train(tmp_path, path)
    assert [s for s, _ in logged] == [1, 2]  # rank 0 alone logs
    assert os.listdir(tmp_path / "ring" / "checkpoints") == ["ckpt_2.pt"]
    path = _train_config(tmp_path, "ring")
    logged += _train(tmp_path, path)
    assert [s for s, _ in logged] == [1, 2, 3]
    for (_, loss), h in zip(logged, one.history):
        assert abs(loss - h["loss"]) <= 2e-5  # logged to 5 decimals
    got, want = _final(tmp_path, "ring"), _final(tmp_path, "one")
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=1e-5, msg=name)
    # one summary writer a run: rank 0's
    events = [f for f in os.listdir(tmp_path / "ring") if f.startswith("events.out")]
    assert len(events) == 2


def test_train_dalle_data2_seq2_resume_equals_unbroken_run(tmp_path):
    unbroken = _train(tmp_path, _train_config(tmp_path, "unbroken", mesh_shape="data:2,seq:2"))
    assert [s for s, _ in unbroken] == [1, 2, 3]
    assert all(np.isfinite(v) for _, v in unbroken)
    path = _train_config(tmp_path, "split", mesh_shape="data:2,seq:2", train_steps=2)
    split = _train(tmp_path, path)
    split += _train(tmp_path, _train_config(tmp_path, "split", mesh_shape="data:2,seq:2"))
    assert split == unbroken
    got, want = _final(tmp_path, "split"), _final(tmp_path, "unbroken")
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("mesh_shape,layout,kind", [
    ("data:2,model:2", "batch_dim:data,heads_dim:model", "tensor"),
    ("data:2,model:2", "batch_dim:data,intermediate_expanded:model", "tensor"),
    ("data:2,model:2", "batch_dim:data,vocab_dim:model", "tensor"),
    ("pipe:2,data:2", "batch_dim:data,layers:pipe", "pipe"),
    ("data:2,model:2", "batch_dim:data", "replicate"),  # an axis that only replicates
    ("data:1,seq:2,model:2", "batch_dim:data,total_seq_dim:seq,heads_dim:model", "tpsp"),
    ("pipe:2,model:2", "batch_dim:data,layers:pipe,heads_dim:model", "pptp"),
])
def test_tp_and_pp_layouts_raise_above_one_process(mesh_shape, layout, kind):
    """Tensor-parallel layouts build a mesh (a fake 4-rank process group)
    under global and ring attention; TP beside the ring's sequence axis
    (TP x SP) builds under ring attention, its sequence axis summed over
    (2 replicas) and its model group the copies of a replicated leaf, and
    raises under global attention (a sequence axis needs the ring); a
    pipeline layout builds a mesh with its pipe axis, 2 replicas and the
    rank's stage under global attention, and raises under ring attention
    (PP x SP); an axis that only replicates builds under either, with the
    batch axis's 2 replicas; PP beside TP (PP x TP) builds under global
    attention, its model group the copies of a replicated leaf, and raises
    under ring attention (PP x SP)."""
    from test_torch_tp_dalle import fake_world

    for attention in ("global", "ring"):
        if kind in ("replicate", "tensor") or (kind, attention) in (
                ("pipe", "global"), ("tpsp", "ring"), ("pptp", "global")):
            with fake_world(4):
                mesh = tmesh.build_mesh(mesh_shape, layout, attention, rank=0, world=4)
                assert mesh.tp_axis == ("model" if kind in ("tensor", "tpsp", "pptp") else None)
                assert mesh.pipe_axis == ("pipe" if kind in ("pipe", "pptp") else None)
                assert mesh.replicas == (1 if kind == "pptp" else 2)  # pptp: no batch axis
                if kind in ("pipe", "pptp"):
                    assert (mesh.stage, mesh.stages, mesh.pipe_ranks) == (0, 2, [0, 2])
                if kind == "pptp":
                    assert (mesh.copy_ranks, mesh.block_copy_ranks) == ([0, 1], None)
                if kind == "tpsp":
                    assert (mesh.copy_ranks, mesh.block_copy_ranks) == ([0, 1], None)
        else:
            with pytest.raises(NotImplementedError, match="not ported"):
                tmesh.build_mesh(mesh_shape, layout, attention, rank=0, world=4)
        # one process: every axis resizes to 1, one device, accepted
        assert tmesh.build_mesh(mesh_shape, layout, attention).world == 1
    if kind in ("tensor", "tpsp"):  # TP x SP is ported: the ring mesh's data axes
        with fake_world(4):
            mesh = tmesh.build_mesh(mesh_shape, layout, "ring", rank=0, world=4)
            assert tmesh.data_axes(mesh.rules, "ring") == ("data", "seq")
            assert mesh.copies == 2
    if kind in ("pipe", "pptp"):
        with pytest.raises(NotImplementedError, match="PP x SP.*5c-iii"):
            tmesh.build_mesh(mesh_shape, layout, "ring", rank=0, world=4)
    # a sequence axis needs ring attention
    with pytest.raises(NotImplementedError, match="sequence"):
        tmesh.build_mesh("data:1,seq:4", LAYOUT, "global", rank=0, world=4)
