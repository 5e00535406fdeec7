"""The port's remat policies (``recompute_grad`` with every
``remat_policy`` of dalle_mtf_tpu_torch/models/dalle.py) on the CPU at tiny
shapes:

- every ``jax.checkpoint_policies`` name that takes no arguments builds in
  the port, and every one that takes arguments raises ValueError;
- under each policy, with embedding, residual and attention dropout on, the
  loss and every grad are bit-equal to the port without remat, the
  generator ends where it does without remat, and the attention forward runs
  once a layer where the policy keeps its out and lse, twice where the
  recompute re-runs it; in the packed and the [B, H, S, D] arm;
- each policy's loss and grads against JAX's under the same policy, without
  dropout, within 1e-5 (as tests/test_dalle.py holds JAX's policies to its
  no-remat grads);
- a ring mesh (4 gloo ranks) under ``save_attn`` with the fused head and
  every dropout on: the recompute re-runs the ring's sends, and the ranks'
  summed loss and grads equal one process without remat.
"""

import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.ops import attention as tattn
from dalle_mtf_tpu_torch.ops import attention_packed as tpacked
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.utils import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(n_embd=128, text_vocab_size=40, image_vocab_size=32, text_seq_len=8,
          image_seq_len=16, n_layers=2, n_heads=2)
DROPOUT = dict(embed_dropout=0.1, residual_dropout=0.1, attention_dropout=0.1)
# policies under which the attention forward's out and lse are kept
KEEP_ATTENTION = {"dots_and_attn", "everything_saveable", "save_attn", "save_attn_lean"}


def _jax_policy_names():
    """(name, takes arguments) for every public jax.checkpoint_policies entry:
    a policy itself takes (prim, *args, **params); a factory of one takes
    names or policies and no ``**``."""
    out = []
    for name in dir(jax.checkpoint_policies):
        if name.startswith("_"):
            continue
        params = inspect.signature(getattr(jax.checkpoint_policies, name)).parameters.values()
        out.append((name, not any(p.kind == p.VAR_KEYWORD for p in params)))
    return out


@pytest.mark.parametrize("name,takes_args", _jax_policy_names())
def test_every_jax_policy_without_arguments_builds(name, takes_args):
    base = {"n_embd": 64, "text_vocab_size": 48, "image_vocab_size": 32, "text_seq_len": 8,
            "n_layers": 1, "n_heads": 2, "recompute_grad": True, "remat_policy": name}
    if takes_args:
        with pytest.raises(ValueError, match="arguments"):
            tdalle.DalleConfig.from_params(base, 16)
    else:
        assert tdalle.DalleConfig.from_params(base, 16).remat_policy == name
    # without recompute_grad the policy is not read, as in JAX
    assert tdalle.DalleConfig.from_params({**base, "recompute_grad": False}, 16)


def _params(cfg):
    return tdalle.DALLE(cfg, "cpu").init(torch.Generator().manual_seed(0))


def _step(cfg, params, tokens, monkeypatch, fused=False):
    """Loss, grads, the generator's state after the pass and the attention
    forward's runs, for one training pass."""
    runs = {"n": 0}
    module, name = (tpacked, "_forward") if cfg.attn_packed else (tattn, "_forward")
    orig = getattr(module, name)

    def counted(*a, **k):
        runs["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(module, name, counted)
    tree = {k: ({n: t.clone().requires_grad_(True) for n, t in v.items()}
                if isinstance(v, dict) else v.clone().requires_grad_(True))
            for k, v in params.items()}
    gen = torch.Generator().manual_seed(5)
    loss, _ = tdalle.DALLE(cfg, "cpu").loss(tree, tokens, gen, train=True, fused_xent=fused)
    loss.backward()
    monkeypatch.setattr(module, name, orig)
    return (loss.detach(), {"/".join(p): t.grad for p, t in named_leaves(tree)},
            gen.get_state(), runs["n"])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bhsd"])
@pytest.mark.parametrize("policy", tdalle.REMAT_POLICIES)
def test_policy_is_bit_equal_to_no_remat_with_dropout(policy, packed, monkeypatch):
    plain = tdalle.DalleConfig(**KW, **DROPOUT, attn_packed=packed)
    remat = tdalle.DalleConfig(**KW, **DROPOUT, attn_packed=packed, recompute_grad=True,
                               remat_policy=policy)
    params = _params(plain)
    tokens = torch.randint(0, plain.total_tokens, (2, plain.total_seq_len),
                           generator=torch.Generator().manual_seed(1))
    want_loss, want, want_gen, want_runs = _step(plain, params, tokens, monkeypatch)
    loss, grads, gen, runs = _step(remat, params, tokens, monkeypatch)
    assert want_runs == KW["n_layers"]
    assert runs == KW["n_layers"] * (1 if policy in KEEP_ATTENTION else 2)
    assert torch.equal(loss, want_loss)
    assert torch.equal(gen, want_gen)
    for name, g in want.items():
        assert torch.equal(grads[name], g), name


JAX_KW = dict(n_embd=64, text_vocab_size=48, image_vocab_size=32, text_seq_len=8,
              image_seq_len=16, n_layers=2, n_heads=2)


@pytest.fixture(scope="module")
def jax_case():
    jm = jdalle.DALLE(jdalle.DalleConfig(**JAX_KW))
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, jm.cfg.total_tokens, (2, jm.cfg.total_seq_len))
    return jparams, tokens


@pytest.mark.parametrize("policy", tdalle.REMAT_POLICIES)
def test_policy_matches_jax(policy, jax_case):
    jparams, tokens = jax_case
    over = dict(recompute_grad=True, remat_policy=policy)
    jm = jdalle.DALLE(jdalle.DalleConfig(**JAX_KW, **over))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(tokens, jnp.int32), train=True)[0]))(jparams)
    tm = tdalle.DALLE(tdalle.DalleConfig(**JAX_KW, **over), "cpu")
    tparams = convert.dalle_params_from_numpy(jparams, tm)
    for _, t in named_leaves(tparams):
        t.requires_grad_(True)
    tl, _ = tm.loss(tparams, torch.from_numpy(tokens), train=True)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-5
    got = dict(convert._flatten(convert.grads_to_numpy(tparams)))
    for name, want in convert._flatten(jax.device_get(jg)):
        np.testing.assert_allclose(got[name], want, atol=1e-5, err_msg=name)


def test_ring_recompute_with_the_fused_head_equals_one_process(tmp_path):
    kw = dict(n_embd=64, text_vocab_size=40, image_vocab_size=32, text_seq_len=8,
              image_seq_len=16, n_layers=2, n_heads=4, attention_type="ring", **DROPOUT)
    plain = tdalle.DALLE(tdalle.DalleConfig(**kw), "cpu")
    params = plain.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, plain.cfg.total_tokens, (4, plain.cfg.total_seq_len),
                           generator=torch.Generator().manual_seed(1))
    torch.save({"config": {**kw, "recompute_grad": True, "remat_policy": "save_attn"},
                "mesh_shape": "data:2,seq:2", "layout": "batch_dim:data,total_seq_dim:seq",
                "params": params, "tokens": tokens, "seed": 5, "fused_xent": True},
               tmp_path / "in.pt")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "4", os.path.join(ROOT, "tests", "torch_ring_worker.py"), "dalle_step",
           str(tmp_path / "in.pt"), str(tmp_path)]
    res = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    got = torch.load(tmp_path / "step.pt", weights_only=False)
    for _, t in named_leaves(params):
        t.requires_grad_(True)
    loss, _ = plain.loss(params, tokens, torch.Generator().manual_seed(5))
    loss.backward()
    assert abs(got["loss"].item() - loss.item()) <= 1e-5
    for path, t in named_leaves(params):
        name = "/".join(path)
        want = t.grad.numpy()
        np.testing.assert_allclose(got["grads"][name].numpy(), want,
                                   atol=1e-4 * np.abs(want).max() + 1e-9, err_msg=name)
