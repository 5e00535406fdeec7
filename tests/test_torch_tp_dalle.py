"""Tensor-parallel DALLE training in the port against one process and against
the JAX package, on the CPU with 2 and 4 gloo ranks.

- The published layouts (``configs/dalle_coco.json``'s ``data:16,model:2``,
  ``configs/dalle_12B.json``'s ``data:16,model:8``) build a mesh at world
  size 2 and 8 (a fake process group: no ranks are started), with the
  blocks ``DALLE.param_shapes`` names; a dim that does not divide warns and
  is replicated.
- One loss and its gradients (every leaf, the blocks gathered) on
  ``data:1,model:2`` and ``data:2,model:2`` (tests/torch_tp_worker.py under
  ``torch.distributed.run``), with the heads, intermediate and vocab rules
  together and each alone, the dense and the fused head, against the
  single-process port and JAX ``DALLE.loss`` under ``make_constrain`` on its
  own ``data:1,model:2`` mesh; the eval metrics against one process; with
  every dropout on (packed and [B, H, S, D] attention) against one process:
  the residual and embedding masks come from the generator every rank
  shares, the attention hash takes the rank's heads at their
  single-process index (``head0``), so the masks are the single process's.
  Tolerance: loss 1e-5, each grad 1e-4 of its leaf's max, as
  tests/test_torch_ring_dalle.py. Under two selective-checkpoint remat
  policies (the collectives re-run in the recompute) against one process;
  the plain attention on a block of the heads (``head0``, ``heads_total``)
  bit-equal to those heads of one call.
- AdamW and Adafactor (factored ``w_mlp1``, ``w_mlp2``, ``w_out``, ``wte``,
  split over the model axis) with the global-norm clip, and
  ``skip_nonfinite_updates`` with a NaN planted in one rank's block, over
  3 steps against one process (the whole parameters after them through
  ``utils.convert.gather_dalle_params``).

``train_dalle`` on a tensor-parallel mesh: tests/test_torch_tp_train.py.
"""

import contextlib
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu.parallel.mesh import make_constrain
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.parallel import mesh as tmesh
from dalle_mtf_tpu_torch.train.optim import get_optimizer, named_leaves
from dalle_mtf_tpu_torch.utils import convert
from test_torch_tp_xent import ROOT, torchrun

TP = "batch_dim:data,heads_dim:model,intermediate_expanded:model,vocab_dim:model"
RULES = {"all": TP, "heads": "batch_dim:data,heads_dim:model",
         "intermediate": "batch_dim:data,intermediate_expanded:model",
         "vocab": "batch_dim:data,vocab_dim:model"}
# V = 300 + 64 + 1 = 365: blocks of 256 at model:2, the second 109 rows
KW = dict(n_embd=64, text_vocab_size=300, image_vocab_size=64, text_seq_len=8,
          image_seq_len=16, n_layers=2, n_heads=4)
DROPOUT = dict(embed_dropout=0.1, residual_dropout=0.1, attention_dropout=0.1)
# E = 128, so that Adafactor factors the split leaves (second-largest dim >= 128)
OPT_KW = dict(KW, n_embd=128)
OPTIMIZERS = {
    "adamw": {"lr": 1e-2, "warmup_steps": 0, "gradient_clipping": 0.5, "weight_decay": 0.1},
    "adafactor": {"optimizer": "adafactor", "lr": 1e-2, "warmup_steps": 0,
                  "gradient_clipping": 0.5, "skip_nonfinite_updates": 1},
}
# selective-checkpoint policies: the collectives re-run inside the recompute
REMAT = ("nothing_saveable", "save_attn")
STEP_CASES = [("all", False), ("all", True), ("heads", False), ("intermediate", False),
              ("vocab", False), ("vocab", True)]


@contextlib.contextmanager
def fake_world(n):
    """A process group of ``n`` ranks that runs no collective (rank 0 of a
    fake backend), so that a mesh of ``n`` ranks can be built here."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _config(name):
    with open(os.path.join(ROOT, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,world,axes,heads,wte_rows", [
    ("dalle_coco", 2, [("data", 1), ("model", 2)], (0, 4), 26240),
    ("dalle_coco", 8, [("data", 4), ("model", 2)], (0, 4), 26240),
    ("dalle_12B", 2, [("data", 1), ("model", 2)], (0, 20), 26240),
    ("dalle_12B", 8, [("data", 1), ("model", 8)], (0, 5), 6656),
])
def test_published_tp_layouts_build_a_mesh(name, world, axes, heads, wte_rows):
    cfg = _config(name)
    with fake_world(world):
        mesh = tmesh.build_mesh(cfg["mesh_shape"], cfg["layout"], "global", 0, world)
        assert mesh.axes == axes and mesh.tp_axis == "model"
        assert mesh.replicas == world // mesh.size("model")
        dalle = tdalle.DALLE(tdalle.DalleConfig.from_params(cfg, 1024), "cpu", mesh)
        assert dalle.heads == heads
        shapes = dalle.param_shapes()
        e, m = cfg["n_embd"], mesh.size("model")
        assert shapes["wte"] == (wte_rows, e) and shapes["w_out"] == (e, wte_rows)
        assert shapes["layers"]["w_mlp1"] == (cfg["n_layers"], e, 4 * e // m)
        assert shapes["layers"]["wo"][1] == heads[1]
        assert shapes["layers"]["ln1_g"] == (cfg["n_layers"], e)  # replicated
        assert dalle.param_shapes(whole=True)["wte"][0] == dalle.cfg.total_tokens


def test_a_dim_that_does_not_divide_is_replicated_with_a_warning(caplog):
    with fake_world(4):
        mesh = tmesh.build_mesh("data:1,model:4", TP, "global", 0, 4)
        cfg = tdalle.DalleConfig(**dict(KW, n_heads=2, text_vocab_size=800))
        dalle = tdalle.DALLE(cfg, "cpu", mesh)
    assert "heads_dim of size 2 does not divide" in caplog.text
    assert dalle.heads == (0, 2)
    assert dalle.param_shapes()["layers"]["wq"] == (2, 64, 2, 32)
    assert dalle.param_shapes()["layers"]["w_mlp1"] == (2, 64, 64)  # 256 / 4


def _jax_reference(kw, rules, params, tokens, fused):
    """JAX ``DALLE.loss`` and its grads under ``make_constrain`` on its own
    ``data:1,model:2`` mesh (resized to the suite's devices)."""
    layout = RULES[rules]
    jkw = dict(kw, vocab_axis="model" if "vocab_dim" in layout else None,
               ring_heads_axis="model" if "heads_dim" in layout else None)
    jm = jdalle.DALLE(jdalle.DalleConfig(**jkw))
    mesh, constrain = make_constrain({"mesh_shape": "data:1,model:2", "layout": layout})
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jm.loss(
            p, jnp.asarray(tokens, jnp.int32), jax.random.PRNGKey(0), train=True,
            constrain=constrain, fused_xent=fused)[0]))(params)
    return float(loss), dict(convert._flatten(jax.device_get(grads)))


_REFERENCES = {}


def _references(jparams):
    """The single-process port's (loss, grads, eval) for each head and JAX's
    (loss, grads) for each STEP_CASES case, computed once for the module."""
    if not _REFERENCES:
        tokens = _tokens(KW)
        for fused in (False, True):
            _REFERENCES[("single", fused)] = _single(KW, jparams, tokens, 5, fused)
        for rules, fused in STEP_CASES:
            _REFERENCES[(rules, fused)] = _jax_reference(KW, rules, jparams, tokens, fused)
    return _REFERENCES


def _single(kw, params, tokens, seed, fused):
    model = tdalle.DALLE(tdalle.DalleConfig(**kw), "cpu")
    tree = convert.dalle_params_from_numpy(params, model)
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    loss, _ = model.loss(tree, torch.from_numpy(tokens), torch.Generator().manual_seed(seed),
                         train=True, fused_xent=fused)
    loss.backward()
    evaluate = model.fused_eval if fused else model.dense_eval
    el, correct = evaluate(tree, torch.from_numpy(tokens), torch.Generator().manual_seed(1))
    return (loss.item(), {"/".join(p): t.grad.numpy() for p, t in named_leaves(tree)},
            (el.mean().item(), correct.mean().item()))


def _check(got_loss, got_grads, want_loss, want_grads):
    assert abs(float(got_loss) - want_loss) <= 1e-5
    assert set(got_grads) == set(want_grads)
    for name, want in want_grads.items():
        np.testing.assert_allclose(got_grads[name].numpy(), want,
                                   atol=1e-4 * np.abs(want).max() + 1e-9, err_msg=name)


def _tokens(kw, rows=8, seed=1):
    cfg = tdalle.DalleConfig(**kw)
    return np.random.default_rng(seed).integers(0, cfg.total_tokens, (rows, cfg.total_seq_len))


def _opt_case(mesh_shape, name):
    params = convert.params_to_numpy(tdalle.DALLE(tdalle.DalleConfig(**OPT_KW), "cpu").init(
        torch.Generator().manual_seed(3)))
    return {"config": OPT_KW, "mesh_shape": mesh_shape, "layout": TP, "params": params,
            "tokens": torch.from_numpy(_tokens(OPT_KW)), "steps": 3,
            "opt_params": OPTIMIZERS[name], "nan_step": 1 if name == "adafactor" else None}


@pytest.fixture(scope="module", params=["data:1,model:2", "data:2,model:2"])
def tp_steps(request, tmp_path_factory):
    """One launch of every case on a mesh: (mesh_shape, {case: result},
    JAX parameters)."""
    mesh_shape = request.param
    jparams = jax.device_get(jdalle.DALLE(jdalle.DalleConfig(**KW)).init(jax.random.PRNGKey(0)))
    tokens = torch.from_numpy(_tokens(KW))
    keys, cases = [], []
    for rules, fused in STEP_CASES:
        keys.append((rules, fused))
        cases.append({"config": KW, "mesh_shape": mesh_shape, "layout": RULES[rules],
                      "params": jparams, "tokens": tokens, "seed": 5, "fused_xent": fused,
                      "eval": True})
    for packed in (True, False):
        keys.append(("dropout", packed))
        cases.append({"config": dict(KW, **DROPOUT, attn_packed=packed),
                      "mesh_shape": mesh_shape, "layout": TP, "params": jparams,
                      "tokens": tokens, "seed": 5})
    for name in OPTIMIZERS:
        keys.append(("optim", name))
        cases.append(_opt_case(mesh_shape, name))
    for policy in REMAT:
        keys.append(("remat", policy))
        cases.append({"config": dict(KW, recompute_grad=True, remat_policy=policy),
                      "mesh_shape": mesh_shape, "layout": TP, "params": jparams,
                      "tokens": tokens, "seed": 5})
    ranks = math.prod(n for _, n in tmesh.parse_mesh_shape(mesh_shape))
    results = torchrun(ranks, "dalle_step", cases,
                       tmp_path_factory.mktemp("tp_steps"))
    return mesh_shape, dict(zip(keys, results)), jparams


@pytest.mark.parametrize("rules,fused", STEP_CASES)
def test_tp_step_matches_single_process_and_jax(tp_steps, rules, fused):
    _, results, jparams = tp_steps
    got = results[(rules, fused)]
    loss, grads, evals = _references(jparams)[("single", fused)]
    _check(got["loss"], got["grads"], loss, grads)
    _check(got["loss"], got["grads"], *_references(jparams)[(rules, fused)])
    assert abs(float(got["eval"][0]) - evals[0]) <= 1e-5
    assert float(got["eval"][1]) == evals[1]


@pytest.mark.parametrize("packed", [True, False])
def test_tp_dropout_draws_the_single_process_masks(tp_steps, packed):
    _, results, jparams = tp_steps
    got = results[("dropout", packed)]
    kw = dict(KW, **DROPOUT, attn_packed=packed)
    loss, grads, _ = _single(kw, jparams, _tokens(KW), 5, False)
    _check(got["loss"], got["grads"], loss, grads)
    # and the masks matter: without dropout the loss differs
    assert abs(float(got["loss"]) - _single(KW, jparams, _tokens(KW), 5, False)[0]) > 1e-4


@pytest.mark.parametrize("policy", REMAT)
def test_tp_remat_matches_single_process(tp_steps, policy):
    _, results, jparams = tp_steps
    got = results[("remat", policy)]
    kw = dict(KW, recompute_grad=True, remat_policy=policy)
    loss, grads, _ = _single(kw, jparams, _tokens(KW), 5, False)
    _check(got["loss"], got["grads"], loss, grads)


@pytest.mark.parametrize("packed", [True, False])
def test_plain_attention_takes_a_block_of_the_heads(packed):
    """Heads [4, 8) of 8 through the plain versions with ``head0`` 4 and
    ``heads_total`` 8 are those heads of one 8-head call, bit for bit, with
    hash dropout (the kernels' rule, held on the card by chip_smoke.py)."""
    from dalle_mtf_tpu_torch.ops import attention as tattn
    from dalle_mtf_tpu_torch.ops import attention_packed as tap

    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.rand((2, 8, 24, 16), generator=gen) * 2 - 1 for _ in range(4))
    seed, rate = 2**31 - 7, 0.1

    def run(tensors, heads, head0=0, total=None):
        if packed:
            pq, pk, pv, pg = (tap._pack(t) for t in tensors)
            out, lse = tap.attention_packed_reference(pq, pk, pv, heads, None, rate, seed, True,
                                                      head0, total)
            grads = tap.backward_reference(pq, pk, pv, out, lse, pg, heads, None, rate, seed,
                                           head0, total)
            return [tap._unpack(t, heads) for t in (out, *grads)], lse
        out, lse = tattn.attention_reference(*tensors[:3], True, None, True, rate, seed, head0,
                                             total)
        return [out, *tattn.attention_backward_reference(*tensors[:3], out, lse, tensors[3],
                                                         None, rate, seed, head0, total)], lse

    whole, whole_lse = run((q, k, v, g), 8)
    block, block_lse = run([t[:, 4:] for t in (q, k, v, g)], 4, 4, 8)
    for b, w in zip(block, whole):
        torch.testing.assert_close(b, w[:, 4:], rtol=0, atol=0)
    torch.testing.assert_close(block_lse, whole_lse.reshape(2, 8, 24)[:, 4:].reshape(8, 24),
                               rtol=0, atol=0)
    # the defaults take the block as heads [0, 4): another mask
    assert not torch.equal(run([t[:, 4:] for t in (q, k, v, g)], 4)[0][0], whole[0][:, 4:])


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_tp_optimizers_match_single_process(tp_steps, name):
    mesh_shape, results, _ = tp_steps
    got = results[("optim", name)]
    case = _opt_case(mesh_shape, name)
    model = tdalle.DALLE(tdalle.DalleConfig(**OPT_KW), "cpu")
    tree = convert.dalle_params_from_numpy(case["params"], model)
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    opt, _ = get_optimizer(case["opt_params"], tree)
    if name == "adafactor":
        dims = {"/".join(p): d for (p, _), d in zip(opt.inner.named, opt.inner.dims)}
        assert all(dims[k] for k in ("layers/w_mlp1", "layers/w_mlp2", "w_out", "wte"))
    tokens = case["tokens"]
    for step, (got_loss, got_norm) in enumerate(got["losses"]):
        opt.zero_grad()
        loss, _ = model.loss(tree, tokens, torch.Generator().manual_seed(step), train=True)
        loss.backward()
        if step == case["nan_step"]:
            tree["b_out"].grad[0] = float("nan")
        norm = opt.step()
        assert abs(got_loss - loss.item()) <= 1e-5
        if np.isfinite(got_norm) or np.isfinite(norm.item()):
            assert abs(got_norm - norm.item()) <= 1e-5 * max(1.0, norm.item())
    if name == "adafactor":
        assert opt.total_notfinite == 1  # the planted NaN skipped one step on every rank
    # each leaf within 1e-5 of its max, plus 1e-3 of one step's learning rate:
    # AdamW moves an element by ~lr * g / |g| whatever its size, so an element
    # whose gradient is near 0 turns fp32 sums in another order into ~1e-3 lr
    lr = case["opt_params"]["lr"]
    for path, t in named_leaves(tree):
        want = t.detach().numpy()
        np.testing.assert_allclose(got["params"]["/".join(path)], want,
                                   atol=1e-5 * np.abs(want).max() + 1e-3 * lr, rtol=0,
                                   err_msg="/".join(path))
