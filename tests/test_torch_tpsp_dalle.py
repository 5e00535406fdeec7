"""Tensor parallelism under ring attention ("TP x SP") in the port against the
JAX package and one process, on the CPU with 4 gloo ranks
(tests/torch_tp_worker.py ``dalle_step`` under ``torch.distributed.run``, one
launch for every case), at tests/test_ring_dalle.py's model (E = 64, 4 heads,
2 layers, text 8 + image 16; a text vocabulary of 300) on ``data:1,seq:2,model:2`` with the Megatron
rules beside the ring's: each rank holds 2 of the 4 heads and 12 of the 24
positions.

- Against live JAX ``DALLE`` with the ring and heads axes under a ``Mesh``
  of 4 of the suite's fake CPU devices (``data:1,seq:2,model:2``),
  embedding and residual dropout off: the loss and every gradient for
  ``ring`` and ``local_ring``, with attention dropout off and at 0.1 (the
  ranks draw JAX's per-layer seeds, and the hash of a rank's heads at their
  global (row, head) is JAX's bit for bit), at JAX's own tolerance
  (tests/test_ring_dalle.py's ``_assert_same``: rtol 2e-5 on the loss, atol
  2e-5 on each gradient); two ``Trainer.train_step``s against JAX's
  single-device steps (loss and parameters at 2e-5).
- Against one process, with every dropout on (the embedding and residual
  masks from the generator every rank shares, sliced at the shard's global
  rows and positions): loss and gradients within fp32 rounding (loss 1e-5,
  each gradient 1e-4 of its leaf's max, as tests/test_torch_ring_dalle.py);
  the dense and the fused vocab-parallel heads with their eval metrics
  summed over the data and sequence axes.
- Without a launch: the plain per-hop versions and the tiled ring
  references on a block of the heads (``head0``, ``heads_total``) bit-equal
  to those heads of one call over all of them, with hash dropout; the seed
  ``ring_attention_auto`` gives a rank at each (data, seq, model) coordinate
  equal to the single process's program seeds of its rows and heads; the
  one-process branch of ``ring_attention_auto`` on a block of the heads
  equal to those heads of one ``causal_attention`` over all of them.

``train_dalle`` and sampling on the layout: tests/test_torch_tpsp_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu.parallel.mesh import make_constrain
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.ops import attention as tattn
from dalle_mtf_tpu_torch.ops import attention_tiles as tiles
from dalle_mtf_tpu_torch.ops import ring_attention as tring
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.utils import convert
from test_torch_tp_xent import torchrun

MESH = "data:1,seq:2,model:2"
TPSP = ("batch_dim:data,total_seq_dim:seq,heads_dim:model,intermediate_expanded:model,"
        "vocab_dim:model")
# tests/test_ring_dalle.py's _params model, its text vocabulary widened so
# that V = 300 + 32 + 1 = 333 gives each model rank a block (256 and 77 rows
# of 128-row lanes); a window of 5 for local_ring
KW = dict(n_embd=64, text_vocab_size=300, image_vocab_size=32, text_seq_len=8,
          image_seq_len=16, n_layers=2, n_heads=4, local_attention_radius=5)
DROPOUT = dict(embed_dropout=0.1, residual_dropout=0.1, attention_dropout=0.1)
# (name, attention_type, attention dropout): the cases held to JAX
JAX_CASES = [("ring", "ring", 0.0), ("local_ring", "local_ring", 0.0),
             ("ring_dropout", "ring", 0.1), ("local_ring_dropout", "local_ring", 0.1)]
# (name, config fields, fused head): the cases held to one process
ONE_CASES = [("dense_eval", {}, False), ("fused_eval", {}, True),
             ("every_dropout", DROPOUT, False)]
TASK = {"config_name": "tpsp_steps", "model_type": "dalle", "dataset": {"image_size": 16},
        "n_embd": 64, "text_vocab_size": 300, "image_vocab_size": 32, "text_seq_len": 8,
        "n_layers": 2, "n_heads": 4, "train_batch_size": 8, "train_steps": 2, "lr": 1e-3,
        "warmup_steps": 0,
        "vae_params": {"dataset": {"image_size": 16}, "num_tokens": 32,
                       "convblocks": [[1, 8], [1, 16]]}}


def _tokens(rows=8, seed=1):
    cfg = tdalle.DalleConfig(**KW)
    return np.random.default_rng(seed).integers(0, cfg.total_tokens, (rows, cfg.total_seq_len))


def _jax_attention_seeds(rng, n_layers):
    """The ring's attention-dropout seed of each layer of JAX ``DALLE.loss``
    under ``rng``: ``hidden`` splits it into (embedding, layers), the layers'
    key into one a layer, a layer's into (attention, residual, residual),
    and ``ring_attention_auto`` draws its int32 seed from the first."""
    _, r_layers = jax.random.split(rng)
    return [int(jax.random.randint(jax.random.split(r, 3)[0], (), 0, jnp.iinfo(jnp.int32).max,
                                   dtype=jnp.int32))
            for r in jax.random.split(r_layers, n_layers)]


def _jax_loss(jparams, attention_type, rate, rng):
    """JAX ``DALLE.loss`` and its gradients with the ring over ``seq``, the
    heads over ``model`` and the vocabulary over ``model``, under a
    ``data:1,seq:2,model:2`` mesh of 4 fake CPU devices."""
    jm = jdalle.DALLE(jdalle.DalleConfig(**KW, attention_type=attention_type,
                                         attention_dropout=rate, ring_heads_axis="model",
                                         vocab_axis="model"))
    mesh = JaxMesh(np.array(jax.devices()[:4]).reshape(1, 2, 2), ("data", "seq", "model"))
    _, constrain = make_constrain({"mesh_shape": MESH, "layout": TPSP}, mesh)
    tokens = jnp.asarray(_tokens(), jnp.int32)
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jm.loss(
            p, tokens, rng, train=True, constrain=constrain)[0]))(jparams)
    return float(loss), dict(convert._flatten(jax.device_get(grads)))


def _single(kw, params, fused=False):
    """The single-process port's loss, gradients and (dense or fused) eval
    means, dropout generator seed 5 as the ranks."""
    model = tdalle.DALLE(tdalle.DalleConfig(**kw), "cpu")
    tree = convert.dalle_params_from_numpy(params, model)
    for _, t in named_leaves(tree):
        t.requires_grad_(True)
    tokens = torch.from_numpy(_tokens())
    loss, _ = model.loss(tree, tokens, torch.Generator().manual_seed(5), train=True,
                         fused_xent=fused)
    loss.backward()
    evaluate = model.fused_eval if fused else model.dense_eval
    el, correct = evaluate(tree, tokens, torch.Generator().manual_seed(1))
    return (loss.item(), {"/".join(p): t.grad.numpy() for p, t in named_leaves(tree)},
            (el.mean().item(), correct.mean().item()))


def _jax_trainer_steps(tmp_path, tokens, caption):
    """JAX's Trainer on one device (global attention): its init (numpy),
    the losses of two steps and the parameters after them."""
    from dalle_mtf_tpu.models.vae import DiscreteVAE, VAEConfig
    from dalle_mtf_tpu.train.tasks import make_dalle_task
    from dalle_mtf_tpu.train.trainer import Trainer
    from dalle_mtf_tpu.utils.config import Config

    params = Config.from_mapping({**TASK, "mesh_shape": "data:1", "layout": "batch_dim:data"})
    vae_params = DiscreteVAE(VAEConfig.from_params(params["vae_params"])).init(
        jax.random.PRNGKey(7))
    _d, _v, init_fn, loss_fn, _e, axes = make_dalle_task(params)
    trainer = Trainer(params, init_fn, loss_fn, axes, model_dir=str(tmp_path / "jax_steps"),
                      seq_len=24, frozen_params=vae_params)
    state = trainer.init_state(jax.random.PRNGKey(0))
    init = jax.device_get(state["params"])
    losses = []
    for i in range(2):
        state, m = trainer.train_step(state, {"tokens": tokens, "caption": caption},
                                      jax.random.PRNGKey(1 + i))
        losses.append({k: float(jax.device_get(m[k]))
                       for k in ("loss", "loss_text", "loss_image")})
    final = dict(convert._flatten(jax.device_get(state["params"])))
    trainer.close()
    return init, losses, final


@pytest.fixture(scope="module")
def tpsp_run(tmp_path_factory):
    """One 4-rank launch of every case: ({name: result}, JAX parameters)."""
    tmp = tmp_path_factory.mktemp("tpsp_steps")
    jparams = jax.device_get(jdalle.DALLE(jdalle.DalleConfig(**KW)).init(jax.random.PRNGKey(0)))
    tokens = torch.from_numpy(_tokens())
    names, cases = [], []
    for name, attention, rate in JAX_CASES:
        names.append(name)
        cases.append({"config": dict(KW, attention_type=attention, attention_dropout=rate),
                      "mesh_shape": MESH, "layout": TPSP, "params": jparams,
                      "tokens": tokens, "seed": 5,
                      "draws": _jax_attention_seeds(jax.random.PRNGKey(2), KW["n_layers"])})
    for name, over, fused in ONE_CASES:
        names.append(name)
        cases.append({"config": dict(KW, attention_type="ring", **over), "mesh_shape": MESH,
                      "layout": TPSP, "params": jparams, "tokens": tokens, "seed": 5,
                      "fused_xent": fused, "eval": True})
    names.append("trainer")
    rng = np.random.RandomState(0)
    steps_tokens = rng.randint(0, 32, (8, 16)).astype(np.int32)
    caption = rng.randint(0, 300, (8, 8)).astype(np.int32)
    tparams, *jax_trainer = _jax_trainer_steps(tmp, steps_tokens, caption)
    cases.append({"trainer": True, "task": {**TASK, "attention_type": "ring",
                                            "mesh_shape": MESH, "layout": TPSP},
                  "params": tparams, "tokens": torch.from_numpy(steps_tokens),
                  "caption": torch.from_numpy(caption), "steps": 2, "out_dir": str(tmp)})
    results = dict(zip(names, torchrun(4, "dalle_step", cases, tmp, timeout=400)))
    results["jax_trainer"] = jax_trainer
    return results, jparams


@pytest.mark.parametrize("name,attention,rate", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_tpsp_step_matches_jax(tpsp_run, name, attention, rate):
    results, jparams = tpsp_run
    got = results[name]
    loss, grads = _jax_loss(jparams, attention, rate, jax.random.PRNGKey(2))
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=2e-5)
    assert set(got["grads"]) == set(grads)
    for key, want in grads.items():
        np.testing.assert_allclose(got["grads"][key].numpy(), want, atol=2e-5, err_msg=key)
    if rate:  # and the masks matter: without dropout the loss differs
        assert abs(float(got["loss"]) - float(results[attention]["loss"])) > 1e-4


@pytest.mark.parametrize("name,over,fused", ONE_CASES, ids=[c[0] for c in ONE_CASES])
def test_tpsp_step_matches_one_process(tpsp_run, name, over, fused):
    results, jparams = tpsp_run
    got = results[name]
    loss, grads, evals = _single(dict(KW, **over), jparams, fused)
    assert abs(float(got["loss"]) - loss) <= 1e-5
    assert set(got["grads"]) == set(grads)
    for key, want in grads.items():
        np.testing.assert_allclose(got["grads"][key].numpy(), want,
                                   atol=1e-4 * np.abs(want).max() + 1e-9, err_msg=key)
    # the eval's loss and accuracy shares summed over the data and sequence axes
    assert abs(float(got["eval"][0]) - evals[0]) <= 1e-5
    # (the accuracy's counts are exact; their shares add in another order)
    assert abs(float(got["eval"][1]) - evals[1]) <= 1e-6
    if over:  # and the masks matter: without dropout the loss differs
        assert abs(float(got["loss"]) - _single(KW, jparams)[0]) > 1e-4


def test_tpsp_trainer_steps_match_jax_single_device(tpsp_run):
    results, _ = tpsp_run
    got = results["trainer"]
    losses, final = results["jax_trainer"]
    for key in ("loss", "loss_text", "loss_image"):
        np.testing.assert_allclose([m[key] for m in got["metrics"]], [m[key] for m in losses],
                                   rtol=2e-5, err_msg=key)
    assert set(got["params"]) == set(final)
    for name, want in final.items():
        np.testing.assert_allclose(got["params"][name], np.asarray(want), atol=2e-5,
                                   err_msg=name)


# ------------------------------------------------------- without a launch

# (name, diff, window): the diagonal hop, a past hop, a window band
HOPS = [("diagonal", 0, None), ("past", 12, None), ("window_band", 12, 5)]


@pytest.mark.parametrize("tiled", [False, True], ids=["one_shot", "tiled"])
@pytest.mark.parametrize("head0", [0, 2])
@pytest.mark.parametrize("name,diff,window", HOPS, ids=[h[0] for h in HOPS])
def test_ring_hop_references_take_a_block_of_the_heads(name, diff, window, head0, tiled):
    """Heads [head0, head0 + 2) of 4 through one hop's plain versions (the
    one-shot and the tiled walk) with ``head0`` and ``heads_total`` 4 are
    those heads of one 4-head call, bit for bit, with hash dropout; the
    block with the default head0 draws another mask."""
    gen = torch.Generator().manual_seed(head0 + diff)
    q, k, v, g = (torch.rand((2, 4, 12, 16), generator=gen) * 2 - 1 for _ in range(4))
    row0 = 24
    args = (diff, row0, row0 - diff, window, 0.25, 2**31 - 7)
    fwd = tiles.ring_partial_tiled_reference if tiled else tring.ring_partial_reference
    bwd = tiles.ring_block_grads_tiled_reference if tiled else tring.ring_block_grads_reference

    def run(tensors, **heads):
        q_, k_, v_, g_ = tensors
        num, m, l = fwd(q_, k_, v_, *args, **heads)
        b, h, s, _ = q_.shape
        lse = m + torch.log(l.clamp_min(1e-30))
        out = num / l.clamp_min(1e-30).reshape(b, h, s, 1)
        dsum = (g_ * out).sum(-1).reshape(b * h, s)
        return [num, m.reshape(b, h, s), l.reshape(b, h, s),
                *bwd(q_, g_, lse, dsum, k_, v_, *args, **heads)]

    whole = run((q, k, v, g))
    block_in = [t[:, head0:head0 + 2] for t in (q, k, v, g)]
    block = run(block_in, head0=head0, heads_total=4)
    for b, w in zip(block, whole):
        torch.testing.assert_close(b, w[:, head0:head0 + 2], rtol=0, atol=0)
    if head0:
        assert not torch.equal(run(block_in)[0], whole[0][:, head0:head0 + 2])


class _Coords:
    """What ``ring_seed`` reads of a mesh: the rank's index on each axis."""

    def __init__(self, **coords):
        self.coords = coords

    def index(self, name):
        return self.coords.get(name, 0)


@pytest.mark.parametrize("data,seq,model", [(0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0)])
def test_ring_seeds_of_a_rank_are_the_single_process_program_seeds(data, seq, model):
    """On ``data:2,seq:2,model:2`` with 4 rows a data rank and 2 heads a
    model rank: the programs (b, h) of rank (data, seq, model) hash with the
    seeds one process gives its rows [2 data, 2 data + 2) and heads
    [2 model, 2 model + 2) of 8 rows and 4 heads (the sequence axis changes
    only the coordinates, never the seed)."""
    seed, rows, heads, total = 123456789, 4, 2, 4
    mesh = _Coords(data=data, seq=seq, model=model)
    rank = tattn.program_seeds(tring.ring_seed(seed, mesh, "data", rows, total), rows, heads,
                               "cpu", model * heads, total)
    one = tattn.program_seeds(seed, 2 * rows, total, "cpu")
    assert torch.equal(rank, one[data * rows:(data + 1) * rows, model * heads:][:, :heads])


@pytest.mark.parametrize("plain", [False, True])
def test_one_process_ring_branch_takes_a_block_of_the_heads(plain):
    """Without a sequence axis ``ring_attention_auto`` is the attention over
    the whole sequence; on heads [2, 4) of 4 (``head0`` 2, ``heads_total``
    4) with hash dropout it equals those heads of one ``causal_attention``
    over all four, value and gradients."""
    gen = torch.Generator().manual_seed(3)
    q, k, v, g = (torch.rand((2, 4, 24, 16), generator=gen) * 2 - 1 for _ in range(4))
    seed, rate, window = 77, 0.2, 9

    def grads(fn, tensors):
        leaves = [t.clone().requires_grad_(True) for t in tensors[:3]]
        out = fn(*leaves)
        out.backward(tensors[3])
        return [out.detach(), *(t.grad for t in leaves)]

    whole = grads(lambda *t: tattn.causal_attention(*t, window=window, dropout_rate=rate,
                                                    dropout_seed=seed), (q, k, v, g))
    block = grads(lambda *t: tring.ring_attention_auto(*t, None, window=window,
                                                       dropout_rate=rate, dropout_seed=seed,
                                                       plain=plain, head0=2, heads_total=4),
                  [t[:, 2:] for t in (q, k, v, g)])
    for b, w in zip(block, whole):
        torch.testing.assert_close(b, w[:, 2:], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="do not lie in 4 heads"):
        tring.ring_attention_auto(*(t[:, 2:] for t in (q, k, v)), None, window=window,
                                  dropout_rate=rate, dropout_seed=seed, head0=3,
                                  heads_total=4)
