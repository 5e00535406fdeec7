"""Sampling from a tensor-parallel model in the port against one process and
against the JAX package's sharded generation, on the CPU over gloo ranks
(tests/torch_tp_worker.py ``sample`` and ``sample_cli`` under
``torch.distributed.run``; one launch of 2 ranks, one of 4).

The vocabulary splits so that the image band straddles two ranks: text 200,
image 64, V = 265, blocks of 256 at ``model:2`` (rank 0 holds band columns
[200, 256), rank 1 [256, 264) and EOS). JAX replicates a V that does not
divide its axis, so its run stays the reference.

- Greedy whole-batch generation (``generate_image_tokens``, and the
  ``CapturedDecoder`` the servers use, eager on the CPU) on ``model:2`` and
  on ``data:2,model:2``: bit-identical to one process and to the live JAX
  run on ``data:4,model:2`` with the weights carried across, on every rank.
- The continuous engine (``admit_rows`` + ``decode_chunk``, chunk 5 over 16
  tokens, the JAX test's) reproduces the whole-batch greedy tokens.
- Prefill and 16 teacher-forced decode steps: logits within 1e-5 of one
  process's (fp32; the blocks' partial sums are added in another order),
  the same on every rank; a rank's cache holds its heads.
- int8 and int4 after sharding: every rank's scales equal the same columns
  of one process's bit for bit (``wo`` and ``w_mlp2``, whose contraction
  axis is split, through the MAX all_reduce), and the greedy tokens equal
  one process's quantized greedy tokens.
- Sampled runs (temperature 1 with top_k and top_p): the same tokens on
  every rank of the group.
- ``sample_dalle.main`` over 2 ranks, from a ``model:2`` checkpoint and from
  a single process's: rank 0 writes one process's greedy PNGs, each rank
  copies only its blocks out of the mapped file.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu.parallel.mesh import build_mesh as jax_build_mesh
from dalle_mtf_tpu.parallel.mesh import parse_layout as jax_parse_layout
from dalle_mtf_tpu.parallel.mesh import shard_params as jax_shard_params
from dalle_mtf_tpu.sample import generate_image_tokens as jax_generate
from dalle_mtf_tpu_torch import quantize as tq
from dalle_mtf_tpu_torch import sample as tsample
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.parallel import mesh as tmesh
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.utils import convert
from test_torch_tp_dalle import TP
from test_torch_tp_xent import torchrun
from torch_tp_worker import save_checkpoint

KW = dict(n_embd=64, text_vocab_size=200, image_vocab_size=64, text_seq_len=8,
          image_seq_len=16, n_layers=2, n_heads=4)
B = 4
LOGITS_TOL = 1e-5
CONTINUOUS = dict(engine="continuous", chunk=5, chunks=4, k_max=8)
SAMPLED = dict(temperature=1.0, top_k=8, top_p=0.9, seed=3)
# each launch's runs, in order: (name, run)
RUNS = {
    "model:2": [("whole", dict(engine="whole")), ("decoder", dict(engine="decoder")),
                ("continuous", CONTINUOUS), ("logits", dict(engine="logits")),
                ("int8", dict(engine="whole", quantize="int8")),
                ("int4", dict(engine="whole", quantize="int4")),
                ("sampled", dict(engine="whole", **SAMPLED)),
                ("sampled_decoder", dict(engine="decoder", **SAMPLED)),
                ("sampled_continuous", dict(CONTINUOUS, **SAMPLED))],
    "data:2,model:2": [("whole", dict(engine="whole")), ("decoder", dict(engine="decoder")),
                       ("continuous", CONTINUOUS), ("sampled", dict(engine="whole", **SAMPLED))],
}
GREEDY = ("whole", "decoder", "continuous")


@pytest.fixture(scope="module")
def inputs():
    """JAX's weights and texts, and JAX's greedy tokens on data:4,model:2."""
    cfg = jdalle.DalleConfig(**KW)
    model = jdalle.DALLE(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    texts = rng.integers(0, KW["text_vocab_size"], (B, KW["text_seq_len"])).astype(np.int32)
    mesh = jax_build_mesh("data:4,model:2")
    sharded = jax_shard_params(params, mesh, jax_parse_layout(TP), model.logical_axes())
    jax_tokens = jax_generate(model, sharded, jax.numpy.asarray(texts), jax.random.PRNGKey(2),
                              temperature=0.0)
    forced = rng.integers(0, KW["image_vocab_size"], (B, KW["image_seq_len"]))
    return dict(params=jax.device_get(params), texts=texts, jax_tokens=np.asarray(jax_tokens),
                forced=forced)


def _one_process(inputs, run):
    """The single-process port on the same weights."""
    model = tdalle.DALLE(tdalle.DalleConfig(**KW), "cpu")
    masters = convert.dalle_params_from_numpy(inputs["params"], model)
    mode = run.get("quantize", "none")
    params = (tq.cast_decode_weights(masters, torch.float32) if mode == "none" else
              (tq.quantize_layers_int8 if mode == "int8" else tq.quantize_layers_int4)(masters))
    text = torch.as_tensor(inputs["texts"], dtype=torch.long)
    if run["engine"] == "logits":
        lo = KW["text_vocab_size"]
        head = model.logits_head(params, (lo, lo + KW["image_vocab_size"]))
        cache = model.init_cache(B)
        with torch.inference_mode():
            out = [model.prefill(params, text, cache, head=head)]
            for i, tok in enumerate(torch.as_tensor(inputs["forced"]).T):
                out.append(model.decode_step(params, cache, tok + lo, KW["text_seq_len"] + i,
                                             head=head))
        return torch.stack(out), params
    tokens = tsample.generate_image_tokens(model, params, text, torch.Generator().manual_seed(0),
                                           0.0)
    return tokens, params


@pytest.fixture(scope="module")
def launches(inputs, tmp_path_factory):
    """Each mesh's launch: {mesh: {run name: every rank's result}}."""
    out = {}
    for mesh_shape, world in (("model:2", 2), ("data:2,model:2", 4)):
        tmp = tmp_path_factory.mktemp(mesh_shape.replace(":", "").replace(",", "_"))
        runs = [dict(run, forced=inputs["forced"]) for _, run in RUNS[mesh_shape]]
        case = dict(config=KW, mesh_shape=f"data:16,{mesh_shape.split(',')[-1]}", layout=TP,
                    params=inputs["params"], texts=inputs["texts"].astype(np.int64), runs=runs)
        res = torchrun(world, "sample", [case], tmp)[0]
        out[mesh_shape] = dict(zip((name for name, _ in RUNS[mesh_shape]), res))
    return out


def test_the_band_straddles_two_ranks():
    bounds = tmesh.split_bounds("vocab_dim", 265, 2)
    band = (200, 264)
    assert bounds == ((0, 256), (256, 265))
    assert bounds[0][0] < band[0] < bounds[0][1] < band[1] <= bounds[1][1]


@pytest.mark.parametrize("mesh_shape,world", [("model:2", 2), ("data:2,model:2", 4)])
def test_each_launch_has_the_layout_it_asks_for(launches, mesh_shape, world):
    ranks = launches[mesh_shape]["whole"]
    assert len(ranks) == world
    want = [{"data": r // 2, "model": r % 2} for r in range(world)]
    assert [r["coords"] for r in ranks] == want


@pytest.mark.parametrize("mesh_shape,name", [(m, n) for m in RUNS for n in GREEDY])
def test_greedy_tokens_equal_one_process_and_jax(inputs, launches, mesh_shape, name):
    want, _ = _one_process(inputs, dict(engine="whole"))
    np.testing.assert_array_equal(want.numpy(), inputs["jax_tokens"])
    for r in launches[mesh_shape][name]:
        assert r["tokens"].shape == (B, KW["image_seq_len"]), r["rank"]
        np.testing.assert_array_equal(r["tokens"].numpy(), inputs["jax_tokens"],
                                      err_msg=f"rank {r['rank']}")


@pytest.mark.parametrize("mesh_shape,name", [(m, n) for m in RUNS for n, _ in RUNS[m]
                                             if n != "logits"])
def test_every_rank_feeds_the_same_tokens(launches, mesh_shape, name):
    ranks = launches[mesh_shape][name]
    for r in ranks[1:]:
        assert torch.equal(r["tokens"], ranks[0]["tokens"]), (name, r["rank"])


@pytest.mark.parametrize("name", ["sampled", "sampled_decoder", "sampled_continuous"])
def test_sampled_runs_draw_within_the_band(launches, name):
    tokens = launches["model:2"][name][0]["tokens"]
    assert tokens.shape == (B, KW["image_seq_len"])
    assert 0 <= int(tokens.min()) and int(tokens.max()) < KW["image_vocab_size"]
    assert tokens.unique().numel() > 8  # sampled, not greedy


def test_the_decoder_runs_its_steps_eagerly_on_the_cpu(launches):
    assert not any(r["captures"] for r in launches["model:2"]["decoder"])


def test_logits_equal_one_process_within_tolerance(inputs, launches):
    want, _ = _one_process(inputs, dict(engine="logits"))
    assert want.shape == (KW["image_seq_len"] + 1, B, KW["image_vocab_size"])
    ranks = launches["model:2"]["logits"]
    for r in ranks:
        got = r["logits"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=LOGITS_TOL * float(want.abs().max()),
                                   err_msg=f"rank {r['rank']}")
    # the joined band is the same on both ranks, bit for bit
    assert torch.equal(ranks[0]["logits"], ranks[1]["logits"])


def test_a_ranks_cache_holds_its_heads(launches):
    assert [r["cache_heads"] for r in launches["model:2"]["logits"]] == [2, 2]


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("leaf", ["layers/wq_scale", "layers/wk_scale", "layers/wv_scale",
                                  "layers/wo_scale", "layers/w_mlp1_scale",
                                  "layers/w_mlp2_scale", "w_out_scale"])
def test_scales_after_sharding_equal_one_process(inputs, launches, mode, leaf):
    _, whole = _one_process(inputs, dict(engine="whole", quantize=mode))
    whole = dict((("/".join(p), t) for p, t in named_leaves(whole)))[leaf]
    for r in launches["model:2"][mode]:
        got, where = r["scales"][leaf]
        want = whole if where is None else whole.narrow(where[0], where[1], where[2] - where[1])
        assert torch.equal(got, want), (leaf, r["rank"], where)
    # the split contraction axes: the MAX over the group, else a rank's own max
    wheres = [r["scales"][leaf][1] for r in launches["model:2"][mode]]
    if leaf in ("layers/wo_scale", "layers/w_mlp2_scale"):
        assert wheres == [None, None]
    else:
        assert None not in wheres


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_greedy_tokens_equal_one_process(inputs, launches, mode):
    want, _ = _one_process(inputs, dict(engine="whole", quantize=mode))
    for r in launches["model:2"][mode]:
        assert torch.equal(r["tokens"], want), r["rank"]


# ------------------------------------------------------------ sample_dalle

VAE = {"model_type": "vae", "dataset": {"image_size": 16}, "num_tokens": 32,
       "convblocks": [[1, 8], [1, 16]]}
TEXT = "a red cube on a table"


def _cli_config(root, name):
    """A dalle config over the tiny VAE, published layout model:2, whose
    band straddles the ranks (text vocab 50258 + 32 + 1: the tokenizer's)."""
    cfg = {"model_type": "dalle", "vae_model": str(root / "vae.json"),
           "vae_checkpoint_path": str(root / "vae.npz"), "dataset": {},
           "n_embd": 32, "text_vocab_size": 50258, "image_vocab_size": 32, "text_seq_len": 8,
           "n_layers": 2, "n_heads": 2, "predict_batch_size": 2, "train_batch_size": 2,
           "mesh_shape": "data:16,model:2", "layout": TP, "model_path": str(root / name)}
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    from dalle_mtf_tpu_torch import sample_dalle
    from dalle_mtf_tpu_torch.models.vae import DiscreteVAE, VAEConfig

    root = tmp_path_factory.mktemp("tp_sample_cli")
    (root / "vae.json").write_text(json.dumps(VAE))
    vae = DiscreteVAE(VAEConfig.from_params(VAE), "cpu")
    convert.save_npz(root / "vae.npz", vae.init(torch.Generator().manual_seed(5)))
    single, split = _cli_config(root, "single"), _cli_config(root, "split")
    save_checkpoint(single, 3)
    argvs = [["--model", path, "--text", TEXT, "--out", str(root / f"out_{name}"),
              "--temperature", "0", "--device", "cpu"]
             for name, path in (("split", split), ("single", single))]
    ranks = torchrun(2, "sample_cli", [dict(argvs=argvs, save=dict(config=split, seed=3))],
                     root)[0]
    old = os.getcwd()
    os.chdir(root)
    try:
        want = sample_dalle.main(["--model", single, "--text", TEXT, "--out",
                                  str(root / "out_one"), "--temperature", "0", "--device",
                                  "cpu"])
    finally:
        os.chdir(old)
    from PIL import Image

    return dict(ranks=ranks, want=[np.asarray(Image.open(p)) for p in want], root=root)


@pytest.mark.parametrize("run", ["model:2 checkpoint", "single-process checkpoint"])
def test_sample_dalle_over_two_ranks_writes_one_process_greedy_pngs(cli, run):
    ranks = cli["ranks"][0 if run.startswith("model") else 1]
    rank0, rank1 = ranks
    assert len(rank0["paths"]) == 2 and rank1["paths"] == []
    assert all(os.path.basename(p) == f"sample_{i}.png" for i, p in enumerate(rank0["paths"]))
    for got, want in zip(rank0["pixels"], cli["want"]):
        assert got.shape == (16, 16, 3)
        np.testing.assert_array_equal(got, want)


REPLICATED = ("wpe", "lnf_g", "lnf_b", "layers/ln1_g", "layers/ln1_b", "layers/o_b",
              "layers/ln2_g", "layers/ln2_b", "layers/b_mlp2")


@pytest.mark.parametrize("run", [0, 1])
def test_sample_dalle_ranks_read_only_their_blocks(cli, run):
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params

    params = fetch_model_params(str(cli["root"] / "single.json"))
    dalle, _ = make_dalle_models(params, "cpu")
    nbytes = {"/".join(p): int(np.prod(s)) * 4 for p, s in named_leaves(dalle.param_shapes())}
    whole, replicated = sum(nbytes.values()), sum(nbytes[k] for k in REPLICATED)
    ranks = cli["ranks"][run]
    for r in ranks:
        assert r["loads"] and all(r["loads"]), r  # every read mapped, none whole
        assert 0 < r["block_bytes"] < 0.75 * whole, (r["block_bytes"], whole)
    # the split leaves' blocks once over the ranks, the replicated leaves on each
    assert sum(r["block_bytes"] for r in ranks) == whole + replicated
