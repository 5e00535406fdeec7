"""``python -m dalle_mtf_tpu_torch.sample_dalle`` (the port of the root
``sample_dalle.py``) on the CPU at tiny shapes: from a port checkpoint (the
trainer's ``ckpt_<step>.pt``, the latest of two) and a VAE ``.npz``, its
``--n`` PNGs against the JAX package's ``generate_images`` greedy on the
same weights, unquantized and ``--quantize int8`` (both packages' dequant
form); launched as one of several processes, a layout that stays unported
(a ``layers:`` rule) raises before the process group is joined (sampling
over ranks: tests/test_torch_tp_sample.py). The images are compared as 8-bit pixels within one step: the same
greedy tokens, then the same fp32 VAE decode summed in another order, so a
value a hair from a rounding edge may land on its neighbour.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dalle_mtf_tpu import quantize as jq
from dalle_mtf_tpu import sample as jsample
from dalle_mtf_tpu.train import tasks as jtasks
from dalle_mtf_tpu_torch import sample_dalle
from dalle_mtf_tpu_torch.data.tokenizer import get_tokenizer, pad_or_truncate
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.train.tasks import make_dalle_models
from dalle_mtf_tpu_torch.utils import convert
from dalle_mtf_tpu_torch.utils.config import Config, fetch_model_params

VAE = {"model_type": "vae", "dataset": {"image_size": 16}, "num_tokens": 32,
       "convblocks": [[1, 8], [1, 16]]}
TEXT = "a red cube on a table"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A config, its port checkpoints (steps 1 and 3: 3 is the latest) and
    VAE npz; returns (config path, JAX models, JAX dalle params of step 3,
    JAX vae params)."""
    root = tmp_path_factory.mktemp("sample_cli")
    (root / "vae.json").write_text(json.dumps(VAE))
    cfg = {
        "model_type": "dalle", "vae_model": str(root / "vae.json"),
        "vae_checkpoint_path": str(root / "vae.npz"), "dataset": {},
        "n_embd": 32, "text_vocab_size": 50258, "image_vocab_size": 32,
        "text_seq_len": 8, "n_layers": 2, "n_heads": 2, "predict_batch_size": 2,
        "model_path": str(root / "run"),
    }
    (root / "dalle.json").write_text(json.dumps(cfg))
    params = fetch_model_params(str(root / "dalle.json"))
    jt = jtasks.make_dalle_task(Config.from_mapping({**params, "padding_id": 50257}))
    tdalle, tvae = make_dalle_models(params, "cpu")
    jvp = jax.device_get(jt[1].init(jax.random.PRNGKey(7)))
    convert.save_npz(root / "vae.npz", convert.vae_params_from_numpy(jvp, tvae))
    os.makedirs(root / "run" / "checkpoints")
    for step, seed in ((1, 1), (3, 0)):
        jdp = jax.device_get(jt[0].init(jax.random.PRNGKey(seed)))
        tree = convert.dalle_params_from_numpy(jdp, tdalle)
        torch.save({"step": step, "params": {"/".join(p): t for p, t in named_leaves(tree)},
                    "opt_state": {}}, root / "run" / "checkpoints" / f"ckpt_{step}.pt")
    return str(root / "dalle.json"), jt, jdp, jvp


def _jax_images(run, n, quantize=None):
    _, jt, jdp, jvp = run
    tok = get_tokenizer()
    ids = pad_or_truncate(tok.encode(TEXT), 8, tok.pad_token_id)
    if quantize:
        jdp = jax.device_get(quantize(jdp))
    imgs = jsample.generate_images(jt[0], jdp, jt[1], jvp, jnp.asarray([ids] * n, jnp.int32),
                                   jax.random.PRNGKey(0), temperature=0.0)
    return np.clip(np.asarray(imgs) * 255.0, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("n,flags,quantize", [
    (3, [], None),
    (None, ["--top_k", "8", "--top_p", "0.9"], None),  # greedy rows ignore the candidate set
    (2, ["--quantize", "int8"], jq.quantize_layers_int8),
    (2, ["--int8"], jq.quantize_layers_int8),
])
def test_sample_dalle_writes_jax_greedy_images(run, tmp_path, monkeypatch, n, flags, quantize):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    argv = ["--model", run[0], "--text", TEXT, "--out", str(out), "--temperature", "0",
            "--device", "cpu", *flags]
    if n is not None:
        argv += ["--n", str(n)]
    paths = sample_dalle.main(argv)
    n = n or 2  # the config's predict_batch_size
    assert sorted(os.listdir(out)) == [f"sample_{i}.png" for i in range(n)]
    assert paths == [str(out / f"sample_{i}.png") for i in range(n)]
    want = _jax_images(run, n, quantize)
    for i in range(n):
        got = np.asarray(Image.open(out / f"sample_{i}.png"))
        assert got.shape == want[i].shape == (16, 16, 3)
        assert np.abs(got.astype(int) - want[i].astype(int)).max() <= 1


def test_sample_dalle_is_seeded(run, tmp_path, monkeypatch):
    """Sampled images depend on --seed alone: equal for one seed, not for two."""
    monkeypatch.chdir(tmp_path)

    def pixels(seed, out):
        sample_dalle.main(["--model", run[0], "--text", TEXT, "--out", str(tmp_path / out),
                           "--top_k", "8", "--seed", str(seed), "--device", "cpu", "--n", "2"])
        return [np.asarray(Image.open(tmp_path / out / f"sample_{i}.png")) for i in range(2)]

    a, b, c = pixels(1, "a"), pixels(1, "b"), pixels(2, "c")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_sample_dalle_refusals(run, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["--model", run[0], "--text", TEXT, "--out", str(tmp_path / "o"), "--device", "cpu"]
    cfg = json.loads(open(run[0]).read())
    # over ranks, a layout that stays unported raises before the group is
    # joined: sampling on a pipeline layout (ROADMAP queue 1 item 5c-iv)
    piped = tmp_path / "piped.json"
    piped.write_text(json.dumps({**cfg, "mesh_shape": "data:1,model:2",
                                 "layout": "batch_dim:data,layers:model"}))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="pipeline parallelism.*5c-iv"):
        sample_dalle.main(["--model", str(piped), *base[2:]])
    monkeypatch.delenv("WORLD_SIZE")
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({**cfg, "model_path": str(tmp_path / "none")}))
    with pytest.raises(FileNotFoundError, match="no DALLE checkpoint"):
        sample_dalle.main(["--model", str(empty), *base[2:]])
    wider = tmp_path / "wider.json"
    wider.write_text(json.dumps({**cfg, "n_embd": 64}))
    with pytest.raises(ValueError, match="does not match"):
        sample_dalle.main(["--model", str(wider), *base[2:]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            sample_dalle.main(base[:-2])
    assert not (tmp_path / "o").exists()
