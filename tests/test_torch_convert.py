"""Weights carried across (dalle_mtf_tpu_torch/utils/convert.py): the npz
round trip, the JAX tree's names and shapes, refusal of a wrong tree, the
server CLI loading npz weights and serving every mode, and that the port
never imports JAX."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.models import dalle as jdalle
from dalle_mtf_tpu.models import vae as jvae
from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.models import vae as tvae
from dalle_mtf_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(n_embd=64, text_vocab_size=40, image_vocab_size=16, text_seq_len=4,
          image_seq_len=4, n_layers=2, n_heads=2)
VKW = dict(num_tokens=16, image_size=8, convblocks=((1, 8), (2, 8)))


def _paths(tree, prefix=""):
    return {
        p: tuple(np.shape(v)) for p, v in convert._flatten(tree, prefix)
    }


def test_jax_trees_load_with_their_names_and_shapes():
    jparams = jax.device_get(jdalle.DALLE(jdalle.DalleConfig(**KW)).init(
        jax.random.PRNGKey(0)))
    tm = tdalle.DALLE(tdalle.DalleConfig(**KW), "cpu")
    assert _paths(jparams) == _paths(tm.init(torch.Generator().manual_seed(0)))
    tparams = convert.dalle_params_from_numpy(jparams, tm)
    assert "layers/wq" in _paths(tparams) and _paths(tparams)["layers/wq"] == (2, 64, 2, 32)

    jv = jax.device_get(jvae.DiscreteVAE(jvae.VAEConfig(**VKW)).init(
        jax.random.PRNGKey(1)))
    vm = tvae.DiscreteVAE(tvae.VAEConfig(**VKW), "cpu")
    tv = convert.vae_params_from_numpy(jv, vm)
    assert _paths(tv)["decoder/block_0/up/w"] == (4, 4, 8, 8)
    # the port's tree is exactly the JAX tree, its encoder included
    assert _paths(tv)["encoder/block_1/res_1/conv_out/w"] == (3, 3, 8, 8)
    assert _paths(vm.init(torch.Generator().manual_seed(0))) == _paths(jv)


def test_npz_roundtrip_keeps_values_and_widens_bf16(tmp_path):
    tm = tdalle.DALLE(tdalle.DalleConfig(**KW), "cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    params["layers"]["wq"] = params["layers"]["wq"].to(torch.bfloat16)
    path = tmp_path / "w.npz"
    convert.save_npz(path, params)
    with np.load(path) as z:
        assert "layers/wq" in z.files and "w_out" in z.files
    back = convert.dalle_params_from_numpy(convert.load_npz(path), tm)
    for key, want in convert._flatten(params):
        got = dict(convert._flatten(back))[key]
        assert got.dtype == torch.float32, key
        torch.testing.assert_close(got, want.float(), rtol=0, atol=0)


def test_wrong_tree_is_refused():
    tm = tdalle.DALLE(tdalle.DalleConfig(**KW), "cpu")
    tree = convert.params_to_numpy(tm.init(torch.Generator().manual_seed(0)))
    tree["layers"]["wo"] = tree["layers"]["wo"][:, :1]
    with pytest.raises(ValueError, match="layers/wo"):
        convert.dalle_params_from_numpy(tree, tm)
    del tree["layers"]["wq"]
    with pytest.raises(KeyError, match="layers/wq"):
        convert.dalle_params_from_numpy(tree, tm)


def test_serve_cli_loads_npz_and_refuses_unported_modes(tmp_path):
    """The server CLI loads npz weights, quantizes them for --int8 and
    --quantize int4, and serves HTTP requests in those modes and with
    --continuous; a quantization it does not know is refused."""
    import json
    import threading
    import urllib.request

    from dalle_mtf_tpu_torch import serve_dalle
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params

    params = fetch_model_params("dalle_smoke")
    dalle, vae = make_dalle_models(params, "cpu")
    want = dalle.init(torch.Generator().manual_seed(3))
    convert.save_npz(tmp_path / "d.npz", want)
    convert.save_npz(tmp_path / "v.npz", vae.init(torch.Generator().manual_seed(4)))
    common = [
        "--model", "dalle_smoke", "--device", "cpu",
        "--weights", str(tmp_path / "d.npz"), "--vae-weights", str(tmp_path / "v.npz"),
    ]
    args = serve_dalle.parse_args(common)
    dalle, dparams, vae, vparams = serve_dalle.load_models(params, args)
    assert dparams["layers"]["wq"].dtype == torch.float32  # dalle_smoke is fp32
    torch.testing.assert_close(dparams["w_out"], want["w_out"])
    assert vparams["codebook"].shape == (64, 64)  # vae_smoke: n_hid 64, 64 tokens
    for flags, mode in ((["--int8"], "int8"), (["--quantize", "int4"], "int4")):
        _, qparams, _, _ = serve_dalle.load_models(params, serve_dalle.parse_args(common + flags))
        assert convert.quantize_mode(qparams) == mode
        assert qparams["layers"]["w_mlp1"].dtype == torch.int8
    with pytest.raises(SystemExit):
        serve_dalle.parse_args(common + ["--quantize", "int2"])

    for flags, engine in ((["--continuous", "--chunk", "16"], "continuous"),
                          (["--int8"], "whole-batch"), (["--quantize", "int4"], "whole-batch")):
        sampler, server = serve_dalle.build_server(
            common + ["--host", "127.0.0.1", "--port", "0", "--batch-size", "2", *flags])
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            port = server.server_address[1]
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps({"text": "a red cube", "n": 2, "top_k": 8}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                assert len(json.load(r)["images"]) == 2
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
                assert json.load(r)["engine"] == engine
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
            sampler.drain(timeout=120)
        assert not thread.is_alive() and not sampler._worker.is_alive()


def test_vocab_mismatch_is_refused():
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params

    params = fetch_model_params("dalle_coco")
    params["image_vocab_size"] = 512
    with pytest.raises(ValueError, match="num_tokens"):
        make_dalle_models(params, "cpu")


def test_port_never_imports_jax():
    """Import every module of the port in a fresh interpreter: JAX must not
    be loaded (the JAX package's __init__ imports it, so nothing of
    dalle_mtf_tpu may be reached either)."""
    training = [
        "ops.attention_packed", "ops.losses", "train.optim", "train.trainer",
        "train.tasks", "train_dalle", "data.pipeline", "data.tfrecord", "data.fs",
        "utils.logging_utils", "utils.summaries",
        # quantized and continuous-batching serving
        "quantize", "ops.decode_matmul", "sample", "serve", "serve_dalle",
        # unpacked and long-sequence training
        "ops.layer_norm",
        # stage-1 VAE training
        "ops.gumbel", "models.vae", "train_vae", "utils.png",
        # DALLE image mode and the offline encode
        "utils.restore", "data.encode_dataset", "data.create_tfrecords",
        # the captured decode loop's clients: predict at checkpoints, the CLI
        "train.predict", "sample_dalle",
        # tensor parallelism
        "parallel.mesh", "parallel.tensor",
        # the sharded init's keyed draws and the streamed checkpoints
        "utils.seeds", "utils.checkpoint",
        # pipeline parallelism
        "parallel.pipeline",
    ]
    code = (
        "import pkgutil, sys, dalle_mtf_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'dalle_mtf_tpu_torch.')]\n"
        "assert len(mods) >= 33, mods\n"
        f"missing = {['dalle_mtf_tpu_torch.' + m for m in training]!r}\n"
        "assert not set(missing) - set(mods), sorted(set(missing) - set(mods))\n"
        "for m in mods: __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'dalle_mtf_tpu', 'tensorflow'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
