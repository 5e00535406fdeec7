"""``serve_dalle.build_server`` over a tensor-parallel model group in the
port, on the CPU over 2 gloo ranks (tests/torch_tp_worker.py ``serve`` under
``torch.distributed.run``, one launch), against one process's server on the
same weights, as JAX's ``test_tp_sharded_sampler_matches_unsharded``.

The config splits as dalle_coco's published ``model:2`` does: V = 50,291 in
blocks of 25,216, so the whole image band lies on the last rank. Rank 0
binds HTTP and runs the engine; rank 1 follows its orders.

- The whole-batch engine, weights drawn from ``--seed`` (the sharded init
  draws each rank's blocks of the single process's tree) and from
  ``--weights`` (cut into blocks by ``shard_dalle_params``), and
  ``--quantize int8`` after sharding: rank 0 answers greedy HTTP requests
  with one process's images, byte for byte (the PNGs' base64), a later
  request repeats them.
- The continuous engine (``--continuous --chunk 5``): the same images as
  one process's whole-batch engine.
- ``drain`` on rank 0 sends the stop: the follower returns from ``follow``
  and both ranks go on to the next server in the same process group; no
  decoder is captured (eager steps: the CPU).
- A tree that is already quantized is refused on every rank.
- A failure on rank 0 alone (its VAE decode made to raise), in either
  engine: the batch's future and the one queued behind it fail, the engine
  refuses later requests, its worker ends, and the stop it sends returns
  the follower from ``follow``.
"""

import base64
import io
import json

import numpy as np
import pytest
import torch

from dalle_mtf_tpu_torch import quantize as tq
from dalle_mtf_tpu_torch import serve_dalle
from dalle_mtf_tpu_torch.data.tokenizer import get_tokenizer, pad_or_truncate
from dalle_mtf_tpu_torch.serve import _png_b64
from dalle_mtf_tpu_torch.utils import convert
from test_torch_tp_dalle import TP
from test_torch_tp_xent import torchrun

VAE = {"model_type": "vae", "dataset": {"image_size": 16}, "num_tokens": 32,
       "convblocks": [[1, 8], [1, 16]]}
TEXTS = ("a red cube on a table", "two dogs in the snow")
# full batches of one text: every request is its own batch, in both servers
REQUESTS = [{"text": t, "n": 2, "temperature": 0.0, "top_k": 0} for t in TEXTS]
LATER = [REQUESTS[0]]
RUNS = ("seeded", "weights", "int8", "continuous")
BROKEN = ("seeded", "continuous")  # the engines whose rank 0 fails alone


def _config(root):
    cfg = {"model_type": "dalle", "vae_model": str(root / "vae.json"), "dataset": {},
           "n_embd": 32, "text_vocab_size": 50258, "image_vocab_size": 32, "text_seq_len": 8,
           "n_layers": 2, "n_heads": 2, "mesh_shape": "data:16,model:2", "layout": TP,
           "model_path": str(root / "run")}
    (root / "vae.json").write_text(json.dumps(VAE))
    path = root / "dalle.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _argv(config, name, root):
    argv = ["--model", config, "--batch-size", "2", "--top_k", "0", "--seed", "4"]
    if name in ("weights", "int8"):
        argv += ["--weights", str(root / "dalle.npz")]
    return argv + {"int8": ["--quantize", "int8"],
                   "continuous": ["--continuous", "--chunk", "5"]}.get(name, [])


def _one_process(argv):
    """One process's server on ``argv``: its images for REQUESTS, as PNGs."""
    tok = get_tokenizer()
    sampler, server = serve_dalle.build_server(argv + ["--device", "cpu", "--host",
                                                       "127.0.0.1", "--port", "0"])
    try:
        out = []
        for req in REQUESTS:
            ids = pad_or_truncate(tok.encode(req["text"]), 8, tok.pad_token_id)
            imgs = sampler.submit(ids, req["n"], temperature=0.0, top_k=0).result(timeout=300)
            out.append([_png_b64(im) for im in imgs])
        return out
    finally:
        server.server_close()
        sampler.drain(timeout=300)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from dalle_mtf_tpu_torch.train.tasks import make_dalle_models
    from dalle_mtf_tpu_torch.utils.config import fetch_model_params

    root = tmp_path_factory.mktemp("tp_serve")
    config = _config(root)
    dalle, _ = make_dalle_models(fetch_model_params(config), "cpu")
    masters = dalle.init(torch.Generator().manual_seed(9))
    convert.save_npz(root / "dalle.npz", masters)
    convert.save_npz(root / "dalle_int8.npz", tq.quantize_layers_int8(masters))
    runs = [dict(argv=_argv(config, name, root), requests=REQUESTS, later=LATER)
            for name in RUNS]
    runs.append(dict(argv=["--model", config, "--weights", str(root / "dalle_int8.npz")],
                     raises="cannot be cut"))
    tok = get_tokenizer()
    broken = [pad_or_truncate(tok.encode(t), 8, tok.pad_token_id) for t in TEXTS]
    runs += [dict(argv=_argv(config, name, root), broken=broken) for name in BROKEN]
    ranks = torchrun(2, "serve", [dict(runs=runs)], root)[0]
    whole_batch = [a for a in _argv(config, "seeded", root)]
    want = {name: _one_process(whole_batch if name == "continuous" else _argv(config, name, root))
            for name in RUNS}
    return dict(ranks=dict(zip(RUNS + ("refused",), ranks)), want=want,
                broken=dict(zip(BROKEN, ranks[len(RUNS) + 1:])))


@pytest.mark.parametrize("name", RUNS)
def test_rank0_answers_with_one_process_images(served, name):
    rank0 = served["ranks"][name][0]
    got = [r["images"] for r in rank0["replies"]]
    assert got == served["want"][name]
    for b64 in got[0]:
        from PIL import Image

        assert np.asarray(Image.open(io.BytesIO(base64.b64decode(b64)))).shape == (16, 16, 3)


@pytest.mark.parametrize("name", RUNS)
def test_a_later_greedy_request_repeats(served, name):
    rank0 = served["ranks"][name][0]
    assert rank0["later"][0]["images"] == rank0["replies"][0]["images"]


@pytest.mark.parametrize("name", RUNS)
def test_drain_stops_the_follower(served, name):
    rank0, rank1 = served["ranks"][name]
    assert rank1["followed"] and not rank0["worker_alive"]
    # whole batch: one order a request's batch, and the stop (the warm-up, a
    # prefill on each rank, sends none); continuous: admissions and chunks
    orders = len(REQUESTS) + len(LATER) + 1
    assert rank0["sent"] == orders if name != "continuous" else rank0["sent"] > orders
    assert not rank0["captures"] and not rank1["captures"]
    # the follower ran the same collectives as rank 0's engine
    assert rank0["collective_calls"] == rank1["collective_calls"] > 0


def test_continuous_stats_name_its_engine(served):
    stats = served["ranks"]["continuous"][0]["stats"]
    assert stats["engine"] == "continuous" and stats["slots_busy"] == 0


def test_a_quantized_tree_is_refused_on_every_rank(served):
    for r in served["ranks"]["refused"]:
        assert "cannot be cut into a rank's blocks" in r["raised"]


@pytest.mark.parametrize("name", BROKEN)
def test_a_failure_on_rank0_alone_fails_the_futures_and_stops_the_follower(served, name):
    rank0, rank1 = served["broken"][name]
    assert rank0["raised"] == ["planted VAE failure"] * len(TEXTS)
    assert rank0["refused"] and not rank0["worker_alive"]
    assert rank1["followed"]
