"""Remote paths in the port (data/fs.py, data/readahead.py and the model
dir of train/trainer.py, utils/checkpoint.py, utils/summaries.py,
utils/restore.py, utils/logging_utils.py) on the CPU, through fsspec's
memory:// filesystem, whose code path is gs://'s but for the backend:

- the fs helpers on URLs and local paths, the read hints from the
  environment, ``prefetch_iter``'s order, errors and bound;
- memory:// shards written once and read by both packages' ``vae_input_fn``
  and ``dalle_input_fn``, batch for batch: tokens mode, image mode (both on
  PIL; the port's native pool against its own read of a local copy) and a
  resume skip, each remote shard read ahead on its own thread;
- ``train_vae.main`` and ``train_dalle.main`` with memory:// data and
  model dir against the same runs on local paths: the same losses and
  evals, the same checkpoints kept, the same parameters, a resume bit-equal
  to the unbroken run, the event files read back, ``--new`` clearing the
  remote dir, ``restore_vae_params`` and ``encode_dataset`` over URLs;
- a gs:// ``model_path`` kept as given (it was once made a local path under
  the working directory) -- only the names, no gs:// I/O.

The JAX package stays on its Python path (``dalle_mtf_tpu.data.native.get_lib``
returns None here).
"""

import json
import os
import threading
import time
import uuid

import fsspec
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.data import native as jnative
from dalle_mtf_tpu.data import pipeline as jpipe
from dalle_mtf_tpu_torch.data import fs
from dalle_mtf_tpu_torch.data import native as tnative
from dalle_mtf_tpu_torch.data import pipeline as tpipe
from dalle_mtf_tpu_torch.data import tfrecord as ttfr
from dalle_mtf_tpu_torch.data.readahead import prefetch_iter

MEM = fsspec.filesystem("memory")


@pytest.fixture(autouse=True)
def jax_python_path(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)


@pytest.fixture
def port_pil(monkeypatch):
    monkeypatch.setattr(tnative, "get_lib", lambda: None)


@pytest.fixture
def mem():
    """A memory:// root of this test's own, removed after it."""
    root = f"memory://t{uuid.uuid4().hex}"
    yield root
    path = root.split("://", 1)[1]
    if MEM.exists(path):
        MEM.rm(path, recursive=True)


def _copy_to(url_dir, local_dir):
    """Copy every file of ``local_dir`` (flat) under ``url_dir``."""
    for name in sorted(os.listdir(local_dir)):
        with open(os.path.join(local_dir, name), "rb") as f, \
                fs.open_file(fs.join(url_dir, name), "wb") as g:
            g.write(f.read())


# --------------------------------------------------------------- fs layer

def test_fs_helpers_on_urls_and_paths(mem, tmp_path):
    assert fs.is_remote("memory://a/b") and fs.is_remote("gs://b/x") and fs.is_remote("file:///x")
    assert fs.is_remote("s3://b/x") and not fs.is_remote("3s://b/x")
    assert not fs.is_remote("/tmp/x") and not fs.is_remote("C://x") and not fs.is_remote(None)
    for root in (mem, str(tmp_path / "local")):
        d = fs.join(root, "dir", "sub")
        assert not fs.exists(d) and fs.listdir(d) == []
        fs.makedirs(d)
        for name in ("b.bin", "a.bin"):
            with fs.open_file(fs.join(d, name), "wb") as f:
                f.write(name.encode())
        assert sorted(fs.listdir(d)) == ["a.bin", "b.bin"]
        with fs.open_file(fs.join(d, "a.bin")) as f:
            assert f.read() == b"a.bin"
        got = fs.list_files(fs.join(root, "dir", "sub", "*.bin"))
        assert [os.path.basename(p) for p in got] == ["a.bin", "b.bin"]
        assert all(fs.is_remote(p) == fs.is_remote(root) for p in got)
        fs.remove(got[0])
        assert fs.listdir(d) == ["b.bin"]
        fs.remove_tree(fs.join(root, "dir"))
        assert not fs.exists(fs.join(root, "dir"))
        fs.remove_tree(fs.join(root, "dir"))  # absent: nothing to do


def test_remote_reads_take_the_environment_hints(monkeypatch, mem):
    monkeypatch.setenv("DALLE_TPU_GCS_BLOCK_MB", "32")
    monkeypatch.setenv("DALLE_TPU_GCS_CACHE", "background")
    assert fs._remote_read_hints() == ("background", 32 << 20)
    seen = []
    real = fsspec.open

    def spy(path, mode="rb", **kw):
        seen.append(kw)
        return real(path, mode, **kw)

    monkeypatch.setattr(fsspec, "open", spy)
    with fs.open_file(f"{mem}/x", "wb") as f:
        f.write(b"x")
    with fs.open_file(f"{mem}/x") as f:
        assert f.read() == b"x"
    with fs.open_file(f"{mem}/x", block_size=7) as f:
        f.read()
    assert seen == [{}, {"cache_type": "background", "block_size": 32 << 20},
                    {"cache_type": "background", "block_size": 7}]


def test_prefetch_iter_keeps_order_raises_and_is_bounded():
    assert list(prefetch_iter(iter(range(500)), depth=7)) == list(range(500))
    assert list(prefetch_iter(iter([]), depth=3)) == []

    def bad():
        yield 1
        raise IOError("backend died")

    it = prefetch_iter(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(IOError, match="backend died"):
        next(it)

    produced = []

    def src():
        for i in range(100):
            produced.append(i)
            yield i

    before = set(threading.enumerate())
    it = prefetch_iter(src(), depth=8)
    assert next(it) == 0
    (producer,) = [t for t in threading.enumerate() if t not in before and t.name == "readahead"]
    for _ in range(200):
        if len(produced) >= 9:
            break
        time.sleep(0.01)
    time.sleep(0.1)
    assert 9 <= len(produced) <= 11  # 1 taken, 8 queued, 1 in hand at the put
    it.close()
    producer.join(timeout=10)  # it ends once abandoned
    assert not producer.is_alive()


def test_readahead_depth_from_config_and_environment(monkeypatch, mem):
    with ttfr.TFRecordWriter(f"{mem}/a_0.tfrecords") as w:
        w.write(ttfr.serialize_example({"tokens": [1], "caption": [2]}))
    params = {"dataset": {"train_path": f"{mem}/*.tfrecords", "tokens": True,
                          "readahead_depth": 13, "cycle_length": 7},
              "train_batch_size": 1, "eval_batch_size": 1, "text_seq_len": 2}
    p = tpipe.dalle_input_fn(params)
    assert (p.readahead_depth, p.cycle_length) == (13, 7)
    monkeypatch.setenv("DALLE_TPU_READAHEAD_DEPTH", "21")
    del params["dataset"]["readahead_depth"]
    assert tpipe.dalle_input_fn(params).readahead_depth == 21


# ------------------------------------------------------ remote pipelines

def _jpeg(rng) -> bytes:
    import io

    from PIL import Image

    arr = rng.integers(0, 256, (int(rng.integers(12, 30)), int(rng.integers(12, 30)), 3),
                       dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def _write_records(root, tokens, files=3, per_file=9, seed=0):
    """Records under ``root`` (a URL or a directory): tokens + caption, or
    JPEG + caption; returns the glob."""
    rng = np.random.default_rng(seed)
    fs.makedirs(root)
    for f in range(files):
        with ttfr.TFRecordWriter(fs.join(root, f"part_{f}.tfrecords")) as w:
            for _ in range(per_file + f):  # uneven files
                caption = rng.integers(0, 48, int(rng.integers(0, 12))).tolist()
                ex = ({"tokens": rng.integers(0, 32, 16).tolist()} if tokens
                      else {"image": _jpeg(rng)})
                w.write(ttfr.serialize_example({**ex, "caption": caption}))
    return fs.join(root, "*.tfrecords")


def _params(pattern, **ds):
    return {"dataset": {"train_path": pattern, "eval_path": pattern, "image_size": 12, **ds},
            "train_batch_size": 4, "eval_batch_size": 3, "text_seq_len": 6, "padding_id": 47}


def _same(want, got, n):
    for _ in range(n):
        w, g = next(want), next(got)
        assert set(g) == set(w)
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


CASES = [("dalle_input_fn", {"tokens": True}), ("dalle_input_fn", {}),
         ("dalle_input_fn", {"uint8_images": True}), ("vae_input_fn", {"tfrecords": True})]


@pytest.mark.parametrize("fn,ds", CASES)
@pytest.mark.parametrize("skip_steps", [0, 3])
def test_remote_pipelines_match_jax(mem, port_pil, fn, ds, skip_steps):
    params = _params(_write_records(mem, tokens=ds.get("tokens", False)), **ds)
    for eval_, n in ((False, 10), (True, 6)):
        skip = 0 if eval_ else skip_steps
        pipeline = getattr(tpipe, fn)(params, eval=eval_, skip_steps=skip)
        want = iter(getattr(jpipe, fn)(params, eval=eval_, shard=(0, 1), skip_steps=skip))
        got = iter(pipeline)
        _same(want, got, n)
        want.close()
        got.close()
        assert pipeline.reader == "python + readahead"


@pytest.mark.parametrize("fn,ds", CASES[1:])
def test_remote_native_pool_reads_what_a_local_copy_reads(mem, tmp_path, fn, ds):
    """The port's native pool over memory:// shards (read in Python, ahead
    on threads) and over a local copy (io_uring) gives the same batches."""
    if tnative.missing_toolchain() is not None:
        pytest.skip(f"the native library cannot be built here: {tnative.missing_toolchain()}")
    _write_records(str(tmp_path / "local"), tokens=False)
    _copy_to(mem, str(tmp_path / "local"))
    remote = getattr(tpipe, fn)(_params(f"{mem}/*.tfrecords", **ds), skip_steps=2)
    local = getattr(tpipe, fn)(_params(str(tmp_path / "local" / "*.tfrecords"), **ds),
                               skip_steps=2)
    want, got = iter(local), iter(remote)
    _same(want, got, 8)
    want.close()
    got.close()
    assert (remote.reader, remote.decoder) == ("python + readahead", "native pool")
    assert local.reader in ("io_uring", "native")


# ------------------------------------------------------------ model dirs

VAE = {"model_type": "vae", "num_tokens": 32, "convblocks": [[1, 8], [1, 16]]}


def _vae_config(tmp_path, data, model_path, name, train_steps=3):
    cfg = {**VAE, "dataset": {"train_path": data, "eval_path": data, "image_size": 16,
                              "tfrecords": True},
           "train_batch_size": 2, "eval_batch_size": 2, "train_steps": train_steps,
           "steps_per_checkpoint": 1, "eval_steps": 1, "log_every": 1, "max_to_keep": 2,
           "lr": 1e-3, "warmup_steps": 0, "model_path": model_path}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _ckpt(model_dir, step):
    from dalle_mtf_tpu_torch.utils import checkpoint

    return checkpoint.read(fs.join(model_dir, "checkpoints", f"ckpt_{step}.pt"))


def _same_params(a, b):
    assert set(a) == set(b)
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0, msg=name)


@pytest.fixture
def vae_runs(tmp_path, mem, monkeypatch):
    """``train_vae.main --device cpu`` for 3 steps on local data and model
    dir, and on memory:// ones: (local trainer, remote trainer)."""
    from dalle_mtf_tpu_torch import train_vae

    monkeypatch.chdir(tmp_path)
    _write_records(str(tmp_path / "data"), tokens=False, files=2, per_file=4)
    _copy_to(f"{mem}/data", str(tmp_path / "data"))
    runs = []
    for data, model in ((str(tmp_path / "data" / "*.tfrecords"), str(tmp_path / "run")),
                        (f"{mem}/data/*.tfrecords", f"{mem}/run")):
        runs.append(train_vae.main(["--model", _vae_config(tmp_path, data, model, "vae"),
                                    "--device", "cpu"]))
    return runs


def test_train_vae_on_a_remote_model_dir_keeps_what_a_local_run_keeps(vae_runs, mem):
    from dalle_mtf_tpu_torch.utils.summaries import read_summaries

    local, remote = vae_runs
    assert remote.model_dir == f"{mem}/run" and remote.ckpt_dir == f"{mem}/run/checkpoints"
    assert [h["loss"] for h in remote.history] == [h["loss"] for h in local.history]
    assert remote.eval_history == local.eval_history
    assert remote.checkpoint_steps() == local.checkpoint_steps() == [2, 3]  # max_to_keep 2
    for step in (2, 3):
        _same_params(_ckpt(remote.model_dir, step)["params"], _ckpt(local.model_dir, step)["params"])
    got = [(s, t) for s, t, _ in read_summaries(remote.model_dir)]
    assert got == [(s, t) for s, t, _ in read_summaries(local.model_dir)]
    assert {t for _, t in got} >= {"loss", "eval_loss", "input_image/image/0"}


def test_restore_and_encode_over_urls(vae_runs, mem, tmp_path, port_pil):
    from dalle_mtf_tpu_torch.data.encode_dataset import encode_dataset
    from dalle_mtf_tpu_torch.train.tasks import make_vae_task
    from dalle_mtf_tpu_torch.utils import convert
    from dalle_mtf_tpu_torch.utils.config import Config
    from dalle_mtf_tpu_torch.utils.restore import restore_vae_params

    local, remote = vae_runs
    vae = make_vae_task(Config.from_mapping({**VAE, "dataset": {"image_size": 16}}), "cpu")[0]
    got, want = restore_vae_params(vae, remote.model_dir), restore_vae_params(vae, local.model_dir)
    _same_params(dict(convert._flatten(got)), _ckpt(local.model_dir, 3)["params"])
    for data, out in ((f"{mem}/data/*.tfrecords", f"{mem}/enc"),
                      (str(tmp_path / "data" / "*.tfrecords"), str(tmp_path / "enc"))):
        assert encode_dataset(data, out, "tok", vae, got if "://" in out else want,
                              image_size=16, batch_size=3, examples_per_file=4) == 3
    for i in range(3):
        with fs.open_file(f"{mem}/enc/tok_{i}.tfrecords") as f:
            assert f.read() == (tmp_path / "enc" / f"tok_{i}.tfrecords").read_bytes()


def _dalle_config(tmp_path, data, model_path, train_steps):
    (tmp_path / "vae.json").write_text(json.dumps({**VAE, "dataset": {"image_size": 16}}))
    cfg = {
        "model_type": "dalle", "vae_model": str(tmp_path / "vae.json"),
        "dataset": {"train_path": data, "eval_path": data, "tokens": True},
        "n_embd": 32, "text_vocab_size": 50258, "image_vocab_size": 32, "text_seq_len": 6,
        "n_layers": 1, "n_heads": 2, "train_batch_size": 4, "eval_batch_size": 4,
        "train_steps": train_steps, "steps_per_checkpoint": 2, "eval_steps": 1,
        "log_every": 1, "max_to_keep": 1, "lr": 1e-3, "warmup_steps": 1, "lr_decay_end": 4,
        "attention_dropout": 0.1, "model_path": model_path,
    }
    path = tmp_path / f"dalle_{uuid.uuid4().hex[:8]}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_train_dalle_on_remote_paths_resumes_bit_equal(tmp_path, mem, monkeypatch):
    """4 steps on memory:// data and model dir equal 4 local steps, and 2
    steps, a restore from the URL and 2 more equal both; ``--new`` clears
    the remote dir."""
    from dalle_mtf_tpu_torch import train_dalle

    monkeypatch.chdir(tmp_path)
    local_data = _write_records(str(tmp_path / "data"), tokens=True)
    _copy_to(f"{mem}/data", str(tmp_path / "data"))
    remote_data = f"{mem}/data/*.tfrecords"
    local = train_dalle.main(["--model", _dalle_config(tmp_path, local_data,
                                                       str(tmp_path / "run"), 4),
                              "--device", "cpu"])
    whole = train_dalle.main(["--model", _dalle_config(tmp_path, remote_data, f"{mem}/whole", 4),
                              "--device", "cpu"])
    assert [h["loss"] for h in whole.history] == [h["loss"] for h in local.history]
    assert whole.eval_history == local.eval_history
    assert whole.checkpoint_steps() == local.checkpoint_steps() == [4]
    want = _ckpt(local.model_dir, 4)
    _same_params(_ckpt(whole.model_dir, 4)["params"], want["params"])

    train_dalle.main(["--model", _dalle_config(tmp_path, remote_data, f"{mem}/split", 2),
                      "--device", "cpu"])
    path = _dalle_config(tmp_path, remote_data, f"{mem}/split", 4)
    resumed = train_dalle.main(["--model", path, "--device", "cpu"])
    assert [h["step"] for h in resumed.history] == [3, 4]
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in local.history[2:]]
    _same_params(_ckpt(resumed.model_dir, 4)["params"], want["params"])
    assert resumed.checkpoint_steps() == [4]

    again = train_dalle.main(["--model", path, "--new", "--yes", "--device", "cpu"])
    assert [h["step"] for h in again.history] == [1, 2, 3, 4]


def test_a_failed_remote_checkpoint_write_leaves_no_object(mem):
    from dalle_mtf_tpu_torch.utils import checkpoint

    def fetch():
        raise RuntimeError("gather failed")

    path = f"{mem}/checkpoints/ckpt_1.pt"
    with pytest.raises(RuntimeError, match="gather failed"):
        checkpoint.write(path, {"a": torch.ones(2),
                                "b": checkpoint.Lazy((2,), torch.float32, fetch)})
    assert not fs.exists(path) and fs.listdir(f"{mem}/checkpoints") == []
    checkpoint.write(path, {"a": torch.ones(2)})
    torch.testing.assert_close(checkpoint.read(path)["a"], torch.ones(2))


_KILLED_WRITER = """
import os, signal, sys
import torch
from dalle_mtf_tpu_torch.utils import checkpoint
d = sys.argv[1]
checkpoint.write(d + "/ckpt_1.pt", {"step": 1, "w": torch.full((1024,), 1.0)})
def killed():
    os.kill(os.getpid(), signal.SIGKILL)
checkpoint.write(d + "/ckpt_2.pt", {"step": 2, "w": torch.full((1 << 20,), 2.0),
                                    "late": checkpoint.Lazy((2,), torch.float32, killed)})
"""


def test_a_killed_remote_checkpoint_write_leaves_the_previous_one_newest(tmp_path):
    """A process killed half-way through writing ckpt_2 under a file:// model
    dir (no clean-up runs) leaves ckpt_1 the newest checkpoint, which the
    restore then reads; the next write of ckpt_2 replaces the leftover."""
    import subprocess
    import sys

    from dalle_mtf_tpu_torch.train.trainer import checkpoint_steps
    from dalle_mtf_tpu_torch.utils import checkpoint

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = f"file://{tmp_path}/checkpoints"
    fs.makedirs(d)
    env = {**os.environ, "PYTHONPATH": root}
    proc = subprocess.run([sys.executable, "-c", _KILLED_WRITER, d], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -9, proc.stderr
    assert fs.listdir(d) != ["ckpt_1.pt"]  # the cut write left something behind
    assert checkpoint_steps(d) == [1]
    obj = checkpoint.read(fs.join(d, "ckpt_1.pt"))
    assert obj["step"] == 1 and torch.equal(obj["w"], torch.full((1024,), 1.0))
    checkpoint.write(fs.join(d, "ckpt_2.pt"), {"step": 2, "w": torch.full((4,), 2.0)})
    assert sorted(fs.listdir(d)) == ["ckpt_1.pt", "ckpt_2.pt"]
    assert checkpoint_steps(d) == [1, 2]
    assert checkpoint.read(fs.join(d, "ckpt_2.pt"))["step"] == 2


def test_remove_model_dir_clears_a_url(mem):
    from dalle_mtf_tpu_torch.utils.logging_utils import remove_model_dir

    with fs.open_file(f"{mem}/run/checkpoints/ckpt_1.pt", "wb") as f:
        f.write(b"x")
    remove_model_dir(f"{mem}/run", interactive=False)
    assert not fs.exists(f"{mem}/run")


def test_url_model_dirs_are_kept_as_given(tmp_path, monkeypatch):
    """A gs:// model_path stays a URL (it once became <cwd>/gs:/b/run, where
    checkpoints went without a word); a local one is made absolute. No gs://
    request is made."""
    from dalle_mtf_tpu_torch.train.trainer import Trainer, model_dir_path
    from dalle_mtf_tpu_torch.utils.restore import _ckpt_dir

    monkeypatch.chdir(tmp_path)
    assert model_dir_path("gs://bucket/run") == "gs://bucket/run"
    assert model_dir_path("s3://bucket/a/b/") == "s3://bucket/a/b/"
    assert model_dir_path("runs/x") == str(tmp_path / "runs" / "x")
    tr = Trainer({"train_batch_size": 1, "lr": 1e-3}, None, None, "gs://bucket/run", 1, "cpu")
    assert tr.model_dir == "gs://bucket/run"
    assert tr.ckpt_dir == "gs://bucket/run/checkpoints"
    assert tr.writer.logdir == "gs://bucket/run"
    assert _ckpt_dir("gs://bucket/vae/") == "gs://bucket/vae/checkpoints"
    assert not os.path.exists(tmp_path / "gs:")
