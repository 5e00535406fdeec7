"""The port's dataset builders (dalle_mtf_tpu_torch/data/create_tfrecords.py,
data/smoke_data.py) against the JAX package's, on the CPU at tiny sizes:
from the same jsonl, images and seed, ``paired`` (with and without
``--reencode``, a shard rollover, to a local directory and to a memory://
``--out``) and ``random`` write the same bytes; ``smoke_data`` the same
images; the CLI the same as the functions. Both packages read the same
captions through their own ``get_tokenizer``, which in one environment is one
tokenizer.
"""

import os

import fsspec
import numpy as np
import pytest

from dalle_mtf_tpu.data import create_tfrecords as jct
from dalle_mtf_tpu.data import smoke_data as jsmoke
from dalle_mtf_tpu_torch.data import create_tfrecords as tct
from dalle_mtf_tpu_torch.data import smoke_data as tsmoke
from dalle_mtf_tpu_torch.data import tfrecord as ttfr


def _tree(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _memory_tree(url) -> dict:
    fs = fsspec.filesystem("memory")
    root = url.split("://", 1)[1].rstrip("/")
    return {os.path.basename(p): fs.cat_file(p) for p in fs.find(root)}


@pytest.fixture
def images(tmp_path):
    """Seeded colored-quadrant JPEGs of two sizes and a PNG: a glob."""
    root = str(tmp_path / "imgs")
    tsmoke.make_quadrant_images(root, n_images=9, size=24, seed=5)
    from PIL import Image

    arr = np.random.default_rng(1).integers(0, 256, (30, 20, 3), dtype=np.uint8)
    Image.fromarray(arr).save(os.path.join(root, "z_other.png"))
    return os.path.join(root, "*.*")


@pytest.fixture
def memory_root():
    """A memory:// directory of this test's own, removed after it."""
    url = f"memory://create_tfrecords_{os.getpid()}_{id(object())}"
    yield url
    fs = fsspec.filesystem("memory")
    root = url.split("://", 1)[1]
    if fs.exists(root):
        fs.rm(root, recursive=True)


@pytest.mark.parametrize("words", [1, 7])
def test_random_writes_jax_bytes(tmp_path, images, words):
    want = jct.create_random_dataset(images, str(tmp_path / "jax"), max_images_per_folder=4,
                                     words_per_caption=words, seed=3)
    got = tct.create_random_dataset(images, str(tmp_path / "port"), max_images_per_folder=4,
                                    words_per_caption=words, seed=3)
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(want, tmp_path / "jax")
    port, jax_ = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port == jax_
    assert sorted({k.split(os.sep)[0] for k in port}) == ["0", "1", "2", "captions_data.jsonl"]
    items = tct.load_jsonl(got)
    assert items == jct.load_jsonl(want) and len(items) == 10
    assert all(len(i["caption"].split()) == words for i in items)


@pytest.mark.parametrize("reencode", [False, True])
@pytest.mark.parametrize("per_file", [4, 100])
def test_paired_writes_jax_bytes(tmp_path, images, reencode, per_file):
    jsonl = tct.create_random_dataset(images, str(tmp_path / "src"), words_per_caption=5)
    n_jax = jct.create_paired_dataset(jsonl, "pairs", str(tmp_path / "jax"),
                                      examples_per_file=per_file, reencode=reencode)
    n_port = tct.create_paired_dataset(jsonl, "pairs", str(tmp_path / "port"),
                                       examples_per_file=per_file, reencode=reencode)
    assert n_port == n_jax == -(-10 // per_file)  # 4 a file: the rollover to a third
    port = _tree(tmp_path / "port")
    assert port == _tree(tmp_path / "jax")
    assert sorted(port) == [f"pairs_{i}.tfrecords" for i in range(n_port)]
    records = [ttfr.parse_example(r) for i in range(n_port)
               for r in ttfr.read_tfrecord_file(str(tmp_path / "port" / f"pairs_{i}.tfrecords"),
                                                verify_crc=True)]
    items = tct.load_jsonl(jsonl)
    assert len(records) == len(items)
    for ex, item in zip(records, items):  # the whole caption, not its first character
        assert len(ex["caption"]) == len(item["caption"].encode())
        raw = open(os.path.join(tmp_path / "src", item["image_path"]), "rb").read()
        assert (ex["image"][0] == raw) != reencode
        if not reencode:
            continue
        assert ex["image"][0][:2] == b"\xff\xd8"  # a JPEG, the PNG too
        assert ex["image"][0] == tct._reencode_jpeg(os.path.join(tmp_path / "src",
                                                                 item["image_path"]))


@pytest.mark.parametrize("reencode", [False, True])
def test_paired_to_a_remote_out(tmp_path, images, memory_root, reencode):
    """``--out`` memory://: the local run's files, byte for byte, through the
    CLI; the JAX package's remote shards the same."""
    jsonl = tct.create_random_dataset(images, str(tmp_path / "src"))
    extra = ["--reencode"] if reencode else []
    n = tct.main(["paired", jsonl, "--name", "pairs", "--out", f"{memory_root}/port",
                  "--examples-per-file", "3", *extra])
    assert n == 4
    jct.create_paired_dataset(jsonl, "pairs", f"{memory_root}/jax", examples_per_file=3,
                              reencode=reencode)
    tct.create_paired_dataset(jsonl, "pairs", str(tmp_path / "local"), examples_per_file=3,
                              reencode=reencode)
    remote = _memory_tree(f"{memory_root}/port")
    assert remote == _tree(tmp_path / "local") == _memory_tree(f"{memory_root}/jax")
    assert len(remote) == 4


def test_the_cli_is_the_functions(tmp_path, images):
    jsonl = tct.main(["random", images, "--out", str(tmp_path / "cli")])
    assert jsonl == os.path.join(str(tmp_path / "cli"), "captions_data.jsonl")
    direct = tct.create_random_dataset(images, str(tmp_path / "direct"))
    assert _tree(tmp_path / "cli") == _tree(tmp_path / "direct")
    assert tct.main(["paired", direct, "--name", "x", "--out", str(tmp_path / "out"),
                     "--examples-per-file", "6"]) == 2
    tct.create_paired_dataset(direct, "x", str(tmp_path / "out2"), examples_per_file=6)
    assert _tree(tmp_path / "out") == _tree(tmp_path / "out2")
    for argv in (["paired", direct], ["random", images], ["nope"]):
        with pytest.raises(SystemExit):
            tct.main(argv)


def test_jsonl_round_trip(tmp_path):
    items = [{"caption": "a b", "image_path": "0/x.jpg"}, {"caption": "ü", "image_path": "y"}]
    tct.dump_jsonl(items[:1], tmp_path / "a.jsonl")
    tct.dump_jsonl(items[1:], tmp_path / "a.jsonl", append=True)
    jct.dump_jsonl(items, tmp_path / "b.jsonl")
    assert (tmp_path / "a.jsonl").read_bytes() == (tmp_path / "b.jsonl").read_bytes()
    assert tct.load_jsonl(tmp_path / "a.jsonl") == items


@pytest.mark.parametrize("n,size,seed", [(3, 32, 0), (5, 17, 4), (2, 64, 9)])
def test_quadrant_images_equal_jax(tmp_path, n, size, seed):
    from PIL import Image

    got = tsmoke.make_quadrant_images(str(tmp_path / "port"), n_images=n, size=size, seed=seed)
    want = jsmoke.make_quadrant_images(str(tmp_path / "jax"), n_images=n, size=size, seed=seed)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()
        np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
        assert Image.open(a).size == (size, size)


def test_smoke_tfrecords_equal_jax(tmp_path, monkeypatch):
    """``make_smoke_tfrecords`` (its data/smoke_paired under the working
    directory) writes the JAX package's shards."""
    trees = {}
    for name, mod in (("port", tsmoke), ("jax", jsmoke)):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        mod.make_quadrant_images("data/smoke_imgs", n_images=40, size=16)
        mod.make_smoke_tfrecords("data/smoke_imgs/*.jpg", "data/smoke_tfrecords")
        trees[name] = _tree(tmp_path / name / "data")
    assert trees["port"] == trees["jax"]
    assert sorted(k for k in trees["port"] if k.startswith("smoke_tfrecords")) == [
        os.path.join("smoke_tfrecords", f"smoke_{i}.tfrecords") for i in range(2)]
