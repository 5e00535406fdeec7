"""The port's vocab-parallel loss heads (dalle_mtf_tpu_torch/ops/xent_fused.py
under a ``vocab_dim`` axis) against the JAX package's, on the CPU.

- ``chunked_softmax_xent_auto`` (loss, dx, dw, db under a cotangent) and
  ``chunked_xent_eval_auto`` (loss, correct) on 2 and 4 gloo ranks
  (tests/torch_tp_worker.py under ``torch.distributed.run``: each rank holds
  its stored block of the vocabulary, the padding lives in the op) against
  JAX's ``*_auto`` under ``build_mesh("data:1,model:m")`` on the suite's
  fake CPU devices, and the JAX single-device op; fp32 and bf16, z-loss on
  and off, V = 401 (ragged: the last block holds 145 rows of 256 at m = 2,
  17 of 128 at m = 4); ties planted across the blocks' boundaries, which
  the first index must win.
- The padded-vocabulary rule of ``parallel.mesh``, a pure function, at
  dalle_coco's V = 52,307.

Tolerances as tests/test_torch_xent_fused.py: fp32 within 1e-5 of each
tensor's largest |value|, bf16 within 2e-2; ``correct`` equal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_mtf_tpu.ops import xent_fused as jxent
from dalle_mtf_tpu.parallel.mesh import build_mesh as jax_build_mesh
from dalle_mtf_tpu_torch.parallel import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_tp_worker.py")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
N, E, V, CHUNKS = 24, 16, 401, 3
# rows whose two largest logits tie across blocks: (row, first col, second col)
TIES = ((0, 5, 300), (1, 5, 300), (2, 200, 390))
CASES = [(dtype, z) for dtype in ("float32", "bfloat16") for z in (0.0, 1e-4)]


def torchrun(n: int, mode: str, cases, tmp_path, timeout: int = 300):
    """Run tests/torch_tp_worker.py ``mode`` on ``n`` gloo ranks; rank 0's
    results, one a case."""
    torch.save(cases, tmp_path / "in.pt")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(n), WORKER, mode, str(tmp_path / "in.pt"), str(tmp_path)]
    res = subprocess.run(cmd, cwd=tmp_path, env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    return torch.load(tmp_path / "out.pt", weights_only=False)


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, E)).astype(np.float32)
    w = (rng.standard_normal((E, V)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    t = rng.integers(0, V, N)
    g = rng.standard_normal(N).astype(np.float32)
    for row, c0, c1 in TIES:
        w[:, c1], b[c1] = w[:, c0], b[c0]
        x[row] = 4.0 * w[:, c0] / np.linalg.norm(w[:, c0])  # the pair dominates the row
    t[0], t[1], t[2] = 5, 300, 200  # the first of a tie is right, the second wrong
    if dtype == "bfloat16":  # one rounding, shared by both packages
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    return x, w, b, t, g


def _close(got, want, tol, name):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=tol * max(np.abs(want).max(), 1e-30), rtol=0,
                               err_msg=name)


@pytest.fixture(scope="module", params=[2, 4])
def tp_run(request, tmp_path_factory):
    """One launch on m ranks of every (dtype, z_loss) case: (m, results)."""
    m = request.param
    cases = []
    for dtype, z in CASES:
        x, w, b, t, g = _inputs(dtype)
        tdt = getattr(torch, dtype)
        cases.append({"x": torch.tensor(x).to(tdt), "w": torch.tensor(w).to(tdt),
                      "b": torch.from_numpy(b), "t": torch.from_numpy(t), "g": torch.from_numpy(g),
                      "z_loss": z, "chunks": CHUNKS})
    return m, dict(zip(CASES, torchrun(m, "xent", cases, tmp_path_factory.mktemp(f"tp{m}"))))


def _jax_inputs(dtype):
    x, w, b, t, g = _inputs(dtype)
    jdt = getattr(jnp, dtype)
    return jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b), jnp.asarray(t), jnp.asarray(g)


@pytest.mark.parametrize("dtype,z", CASES)
def test_tp_xent_matches_jax(tp_run, dtype, z):
    m, results = tp_run
    got = results[(dtype, z)]
    x, w, b, t, g = _jax_inputs(dtype)

    def tp(x_, w_, b_):
        return jxent.chunked_softmax_xent_auto(x_, w_, b_, t, z, CHUNKS, vocab_axis="model")

    with jax_build_mesh(f"data:1,model:{m}"):
        loss, vjp = jax.vjp(jax.jit(tp), x, w, b)
        dx, dw, db = vjp(g)
    plain = jxent.chunked_softmax_xent(x, w, b, t, z, CHUNKS)
    for name, got_t, want in (("loss", got["loss"], loss), ("plain loss", got["loss"], plain),
                              ("dx", got["dx"], dx), ("dw", got["dw"], dw), ("db", got["db"], db)):
        _close(got_t, want, TOL[dtype], name)
    assert got["dw"].shape == (E, V) and got["db"].shape == (V,)


@pytest.mark.parametrize("dtype,z", CASES)
def test_tp_eval_matches_jax(tp_run, dtype, z):
    m, results = tp_run
    got = results[(dtype, z)]
    x, w, b, t, _ = _jax_inputs(dtype)
    with jax_build_mesh(f"data:1,model:{m}"):
        loss, correct = jax.jit(lambda x_, w_, b_: jxent.chunked_xent_eval_auto(
            x_, w_, b_, t, z, CHUNKS, vocab_axis="model"))(x, w, b)
    _close(got["eval_loss"], loss, TOL[dtype], "eval loss")
    np.testing.assert_array_equal(got["correct"].numpy(), np.asarray(correct))
    _, plain = jxent.chunked_xent_eval(x, w, b, t, z, CHUNKS)
    np.testing.assert_array_equal(got["correct"].numpy(), np.asarray(plain))
    # the planted ties: the first index wins, across the blocks
    assert got["correct"][:3].tolist() == [1.0, 0.0, 1.0]


@pytest.mark.parametrize("m,block,stored", [(2, 26240, (26240, 26067)),
                                            (8, 6656, (6656,) * 7 + (5715,))])
def test_padded_vocab_rule(m, block, stored):
    v = 52307
    assert tmesh.padded_vocab(v, m) == block * m
    assert tmesh.padded_vocab(v, m) % (128 * m) == 0
    bounds = tmesh.split_bounds(tmesh.VOCAB, v, m)
    assert [b - a for a, b in bounds] == list(stored)
    assert [a for a, _ in bounds] == [i * block for i in range(m)]
    assert bounds[-1][1] == v
    # other dims split evenly, or not at all
    assert tmesh.split_bounds(tmesh.HEADS, 8, 2) == ((0, 4), (4, 8))
    assert tmesh.split_bounds(tmesh.INTERMEDIATE, 6, 4) is None
    with pytest.raises(ValueError, match="no rows"):
        tmesh.split_bounds(tmesh.VOCAB, 100, 2)
