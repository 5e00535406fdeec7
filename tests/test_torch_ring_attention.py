"""The port's ring attention (dalle_mtf_tpu_torch/ops/ring_attention.py) and
mesh grammar (parallel/mesh.py) against the JAX package, on the CPU.

- The plain per-hop versions against the JAX ``_ring_partial`` and
  ``_ring_block_grads`` (the Pallas TPU kernels ``_ring_fwd_kernel`` and
  ``_ring_bwd_kernel``, run with ``interpret=True``; outside ``shard_map``
  their ``_vma_of`` is None) at B=1, H=2, S=32, D=128, fp32: diagonal, past,
  window-band and far hops, and hash dropout. The triple is compared on rows
  with a live key (a row without one is the fold's to discard, and the
  CUDA kernel writes it differently). Tolerance 1e-5 of each tensor's max:
  the same fp32 math summed in another order.
- ``ring_attention`` in 4 gloo processes (tests/torch_ring_worker.py under
  ``torch.distributed.run``), values and grads, against JAX
  ``ring_attention_auto`` in ``shard_map`` over a 4-device CPU mesh and the
  port's single-process ``attention_reference``, including ``local_ring``
  (a window), hash dropout and a data x seq mesh. Tolerance: atol 2e-5 on
  the output and 5e-5 on the grads (unit-normal inputs, fp32), as the JAX
  package's own ring tests.
- ``parse_mesh_shape``, ``parse_layout`` and the resize rule against JAX
  ``build_mesh``.
"""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from dalle_mtf_tpu.parallel import mesh as jmesh
from dalle_mtf_tpu_torch.ops import ring_attention as tring
from dalle_mtf_tpu_torch.ops.attention import attention_reference
from dalle_mtf_tpu_torch.parallel import mesh as tmesh

# the module (the package's ``ring_attention`` name is the function)
jring = importlib.import_module("dalle_mtf_tpu.ops.ring_attention")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_ring_worker.py")


def run_ranks(mode, inputs, out_dir, n=4):
    """tests/torch_ring_worker.py in ``n`` gloo ranks on the CPU."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), WORKER, mode, str(inputs), str(out_dir)]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]


# (name, diff, window, rate) at S = 32: the diagonal hop, a past hop, the
# window band across the shard edge (rows 0-6 see keys), a far hop whose rows
# see no key, and hash dropout on the diagonal hop and in a band (rows 0-22)
HOPS = [
    ("diagonal", 0, None, 0.0),
    ("past", 32, None, 0.0),
    ("window_band", 64, 40, 0.0),
    ("window_far", 96, 40, 0.0),
    ("dropout_diagonal", 0, None, 0.25),
    ("dropout_past_window", 64, 56, 0.25),
]


def _close(got, want, what, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0, err_msg=what)


@pytest.mark.parametrize("name,diff,window,rate", HOPS, ids=[h[0] for h in HOPS])
def test_ring_hop_references_match_jax_kernels(name, diff, window, rate):
    b, h, s, d = 1, 2, 32, 128
    rng = np.random.default_rng(diff + int(rate * 100))
    q, k, v, g = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4))
    row0 = 96
    col0, seed = row0 - diff, 1234567
    info = jnp.asarray([[diff, row0, col0, seed]], jnp.int32)
    jnum, jm, jl = jring._ring_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), info,
                                       True, window, rate, h)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    num, m, l = tring.ring_partial(tq, tk, tv, diff, row0, col0, window, rate, seed)
    _, _, mask = tring._masks(s, s, diff, window, "cpu")
    live = (~mask.all(-1)).numpy()
    if name == "window_far":
        assert not live.any()
    elif window is not None:
        assert live.any() and not live.all()
    jm, jl = np.asarray(jm).reshape(b * h, s), np.asarray(jl).reshape(b * h, s)
    if live.any():
        _close(m.numpy()[:, live], jm[:, live], "m")
        _close(l.numpy()[:, live], jl[:, live], "l")
        _close(num.numpy()[:, :, live], np.asarray(jnum)[:, :, live], "num")

    # one hop's gradients, from this hop's lse and an arbitrary dsum
    lse = m + torch.log(l)
    dsum = torch.from_numpy(rng.standard_normal((b * h, s)).astype(np.float32))
    jdq, jdk, jdv = jring._ring_block_grads(
        jnp.asarray(q), jnp.asarray(g), jnp.asarray(lse.numpy().reshape(b, h, s, 1)),
        jnp.asarray(dsum.numpy().reshape(b, h, s, 1)), jnp.asarray(k), jnp.asarray(v),
        info, True, window, rate, h)
    dk0, dv0 = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
                for _ in range(2))
    dk, dv = dk0.clone(), dv0.clone()
    dq = tring.ring_block_grads(tq, tg, lse, dsum, tk, tv, dk, dv, diff, row0, col0, window,
                                rate, seed)
    _close(dq.numpy(), jdq, "dq")
    # added into the accumulators in place
    _close((dk - dk0).numpy(), jdk, "dk", 1e-5 * max(1.0, np.abs(dk0.numpy()).max()))
    _close((dv - dv0).numpy(), jdv, "dv", 1e-5 * max(1.0, np.abs(dv0.numpy()).max()))


def test_live_shard_matches_jax():
    for my in range(4):
        for src in range(4):
            for window in (None, 1, 8, 9, 17, 40):
                want = bool(jring._live_shard(src, my, 8, window))
                assert tring._live_shard(src, my, 8, window) == want, (my, src, window)


# (mesh_shape, window, dropout): the ring, local_ring with dropout, and a
# data x seq mesh with dropout (the seed offset by the global batch row)
RINGS = [("data:1,seq:4", None, 0.0), ("data:1,seq:4", 40, 0.25), ("data:2,seq:2", None, 0.25)]


@pytest.mark.parametrize("mesh_shape,window,rate", RINGS)
def test_ring_attention_four_ranks_matches_jax_and_single_process(tmp_path, mesh_shape, window,
                                                                  rate):
    _four_ranks_against_jax(tmp_path, mesh_shape, window, rate, plain=False)


def test_ring_attention_plain_hops_match_jax(tmp_path):
    """``plain=True`` (the model's choice at a head dim the kernels do not
    take, here D = 32) runs the ring's forward fold and backward through the
    hops' plain versions on any device; the same check as above, with a
    window and dropout."""
    _four_ranks_against_jax(tmp_path, "data:1,seq:4", 40, 0.25, plain=True)


def _four_ranks_against_jax(tmp_path, mesh_shape, window, rate, plain):
    b, h, s, d = 2, 2, 128, 32
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4))
    axes = tmesh.parse_mesh_shape(mesh_shape)
    mesh = JaxMesh(np.array(jax.devices()[:4]).reshape([n for _, n in axes]),
                   tuple(n for n, _ in axes))
    key = jax.random.PRNGKey(3)
    seed = int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32))

    def jax_loss(q_, k_, v_):
        out = jring.ring_attention_auto(q_, k_, v_, "seq", "data", window=window,
                                        dropout_rate=rate, dropout_rng=key if rate else None)
        return (out * g).sum(), out

    with mesh:
        (_, jout), jgrads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                                       has_aux=True))(q, k, v)
    torch.save({**{n: torch.from_numpy(x) for n, x in zip("qkvg", (q, k, v, g))},
                "mesh_shape": mesh_shape, "window": window, "rate": rate, "seed": seed,
                "plain": plain},
               tmp_path / "in.pt")
    run_ranks("attention", tmp_path / "in.pt", tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(4)]
    n_data = dict(axes)["data"]
    grid = {(r["coords"]["data"], r["coords"]["seq"]): r for r in ranks}

    def gather(name):
        return torch.cat([torch.cat([grid[(i, j)][name] for j in range(4 // n_data)], 2)
                          for i in range(n_data)], 0).numpy()

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    ref = attention_reference(*leaves, causal=True, window=window, dropout_rate=rate,
                              dropout_seed=seed)
    ref.backward(torch.from_numpy(g))
    np.testing.assert_allclose(gather("out"), np.asarray(jout), atol=2e-5)
    np.testing.assert_allclose(gather("out"), ref.detach().numpy(), atol=2e-5)
    for name, jgrad, leaf in zip(("dq", "dk", "dv"), jgrads, leaves):
        np.testing.assert_allclose(gather(name), np.asarray(jgrad), atol=5e-5, err_msg=name)
        np.testing.assert_allclose(gather(name), leaf.grad.numpy(), atol=5e-5, err_msg=name)
    # on the CPU the wrappers run the plain versions: no kernel launched
    assert all(c == 0 for r in ranks for c in r["launches"].values())


@pytest.mark.parametrize("mesh_shape", ["data:16,model:2", "data:1", "data:2,seq:4",
                                        "data:1,seq:4", "pipe:2,data:2,model:2", "", None,
                                        "data:3,model:5"])
def test_mesh_grammar_and_resize_match_jax(mesh_shape):
    assert tmesh.parse_mesh_shape(mesh_shape) == jmesh.parse_mesh_shape(mesh_shape)
    for n in (1, 2, 4, 8):
        want = list(jmesh.build_mesh(mesh_shape, devices=jax.devices()[:n]).shape.items())
        assert tmesh.resize_axes(tmesh.parse_mesh_shape(mesh_shape), n) == want, n
    for layout in ("batch_dim:data", "batch_dim:data, total_seq_dim:seq,heads_dim:model",
                   "", None, "layers:pipe,vocab_dim:model,intermediate_expanded:model"):
        assert tmesh.parse_layout(layout) == jmesh.parse_layout(layout)


def test_mesh_rank_grid_and_slices():
    """Ranks lie on the axes in row-major order (the last axis fastest), and
    each axis' slices cover every rank once."""
    shape = [2, 3, 2]
    coords = [tmesh._unravel(r, shape) for r in range(12)]
    assert coords == [list(np.unravel_index(r, shape)) for r in range(12)]
    for axis in range(3):
        slices = tmesh._slices(shape, axis)
        assert sorted(r for sl in slices for r in sl) == list(range(12))
        for sl in slices:
            assert len(sl) == shape[axis]
            for i, r in enumerate(sl):
                c = coords[r]
                assert c[axis] == i and all(c[a] == coords[sl[0]][a] for a in range(3)
                                            if a != axis)
    mesh = tmesh.build_mesh("data:16,model:2", "batch_dim:data,heads_dim:model")
    assert mesh.axes == [("data", 1), ("model", 1)] and mesh.size("model") == 1
    assert mesh.index("data") == 0 and mesh.group("data") is None


def test_backend_follows_the_layout():
    """nccl only when every local rank has a card of its own; ranks sharing
    a card, and the CPU, run gloo. No CUDA device: a card raises."""
    from dalle_mtf_tpu_torch.utils import distributed

    cuda0 = torch.device("cuda:0")
    assert distributed.backend_for(cuda0, 4, 1) == "gloo"
    assert distributed.backend_for(cuda0, 4, 4) == "nccl"
    assert distributed.backend_for(cuda0, 1, 1) == "nccl"
    assert distributed.backend_for(torch.device("cpu"), 4, 1) == "gloo"
    assert distributed.rank_device(None, "cpu", 3, 4) == torch.device("cpu")
    if not torch.cuda.is_available():
        for gpu_ids, device in ((["0"], "cuda"), (None, "cuda")):
            with pytest.raises(RuntimeError, match="--device cpu"):
                distributed.rank_device(gpu_ids, device, 1, 4)
