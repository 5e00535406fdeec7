"""The sharded init and the checkpoint path that never holds the whole tree.

- ``DALLE.init`` on ``data:1,model:m`` (a fake process group of m ranks,
  each rank's init in turn) for m in 1, 2, 4, 8: the blocks of every rank
  put together are the single process's tree bit for bit, and each rank
  draws exactly the elements of its blocks (``drawn_elements``).
- ``utils/checkpoint.py::write`` streams: each Lazy leaf is fetched at its
  turn and let go before the next; the file loads with ``torch.load``
  (also mapped), and a write that fails leaves no file behind.
- A checkpoint written by 8 gloo ranks at ``model:8`` (one launch of
  tests/torch_tp_worker.py ``ckpt``: one AdamW step, then the save) is the
  whole tree and state: it restores at ``data:4,model:2`` in the same
  launch, every rank holding the file's blocks of the parameters and the
  moments bit for bit and copying only them, and on one process here; its
  one step agrees with one process's step within 1e-5 of each leaf's
  largest value (the same arithmetic summed over the split in another
  order).
"""

import gc
import math
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from dalle_mtf_tpu_torch.models import dalle as tdalle
from dalle_mtf_tpu_torch.parallel import mesh as tmesh
from dalle_mtf_tpu_torch.parallel.tensor import shard
from dalle_mtf_tpu_torch.train.optim import named_leaves
from dalle_mtf_tpu_torch.train.trainer import Trainer
from dalle_mtf_tpu_torch.utils import checkpoint
from test_torch_tp_dalle import TP
from test_torch_tp_xent import torchrun

# heads 8, 4E = 1024 and V = 900 + 64 + 1 = 965 split evenly into whole units
# at model:8 (one head, 128 columns, 128 vocabulary rows a unit)
INIT_KW = dict(n_embd=256, text_vocab_size=900, image_vocab_size=64, text_seq_len=8,
               image_seq_len=16, n_layers=2, n_heads=8)
CKPT_KW = dict(INIT_KW, n_embd=64, n_layers=1)
OPT = {"lr": 1e-3, "warmup_steps": 0, "train_batch_size": 4, "max_to_keep": 2}
RANDOM = ("wq", "wk", "wv", "wo", "w_mlp1", "w_mlp2", "wte", "wpe", "w_out")


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_sharded_init_is_the_single_process_tree_and_draws_only_the_blocks(m):
    cfg = tdalle.DalleConfig(**INIT_KW)
    whole = dict(named_leaves(tdalle.DALLE(cfg, "cpu").init(torch.Generator().manual_seed(0))))
    blocks = {p: [] for p in whole}
    for rank in range(m):
        if m > 1:
            dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=m)
        try:
            mesh = tmesh.build_mesh(f"data:1,model:{m}", TP, "global", rank, m)
            model = tdalle.DALLE(cfg, "cpu", mesh)
            tree = dict(named_leaves(model.init(torch.Generator().manual_seed(0))))
            drawn = sum(t.numel() for p, t in tree.items() if p[-1] in RANDOM)
            assert model.drawn_elements == drawn
            if m > 1:
                assert drawn < sum(t.numel() for p, t in whole.items() if p[-1] in RANDOM)
            for p, t in tree.items():
                split = model.sharding.of(p) if model.sharding else None
                torch.testing.assert_close(t, shard(whole[p], split), rtol=0, atol=0,
                                           msg=f"rank {rank} of {m}: {p}")
                blocks[p].append((split, t))
        finally:
            if m > 1:
                dist.destroy_process_group()
    for p, parts in blocks.items():
        split = parts[0][0]
        got = parts[0][1] if split is None else torch.cat([t for _, t in parts], split.dim)
        assert torch.equal(got, whole[p]), p


def test_checkpoint_write_streams_one_leaf_at_a_time(tmp_path):
    rng = np.random.default_rng(0)
    leaves = [torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)),
              torch.arange(12, dtype=torch.int64).reshape(3, 4),
              torch.from_numpy(rng.standard_normal(9).astype(np.float32)).bfloat16()]
    fetched, alive = [], []

    def lazy(i):
        def fetch():
            # every leaf fetched before this one has been let go
            gc.collect()
            alive.append(sum(r() is not None for r in fetched))
            t = leaves[i].clone()
            fetched.append(weakref.ref(t))
            return t
        return checkpoint.Lazy(tuple(leaves[i].shape), leaves[i].dtype, fetch)

    tree = {"step": 3, "params": {"a": lazy(0), "b": [lazy(1), {"c": lazy(2)}]},
            "opt": {0: {"step": torch.tensor(2.0)}, "groups": [{"lr": 0.5, "betas": (0.9, 0.99)}]}}
    path = str(tmp_path / "ckpt_3.pt")
    checkpoint.write(path, tree)
    assert alive == [0, 0, 0]
    for got in (torch.load(path, weights_only=True), checkpoint.read(path)):
        assert got["step"] == 3 and got["opt"]["groups"] == [{"lr": 0.5, "betas": (0.9, 0.99)}]
        assert torch.equal(got["params"]["a"], leaves[0])
        assert torch.equal(got["params"]["b"][0], leaves[1])
        assert got["params"]["b"][1]["c"].dtype == torch.bfloat16
        assert torch.equal(got["params"]["b"][1]["c"], leaves[2])
        assert float(got["opt"][0]["step"]) == 2.0

    def broken():
        raise RuntimeError("fetch failed")

    with pytest.raises(RuntimeError, match="fetch failed"):
        checkpoint.write(str(tmp_path / "ckpt_4.pt"),
                         {"a": lazy(0), "b": checkpoint.Lazy((1,), torch.float32, broken)})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_3.pt"]
    with pytest.raises(ValueError, match="expected"):
        checkpoint.write(str(tmp_path / "ckpt_5.pt"),
                         {"a": checkpoint.Lazy((2,), torch.float32, lambda: torch.zeros(3))})




def test_model8_checkpoint_restores_at_model2_and_on_one_process(tmp_path):
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 965, (4, 24)))
    case = {"config": CKPT_KW, "layout": TP, "opt_params": OPT, "tokens": tokens, "seed": 4}
    (ranks,) = torchrun(8, "ckpt", [case], tmp_path, timeout=400)
    saved = torch.load(tmp_path / "ckpt_run" / "checkpoints" / "ckpt_1.pt", weights_only=True)
    cfg = tdalle.DalleConfig(**CKPT_KW)
    model = tdalle.DALLE(cfg, "cpu")
    shapes = dict(named_leaves(model.param_shapes(whole=True)))
    assert {p: tuple(t.shape) for p, t in saved["params"].items()} == {
        "/".join(p): s for p, s in shapes.items()}
    total = sum(math.prod(s) for p, s in shapes.items() if p[-1] in RANDOM)
    for r, fig in enumerate(ranks):
        assert fig["step"] == 1
        # model:8 drew an eighth of the split leaves (and the whole wpe)
        assert fig["drawn_elements"] < total // 4, (r, fig)
        # params and both AdamW moments of its own blocks, nothing more
        assert fig["restored_bytes"] == 3 * fig["local_param_bytes"], (r, fig)
    # data:4,model:2: the ranks of a model index hold the same blocks, the
    # second the shorter vocabulary block, both less than the whole tree
    whole_bytes = 4 * sum(math.prod(s) for s in shapes.values())
    assert len({fig["local_param_bytes"] for fig in ranks[0::2]}) == 1
    assert len({fig["local_param_bytes"] for fig in ranks[1::2]}) == 1
    assert whole_bytes > ranks[0]["local_param_bytes"] > ranks[1]["local_param_bytes"]

    def loss(p, _f, b, g, _s):
        return model.loss(p, b["tokens"], g, train=True)[0], {}

    one = Trainer(OPT, model.init, loss, str(tmp_path / "one"), cfg.total_seq_len, "cpu")
    state = one.init_state(torch.Generator().manual_seed(4))
    state, _ = one.train_step(state, {"tokens": tokens}, torch.Generator().manual_seed(1))
    for p, t in named_leaves(state["params"]):
        want = t.detach()
        torch.testing.assert_close(saved["params"]["/".join(p)], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()) + 1e-3 * OPT["lr"],
                                   msg=str(p))
    # on one process: the whole file
    back = Trainer(OPT, model.init, loss, str(tmp_path / "ckpt_run"), cfg.total_seq_len, "cpu")
    state = back.restore(back.init_state(torch.Generator().manual_seed(9)))
    assert state["step"] == 1
    for p, t in named_leaves(state["params"]):
        assert torch.equal(t.detach(), saved["params"]["/".join(p)]), p
    moments = state["opt"].state_dict()["adamw"]["state"]
    for i, st in saved["opt_state"]["adamw"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(moments[i][k], st[k]), (i, k)
    assert back.restored_bytes == 3 * sum(t.numel() * 4 for _, t in named_leaves(state["params"]))
    one.close()
    back.close()
