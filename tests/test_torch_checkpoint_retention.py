"""``keep_checkpoint_every_n_hours`` in the port's ``Trainer.save``, held to
orbax's own retention, which the JAX trainer gets through
``keep_time_interval`` (dalle_mtf_tpu/train/trainer.py): ``EveryNSeconds``
joined with ``LatestN(max_to_keep)`` by ``AnyPreservationPolicy``, applied
after each save to the checkpoints still on disk, as orbax's
``CheckpointManager`` does.

Each case saves a tiny tree at a list of (step, time) pairs, the clock
(``trainer.now``) replaced by the case's times, and compares the steps left
on disk with what the policies keep on the same list: with the key set, at
hours that are whole, fractional and below a second (orbax truncates the
interval to whole seconds), with times exactly one interval apart, and
across a restart (a second Trainer reads the earlier checkpoints' save
times from their files); with the key unset, the newest ``max_to_keep``
alone, as before the key was read.
"""

import datetime
from types import SimpleNamespace

import pytest
import torch
from orbax.checkpoint.checkpoint_managers import (
    AnyPreservationPolicy,
    EveryNSeconds,
    LatestN,
    PreservationContext,
)

from dalle_mtf_tpu_torch.train import trainer as ttrainer
from dalle_mtf_tpu_torch.utils import checkpoint

HOUR = 3600.0


def _orbax_kept(stamps, max_to_keep, hours):
    """The steps orbax leaves on disk after saving ``stamps`` in turn."""
    policies = [LatestN(n=max_to_keep)]
    if hours:
        seconds = int(datetime.timedelta(hours=hours).total_seconds())
        policies.insert(0, EveryNSeconds(interval_secs=seconds))
    policy, alive = AnyPreservationPolicy(policies), []
    for step, t in stamps:
        alive.append(SimpleNamespace(step=step, metrics=None, time=datetime.datetime.fromtimestamp(
            t, tz=datetime.timezone.utc)))
        keep = policy.should_preserve(alive, context=PreservationContext())
        alive = [c for c, k in zip(alive, keep) if k]
    return [c.step for c in alive]


def _trainer(tmp_path, **over):
    params = {"train_batch_size": 1, "lr": 1e-3, "warmup_steps": 0, **over}
    tr = ttrainer.Trainer(params, lambda g: {"w": torch.zeros(3)}, None,
                          str(tmp_path / "run"), 1, "cpu")
    return tr, tr.init_state(torch.Generator().manual_seed(0))


def _save_at(monkeypatch, tr, state, stamps):
    for step, t in stamps:
        monkeypatch.setattr(ttrainer, "now", lambda t=t: t)
        tr.save(state, step)


# (hours, max_to_keep, save times in seconds from 0, restart after this many saves)
CASES = {
    "every_2h_half_hourly": (2, 2, [i * 1800.0 for i in range(20)], None),
    "exactly_one_interval": (1, 1, [0.0, 1800.0, 3600.0, 3600.5, 7199.0, 7200.0, 9000.0], None),
    "bursts": (0.5, 5, [0, 10, 20, 1790, 1800, 1810, 5000, 5001, 5002, 5003, 5004, 5005,
                        9000], None),
    "below_a_second": (0.4 / HOUR, 2, [0.0, 0.3, 0.6, 0.9, 1.2], None),
    "fractional_hours": (1.25, 3, [i * 1000.0 + 7 for i in range(25)], None),
    "restart": (1, 2, [i * 1500.0 for i in range(14)], 6),
    "restart_at_zero": (2, 1, [i * 2400.0 for i in range(10)], 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kept_steps_equal_orbax(tmp_path, monkeypatch, case):
    hours, max_to_keep, times, restart = CASES[case]
    stamps = [(10 * (i + 1), t) for i, t in enumerate(times)]
    tr, state = _trainer(tmp_path, max_to_keep=max_to_keep, keep_checkpoint_every_n_hours=hours)
    cut = len(stamps) if restart is None else restart
    _save_at(monkeypatch, tr, state, stamps[:cut])
    assert tr.checkpoint_steps() == _orbax_kept(stamps[:cut], max_to_keep, hours)
    if restart is not None:  # a new run: the kept checkpoints' times come from their files
        tr, state = _trainer(tmp_path, max_to_keep=max_to_keep,
                             keep_checkpoint_every_n_hours=hours)
        assert tr._stamps == {}
        _save_at(monkeypatch, tr, state, stamps[cut:])
    want = _orbax_kept(stamps, max_to_keep, hours)
    assert tr.checkpoint_steps() == want
    assert len(want) > max_to_keep or case == "below_a_second"  # the interval kept some
    for step in want:
        saved = checkpoint.read(f"{tr.ckpt_dir}/ckpt_{step}.pt")
        assert saved["time"] == dict(stamps)[step] and saved["step"] == step


@pytest.mark.parametrize("max_to_keep", [None, 1, 3])
def test_unset_keeps_the_newest_max_to_keep(tmp_path, monkeypatch, max_to_keep):
    """Without the key: the newest ``max_to_keep`` (default 5), whatever the
    times, as orbax's ``LatestN`` alone; no file is read back."""
    stamps = [(i + 1, i * 10 * HOUR) for i in range(8)]
    over = {} if max_to_keep is None else {"max_to_keep": max_to_keep}
    tr, state = _trainer(tmp_path, **over)
    assert tr.keep_interval_s is None
    reads = []
    monkeypatch.setattr(checkpoint, "read", lambda path: reads.append(path))
    _save_at(monkeypatch, tr, state, stamps)
    n = max_to_keep or 5
    assert tr.checkpoint_steps() == [s for s, _ in stamps][-n:] == _orbax_kept(stamps, n, None)
    assert reads == []


def test_kept_checkpoints_rule():
    """The rule itself: either policy keeps a checkpoint."""
    stamps = [(1, 0.0), (2, 50.0), (3, 100.0), (4, 149.0), (5, 250.0), (6, 260.0)]
    assert ttrainer.kept_checkpoints(stamps, 1, 100) == [True, False, True, False, True, True]
    assert ttrainer.kept_checkpoints(stamps, 2, None) == [False] * 4 + [True] * 2
    assert ttrainer.kept_checkpoints([], 2, 100) == []
    assert ttrainer.keep_interval_s(2) == 7200 and ttrainer.keep_interval_s(None) is None
    assert ttrainer.keep_interval_s(0.4 / HOUR) == 0
