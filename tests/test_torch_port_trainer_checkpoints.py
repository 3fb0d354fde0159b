"""The port's checkpoint manager and the trainer's step seeds on the CPU,
mirroring tests/test_checkpoint.py for the JAX package: the seed is a pure
function of the step, the best checkpoint survives garbage collection,
pins persist across a restart, and stale sidecars are removed. Split from
test_torch_port_trainer.py so that each file has at most seven tests
(ROADMAP.md, "The time budget").

Single-worker time: ~2 s.
"""

import glob
import os
import pytest
import torch

from baseboostdepth_tpu_torch.training.checkpoint import CheckpointManager
from baseboostdepth_tpu_torch.training.trainer import step_seed
from test_torch_port_trainer import _state
from torch_port_helpers import lowered_priority


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as in the other port test files, at a lowered
    CPU priority (torch_port_helpers.lowered_priority)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


def test_step_seed_is_a_pure_function():
    assert step_seed(42, 7) == step_seed(42, 7)
    assert len({step_seed(42, s) for s in range(100)}) == 100
    assert step_seed(42, 0) != step_seed(43, 0)
    assert 0 <= step_seed(-1, 3) < 2**63


def test_best_checkpoint_survives_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    mgr.save(1, _state(1), {"epoch": 0})
    mgr.save(2, _state(2), {"epoch": 0, "best": True, "abs_rel": 0.1})
    for s in range(3, 10):
        mgr.save(s, _state(s), {"epoch": s // 3})
    steps = mgr.all_steps()
    assert 2 in steps, "pinned best checkpoint was garbage-collected"
    assert [s for s in steps if s != 2] == [7, 8, 9]
    restored, extra = mgr.restore(_state(0), step=2)
    assert float(restored["w"][0]) == 2.0
    assert extra["best"] is True and extra["pin"] is True
    assert mgr.latest_step() == 9
    # no temporary names are left behind
    assert sorted(os.listdir(tmp_path)) == sorted(
        [str(s) for s in steps] + [f"extra_{s}.json" for s in steps])


def test_pins_persist_across_restart(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(1, _state(1), {"best": True, "abs_rel": 0.2})
    mgr.save(2, _state(2), {})
    mgr2 = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in range(3, 8):
        mgr2.save(s, _state(s), {})
    assert 1 in mgr2.all_steps()
    restored, _ = mgr2.restore(_state(0), step=1)
    assert float(restored["w"][0]) == 1.0


def test_gc_removes_stale_sidecars(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    for s in range(1, 4):
        mgr.save(s, _state(s), {"epoch": s})
    assert mgr.all_steps() == [3]
    sidecars = sorted(glob.glob(os.path.join(str(tmp_path), "extra_*.json")))
    assert [os.path.basename(p) for p in sidecars] == ["extra_3.json"]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_state(0))
