"""Port parity: tools/synthetic_pose_eval.py
(baseboostdepth_tpu_torch/tools/synthetic_pose_eval.py) against the JAX
package's tools/synthetic_pose_eval.py, on the CPU, on a 10-frame
odometry sequence of the synthetic scene at 32x96.

The port tool renders the sequence and scores a fresh pose network
(--untrained); the JAX tool's --untrained run then scores its PRNGKey(0)
init on the same sequence; those weights, carried to the port by from_jax
and saved as a port checkpoint, are scored by the port tool (restored from
--ckpt) to within 1e-4 of the JAX tool's ATEs (measured 3.7e-8), and the
printed lines have the JAX tool's format. The JAX tool's init_state runs
under jax.jit here: op by op it compiles for ~40 s on the CPU, jitted for
~16 s, and its weights differ by 3e-8 (the port is scored on the weights
the JAX tool used).

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 35 s.
"""

import math
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.tools import synthetic_pose_eval as tool
from baseboostdepth_tpu_torch.training.checkpoint import CheckpointManager
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state
from torch_port_helpers import jax_tool, lowered_priority

H, W, N_FRAMES = 32, 96, 10
LINE = re.compile(r"^\[(un)?trained\] ate_direct \d+\.\d{4} \+- \d+\.\d{4} \| "
                  r"ate_chained \d+\.\d{4} \+- \d+\.\d{4} \(units; 1 unit ~ 5\.4 m\)$", re.M)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's default pool (one thread per core) in each oversubscribes the
    CPU and slows every worker; the module at a lowered CPU priority
    (torch_port_helpers.lowered_priority)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


def test_checkpoint_scores_the_jax_tools_untrained_ate(tmp_path, monkeypatch, capsys):
    root, ckpt = str(tmp_path / "odom"), str(tmp_path / "ckpt")
    size = ["--root", root, "--n-frames", str(N_FRAMES), "--width", str(W), "--height", str(H)]
    fresh = tool.main([*size, "--untrained"], device="cpu")
    assert all(math.isfinite(v) for v in fresh.values()), fresh
    fresh_line = capsys.readouterr().out

    # the JAX tool on the sequence the port rendered (same marker), its
    # evaluator's arguments and result recorded
    import baseboostdepth_tpu.evaluation.pose as jax_pose
    import baseboostdepth_tpu.training.step as jax_step

    seen = {}
    evaluate = jax_pose.evaluate_odometry

    def recording(cfg, params, stats, seq, gt_path):
        seen.update(params=params, stats=stats, result=evaluate(cfg, params, stats, seq, gt_path))
        return seen["result"]

    monkeypatch.setattr(jax_pose, "evaluate_odometry", recording)
    monkeypatch.setattr(jax_step, "init_state", jax.jit(jax_step.init_state, static_argnums=(0, 1)))
    monkeypatch.setattr("baseboostdepth_tpu.utils.jax_setup.setup_jax", lambda: None)
    monkeypatch.setattr("sys.argv", ["synthetic_pose_eval.py", *size, "--untrained"])
    jax_tool("synthetic_pose_eval").main()
    jax_line = capsys.readouterr().out

    state = init_state(StepStatic(zoo="md2", height=H, width=W), device="cpu")
    depth_sd, pose_sd = from_jax(*jax.tree.map(np.asarray, (seen["params"], seen["stats"])))
    state.depth_net.load_state_dict(depth_sd)
    state.pose_net.load_state_dict(pose_sd)
    CheckpointManager(ckpt).save(7, state)
    ours = tool.main([*size, "--ckpt", ckpt], device="cpu")
    our_lines = capsys.readouterr().out

    assert f"restored step 7 from {ckpt}" in our_lines
    assert len(LINE.findall(fresh_line + jax_line + our_lines)) == 3
    assert ours.keys() == seen["result"].keys()
    for k, v in seen["result"].items():
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-4, err_msg=k)
    shutil.rmtree(ckpt)  # keep the suite's temp dirs small
