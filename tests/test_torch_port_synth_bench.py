"""Port parity: tools/synthetic_benchmark.py
(baseboostdepth_tpu_torch/tools/synthetic_benchmark.py) against the JAX
package's tools/synthetic_benchmark.py, on the CPU, on a tiny scene
(24 frames at 32x96: 2 val and 8 train samples).

- The Config that the port's make_config builds equals, field for field,
  the one the JAX tool's main hands its Trainer (a recording stub), for
  the default flags and for --zoo sql --no-bucket --pose-scale 0.5
  --disp-bias -2.2 --seed 1.
- The port's scene, rendered by ensure_scene in two processes, is
  byte-equal to the JAX tool's serial render; the port's evaluate and the
  JAX tool's score the same md2 weights (the port's init taken to JAX by
  its importers and back by from_jax) on it to 1e-4 relative, every
  metric.
- The port tool's main trains two epochs (switch at 1, batch 2) and writes
  result.json with the JAX tool's keys and finite metrics.

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 45 s (the JAX tool's serial render of the
scene and its evaluate's compile are a third of it).
"""

import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from baseboostdepth_tpu.training.step import StepStatic as JaxStepStatic
from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.models.convert import from_jax
from baseboostdepth_tpu_torch.tools import synthetic_benchmark as tool
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state
from tests.test_torch_port_eval import to_flax
from tests.test_torch_port_synthetic import _assert_same_tree
from torch_port_helpers import jax_tool, lowered_priority

H, W, N_FRAMES = 32, 96, 24
JAX_KEYS = {"dtype", "zoo", "disp_bias", "pose_input_scale", "bucket_fs", "epochs", "n_frames",
            "resolution", "wall_s", "init", "final"}


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


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The port's scene, rendered in two processes."""
    root = str(tmp_path_factory.mktemp("synth_bench") / "scene")
    tool.ensure_scene(root, N_FRAMES, W, H, 0, workers=2)
    return root


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flags", [
    [],
    ["--zoo", "sql", "--no-bucket", "--pose-scale", "0.5", "--disp-bias", "-2.2", "--seed", "1"],
], ids=["defaults", "sql_nobucket_ps_bias_seed1"])
def test_config_matches_the_jax_tool(flags, tmp_path, monkeypatch):
    root = str(tmp_path / "scene")
    seed = int(flags[flags.index("--seed") + 1]) if "--seed" in flags else 0
    # the default scene's marker: both tools take the scene as rendered
    scene_dir = root if seed == 0 else f"{root}_seed{seed}"
    os.makedirs(scene_dir)
    open(os.path.join(scene_dir, f".done_420_640x192_{seed}"), "w").close()
    argv = ["--root", root, *flags]

    handed = {}

    def trainer_stub(cfg):
        handed["cfg"] = cfg
        raise _Stop

    jax_mod = jax_tool("synthetic_benchmark")
    monkeypatch.setattr("baseboostdepth_tpu.utils.jax_setup.setup_jax", lambda: None)
    monkeypatch.setattr("baseboostdepth_tpu.training.trainer.Trainer", trainer_stub)
    monkeypatch.setattr("sys.argv", ["synthetic_benchmark.py", *argv])
    with pytest.raises(_Stop):
        jax_mod.main()

    ours = tool.make_config(tool.parse_args(argv))
    assert isinstance(ours, Config)
    assert json.loads(json.dumps(ours.to_dict())) == json.loads(json.dumps(handed["cfg"].to_dict()))


def test_evaluate_matches_the_jax_tool(scene, tmp_path):
    import types

    import jax
    import jax.numpy as jnp

    jax_mod = jax_tool("synthetic_benchmark")
    jax_scene = str(tmp_path / "jax_scene")
    jax_mod.ensure_scene(jax_scene, N_FRAMES, W, H, 0)
    _assert_same_tree(scene, jax_scene)  # two processes against JAX's serial render

    # the port's init from seed 0 taken to JAX by its importers, and back by
    # from_jax (JAX's own init compiles for half a minute on the CPU)
    state = init_state(StepStatic(zoo="md2", height=H, width=W), device="cpu")
    params, stats = to_flax(state.depth_net.state_dict(), state.pose_net.state_dict())
    depth_sd, pose_sd = from_jax(params, stats)
    state.depth_net.load_state_dict(depth_sd)
    state.pose_net.load_state_dict(pose_sd)
    jax_state = types.SimpleNamespace(params=jax.tree.map(jnp.asarray, params),
                                      stats=jax.tree.map(jnp.asarray, stats))

    def cfg_for(root):
        cfg = Config()
        cfg.data.kt_path, cfg.data.splits_dir = root, os.path.join(root, "splits")
        cfg.data.split, cfg.data.height, cfg.data.width = "synth", H, W
        return cfg

    ours = tool.evaluate(cfg_for(scene), state, StepStatic(zoo="md2", height=H, width=W),
                         device="cpu")
    ref = jax_mod.evaluate(cfg_for(jax_scene), jax_state, JaxStepStatic(zoo="md2", height=H,
                                                                        width=W))
    assert ours.keys() == ref.keys() and "abs_rel" in ours
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=k)


def test_main_trains_both_stages_and_writes_the_result(scene, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the Trainer's logs/ lands here
    out = tool.main(["--root", scene, "--n-frames", str(N_FRAMES), "--width", str(W),
                     "--height", str(H), "--epochs", "2", "--switch-epoch", "1",
                     "--batch-size", "2"], device="cpu")
    printed = capsys.readouterr().out
    assert "init:" in printed and "final:" in printed and "wrote " in printed
    path = tmp_path / "logs" / "synth_bench_bfloat16" / "result.json"
    with open(path) as f:
        result = json.load(f)
    assert JAX_KEYS <= result.keys() and result == json.loads(json.dumps(out))
    assert result["device"] == "cpu" and result["resolution"] == [H, W]
    assert len(result["epoch_s"]) == 2 and sum(result["epoch_steps"]) >= 2
    for when in ("init", "final"):
        assert result[when].keys() == result["final"].keys() and "a1" in result[when]
        assert all(math.isfinite(v) for v in result[when].values()), result[when]
    ckpts = tmp_path / "logs" / "synth_bench_bfloat16" / "checkpoints"
    assert any(name.isdigit() for name in os.listdir(ckpts))
    shutil.rmtree(ckpts)  # ~0.6 GB of md2 checkpoints: keep the suite's temp dirs small
