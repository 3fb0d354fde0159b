"""Port parity: tools/preflight.py (baseboostdepth_tpu_torch/tools/preflight.py)
against the JAX package's tools/preflight.py, on the CPU, on a KITTI tree
as chip_smoke.py::write_trees writes one (1242x375 JPEGs, 48 eigen_zhou
train samples), given an eigen_zhou val list of 12 frames and its
gt_depths.npz.

- --quick: the same lines and exit code as the JAX tool's --quick, on the
  tree as written (both refuse its 0.0 baselines, the stereo-only
  windows: FAIL, exit 1) and with those baselines at 0.01 (PASS / SKIP).
- Without --quick (baselines at 0.01), at 64x192, batch 2: all seven
  checks PASS, the train step and the 10-image eval on the CPU.
- A deleted stereo image fails "KITTI image tree", a missing
  gt_depths.npz "exported GT depths"; each exits 1.

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 25 s.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from baseboostdepth_tpu_torch.tools import preflight
from torch_port_helpers import jax_tool, lowered_priority

N_VAL = 12


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
def written(tmp_path_factory):
    """write_trees' tree with an eigen_zhou val list and its GT."""
    root = str(tmp_path_factory.mktemp("preflight") / "written")
    chip_smoke.write_trees(root)
    split = os.path.join(root, "splits", "eigen_zhou")
    with open(os.path.join(split, "val_files.txt"), "w") as f:
        f.write("".join(f"{chip_smoke.KITTI_FOLDER} {i} l\n" for i in range(N_VAL)))
    rng = np.random.default_rng(1)
    gt = np.empty(N_VAL, dtype=object)
    for i in range(N_VAL):
        gt[i] = chip_smoke.smooth_depth(rng, 375, 1242, 2.0, 75.0)
    np.savez_compressed(os.path.join(split, "gt_depths.npz"), data=gt)
    return root


@pytest.fixture(scope="module")
def tree(written, tmp_path_factory):
    """The same tree with its 0.0 baselines at 0.01."""
    root = str(tmp_path_factory.mktemp("preflight") / "tree")
    shutil.copytree(written, root)
    path = os.path.join(root, "splits", "eigen_zhou", "train_files_baselines.txt")
    with open(path) as f:
        lines = [ln.split() for ln in f]
    with open(path, "w") as f:
        f.write("".join(" ".join(ln[:4] + [ln[4] if float(ln[4]) > 0 else "0.01"]) + "\n"
                        for ln in lines))
    return root


def _args(root):
    return ["--kt_path", os.path.join(root, "raw"), "--splits_dir", os.path.join(root, "splits")]


def _check_lines(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.split("  ")[0] in ("PASS", "FAIL", "SKIP")]


def _exit_code(fn) -> int:
    try:
        fn()
    except SystemExit as e:
        return e.code
    return 0


@pytest.mark.parametrize("baselines", ["as_written", "positive"])
def test_quick_prints_the_jax_tools_lines(baselines, written, tree, monkeypatch, capsys):
    root = written if baselines == "as_written" else tree
    rc = _exit_code(lambda: preflight.main([*_args(root), "--quick"], device="cpu"))
    ours = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["preflight.py", *_args(root), "--quick"])
    jax_rc = _exit_code(jax_tool("preflight").main)
    ref = capsys.readouterr().out
    assert ours == ref and rc == jax_rc
    lines = _check_lines(ours)
    if baselines == "as_written":
        assert rc == 1 and lines[0] == ("FAIL  splits parse: AssertionError: non-positive "
                                        "baseline entries")
        assert [ln.split("  ")[0] for ln in lines[1:]] == ["PASS"] * 3 + ["SKIP"] * 3
    else:
        assert rc == 0 and [ln.split("  ")[0] for ln in lines] == ["PASS"] * 4 + ["SKIP"] * 3
        assert lines[0] == f"PASS  splits parse  (48 train / {N_VAL} val, baselines=True)"


def test_all_checks_pass_on_the_cpu(tree, capsys):
    preflight.main([*_args(tree), "--height", "64", "--width", "192", "--batch_size", "2"],
                   device="cpu")
    out = capsys.readouterr().out
    lines = _check_lines(out)
    assert [ln.split("  ")[1].split(":")[0] for ln in lines] == [
        "splits parse", "KITTI image tree", "image decode+resize", "exported GT depths",
        "train batch", "train step", "10-image eval"]
    assert all(ln.startswith("PASS") for ln in lines), out
    assert "preflight OK -- ready to train" in out


@pytest.mark.parametrize("broken", ["stereo_image", "gt_depths"])
def test_a_missing_file_fails_and_exits_1(broken, tree, tmp_path, capsys):
    root = str(tmp_path / "tree")
    shutil.copytree(tree, root)
    if broken == "stereo_image":  # the other camera of the first train sample
        with open(os.path.join(root, "splits", "eigen_zhou", "train_files_baselines.txt")) as f:
            folder, frame, side = f.readline().split()[:3]
        other = {"l": "image_03", "r": "image_02"}[side]
        os.remove(os.path.join(root, "raw", folder, other, "data", f"{int(frame):010d}.jpg"))
        failed = "KITTI image tree"
    else:
        os.remove(os.path.join(root, "splits", "eigen_zhou", "gt_depths.npz"))
        failed = "exported GT depths"
    with pytest.raises(SystemExit) as e:
        preflight.main([*_args(root), "--quick"], device="cpu")
    assert e.value.code == 1
    out = capsys.readouterr().out
    fails = [ln for ln in _check_lines(out) if ln.startswith("FAIL")]
    assert len(fails) == 1 and fails[0].startswith(f"FAIL  {failed}: AssertionError: "), out
    assert f"preflight FAILED: ['{failed}']" in out
