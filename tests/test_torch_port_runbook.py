"""Port: tools/verify_reference_parity.py
(baseboostdepth_tpu_torch/tools/verify_reference_parity.py), the day-1
checkpoint runbook, on the CPU.

- --pretrained_start for monovit and diffnet on replica-saved bytes
  (chip_smoke.py::replica_weights_file: tests/torch_mpvit_ref.py::
  mpvit_small, tests/torch_zoo_refs.py::make_hrnet18 with random weights,
  saved as the JAX package's tests/test_zoo_importers.py::
  test_pretrained_start_runbook_path saves them) at 64x96: full key
  coverage, a finite forward, and for monovit the port's MPViT against the
  replica on the same bytes within 1e-3 of each feature's largest entry
  (exit 0).
- --weights on a reference-layout folder (encoder.pth, depth.pth,
  pose_encoder.pth, pose.pth; chip_smoke.py::save_reference_folder) saved
  from seeded port networks, scored on write_trees' eigen split at
  64x192: the same metrics as cli.evaluate_depth on those networks saved
  as a port checkpoint; PASS with --expected_abs_rel at that abs_rel, FAIL
  (exit 1) 0.01 off it.

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 40 s.
"""

import os
import shutil

import pytest
import torch

import chip_smoke
from baseboostdepth_tpu_torch.cli import evaluate_depth
from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.tools import verify_reference_parity as vrp
from baseboostdepth_tpu_torch.training.checkpoint import CheckpointManager
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state
from torch_port_helpers import lowered_priority


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


@pytest.mark.parametrize("zoo", ["monovit", "diffnet"])
def test_pretrained_start_on_replica_bytes(zoo, tmp_path, capsys):
    path = chip_smoke.replica_weights_file(torch, zoo, str(tmp_path / f"{zoo}_start.pth"))
    out = vrp.main(["--zoo", zoo, "--pretrained_start", path, "--height", "64",
                    "--width", "96"], device="cpu")  # returns: exit 0
    printed = capsys.readouterr().out
    assert "replica coverage: " in printed and " 0 replica keys missing" in printed
    assert "pose encoder SKIPPED" in printed
    assert "forward: finite disparities at all scales" in printed
    if zoo == "monovit":
        assert out["worst_rel_err"] < 1e-3
        assert "PASS: monovit encoder forward parity on real bytes" in printed
    else:
        assert printed.rstrip().endswith("PASS")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """write_trees' eigen split; seeded float32 md2 networks saved as a
    reference weights folder and as a port checkpoint with its config."""
    root = str(tmp_path_factory.mktemp("runbook"))
    chip_smoke.write_trees(root)
    state = init_state(StepStatic(zoo="md2", height=64, width=192), seed=3, device="cpu")
    chip_smoke.save_reference_folder(torch, state, os.path.join(root, "weights"))
    CheckpointManager(os.path.join(root, "ckpt")).save(0, state)
    cfg = Config()
    cfg.data.kt_path, cfg.data.splits_dir = os.path.join(root, "raw"), os.path.join(root, "splits")
    cfg.data.height, cfg.data.width, cfg.model.dtype = 64, 192, "float32"
    cfg.save(os.path.join(root, "config.json"))
    yield root
    shutil.rmtree(root)  # ~0.3 GB of weights: keep the suite's temp dirs small


def test_weights_folder_scores_as_evaluate_depth(weights, capsys):
    ref = evaluate_depth.main(["--config", os.path.join(weights, "config.json"),
                               "--checkpoint", os.path.join(weights, "ckpt")], device="cpu")
    base = ["--weights", os.path.join(weights, "weights"),
            "--kt_path", os.path.join(weights, "raw"),
            "--splits_dir", os.path.join(weights, "splits"), "--height", "64", "--width", "192"]
    ours = vrp.main(base, device="cpu")
    assert ours == ref
    capsys.readouterr()
    vrp.main([*base, "--expected_abs_rel", repr(ref["abs_rel"])], device="cpu")
    assert "PASS: abs_rel" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        vrp.main([*base, "--expected_abs_rel", repr(ref["abs_rel"] + 0.01)], device="cpu")
    assert e.value.code == 1
    assert "FAIL: abs_rel" in capsys.readouterr().out
