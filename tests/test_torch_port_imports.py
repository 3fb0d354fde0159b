"""Import hygiene: no module of baseboostdepth_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import baseboostdepth_tpu_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "flax" or m.startswith("flax.")
             or m == "optax" or m == "baseboostdepth_tpu" or m.startswith("baseboostdepth_tpu."))
print(json.dumps({"imported": names, "bad": bad}))
"""


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json

    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_or_jax_package_imported(probe):
    assert probe["bad"] == []


def test_every_port_module_was_imported(probe):
    imported = set(probe["imported"])
    for name in ("baseboostdepth_tpu_torch.training.step", "baseboostdepth_tpu_torch.ops.warp_cuda",
                 "baseboostdepth_tpu_torch.ops.ssim_cuda", "baseboostdepth_tpu_torch.ops.warp_planes",
                 "baseboostdepth_tpu_torch.models.convert", "baseboostdepth_tpu_torch.config",
                 "baseboostdepth_tpu_torch.training.trainer",
                 "baseboostdepth_tpu_torch.training.checkpoint",
                 "baseboostdepth_tpu_torch.data.loader", "baseboostdepth_tpu_torch.data.curriculum",
                 "baseboostdepth_tpu_torch.native", "baseboostdepth_tpu_torch.native.loader",
                 "baseboostdepth_tpu_torch.data.kitti", "baseboostdepth_tpu_torch.data.kitti_utils",
                 "baseboostdepth_tpu_torch.evaluation.metrics",
                 "baseboostdepth_tpu_torch.utils.misc", "baseboostdepth_tpu_torch.cli.train",
                 "baseboostdepth_tpu_torch.utils.colormaps",
                 "baseboostdepth_tpu_torch.ops.chamfer", "baseboostdepth_tpu_torch.ops.probe_cuda",
                 "baseboostdepth_tpu_torch.evaluation.depth",
                 "baseboostdepth_tpu_torch.evaluation.syns",
                 "baseboostdepth_tpu_torch.evaluation.pose",
                 "baseboostdepth_tpu_torch.cli.evaluate_depth",
                 "baseboostdepth_tpu_torch.cli.evaluate_pose",
                 "baseboostdepth_tpu_torch.cli.export_gt", "baseboostdepth_tpu_torch.cli.infer",
                 "baseboostdepth_tpu_torch.cli.visualize",
                 "baseboostdepth_tpu_torch.tools.pallas_probe",
                 "baseboostdepth_tpu_torch.models.cadepth", "baseboostdepth_tpu_torch.models.sql",
                 "baseboostdepth_tpu_torch.models.torch_import",
                 "baseboostdepth_tpu_torch.utils.download",
                 "baseboostdepth_tpu_torch.models.monovit",
                 "baseboostdepth_tpu_torch.models.diffnet",
                 "baseboostdepth_tpu_torch.data.synthetic",
                 "baseboostdepth_tpu_torch.training.optim",
                 "baseboostdepth_tpu_torch.profile_step",
                 "baseboostdepth_tpu_torch.parallel",
                 "baseboostdepth_tpu_torch.parallel.sharding"):
        assert name in imported
    assert len(imported) >= 55
