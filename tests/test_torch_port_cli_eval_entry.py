"""The port's evaluation entry points on the CPU: export_gt on SYNS against
the JAX package's, cli.infer's disparities against JAX's disp forward, and
every evaluation CLI refusing to run without the card by default. The
setup is test_torch_port_cli_eval.py's, split from it so that each file
has at most seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~20 s (its own tiny training run included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import os
import pytest
import torch
from PIL import Image

from baseboostdepth_tpu.cli import export_gt as jexport_gt
from baseboostdepth_tpu.evaluation import depth as jdepth
from baseboostdepth_tpu.models.torch_import import depth_decoder_torch_to_flax, resnet_torch_to_flax
from baseboostdepth_tpu.training.step import StepStatic as JaxStepStatic
from baseboostdepth_tpu_torch.cli import evaluate_depth, evaluate_pose, export_gt, infer, visualize
from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.training.checkpoint import CheckpointManager
from baseboostdepth_tpu_torch.training.step import StepStatic, init_state
from test_torch_port_cli_eval import _write_syns, trained
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


def test_export_gt_syns_matches_jax(tmp_path):
    for pkg, main in (("port", export_gt.main), ("jax", jexport_gt.main)):
        _write_syns(tmp_path / pkg, np.random.default_rng(3))
        args = ["--split", "SYNS", "--syns_path", str(tmp_path / pkg / "syns"),
                "--splits_dir", str(tmp_path / pkg / "splits")]
        main(args)
        main(args + ["--val"])
    for name in ("gt_depths", "gt_edges", "gt_depths_val", "gt_edges_val"):
        ours = np.load(tmp_path / "port" / "splits" / "SYNS" / f"{name}.npz", allow_pickle=True)
        ref = np.load(tmp_path / "jax" / "splits" / "SYNS" / f"{name}.npz", allow_pickle=True)
        assert len(ours["data"]) == len(ref["data"]) == (1 if name.endswith("_val") else 2)
        for a, b in zip(ours["data"], ref["data"]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_infer_matches_jax_disp_forward(tmp_path):
    """infer's saved disparity against JAX's make_disp_forward on the same
    image (decoded and LANCZOS-resized as infer does) and weights."""
    cfg = Config()
    cfg.data.height, cfg.data.width = 64, 128
    cfg.model.dtype = "float32"
    cfg.save(str(tmp_path / "cfg.json"))
    state = init_state(StepStatic(height=64, width=128, dtype="float32"), seed=4, device="cpu")
    CheckpointManager(str(tmp_path / "ckpt")).save(1, state)
    img = np.random.default_rng(8).integers(0, 255, (90, 300, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "frame.jpg")
    infer.main(["--config", str(tmp_path / "cfg.json"), "--checkpoint", str(tmp_path / "ckpt"),
                "--image_path", str(tmp_path / "frame.jpg")], device="cpu")
    ours = np.load(tmp_path / "frame_disp.npy")

    d = {k: v.numpy() for k, v in state.depth_net.state_dict().items()}
    enc_p, enc_s = resnet_torch_to_flax(d, prefix="encoder.encoder.")
    dec = depth_decoder_torch_to_flax({k[len("decoder."):]: v for k, v in d.items()
                                       if k.startswith("decoder.")})
    params = {"depth": {"encoder": enc_p, "decoder": dec}}
    stats = {"depth": {"encoder": enc_s}}
    with Image.open(tmp_path / "frame.jpg") as im:
        x = np.asarray(im.convert("RGB").resize((128, 64), Image.LANCZOS), np.float32) / 255.0
    fwd = jdepth.make_disp_forward(JaxStepStatic(height=64, width=128, dtype="float32"))
    ref = np.asarray(fwd(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
                         jnp.asarray(x[None])))[0]
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    assert os.path.getsize(tmp_path / "frame_disp.jpeg") > 0


def test_entry_points_default_to_the_card(trained):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, config, ckpt = trained
    for main in (evaluate_depth.main, evaluate_pose.main, infer.main, visualize.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--config", config, "--checkpoint", ckpt])
