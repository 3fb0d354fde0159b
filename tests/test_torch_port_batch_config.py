"""Port parity: the static-slot batch layout and the config tree of
baseboostdepth_tpu_torch against baseboostdepth_tpu (exact)."""

import numpy as np
import pytest

from baseboostdepth_tpu.config import Config as JaxConfig
from baseboostdepth_tpu.training import batch as jbatch
from baseboostdepth_tpu_torch.config import Config as TorchConfig
from baseboostdepth_tpu_torch.training import batch as tbatch


def _pieces(seed, B, F, H=8, W=16):
    rng = np.random.default_rng(seed)
    NF = tbatch.num_frames(F)
    frames = rng.integers(0, 256, (B, NF, H, W, 3), dtype=np.uint8)
    f_max = rng.integers(0 if F > 0 else 0, F + 1, B)
    K = np.broadcast_to(np.diag([0.58 * W, 1.92 * H, 1.0, 1.0]).astype(np.float32), (B, 4, 4)).copy()
    K[:, 0, 2], K[:, 1, 2] = 0.5 * W, 0.5 * H
    stereo_T = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    stereo_T[:, 0, 3] = rng.choice([-0.1, 0.1], B)
    flip = rng.random(B) > 0.5
    jitter = rng.random((B, NF, 4)).astype(np.float32)
    return frames, f_max, K, stereo_T, flip, jitter


@pytest.mark.parametrize("F", [1, 2, 5, 7])
@pytest.mark.parametrize("mode", ["trimin", "plain", "classic"])
def test_make_batch_byte_identical(F, mode):
    trimin = mode == "trimin"
    classic = mode == "classic"
    args = _pieces(F * 10 + len(mode), B=6, F=F)
    if classic:
        args = (args[0], np.ones(6, int)) + args[2:]
    a = jbatch.make_batch(*args, F, trimin, True, classic)
    b = tbatch.make_batch(*args, F, trimin, True, classic)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    for f in range(F + 1):
        for x, y in zip(jbatch.slot_table(f, F, trimin, True, classic),
                        tbatch.slot_table(f, F, trimin, True, classic)):
            np.testing.assert_array_equal(x, y)
    assert jbatch.num_temporal_slots(F, trimin) == tbatch.num_temporal_slots(F, trimin)
    assert jbatch.stereo_index(F) == tbatch.stereo_index(F)


def _edited(cls):
    cfg = cls()
    cfg.model.dtype = "float32"
    cfg.model.merged_warp = False
    cfg.method.scales = (0, 2)
    cfg.method.disp_init_bias = -2.2
    cfg.data.bucket_fs = (2, 7)
    cfg.optim.lr_milestones = (3, 5)
    cfg.seed = 7
    return cfg


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_config_round_trip_across_packages(tmp_path, direction):
    src_cls, dst_cls = (JaxConfig, TorchConfig) if direction == "jax_to_torch" else (TorchConfig, JaxConfig)
    path = str(tmp_path / "cfg.json")
    _edited(src_cls).save(path)
    loaded = dst_cls.load(path)
    assert loaded.to_dict() == _edited(dst_cls).to_dict()
    assert loaded.to_dict() == _edited(src_cls).to_dict()
    assert loaded.model.resolved_merged_warp() is False
    assert dst_cls().to_dict() == src_cls().to_dict()


def test_config_cli_and_resolvers_agree():
    argv = ["--optim.batch_size", "8", "--method.trimin", "false", "--model.zoo", "cadepth",
            "--method.disp_init_bias", "-2.2", "--model.phase_tail", "true", "--seed", "3"]
    a, b = JaxConfig.from_args(argv), TorchConfig.from_args(argv)
    assert a.to_dict() == b.to_dict()
    assert a.model.resolved_merged_warp() == b.model.resolved_merged_warp() is False
    assert a.model.resolved_phase_tail() == b.model.resolved_phase_tail() is True
