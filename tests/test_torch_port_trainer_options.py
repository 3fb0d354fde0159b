"""The port's training entry point on the CPU with the lifted options
(`--model.num_layers 50`, `--model.zoo sql`, `--model.merged_warp False`,
`--model.pose_input_scale 0.5`, `--model.weights_init pretrained` with a
local path), and a Trainer epoch identical without the device prefetcher.
The setup is test_torch_port_trainer.py's, split from it so that each file
has at most seven tests (ROADMAP.md, "The time budget").

Single-worker time: ~25 s.
"""

import json
import os
import pytest
import torch

from baseboostdepth_tpu_torch.data.curriculum import stage_for_epoch
from baseboostdepth_tpu_torch.training import trainer as trainer_mod
from baseboostdepth_tpu_torch.training.trainer import Trainer, prefetch_to_device
from test_torch_port_trainer import _config, _params, _resnet_file, tiny_kitti
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


@pytest.mark.parametrize("override", [
    ("model", "weights_init", "pretrained"), ("model", "zoo", "sql"),
    ("model", "num_layers", 50), ("model", "merged_warp", False),
    ("model", "pose_input_scale", 0.5),
])
def test_lifted_configuration_builds(tiny_kitti, tmp_path, override):
    """What the port refused until this slice now builds a Trainer on the
    CPU whose StepStatic carries it (the pretrained case from a local
    ResNet-18 file, which seeds both encoders)."""
    data, splits, logs = tiny_kitti
    cfg = _config(data, splits, logs, "lifted")
    sec, field, value = override
    setattr(getattr(cfg, sec), field, value)
    if value == "pretrained":
        cfg.model.pretrained_path = _resnet_file(str(tmp_path / "rn18.pth"), 18)
    tr = Trainer(cfg, device="cpu")
    st = tr._static_for_stage(stage_for_epoch(0, True, sql=cfg.model.zoo == "sql"))
    assert (st.zoo, st.num_layers) == (cfg.model.zoo, cfg.model.num_layers)
    assert st.merged_warp == (value is not False)
    assert st.pose_input_scale == cfg.model.pose_input_scale
    assert st.scales == ((0,) if cfg.model.zoo == "sql" else (0, 1, 2, 3))
    if value == 50:
        assert tr.state.depth_net.encoder.num_ch_enc == (64, 256, 512, 1024, 2048)
    if value == "pretrained":
        w = torch.load(cfg.model.pretrained_path)["conv1.weight"]
        assert torch.equal(tr.state.depth_net.encoder.encoder.conv1.weight, w)
        assert torch.equal(tr.state.pose_net.encoder.encoder.conv1.weight,
                           torch.cat([w, w], 1) / 2)
    tr.logger.close()


def test_trainer_epoch_identical_without_the_prefetcher(tiny_kitti, monkeypatch):
    """One CPU epoch of two steps through prefetch_to_device and one through
    a plain loop over the loader: the same logged metrics (but the rate and
    the wall-clock stamp) and the same weights."""
    data, splits, logs = tiny_kitti
    runs = {}
    for name, prefetch in (("prefetch", prefetch_to_device),
                           ("plain", lambda batches, device: ((b, b) for b in batches))):
        monkeypatch.setattr(trainer_mod, "prefetch_to_device", prefetch)
        cfg = _config(data, splits, logs, f"prefetch_{name}")
        cfg.optim.batch_size = 4
        cfg.log.log_frequency = 1
        cfg.log.image_panels = False
        tr = Trainer(cfg, device="cpu")
        tr.train()
        lines = [json.loads(ln) for ln in open(os.path.join(logs, f"prefetch_{name}",
                                                             "metrics.jsonl"))]
        logged = [{k: v for k, v in m.items() if k not in ("imgs_per_sec", "t")}
                  for m in lines if "imgs_per_sec" in m]
        runs[name] = (logged, _params(tr.state))
    assert len(runs["prefetch"][0]) == 1 and runs["prefetch"][0] == runs["plain"][0]
    a, b = runs["prefetch"][1], runs["plain"][1]
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
