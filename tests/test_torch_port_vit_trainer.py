"""The port's Trainer and cli.train for the monovit and diffnet zoos on the
CPU (tests/test_torch_port_trainer.py's fixture and configuration: 32x64,
batch 8, float32): both Trainers build with the JAX trainer's optimizers,
and one cli.train epoch of each ends in a checkpoint that a second run
resumes from, both optimizer groups' state restored. A file of its own
with fewer tests than tests/test_zoo_training.py, so that xdist queues it
behind that file (ROADMAP.md, Tier-1 verify).

Single-worker time (one pytest process, one torch thread, Intel Xeon):
about 20 s.
"""

import pytest
import torch

from baseboostdepth_tpu_torch.data.curriculum import stage_for_epoch
from baseboostdepth_tpu_torch.training.trainer import Trainer
from tests.test_torch_port_trainer import _config, _params, tiny_kitti  # noqa: F401
from torch_port_helpers import lowered_priority


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with lowered_priority():
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("zoo", ["monovit", "diffnet"])
def test_vit_zoo_trainer_builds(tiny_kitti, zoo):
    """The monovit and diffnet Trainers build on the CPU with the JAX
    trainer's optimizers: monovit's two-group AdamW (group 0 exactly the
    depth encoder's parameters at optim.vit_encoder_lr, group 1 the rest at
    optim.learning_rate; weight decay 1e-4, optax.adamw's default), diffnet's
    one-group Adam; the merged warp, as the JAX config resolves both."""
    data, splits, logs = tiny_kitti
    cfg = _config(data, splits, logs, f"vit_{zoo}")
    cfg.model.zoo = zoo
    cfg.optim.vit_encoder_lr = 3e-5
    tr = Trainer(cfg, device="cpu")
    st = tr._static_for_stage(stage_for_epoch(0, True))
    assert st.zoo == zoo and st.merged_warp and st.scales == (0, 1, 2, 3)
    opt = tr.state.optimizer
    if zoo == "monovit":
        assert isinstance(opt, torch.optim.AdamW) and len(opt.param_groups) == 2
        enc, rest = opt.param_groups
        assert [id(p) for p in enc["params"]] == \
            [id(p) for p in tr.state.depth_net.encoder.parameters()]
        others = [p for p in tr.state.depth_net.parameters()
                  if id(p) not in {id(q) for q in enc["params"]}]
        assert [id(p) for p in rest["params"]] == \
            [id(p) for p in others + list(tr.state.pose_net.parameters())]
        assert (enc["lr"], rest["lr"]) == (3e-5, cfg.optim.learning_rate)
        assert enc["weight_decay"] == rest["weight_decay"] == 1e-4
        assert enc["betas"] == (0.9, 0.999) and enc["eps"] == 1e-8
    else:
        assert type(opt) is torch.optim.Adam and len(opt.param_groups) == 1
        assert tr.state.depth_net.encoder.num_ch_enc == (64, 18, 36, 72, 144)
    tr.logger.close()


@pytest.mark.parametrize("zoo", ["monovit", "diffnet"])
def test_cli_trains_vit_zoos_and_resumes(tiny_kitti, zoo):
    """cli.train one epoch (one step) of --model.zoo monovit / diffnet on the
    CPU, ending in a checkpoint; a second run with two epochs resumes from
    it with the weights, both optimizer groups' state (moments and rates)
    and the schedule restored."""
    from baseboostdepth_tpu_torch.cli import train as cli

    data, splits, logs = tiny_kitti
    argv = ["--data.kt_path", data, "--data.splits_dir", splits, "--data.height", "32",
            "--data.width", "64", "--data.num_workers", "2", "--model.dtype", "float32",
            "--optim.batch_size", "8", "--optim.num_epochs", "1", "--log.log_dir", logs,
            "--log.model_name", f"cli_{zoo}", "--log.image_panels", "False",
            "--model.zoo", zoo]
    tr = cli.main(argv, device="cpu")
    assert tr.state.step == 1 and tr.ckpt.latest_step() == 1
    saved = tr.state.optimizer.state_dict()
    weights = _params(tr.state)
    tr2 = cli.build_trainer(argv + ["--optim.num_epochs", "2"], device="cpu")
    assert tr2.state.step == 1 and tr2.start_epoch == 1
    assert all(torch.equal(weights[k], v) for k, v in _params(tr2.state).items())
    restored = tr2.state.optimizer.state_dict()
    assert len(restored["param_groups"]) == len(saved["param_groups"]) == \
        (2 if zoo == "monovit" else 1)
    for g, h in zip(restored["param_groups"], saved["param_groups"]):
        assert g["lr"] == h["lr"] and g["params"] == h["params"]
    assert restored["state"].keys() == saved["state"].keys()
    for i, st in saved["state"].items():
        assert all(torch.equal(st[k], restored["state"][i][k]) for k in st)
    assert tr2.state.scheduler.last_epoch == 1
    tr2.logger.close()
