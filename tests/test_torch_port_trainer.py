"""The port's training entry point on the CPU: Trainer, checkpoints and
cli.train, mirroring tests/test_trainer_e2e.py and tests/test_checkpoint.py
for the JAX package (device="cpu", 32x64, batch 8, float32), plus
`_static_for_stage` against JAX's. Since the port refuses no configuration
any more, `dist.enabled` (two processes) is tested in
tests/test_torch_port_dist.py.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.data.curriculum import stage_for_epoch
from baseboostdepth_tpu_torch.data.loader import KittiTrainLoader
from baseboostdepth_tpu_torch.training.checkpoint import CheckpointManager
from baseboostdepth_tpu_torch.training import trainer as trainer_mod
from baseboostdepth_tpu_torch.training.trainer import Trainer, prefetch_to_device, step_seed

FOLDER = "2011_09_26/2011_09_26_drive_0001_sync"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel processes, and
    torch's default pool (one thread per core) in each oversubscribes the
    CPU and slows every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_kitti(tmp_path_factory):
    """The fixture of tests/test_trainer_e2e.py: 16 smooth frames per camera,
    8 training samples, two validation frames with GT."""
    root = tmp_path_factory.mktemp("kitti_port_e2e")
    data = root / "raw"
    splits = root / "splits" / "eigen_zhou"
    splits.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for cam in (2, 3):
        d = data / FOLDER / f"image_0{cam}" / "data"
        d.mkdir(parents=True)
        for i in range(16):
            base = rng.integers(40, 200, (8, 25, 3), dtype=np.uint8)
            img = np.asarray(Image.fromarray(base).resize((100, 32), Image.BILINEAR),
                             dtype=np.uint8)
            Image.fromarray(img).save(d / f"{i:010d}.jpg")
    lines = [f"{FOLDER} {i} l kt 0.05" for i in range(4, 12)]
    (splits / "train_files_baselines.txt").write_text("\n".join(lines) + "\n")
    (splits / "val_files.txt").write_text(f"{FOLDER} 13 l\n{FOLDER} 14 l\n")
    yy = np.linspace(2, 50, 32)[:, None] * np.ones((1, 100))
    gt = np.empty(2, dtype=object)
    for i in range(2):
        gt[i] = yy.astype(np.float32)
    np.savez_compressed(splits / "gt_depths.npz", data=gt)
    return str(data), str(root / "splits"), str(root / "logs")


def _config(data, splits, logs, name="e2e"):
    cfg = Config()
    cfg.data.kt_path = data
    cfg.data.splits_dir = splits
    cfg.data.height = 32
    cfg.data.width = 64
    cfg.data.num_workers = 2
    cfg.model.dtype = "float32"
    cfg.optim.batch_size = 8
    cfg.optim.num_epochs = 1
    cfg.log.log_dir = logs
    cfg.log.model_name = name
    cfg.log.log_frequency = 10000
    return cfg


def _params(state):
    return {f"{net}.{k}": v.detach().clone()
            for net, m in (("depth", state.depth_net), ("pose", state.pose_net))
            for k, v in m.state_dict().items()}


def test_trainer_one_epoch_and_resume(tiny_kitti):
    data, splits, logs = tiny_kitti
    cfg = _config(data, splits, logs)
    tr = Trainer(cfg, device="cpu")
    assert tr.steps_per_epoch == 1
    assert tr.gt_depths is not None  # val assets picked up
    before = _params(tr.state)
    tr.train()
    assert tr.state.step == 1
    after = _params(tr.state)
    assert any(not torch.equal(before[k], after[k]) for k in before)

    # online validation: median-scaled Garg-crop metrics + best checkpoint
    st = tr._static_for_stage(stage_for_epoch(0, cfg.method.trimin))
    tr.validate(st, 1, 0, 0)
    assert tr.best_abs_rel < 10.0
    tr.validate(st, 1, 0, 0, quick=1)  # the quick-val subsample

    # image panels of a train batch
    loader = KittiTrainLoader(tr.train_index, stage_for_epoch(0, True), 8, 32, 64,
                              trimin=True, num_workers=2, seed=0)
    tr.save_image_panels(st, next(iter(loader)), 0, 123)
    panel = os.path.join(logs, "e2e", "panels", "step_00000123.png")
    assert np.asarray(Image.open(panel)).shape == (3 * 32, 6 * 64, 3)

    # logs and the checkpoint
    assert os.path.exists(os.path.join(logs, "e2e", "config.json"))
    assert Config.load(os.path.join(logs, "e2e", "config.json")).data.height == 32
    metrics = [json.loads(ln) for ln in open(os.path.join(logs, "e2e", "metrics.jsonl"))]
    assert any("val/abs_rel" in m for m in metrics)
    assert tr.ckpt.latest_step() == 1
    tr.logger.close()

    # resume: a fresh Trainer restores weights, optimizer and step
    tr2 = Trainer(_config(data, splits, logs), device="cpu")
    assert tr2.state.step == 1
    assert (tr2.start_epoch, tr2.start_batch) == (1, 0)
    restored = _params(tr2.state)
    assert all(torch.equal(after[k], restored[k]) for k in after)
    assert tr2.state.scheduler.last_epoch == 1
    assert tr2.state.optimizer.state_dict()["state"].keys() == \
        tr.state.optimizer.state_dict()["state"].keys()
    tr2.logger.close()


def test_resume_positions_come_from_metadata(tiny_kitti):
    data, splits, logs = tiny_kitti
    tr = Trainer(_config(data, splits, logs, "resume_meta"), device="cpu")
    # a mid-epoch best-val checkpoint: epoch 1, just finished batch 3
    tr.ckpt.save(5, tr.state, {"epoch": 1, "batch_in_epoch": 3, "best": True,
                               "abs_rel": 0.42, "best_abs_rel": 0.42})
    tr2 = Trainer(_config(data, splits, logs, "resume_meta"), device="cpu")
    assert tr2.start_epoch == 1
    assert tr2.start_batch == 4  # resumes at the NEXT batch
    assert abs(tr2.best_abs_rel - 0.42) < 1e-9  # best survives restart

    # an epoch-end checkpoint resumes at the next epoch's first batch
    tr2.ckpt.save(9, tr2.state, {"epoch": 1, "epoch_complete": True, "best_abs_rel": 0.42})
    tr3 = Trainer(_config(data, splits, logs, "resume_meta"), device="cpu")
    assert (tr3.start_epoch, tr3.start_batch) == (2, 0)
    # the pinned best checkpoint is still there
    assert tr3.ckpt.all_steps() == [5, 9]


def test_cli_trains_one_epoch_and_resumes(tiny_kitti):
    """cli.train.main: one epoch of two steps (a metrics line logged at the
    second, with the NaN guard), then again with two epochs, resuming."""
    from baseboostdepth_tpu_torch.cli import train as cli

    data, splits, logs = tiny_kitti
    argv = ["--data.kt_path", data, "--data.splits_dir", splits, "--data.height", "32",
            "--data.width", "64", "--data.num_workers", "2", "--model.dtype", "float32",
            "--optim.batch_size", "4", "--optim.num_epochs", "1", "--log.log_dir", logs,
            "--log.model_name", "cli", "--log.log_frequency", "1",
            "--log.image_panels", "False"]
    tr = cli.main(argv, device="cpu")
    assert tr.steps_per_epoch == 2
    assert tr.state.step == 2 and tr.ckpt.latest_step() == 2
    extra = json.load(open(os.path.join(logs, "cli", "checkpoints", "extra_2.json")))
    assert extra["epoch"] == 0 and extra["epoch_complete"] is True
    lines = [json.loads(ln) for ln in open(os.path.join(logs, "cli", "metrics.jsonl"))]
    logged = [m for m in lines if "imgs_per_sec" in m]
    assert len(logged) == 1 and logged[0]["step"] == 2 and np.isfinite(logged[0]["loss"])

    tr2 = cli.main(argv + ["--optim.num_epochs", "2"], device="cpu")
    assert tr2.start_epoch == 1 and tr2.state.step == 4
    assert tr2.ckpt.all_steps() == [2, 4]
    assert not glob.glob(os.path.join(logs, "cli", "panels", "*"))


def _resnet_file(path, num_layers, seed=0):
    """A torchvision ImageNet-layout file (trunk + fc) from a seeded trunk."""
    from baseboostdepth_tpu_torch.models.resnet import ResNet, init_encoder_, encoder_channels

    gen = torch.Generator().manual_seed(seed)
    trunk = ResNet(num_layers)
    init_encoder_(trunk, gen)
    fc = {"fc.weight": torch.randn(1000, encoder_channels(num_layers)[-1], generator=gen),
          "fc.bias": torch.zeros(1000)}
    torch.save({**trunk.state_dict(), **fc}, path)
    return path


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


def test_cli_trains_cadepth_from_pretrained_encoders(tiny_kitti, tmp_path, monkeypatch):
    """cli.train, one epoch of one step: cadepth (the two-call warp
    schedule at its default) from a local ResNet-50 file given as
    --model.pretrained_path, the pose encoder from the ResNet-18 file
    fetch_torchvision_resnet finds in its local cache (models/ under the
    working directory, its name carrying its sha256 prefix; the table's URL
    is never fetched)."""
    import hashlib

    from baseboostdepth_tpu_torch.cli import train as cli
    from baseboostdepth_tpu_torch.utils import download

    data, splits, logs = tiny_kitti
    rn50 = _resnet_file(str(tmp_path / "rn50.pth"), 50, seed=1)
    monkeypatch.chdir(tmp_path)
    os.makedirs("models")
    rn18 = _resnet_file(str(tmp_path / "rn18.tmp"), 18, seed=2)
    prefix = hashlib.sha256(open(rn18, "rb").read()).hexdigest()[:8]
    cached = os.path.join("models", f"resnet18-{prefix}.pth")
    os.rename(rn18, cached)
    monkeypatch.setattr(download, "TORCHVISION_RESNETS",
                        {18: f"http://invalid.invalid/resnet18-{prefix}.pth"})
    argv = ["--data.kt_path", data, "--data.splits_dir", splits, "--data.height", "32",
            "--data.width", "64", "--data.num_workers", "2", "--model.dtype", "float32",
            "--optim.batch_size", "8", "--optim.num_epochs", "1", "--log.log_dir", logs,
            "--log.model_name", "cadepth_pre", "--log.log_frequency", "10000",
            "--log.image_panels", "False", "--model.zoo", "cadepth",
            "--model.weights_init", "pretrained", "--model.pretrained_path", rn50]
    tr = cli.build_trainer(argv, device="cpu")
    assert not tr.cfg.model.resolved_merged_warp()
    w50 = torch.load(rn50)["conv1.weight"]
    w18 = torch.load(cached)["conv1.weight"]
    assert torch.equal(tr.state.depth_net.encoder.encoder.conv1.weight, w50)
    assert torch.equal(tr.state.pose_net.encoder.encoder.conv1.weight, torch.cat([w18, w18], 1) / 2)
    tr.train()
    assert tr.state.step == 1 and tr.ckpt.latest_step() == 1
    assert not torch.equal(tr.state.depth_net.encoder.encoder.conv1.weight, w50)
    tr.logger.close()


def test_entry_points_default_to_the_card(tiny_kitti):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from baseboostdepth_tpu_torch.cli import train as cli
    from baseboostdepth_tpu_torch.training.step import StepStatic, make_eval_forward

    data, splits, logs = tiny_kitti
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(_config(data, splits, logs, "nocard"))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--data.kt_path", data, "--data.splits_dir", splits])
    with pytest.raises(RuntimeError, match="cuda"):
        make_eval_forward(StepStatic())


def test_static_for_stage_matches_jax(tiny_kitti):
    import dataclasses

    from baseboostdepth_tpu.config import Config as JaxConfig
    from baseboostdepth_tpu.data.curriculum import stage_for_epoch as jax_stage_for_epoch
    from baseboostdepth_tpu.training.trainer import Trainer as JaxTrainer

    data, splits, logs = tiny_kitti
    for zoo, curriculum in ((z, c) for z in ("md2", "cadepth", "sql") for c in (True, False)):
        cfg = _config(data, splits, logs, "static")
        cfg.model.zoo = zoo
        cfg.method.curriculum = curriculum
        cfg.method.no_ssim = not curriculum
        cfg.method.pose_error = 4.0
        cfg.model.pose_input_scale = 0.5 if curriculum else 1.0
        # _static_for_stage reads cfg only
        tr = Trainer.__new__(Trainer)
        tr.cfg = cfg
        jtr = JaxTrainer.__new__(JaxTrainer)
        jtr.cfg = JaxConfig.from_dict(cfg.to_dict())
        for epoch in (0, 5, 10, 19):
            tst = tr._static_for_stage(stage_for_epoch(epoch, True, sql=zoo == "sql"))
            jst = jtr._static_for_stage(jax_stage_for_epoch(epoch, True, sql=zoo == "sql"))
            for f in dataclasses.fields(tst):
                assert getattr(tst, f.name) == getattr(jst, f.name), (zoo, curriculum, epoch,
                                                                      f.name)


def test_prefetch_to_device_passes_batches_through_on_the_cpu(tiny_kitti):
    """On the CPU the prefetcher hands each loader batch over unchanged and
    in order, as (host, device) = (batch, batch); the ragged last batch of a
    loader without drop_last is kept; a loader's exception reaches the
    caller at the batch where it was raised."""
    data, splits, _ = tiny_kitti
    from baseboostdepth_tpu_torch.data.kitti import KittiRawIndex

    index = KittiRawIndex(data, os.path.join(splits, "eigen_zhou", "train_files_baselines.txt"))

    def loader():
        return KittiTrainLoader(index, stage_for_epoch(0, True), 3, 32, 64, trimin=True,
                                num_workers=2, seed=4, drop_last=False, use_native=False)

    expected = list(loader())
    got = list(prefetch_to_device(loader(), torch.device("cpu")))
    assert [b["frames"].shape[0] for b in expected] == [3, 3, 2]
    assert len(got) == len(expected)
    for want, (host, dev) in zip(expected, got):
        assert host is dev and sorted(host) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(host[k], want[k], err_msg=k)

    def failing():
        yield expected[0]
        raise FileNotFoundError("missing frame")

    it = prefetch_to_device(failing(), torch.device("cpu"))
    assert next(it)[0] is expected[0]
    with pytest.raises(FileNotFoundError, match="missing frame"):
        next(it)


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


def test_step_seed_is_a_pure_function():
    assert step_seed(42, 7) == step_seed(42, 7)
    assert len({step_seed(42, s) for s in range(100)}) == 100
    assert step_seed(42, 0) != step_seed(43, 0)
    assert 0 <= step_seed(-1, 3) < 2**63


def _state(v):
    return {"w": torch.full((4,), float(v)), "step": torch.tensor(v)}


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
