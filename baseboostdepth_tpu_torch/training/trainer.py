"""Trainer orchestration on one device: epochs, curriculum stages,
validation, checkpointing, logging; the counterpart of
`baseboostdepth_tpu/training/trainer.py`.

Role parity with the reference Trainer (trainer.py:29-284): the curriculum
advances by swapping the epoch's Stage/StepStatic and loader. Online
validation runs the eigen_zhou val split against precomputed GT every
log_frequency batches and at every epoch end, and tracks the best abs_rel
(trainer.py:623-665) with a pinned checkpoint. Resume positions (epoch,
batch) come from checkpoint metadata, and the per-step automask noise is
drawn from a generator seeded by a pure function of (seed, global step), so
a resumed run replays the stream of an uninterrupted one.

With `log.syns_val` it also runs the SYNS val split (edge metrics) at every
log step (trainer.py:646-663).

Zoos: md2 (ResNet-18/34/50/101/152), monovit (with its two-group AdamW,
the depth encoder at `optim.vit_encoder_lr`), cadepth, diffnet and sql /
sql_large, with `model.merged_warp`, `model.pose_input_scale` and
`model.weights_init pretrained` (ImageNet encoders from
`model.pretrained_path`, or torchvision's ResNet files,
models/torch_import.py). Not ported yet, and refused with
NotImplementedError rather than ignored (see `check_supported`):
multi-process training (ROADMAP.md, A6).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from baseboostdepth_tpu_torch.config import Config
from baseboostdepth_tpu_torch.data import kitti
from baseboostdepth_tpu_torch.data.curriculum import Stage, stage_for_epoch
from baseboostdepth_tpu_torch.data.loader import EvalLoader, KittiTrainLoader
from baseboostdepth_tpu_torch.device import require_device
from baseboostdepth_tpu_torch.evaluation.metrics import METRIC_NAMES, single_image_errors
from baseboostdepth_tpu_torch.evaluation.syns import evaluate_syns
from baseboostdepth_tpu_torch.models import DEPTH_IS_METRIC
from baseboostdepth_tpu_torch.training.checkpoint import CheckpointManager
from baseboostdepth_tpu_torch.training.step import (
    StepStatic,
    init_disp_bias,
    init_state,
    make_debug_forward,
    make_eval_forward,
    make_train_step,
)
from baseboostdepth_tpu_torch.utils import resolve_splits_dir, sec_to_hm_str


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for configuration this port does not run
    yet, instead of training something else than asked."""
    if cfg.dist.enabled:
        raise NotImplementedError(
            "not ported to baseboostdepth_tpu_torch yet (see ROADMAP.md, 'Open items'): "
            "dist.enabled (multi-GPU training, A6)")


def step_seed(seed: int, global_step: int) -> int:
    """The automask noise seed of one step: a pure function of the run's
    seed and the global step (the counterpart of jax.random.fold_in), so a
    resumed run draws the same noise as an uninterrupted one."""
    ss = np.random.SeedSequence([seed % 2**64, global_step])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def prefetch_to_device(batches: Iterable[Dict[str, np.ndarray]], device: torch.device
                       ) -> Iterator[Tuple[Dict[str, np.ndarray], Dict[str, torch.Tensor]]]:
    """Yield (host_batch, device_batch) for each batch of `batches`, with the
    next batch's host-to-device copy in flight while the caller runs its step
    on the current one (the JAX trainer's one-ahead device_put).

    On a CUDA device each array is copied into pinned host memory and sent
    with a non-blocking copy on a side stream; the current stream waits on
    that copy's event before the batch is handed over, and each device
    tensor is recorded on the current stream, so the allocator does not
    reuse its memory before the step that reads it has run. The pinned
    copies are held until the caller has enqueued that step. On the CPU the
    batches pass through unchanged (host and device batch are the same)."""
    if device.type != "cuda":
        for batch in batches:
            yield batch, batch
        return
    side = torch.cuda.Stream(device)
    compute = torch.cuda.current_stream(device)

    def send(host):
        pinned = {k: torch.as_tensor(v).pin_memory() for k, v in host.items()}
        with torch.cuda.stream(side):
            moved = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
        copied = torch.cuda.Event()
        copied.record(side)
        return host, pinned, moved, copied

    it = iter(batches)
    first = next(it, None)
    pending = None if first is None else send(first)
    while pending is not None:
        host, pinned, moved, copied = pending
        following = next(it, None)
        pending = None if following is None else send(following)
        compute.wait_event(copied)
        for t in moved.values():
            t.record_stream(compute)
        yield host, moved
        del pinned, moved  # the step that read them has been enqueued


class MetricLogger:
    """Console + JSONL metric writer; wandb when asked for and installed."""

    def __init__(self, log_dir: str, use_wandb: bool = False, config: Optional[dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project="baseboostdepth_tpu_torch", config=config)
                self._wandb = wandb
            except Exception as e:  # noqa: BLE001 -- wandb is optional
                print(f"[log] wandb unavailable ({e}); continuing with JSONL")

    def log(self, step: int, payload: Dict[str, float]):
        rec = {"step": int(step), "t": time.time(), **{k: float(v) for k, v in payload.items()}}
        if not self._f.closed:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self._wandb is not None:
            self._wandb.log(payload, step=step)

    def close(self):
        self._f.close()


class Trainer:
    def __init__(self, cfg: Config, device="cuda"):
        self.device = require_device(device)
        check_supported(cfg)
        if cfg.data.height % 32 or cfg.data.width % 32:
            raise ValueError("height/width must be multiples of 32")
        # the reference's curriculum path always adds the stereo frame for
        # narrow windows (mono_dataset.py:91-92,107-108)
        if cfg.method.curriculum and not cfg.method.use_stereo:
            raise ValueError("curriculum training requires use_stereo (as in the reference)")
        self.cfg = cfg
        self.log_path = os.path.join(cfg.log.log_dir, cfg.log.model_name)
        os.makedirs(self.log_path, exist_ok=True)
        cfg.save(os.path.join(self.log_path, "config.json"))

        split_dir = os.path.join(resolve_splits_dir(cfg.data.splits_dir), cfg.data.split)
        train_file = os.path.join(split_dir, "train_files_baselines.txt")
        if not os.path.exists(train_file):
            train_file = os.path.join(split_dir, "train_files.txt")
        self.train_index = kitti.KittiRawIndex(
            cfg.data.kt_path, train_file, ".png" if cfg.data.png else ".jpg"
        )
        self.steps_per_epoch = len(self.train_index) // cfg.optim.batch_size

        # online validation assets (optional: only if GT has been exported)
        self.val_paths = []
        self.gt_depths = None
        val_file = os.path.join(split_dir, "val_files.txt")
        gt_file = os.path.join(split_dir, "gt_depths.npz")
        if os.path.exists(val_file) and os.path.exists(gt_file):
            val_index = kitti.KittiRawIndex(cfg.data.kt_path, val_file, ".jpg")
            self.val_paths = [val_index.image_path(s.folder, s.frame_index, s.side)
                              for s in val_index.samples]
            self.gt_depths = np.load(gt_file, fix_imports=True, encoding="latin1",
                                     allow_pickle=True)["data"]

        st0 = self._static_for_stage(stage_for_epoch(0, cfg.method.trimin))
        self.state = init_state(
            st0, seed=cfg.seed, device=self.device, learning_rate=cfg.optim.learning_rate,
            milestones=cfg.optim.lr_milestones, gamma=cfg.optim.lr_gamma,
            steps_per_epoch=self.steps_per_epoch, vit_encoder_lr=cfg.optim.vit_encoder_lr,
        )
        if cfg.method.disp_init_bias is not None:
            init_disp_bias(self.state.depth_net, cfg.method.disp_init_bias)
        if cfg.model.weights_init == "pretrained":
            self._load_pretrained()

        self.ckpt = CheckpointManager(os.path.join(self.log_path, "checkpoints"))
        self.start_epoch = 0
        self.start_batch = 0
        self.best_abs_rel = 10.0
        latest = self.ckpt.latest_step()
        if latest is not None:
            _, extra = self.ckpt.restore(self.state, latest)
            extra = extra or {}
            # the resume position comes from checkpoint metadata, not from
            # latest // steps_per_epoch: best-abs_rel checkpoints land
            # mid-epoch, and bucket_fs drops per-class leftovers so realized
            # steps/epoch < steps_per_epoch; the LR schedule rides the
            # restored scheduler
            if "epoch" in extra:
                if extra.get("epoch_complete"):
                    self.start_epoch = int(extra["epoch"]) + 1
                else:
                    self.start_epoch = int(extra["epoch"])
                    self.start_batch = int(extra.get("batch_in_epoch", -1)) + 1
            else:  # checkpoints without position metadata
                self.start_epoch = int(latest // max(1, self.steps_per_epoch))
            self.best_abs_rel = float(extra.get("best_abs_rel", 10.0))
            print(f"resumed from step {latest} (epoch {self.start_epoch}, "
                  f"batch {self.start_batch}, best_abs_rel {self.best_abs_rel:.4f})")

        self._step_fns: Dict[StepStatic, object] = {}
        self._eval_fns: Dict[object, object] = {}
        self.logger = MetricLogger(self.log_path, cfg.log.wandb, cfg.to_dict())

    def _load_pretrained(self) -> None:
        """ImageNet encoders (the JAX trainer's pretrained branch): an explicit
        model.pretrained_path as given, else torchvision's resnet file for the
        zoo's depth encoder, as the reference fetches it implicitly
        (networks/resnet_encoder.py:46-53); the pose encoder from a
        ResNet-18 file wherever the depth encoder is not one."""
        from baseboostdepth_tpu_torch.models.torch_import import load_pretrained_encoder
        from baseboostdepth_tpu_torch.utils import download

        zoo = self.cfg.model.zoo
        depth_layers = {"md2": self.cfg.model.num_layers, "sql": 50, "sql_large": 50,
                        "cadepth": 50}
        depth_path = self.cfg.model.pretrained_path
        if depth_path is None:
            if zoo not in depth_layers:
                raise SystemExit(
                    f"--model.weights_init pretrained for zoo {zoo!r} needs "
                    "--model.pretrained_path (mpvit_small.pth / hrnet18 ImageNet weights "
                    "have no stable public URL; see utils/download.py)")
            depth_path = download.fetch_torchvision_resnet(depth_layers[zoo])
        pose_path = None
        if depth_layers.get(zoo) != 18:  # the pose pair is always a ResNet-18
            pose_path = download.fetch_torchvision_resnet(18)
        load_pretrained_encoder(self.state.depth_net, self.state.pose_net, depth_path, zoo,
                                pose_path=pose_path)

    # ------------------------------------------------------------------
    def _static_for_stage(self, stage: Stage) -> StepStatic:
        m, cfg = self.cfg.method, self.cfg
        common = dict(
            zoo=cfg.model.zoo, num_layers=cfg.model.num_layers, height=cfg.data.height,
            width=cfg.data.width, use_ssim=not m.no_ssim, min_depth=m.min_depth,
            max_depth=m.max_depth, smooth_weight=m.disparity_smoothness, dtype=cfg.model.dtype,
            pose_input_scale=cfg.model.pose_input_scale,
            merged_warp=cfg.model.resolved_merged_warp(),
        )
        if not m.curriculum:
            scales = (0,) if cfg.model.zoo in DEPTH_IS_METRIC else tuple(m.scales)
            return StepStatic(F=1, scales=scales, trimin=False, incremental=False,
                              partial=False, decomp=False, **common)
        return StepStatic(
            F=stage.F, scales=tuple(stage.scales), trimin=m.trimin,
            incremental=m.incremental and stage.incremental_active,
            partial=m.partial and stage.incremental_active, decomp=m.decomp,
            pose_error=m.pose_error, **common,
        )

    def _step_fn(self, st: StepStatic):
        if st not in self._step_fns:
            self._step_fns[st] = make_train_step(st, device=self.device)
        return self._step_fns[st]

    def _save(self, global_step: int, extra: dict) -> None:
        self.ckpt.save(global_step, self.state, dict(extra, best_abs_rel=self.best_abs_rel))

    # ------------------------------------------------------------------
    def train(self):
        cfg = self.cfg
        t0 = time.time()

        # emergency checkpoint on SIGTERM/SIGINT so preempted runs resume
        # cleanly, and a NaN guard that saves state before aborting
        stop_requested = {"flag": False}

        def _on_signal(signum, frame):
            print(f"signal {signum}: checkpointing and stopping after this step")
            stop_requested["flag"] = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _on_signal)
            except ValueError:
                pass  # not the main thread
        print(f"training {cfg.log.model_name}: {len(self.train_index)} samples, "
              f"{self.steps_per_epoch} steps/epoch, device {self.device}")
        try:
            for epoch in range(self.start_epoch, cfg.optim.num_epochs):
                if not self._train_epoch(epoch, t0, stop_requested):
                    return
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        self.logger.close()

    def _train_epoch(self, epoch: int, t0: float, stop_requested) -> bool:
        """One epoch; False when a signal asked the run to stop."""
        cfg = self.cfg
        global_step = self.state.step
        stage = stage_for_epoch(epoch, cfg.method.trimin, cfg.method.curriculum_switch_epoch,
                                sql=cfg.model.zoo in DEPTH_IS_METRIC)
        st = self._static_for_stage(stage)
        step_fn = self._step_fn(st)
        # frame-budget buckets clipped to this stage (e.g. (2, 5, 7) late,
        # a no-op early); only meaningful with the curriculum on
        bucket_fs = None
        if cfg.data.bucket_fs and cfg.method.curriculum:
            bucket_fs = tuple(sorted({min(b, stage.F) for b in cfg.data.bucket_fs}))
            if bucket_fs == (stage.F,):
                bucket_fs = None
        skip = self.start_batch if epoch == self.start_epoch else 0
        loader = KittiTrainLoader(
            self.train_index, stage, cfg.optim.batch_size, cfg.data.height, cfg.data.width,
            trimin=cfg.method.trimin, use_stereo=cfg.method.use_stereo,
            classic=not cfg.method.curriculum, num_workers=cfg.data.num_workers,
            prefetch=cfg.data.prefetch, seed=cfg.seed * 1000 + epoch, bucket_fs=bucket_fs,
            skip_batches=skip,
        )
        print(f"epoch {epoch}: F={st.F} scales={st.scales} cutoff={stage.cutoff:.2f} "
              f"incremental={st.incremental} partial={st.partial} decomp={st.decomp}")
        t_epoch = time.time()
        seen = 0
        bi = skip - 1  # batch indices continue the pre-resume count
        for host_batch, batch in prefetch_to_device(loader, self.device):
            bi += 1
            fn, st_b = step_fn, st
            if bucket_fs is not None:
                F_c = (host_batch["frames"].shape[1] - 2) // 2
                if F_c != st.F:
                    st_b = dataclasses.replace(st, F=F_c)
                    fn = self._step_fn(st_b)
            seed = step_seed(cfg.seed, global_step)
            gen = torch.Generator(self.device).manual_seed(seed)
            metrics = fn(self.state, batch, generator=gen)
            global_step += 1
            seen += cfg.optim.batch_size

            if stop_requested["flag"]:
                self._save(global_step, {"epoch": epoch, "batch_in_epoch": bi,
                                         "preempted": True})
                print("emergency checkpoint written; exiting")
                return False

            if bi % cfg.log.log_frequency == 0 and bi > 0:
                m = {k: float(v) for k, v in metrics.items()}
                if not all(v == v and abs(v) < 1e6 for v in m.values()):
                    self._save(global_step, {"epoch": epoch, "batch_in_epoch": bi, "nan": True})
                    raise FloatingPointError(f"non-finite loss at step {global_step}: {m}")
                rate = seen / (time.time() - t_epoch)
                m.update(epoch=epoch, imgs_per_sec=rate)
                self.logger.log(global_step, m)
                print(f"e{epoch} b{bi} loss {m['loss']:.4f} | {rate:5.1f} imgs/s | "
                      f"elapsed {sec_to_hm_str(time.time() - t0)}")
                if cfg.log.image_panels:
                    self.save_image_panels(st_b, host_batch, seed, global_step)
                if self.gt_depths is not None:
                    self.validate(st, global_step, epoch, bi, quick=cfg.log.quick_val_size)
                if cfg.log.syns_val:
                    self.validate_syns(global_step)

        # full validation at every epoch end (quick-val only subsamples the
        # in-epoch checks)
        if self.gt_depths is not None:
            self.validate(st, global_step, epoch, -1)
        if (epoch + 1) % cfg.log.save_frequency == 0:
            self._save(global_step, {"epoch": epoch, "epoch_complete": True})
        return True

    # ------------------------------------------------------------------
    def validate(self, st: StepStatic, global_step: int, epoch: int, bi: int, quick: int = 0):
        """Online eigen_zhou validation (reference val(), trainer.py:623-665).

        quick > 0 subsamples the val split to that many images (even
        stride) for the in-epoch checks; the epoch-end call runs them all.
        """
        import cv2

        if st.zoo not in self._eval_fns:
            self._eval_fns[st.zoo] = make_eval_forward(st, device=self.device)
        fwd = self._eval_fns[st.zoo]

        val_paths, gt_depths = self.val_paths, self.gt_depths
        if quick and quick < len(val_paths):
            sel = np.linspace(0, len(val_paths) - 1, quick).astype(int)
            val_paths = [val_paths[i] for i in sel]
            gt_depths = [gt_depths[i] for i in sel]

        totals = np.zeros(len(METRIC_NAMES))
        count = 0
        loader = EvalLoader(val_paths, self.cfg.data.height, self.cfg.data.width, batch_size=16)
        for imgs, start, n in loader:
            depth = fwd(self.state.depth_net, imgs.astype(np.float32) / 255.0).cpu().numpy()
            for j in range(n):
                gt = gt_depths[start + j]
                pred = cv2.resize(depth[j], (gt.shape[1], gt.shape[0]))
                totals += np.array(single_image_errors(pred, gt))
                count += 1
        vals = dict(zip(METRIC_NAMES, totals / max(count, 1)))
        self.logger.log(global_step, {f"val/{k}": v for k, v in vals.items()})
        print("val:", " ".join(f"{k}={v:.4f}" for k, v in vals.items()))
        if vals["abs_rel"] < self.best_abs_rel:
            self.best_abs_rel = vals["abs_rel"]
            self._save(global_step, {"epoch": epoch, "batch_in_epoch": bi,
                                     "epoch_complete": bi < 0, "abs_rel": vals["abs_rel"],
                                     "best": True})
            print(f"new best abs_rel {vals['abs_rel']:.4f} -> checkpoint saved")

    # ------------------------------------------------------------------
    def validate_syns(self, global_step: int):
        """SYNS edge-accuracy online validation (reference trainer.py:646-663,
        its --SYNS_edge path), over the SYNS val split."""
        try:
            m = evaluate_syns(self.cfg, self.state.depth_net, file_name="val_files.txt",
                              device=self.device)
        except FileNotFoundError as e:
            print(f"[syns-val] skipped (missing asset: {e})")
            return
        self.logger.log(global_step, {f"syns/{k}": v for k, v in m.items()})
        print("syns-val:", " ".join(f"{k}={v:.4f}" for k, v in m.items()))

    # ------------------------------------------------------------------
    def save_image_panels(self, st: StepStatic, batch, seed: int, global_step: int,
                          max_rows: int = 3):
        """Write a target | disp | automask | min-loss | warped-candidates
        grid PNG for a train batch (the observability the reference gets from
        wandb image logging, trainer.py:736-772)."""
        from PIL import Image

        from baseboostdepth_tpu_torch.utils import colormap

        key = ("dbg", st)
        if key not in self._eval_fns:
            self._eval_fns[key] = make_debug_forward(st, device=self.device)
        gen = torch.Generator(self.device).manual_seed(seed)
        dbg = self._eval_fns[key](self.state.depth_net, self.state.pose_net, batch, gen)
        dbg = {k: v.float().cpu().numpy() for k, v in dbg.items()}

        rows = []
        for b in range(min(max_rows, dbg["target"].shape[0])):
            cells = [dbg["target"][b]]
            cells.append(colormap(dbg["disp"][b], cmap="magma"))
            cells.append(np.repeat(dbg["automask"][b][..., None], 3, axis=-1))
            ml = dbg["min_loss"][b]
            cells.append(colormap(np.clip(ml, 0, np.percentile(ml, 98) + 1e-8)))
            S = dbg["warped"].shape[1]
            for s in (0, S - 1):  # farthest temporal slot + stereo
                cells.append(dbg["warped"][b, s])
            rows.append(np.concatenate(cells, axis=1))
        panel = (np.clip(np.concatenate(rows, axis=0), 0, 1) * 255).astype(np.uint8)
        out_dir = os.path.join(self.log_path, "panels")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"step_{global_step:08d}.png")
        Image.fromarray(panel).save(path)
        if self.logger._wandb is not None:
            self.logger._wandb.log({"panels": self.logger._wandb.Image(path)}, step=global_step)
