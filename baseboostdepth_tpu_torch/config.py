"""Configuration tree, a copy of `baseboostdepth_tpu/config.py`.

Same dataclasses, defaults, CLI overrides (`--optim.batch_size 12` style) and
JSON round-trip (`Config.save` / `Config.load`), so a config written by
either package loads to equal values in the other. The copy exists because
importing any module of the JAX package imports jax.

`ModelConfig.merged_warp` and `phase_tail` keep the JAX package's per-zoo
defaults (chosen from its TPU measurements); the port reads
`resolved_merged_warp()` and keeps `phase_tail` as configuration only -- the
phase-domain decoder tail is a TPU layout choice that computes the same
numbers as the plain decoder.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class ModelConfig:
    zoo: str = "md2"  # md2 | monovit | sql | sql_large | cadepth | diffnet
    num_layers: int = 18  # ResNet depth for md2 (reference --num_layers)
    weights_init: str = "scratch"  # "pretrained" needs a torch ckpt to import
    pretrained_path: Optional[str] = None  # torchvision/MPViT .pth to import
    dtype: str = "bfloat16"  # conv/attention compute dtype (params, losses,
    # geometry and BN statistics stay float32); set float32 for bit-parity runs
    # pose net on downscaled pairs (1.0 = reference behavior)
    pose_input_scale: float = 1.0
    # main-slot + error-pose warps in ONE warp call over 2S-1 slots instead of
    # two calls; loss-and-grad exact. None = auto per zoo (True except
    # cadepth, as the JAX package chose).
    merged_warp: Optional[bool] = None
    # phase-domain scale-0 decoder tail of the JAX package (a TPU layout
    # choice, exact to fp32). None = auto per zoo. Configuration only here.
    phase_tail: Optional[bool] = None

    def resolved_merged_warp(self) -> bool:
        if self.merged_warp is not None:
            return bool(self.merged_warp)
        return self.zoo != "cadepth"

    def resolved_phase_tail(self) -> bool:
        if self.phase_tail is not None:
            return bool(self.phase_tail)
        return self.zoo == "md2"


@dataclass
class MethodConfig:
    """The BaseBoostDepth method toggles; defaults reproduce the full paper
    method (reference run.sh: --rand --trimin --incremental_skip
    --partial_skip --decomp)."""

    curriculum: bool = True  # reference --rand
    trimin: bool = True  # tri-minimization across neighboring baselines
    incremental: bool = True  # chained step poses (--incremental_skip)
    partial: bool = True  # partial pose (translation) replacement
    decomp: bool = True  # error-induced reconstructions (--decomp)
    pose_error: float = 5.5  # error-pose translation divisor (run.sh:22)
    use_stereo: bool = True
    scales: Tuple[int, ...] = (0, 1, 2, 3)
    min_depth: float = 0.1
    max_depth: float = 100.0
    disparity_smoothness: float = 1e-3
    no_ssim: bool = False
    frame_ids: Tuple[int, ...] = (0, -1, 1)  # classic mode (curriculum=False)
    # cold-start disparity-head bias (sigmoid logit; None = reference
    # zero-bias init); see training/step.py init_disp_bias
    disp_init_bias: Optional[float] = None
    # curriculum schedule (reference mono_dataset.py:61-66):
    #   epoch < switch: F = 2 (trimin) / 1, cutoff = 0.1 + 0.04 * epoch
    #   epoch >= switch: F = 7 (trimin) / 5, cutoff = 0.15 * epoch - 0.9
    curriculum_switch_epoch: int = 10


@dataclass
class DataConfig:
    kt_path: str = "kitti_data"
    syns_path: str = "syns_data"
    split: str = "eigen_zhou"
    splits_dir: str = "splits"  # directory containing split txt files
    height: int = 192
    width: int = 640
    png: bool = False
    num_workers: int = 8
    prefetch: int = 2
    # frame-budget bucketing: batch samples by curriculum window class
    # (2, 5, 7); () = off (pad every sample to the stage budget)
    bucket_fs: Tuple[int, ...] = (2, 5, 7)


@dataclass
class OptimConfig:
    batch_size: int = 12
    learning_rate: float = 1e-4
    num_epochs: int = 20
    lr_milestones: Tuple[int, ...] = (11, 13, 15, 16, 17, 18, 19)
    lr_gamma: float = 0.4
    vit_encoder_lr: float = 5e-5  # MonoViT two-group AdamW (trainer.py:106-109)


@dataclass
class DistConfig:
    """Multi-process data parallelism, one process per GPU (set all three
    fields explicitly for a cluster that announces nothing; without them
    the process group comes from torch.distributed.run's environment)."""

    enabled: bool = False
    coordinator: Optional[str] = None  # "host:port" of process 0, or an init URL (file://...)
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


@dataclass
class LogConfig:
    log_dir: str = "logs"
    model_name: str = "bbd_tpu"
    log_frequency: int = 250  # batches between val+checkpoint (trainer.py:266)
    save_frequency: int = 1  # epochs between checkpoints
    wandb: bool = False  # optional; console/JSONL writer is the default
    # quick-val subsample size for the periodic in-epoch validation; 0 = all
    quick_val_size: int = 0
    image_panels: bool = True  # per-val target/disp/warp/automask PNG grids
    # SYNS edge-accuracy online validation (reference trainer.py:646-663)
    syns_val: bool = False


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    method: MethodConfig = field(default_factory=MethodConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    log: LogConfig = field(default_factory=LogConfig)
    dist: DistConfig = field(default_factory=DistConfig)
    seed: int = 42

    # ------------------------------------------------------------------ io
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def build(tcls, sub):
            kw = {}
            for f_ in dataclasses.fields(tcls):
                if f_.name in sub:
                    v = sub[f_.name]
                    if isinstance(v, list):
                        v = tuple(v)
                    kw[f_.name] = v
            return tcls(**kw)

        return cls(
            model=build(ModelConfig, d.get("model", {})),
            method=build(MethodConfig, d.get("method", {})),
            data=build(DataConfig, d.get("data", {})),
            optim=build(OptimConfig, d.get("optim", {})),
            log=build(LogConfig, d.get("log", {})),
            dist=build(DistConfig, d.get("dist", {})),
            seed=d.get("seed", 42),
        )

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # ----------------------------------------------------------------- cli
    @classmethod
    def from_args(cls, argv: Optional[List[str]] = None) -> "Config":
        """Parse `--section.field value` overrides over the defaults.

        Booleans accept true/false; tuples accept comma-separated values.
        `--config path.json` loads a base config first.
        """
        parser = argparse.ArgumentParser(description="BaseBoostDepth (PyTorch)")
        parser.add_argument("--config", type=str, default=None)
        ns, rest = parser.parse_known_args(argv)
        cfg = cls.load(ns.config) if ns.config else cls()

        it = iter(rest)
        for tok in it:
            if not tok.startswith("--"):
                raise SystemExit(f"unexpected argument: {tok}")
            key = tok[2:]
            try:
                val = next(it)
            except StopIteration:
                raise SystemExit(f"missing value for --{key}")
            if key == "seed":
                cfg.seed = int(val)
                continue
            if "." not in key:
                raise SystemExit(f"expected --section.field, got --{key}")
            sec_name, f_name = key.split(".", 1)
            sec = getattr(cfg, sec_name, None)
            if sec is None or not hasattr(sec, f_name):
                raise SystemExit(f"unknown config field: {key}")
            cur = getattr(sec, f_name)
            setattr(sec, f_name, _coerce(val, cur))
        return cfg


def _coerce(val: str, current):
    if isinstance(current, bool):
        return val.lower() in ("1", "true", "yes", "on")
    if isinstance(current, tuple):
        elems = [e for e in val.split(",") if e]
        elem_t = type(current[0]) if current else int
        return tuple(elem_t(e) for e in elems)
    if isinstance(current, int) and not isinstance(current, bool):
        return int(val)
    if isinstance(current, float):
        return float(val)
    if current is None:
        # Optional[...] field with no current value to infer from: accept
        # none/null, then booleans, then numbers narrowest-first, then the
        # raw string (e.g. --method.disp_init_bias -2.2 parses as a float)
        if val.lower() in ("none", "null"):
            return None
        if val.lower() in ("true", "false", "yes", "no", "on", "off"):
            return val.lower() in ("true", "yes", "on")
        for typ in (int, float):
            try:
                return typ(val)
            except ValueError:
                pass
        return val
    return val
