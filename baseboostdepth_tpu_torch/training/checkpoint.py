"""Checkpointing with torch.save, the counterpart of
`baseboostdepth_tpu/training/checkpoint.py` (which uses Orbax), with its
policy and file names.

Each save writes a step directory `{step}/state.pt` holding the state's
`state_dict()` (for a TrainState: both networks with their BatchNorm
statistics, the optimizer, the scheduler and the step) or, for a plain dict
of tensors, the dict itself; and, when metadata is given, an
`extra_{step}.json` sidecar beside it (epoch, batch, validation metrics).
Writes are atomic: the directory and the sidecar are written under a
temporary name and moved into place with `os.replace`.

Retention: periodic saves are rolled (newest `max_to_keep` kept) but saves
marked pinned, or whose metadata says "best" (best-abs_rel checkpoints), are
exempt from GC, so a best checkpoint survives any number of later periodic
saves. Pins persist across restarts through the sidecars (`"pin": true`).
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
from typing import Any, Optional, Tuple

import torch

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._pinned = self._scan_pinned()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _sidecar(self, step: int) -> str:
        return os.path.join(self.directory, f"extra_{int(step)}.json")

    def _scan_pinned(self) -> set:
        pinned = set()
        for path in glob.glob(os.path.join(self.directory, "extra_*.json")):
            m = re.match(r"extra_(\d+)\.json$", os.path.basename(path))
            if not m:
                continue
            try:
                with open(path) as f:
                    extra = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if extra.get("pin") or extra.get("best"):
                pinned.add(int(m.group(1)))
        return pinned

    def save(self, step: int, state: Any, extra: Optional[dict] = None,
             pinned: bool = False) -> None:
        step = int(step)
        if pinned or (extra or {}).get("best"):
            self._pinned.add(step)
        if step in self._pinned:  # a re-save of a pinned step stays pinned
            extra = dict(extra or {}, pin=True)
        payload = state.state_dict() if hasattr(state, "state_dict") else state
        tmp = os.path.join(self.directory, f".{step}.tmp{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        final = self._step_dir(step)
        if os.path.isdir(final):  # re-saved step (e.g. best, then epoch end)
            shutil.rmtree(final)
        os.replace(tmp, final)
        if extra is not None:
            side_tmp = self._sidecar(step) + f".tmp{os.getpid()}"
            with open(side_tmp, "w") as f:
                json.dump(extra, f)
            os.replace(side_tmp, self._sidecar(step))
        self._gc()

    def _gc(self) -> None:
        """Delete the oldest unpinned steps beyond max_to_keep."""
        if self.max_to_keep is None:
            return
        unpinned = [s for s in self.all_steps() if s not in self._pinned]
        for s in unpinned[: max(0, len(unpinned) - self.max_to_keep)]:
            shutil.rmtree(self._step_dir(s))
            if os.path.exists(self._sidecar(s)):
                os.remove(self._sidecar(s))

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_state: Any, step: Optional[int] = None) -> Tuple[Any, Optional[dict]]:
        """Load step `step` (default: the latest). A target with
        `load_state_dict` (a TrainState) is restored in place and returned;
        otherwise the saved dict is returned. Tensors land on the CPU and
        `load_state_dict` copies them to the target's device."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                             map_location="cpu", weights_only=True)
        if hasattr(target_state, "load_state_dict"):
            target_state.load_state_dict(payload)
            restored = target_state
        else:
            restored = payload
        extra = None
        if os.path.exists(self._sidecar(step)):
            with open(self._sidecar(step)) as f:
                extra = json.load(f)
        return restored, extra
