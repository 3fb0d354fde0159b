"""Fixed-shape training batch layout (host side, numpy), a copy of
`baseboostdepth_tpu/training/batch.py`.

A batch is a flat dict of arrays:

  frames:       uint8 [B, NF, H, W, 3], NF = 2F + 2. Index o + F holds the
                frame at temporal offset o in [-F, F]; index NF-1 holds the
                stereo pair. Frames beyond a sample's own window (|o| >
                f_max) are replicated copies of frame 0 -- they never reach
                the loss (masked slots) but keep the BatchNorm statistics of
                the batched pose-net pass on natural images.
  slot_offset:  int32 [B, S] temporal offsets of the candidate slots.
  slot_valid:   bool  [B, S+1] candidate-slot validity (S temporal + stereo).
  slot_partial: bool  [B, S] slots whose chained pose gets its translation
                replaced by a direct estimate (partial_skip).
  K, inv_K:     float32 [B, 4, 4] full-res intrinsics.
  stereo_T:     float32 [B, 4, 4] (x-translation +-0.1).
  flip:         bool [B]  (applied on device).
  jitter:       float32 [B, NF, 4] color-jitter params ((1,1,1,0)=identity).

See losses.py for the slot semantics.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def num_frames(F: int) -> int:
    return 2 * F + 2


def stereo_index(F: int) -> int:
    return 2 * F + 1


def num_temporal_slots(F: int, trimin: bool) -> int:
    """Stage-wide temporal slot count: at F <= 2 the tri-min slot pairs
    +-(f-1)/+-(f-2) can never all exist, so the candidate axis shrinks."""
    return min(6, 2 * F) if trimin else 2


def slot_table(
    f_max: int, F: int, trimin: bool, use_stereo: bool, classic: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Candidate slots for one sample with max temporal offset f_max.

    Returns (slot_offset [6] int32, slot_valid [7] bool, partial_eligible [6]
    bool). Reproduces the candidate sets of the reference's x_min_opt
    (trainer.py:983-1100):
      f>=3: warps/identities of +-f, +-(f-1), +-(f-2)
      f==2: +-2, +-1, stereo        f==1: +-1, stereo
      f==0: stereo only
    Non-trimin (plain curriculum): +-f only, stereo only when f==0. Classic
    mode (no curriculum, frames [0,-1,1,'s']): +-1 plus stereo for every
    sample.

    partial_eligible marks slots whose offset magnitude is f_max or f_max-1
    and > 1 (reference trainer.py:407-418).
    """
    off = np.zeros(6, dtype=np.int32)
    valid = np.zeros(7, dtype=bool)
    partial = np.zeros(6, dtype=bool)

    f = int(f_max)
    if f >= 1:
        off[0], off[1] = f, -f
        valid[0], valid[1] = True, True
        if trimin and f >= 2:
            off[2], off[3] = f - 1, -(f - 1)
            valid[2], valid[3] = True, True
        if trimin and f >= 3:
            off[4], off[5] = f - 2, -(f - 2)
            valid[4], valid[5] = True, True

    if classic:
        stereo_ok = True
    elif trimin:
        stereo_ok = f <= 2  # includes f == 0 (stereo-only samples)
    else:
        stereo_ok = f == 0
    valid[6] = bool(use_stereo and stereo_ok)

    # partial replacement: slots 0..3 (offsets +-f, +-(f-1)) with |off| > 1
    for j in range(4):
        partial[j] = valid[j] and abs(int(off[j])) > 1

    if F > 0:
        assert f <= F, (f, F)
    return off, valid, partial


def make_batch(
    frames: np.ndarray,
    f_max: np.ndarray,
    K: np.ndarray,
    stereo_T: np.ndarray,
    flip: np.ndarray,
    jitter: np.ndarray,
    F: int,
    trimin: bool,
    use_stereo: bool,
    classic: bool = False,
) -> Dict[str, np.ndarray]:
    """Assemble the per-step batch dict from per-sample pieces."""
    B = frames.shape[0]
    off6 = np.zeros((B, 6), dtype=np.int32)
    valid7 = np.zeros((B, 7), dtype=bool)
    partial6 = np.zeros((B, 6), dtype=bool)
    for b in range(B):
        off6[b], valid7[b], partial6[b] = slot_table(
            int(f_max[b]), F, trimin, use_stereo, classic
        )
    S = num_temporal_slots(F, trimin)
    assert not valid7[:, S:6].any(), "slot beyond the stage slot budget"
    assert valid7.any(axis=1).all(), (
        "sample with no valid loss candidate (stereo-only sample without "
        "use_stereo?)"
    )
    off = off6[:, :S]
    valid = np.concatenate([valid7[:, :S], valid7[:, 6:7]], axis=1)
    partial = partial6[:, :S]
    return {
        "frames": frames,
        "slot_offset": off,
        "slot_valid": valid,
        "slot_partial": partial,
        "K": K.astype(np.float32),
        "inv_K": np.linalg.inv(K).astype(np.float32),
        "stereo_T": stereo_T.astype(np.float32),
        "flip": flip.astype(bool),
        "jitter": jitter.astype(np.float32),
    }


def synthetic_batch(F: int, batch: int, height: int, width: int, seed: int) -> Dict[str, np.ndarray]:
    """Random uint8 batch of the main path's layout, as bench.py builds it:
    every sample at the stage's frame budget (f_max = F), tri-min with
    stereo, KITTI-like intrinsics, stereo baseline 0.1, no flip, identity
    jitter. Frames are uniform noise made from `seed`."""
    rng = np.random.default_rng(seed)
    NF = num_frames(F)
    frames = rng.integers(0, 255, (batch, NF, height, width, 3), dtype=np.uint8)
    K = np.array([[0.58 * width, 0, 0.5 * width, 0], [0, 1.92 * height, 0.5 * height, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    K = np.broadcast_to(K, (batch, 4, 4)).copy()
    stereo_T = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, 4, 4)).copy()
    stereo_T[:, 0, 3] = 0.1
    jitter = np.ones((batch, NF, 4), np.float32)
    jitter[..., 3] = 0.0
    return make_batch(frames, np.full(batch, F), K, stereo_T, np.zeros(batch, bool), jitter,
                      F, True, True)
