"""Analytic multi-view-consistent synthetic scenes, the counterpart of
`baseboostdepth_tpu/data/synthetic.py` (numpy and PIL, no torch): for the
same seed its renders, depth maps, poses and written trees are byte-equal
to the JAX package's.

A procedurally generated driving scene that is EXACTLY multi-view
consistent: a flat textured ground plane (road), a set of fronto-parallel
textured billboard quads at assorted depths (buildings/objects), and a
distant sky plane. Every view is a closed-form ray-plane intersection +
procedural texture lookup, so rendered images, ground-truth depth maps, and
ground-truth camera poses agree to machine precision -- any abs_rel left
after training is the method's, not the data's.

`materialize_kitti_layout` writes the scene as a KITTI-raw drive (image_02/
image_03 JPEGs + split files with the baselines column + gt_depths.npz), so
the real pipeline -- KittiRawIndex, curriculum loader, Trainer, evaluator --
runs unchanged on it (as the reference trains on KITTI raw,
datasets/kitti_dataset.py:43-60); `materialize_odometry_layout` writes a
KITTI-odometry sequence with exact GT poses for the pose evaluator.

Scale convention: the stereo rig translation is 0.1 units (the method's
hard-coded stereo_T, mono_dataset.py:136-140), matching KITTI's 0.54 m
baseline => 1 unit ~ 5.4 m. Ground height 0.3 units (~1.65 m), scene depths
1-20 units (~5-108 m), per-frame ego motion ~0.15 units (~0.8 m/frame).
One 640x192 render takes seconds on a CPU core.
"""

from __future__ import annotations

import functools
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


# --------------------------------------------------------------------------
# procedural texture: smooth band-limited RGB noise over a 2-D surface chart
# --------------------------------------------------------------------------
class _Texture:
    def __init__(self, rng: np.random.Generator, n_waves: int = 10,
                 f_lo: float = 0.3, f_hi: float = 6.0):
        self.freq = np.exp(rng.uniform(np.log(f_lo), np.log(f_hi), (n_waves, 2)))
        self.phase = rng.uniform(0, 2 * np.pi, (n_waves, 2))
        self.amp = rng.uniform(0.3, 1.0, (n_waves, 3)) / n_waves * 2.2
        self.base = rng.uniform(0.35, 0.65, 3)

    def __call__(self, a: np.ndarray, b: np.ndarray,
                 da: np.ndarray | None = None,
                 db: np.ndarray | None = None) -> np.ndarray:
        """(a, b) surface coords [...,] -> RGB [..., 3] in [0, 1].

        da/db: per-pixel footprint (surface units per pixel). Each wave is
        attenuated by the Gaussian-integrated footprint -- analytic
        anti-aliasing, the supersampled limit. Without it, far-field /
        grazing-angle pixels point-sample high-frequency texture and alias,
        which breaks photometric consistency between views.
        """
        out = np.broadcast_to(self.base, a.shape + (3,)).copy()
        tau = 2 * np.pi
        for k in range(self.freq.shape[0]):
            w = np.sin(tau * self.freq[k, 0] * a + self.phase[k, 0]) * \
                np.sin(tau * self.freq[k, 1] * b + self.phase[k, 1])
            if da is not None:
                att = np.exp(
                    -2.0 * ((self.freq[k, 0] * da) ** 2 + (self.freq[k, 1] * db) ** 2)
                )
                w = w * att
            out += w[..., None] * self.amp[k]
        return np.clip(out, 0.0, 1.0)


@dataclass
class _Billboard:
    z: float          # world z of the quad plane
    x0: float
    x1: float
    y0: float
    y1: float
    tex: _Texture = field(repr=False, default=None)


class SyntheticScene:
    """A drive through a static analytic scene.

    World frame = camera frame at t=0: x right, y DOWN, z forward.
    Trajectory: forward motion with gentle lateral sway and yaw/pitch
    wobble -- KITTI-like ego-motion with nonzero rotation.

    The scene is INFINITE along the driving direction: billboards repeat
    with period `z_period` (each repetition is the same static quad -- the
    scene is genuinely periodic, so every view of it is exactly consistent
    no matter how far the camera drives), the ground is an infinite plane,
    and the "sky" is an infinite ceiling plane high above (parallax-correct,
    unlike a fixed far wall the camera would eventually reach). Rays that
    hit nothing (a thin horizon band) get a constant sky color -- constant
    across views, hence still photometrically consistent -- at `sky_depth`.
    """

    def __init__(
        self,
        seed: int = 0,
        n_billboards: int = 14,
        ground_y: float = 0.3,
        sky_y: float = -2.5,
        z_period: float = 20.0,
        n_repeats: int = 4,
        sky_depth: float = 60.0,
        speed: float = 0.15,
        sway: float = 0.06,
        yaw_amp: float = 0.015,
        pitch_amp: float = 0.006,
    ):
        rng = np.random.default_rng(seed)
        self.ground_y = ground_y
        self.sky_y = sky_y
        self.z_period = z_period
        self.n_repeats = n_repeats
        self.sky_depth = sky_depth
        self.speed = speed
        self.sway = sway
        self.yaw_amp = yaw_amp
        self.pitch_amp = pitch_amp
        self.ground_tex = _Texture(rng)
        self.sky_tex = _Texture(rng, f_lo=0.02, f_hi=0.3)
        self.sky_color = rng.uniform(0.55, 0.75, 3)

        self.billboards: List[_Billboard] = []
        for _ in range(n_billboards):
            z = float(rng.uniform(0.0, z_period))
            # keep a clear driving corridor: objects sit left/right of x=0
            side = 1 if rng.random() < 0.5 else -1
            xc = side * float(rng.uniform(0.4, 3.0))
            w = float(rng.uniform(0.3, 2.5))
            top = float(rng.uniform(-1.2, -0.1))
            self.billboards.append(
                _Billboard(z=z, x0=xc - w / 2, x1=xc + w / 2,
                           y0=top, y1=self.ground_y + 0.01, tex=_Texture(rng))
            )

    # ------------------------------------------------------------ cameras
    def camera_center(self, i: int | float) -> np.ndarray:
        t = float(i)
        return np.array(
            [self.sway * np.sin(0.08 * t), 0.0, self.speed * t], np.float64
        )

    def camera_rotation(self, i: int | float) -> np.ndarray:
        """world->camera rotation R (x_c = R @ (x_w - C))."""
        t = float(i)
        yaw = self.yaw_amp * np.sin(0.11 * t + 0.7)
        pitch = self.pitch_amp * np.sin(0.17 * t)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cp, sp], [0, -sp, cp]])
        return Rx @ Ry

    def pose_0_to_f(self, f: int, base: int = 0) -> np.ndarray:
        """GT 4x4 pose mapping frame-`base` camera points into frame-`f`
        camera points (the training convention, geometry.py)."""
        R0, Rf = self.camera_rotation(base), self.camera_rotation(f)
        C0, Cf = self.camera_center(base), self.camera_center(f)
        T = np.eye(4)
        T[:3, :3] = Rf @ R0.T
        T[:3, 3] = Rf @ (C0 - Cf)
        return T.astype(np.float32)

    def stereo_center(self, i: int) -> np.ndarray:
        """Right camera center: +0.1 units along the camera x-axis (the
        method's stereo_T convention: x_r = x_l - 0.1)."""
        return self.camera_center(i) + self.camera_rotation(i).T @ np.array([0.1, 0.0, 0.0])

    # ------------------------------------------------------------- render
    def _trace(self, C: np.ndarray, R: np.ndarray, K: np.ndarray,
               width: int, height: int):
        """Returns (rgb [H,W,3] float, depth [H,W] float)."""
        u, v = np.meshgrid(np.arange(width), np.arange(height))
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        d_c = np.stack(
            [(u - cx) / fx, (v - cy) / fy, np.ones_like(u, np.float64)], axis=-1
        )  # camera ray with z=1 -> intersection t IS camera depth
        d_w = d_c @ R  # R^T d_c

        t_best = np.full((height, width), np.inf)
        rgb = np.broadcast_to(self.sky_color, (height, width, 3)).copy()

        def footprint(a, b):
            """Per-pixel surface-coordinate footprint via finite differences
            of the intersection chart over the pixel grid."""
            da = np.maximum(np.abs(np.gradient(a, axis=1)), np.abs(np.gradient(a, axis=0)))
            db = np.maximum(np.abs(np.gradient(b, axis=1)), np.abs(np.gradient(b, axis=0)))
            return np.clip(da, 0, 50), np.clip(db, 0, 50)

        def consider(t, mask, color):
            m = mask & (t > 1e-6) & (t < t_best)
            t_best[m] = t[m]
            rgb[m] = color[m]

        # ground plane y = ground_y
        tg = (self.ground_y - C[1]) / d_w[..., 1]
        p = C + tg[..., None] * d_w
        consider(
            tg, d_w[..., 1] > 1e-9,
            self.ground_tex(p[..., 0], p[..., 2], *footprint(p[..., 0], p[..., 2])),
        )

        # sky ceiling plane y = sky_y (infinite, parallax-correct)
        ts = (self.sky_y - C[1]) / d_w[..., 1]
        p = C + ts[..., None] * d_w
        consider(
            ts, d_w[..., 1] < -1e-9,
            self.sky_tex(p[..., 0], p[..., 2], *footprint(p[..., 0], p[..., 2])),
        )

        # periodic billboards: each quad repeats every z_period; check the
        # first n_repeats repetitions ahead of the camera (min-t wins)
        dz = d_w[..., 2]
        fwd = dz > 1e-9
        safe_dz = np.where(fwd, dz, 1.0)
        for bb in self.billboards:
            k0 = np.ceil((C[2] - bb.z) / self.z_period)
            for k in range(self.n_repeats):
                zp = bb.z + (k0 + k) * self.z_period
                tb = (zp - C[2]) / safe_dz
                p = C + tb[..., None] * d_w
                inb = (
                    fwd
                    & (p[..., 0] >= bb.x0) & (p[..., 0] <= bb.x1)
                    & (p[..., 1] >= bb.y0) & (p[..., 1] <= bb.y1)
                )
                consider(
                    tb, inb,
                    bb.tex(p[..., 0], p[..., 1], *footprint(p[..., 0], p[..., 1])),
                )

        # horizon-band ground hits have near-infinite range; clamp GT depth
        # to sky_depth (parallax there is sub-pixel either way)
        depth = np.where(np.isfinite(t_best), t_best, self.sky_depth)
        depth = np.minimum(depth, self.sky_depth)
        return np.nan_to_num(rgb, nan=0.5), depth.astype(np.float32)

    def render(self, i: int, side: str, K: np.ndarray, width: int, height: int):
        """-> (uint8 image [H,W,3], float32 depth [H,W]) for frame i."""
        C = self.camera_center(i) if side == "l" else self.stereo_center(i)
        R = self.camera_rotation(i)
        # rays parallel to the ground or the sky plane divide by zero, and
        # the inf and nan that follow are handled as the JAX package's
        # renderer handles them (plane masks, nan_to_num); silencing the
        # warnings changes no value
        with np.errstate(divide="ignore", invalid="ignore"):
            rgb, depth = self._trace(C, R, K, width, height)
        return (rgb * 255.0 + 0.5).astype(np.uint8), depth


def _render_file(scene: SyntheticScene, K: np.ndarray, width: int, height: int, save: dict,
                 i: int, side: str, path: str) -> np.ndarray:
    """Render frame i of one camera into the image file `path` (`save`: PIL's
    save options); -> its depth."""
    from PIL import Image

    img, depth = scene.render(i, side, K, width, height)
    Image.fromarray(img).save(path, **save)
    return depth


def _render_files(scene: SyntheticScene, jobs, K: np.ndarray, width: int, height: int,
                  workers: int, save: dict) -> List[np.ndarray]:
    """The depths of `jobs` ((frame, side, path) each, rendered and written
    by _render_file), in order; with workers > 1 in that many spawned
    processes. Each render depends only on its frame and side, so the files
    are the same bytes at any worker count."""
    render = functools.partial(_render_file, scene, K, width, height, save)
    frames, sides, paths = zip(*jobs)
    if workers <= 1:
        return list(map(render, frames, sides, paths))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(render, frames, sides, paths, chunksize=4))


# --------------------------------------------------------------------------
# KITTI-raw materialization
# --------------------------------------------------------------------------
def materialize_kitti_layout(
    root: str,
    n_frames: int = 120,
    width: int = 640,
    height: int = 192,
    seed: int = 0,
    margin: int = 7,
    val_fraction: float = 0.2,
    jpeg_quality: int = 95,
    scene: SyntheticScene | None = None,
    workers: int = 1,
) -> Tuple[str, str]:
    """Render a SyntheticScene into a KITTI-raw tree (the frames in
    `workers` processes; the files are the same bytes at any count).

    Writes:
      <root>/synth_drive/image_0{2,3}/data/{i:010d}.jpg
      <root>/splits/synth/train_files_baselines.txt  (baseline column = the
          per-frame ego translation magnitude, the reference's 5th column,
          mono_dataset.py:99-101)
      <root>/splits/synth/val_files.txt + gt_depths.npz (+ test_files.txt =
          val, for the offline evaluator)

    Trainable frames keep `margin` neighbors on both sides; the last
    val_fraction of them are held out for validation. Returns
    (data_path, splits_dir).
    """
    from baseboostdepth_tpu_torch.data.kitti import intrinsics

    scene = scene or SyntheticScene(seed=seed)
    K, _ = intrinsics(width, height)
    folder = "synth_drive"
    data_dir = os.path.join(root, folder)
    for cam in (2, 3):
        os.makedirs(os.path.join(data_dir, f"image_0{cam}", "data"), exist_ok=True)

    jobs = [(i, side, os.path.join(data_dir, f"image_0{cam}", "data", f"{i:010d}.jpg"))
            for i in range(n_frames) for cam, side in ((2, "l"), (3, "r"))]
    rendered = _render_files(scene, jobs, K, width, height, workers,
                              {"quality": jpeg_quality})
    depths = {i: d for (i, side, _), d in zip(jobs, rendered) if side == "l"}

    usable = list(range(margin, n_frames - margin))
    n_val = max(1, int(len(usable) * val_fraction))
    train_ids, val_ids = usable[:-n_val], usable[-n_val:]

    splits_dir = os.path.join(root, "splits")
    split = os.path.join(splits_dir, "synth")
    os.makedirs(split, exist_ok=True)

    def motion(i):
        return float(np.linalg.norm(scene.camera_center(i + 1) - scene.camera_center(i)))

    with open(os.path.join(split, "train_files_baselines.txt"), "w") as f:
        for i in train_ids:
            f.write(f"{folder} {i} l kt {motion(i):.6f}\n")
    with open(os.path.join(split, "val_files.txt"), "w") as f:
        for i in val_ids:
            f.write(f"{folder} {i} l\n")
    with open(os.path.join(split, "test_files.txt"), "w") as f:
        for i in val_ids:
            f.write(f"{folder} {i} l\n")
    np.savez_compressed(
        os.path.join(split, "gt_depths.npz"),
        data=np.array([depths[i] for i in val_ids]),
    )
    return root, splits_dir


def materialize_odometry_layout(
    root: str,
    n_frames: int = 60,
    width: int = 640,
    height: int = 192,
    sequence: int = 9,
    scene: SyntheticScene | None = None,
    seed: int = 0,
) -> Tuple[str, str, str]:
    """Render the scene as a KITTI-odometry sequence so the real pose
    evaluator (evaluation/pose.py, parity with the reference
    evaluate_pose.py) runs unchanged against exact GT poses.

    Writes:
      <root>/sequences/<seq>/image_2/{i:06d}.png
      <root>/splits/odom/test_files_<seq>.txt
      <root>/poses/<seq>.txt   (KITTI gt format: flattened cam-to-world
                                [3,4] per frame)
    Returns (data_path, splits_dir, gt_poses_path).
    """
    from PIL import Image

    from baseboostdepth_tpu_torch.data.kitti import intrinsics

    scene = scene or SyntheticScene(seed=seed)
    K, _ = intrinsics(width, height)
    seq_dir = os.path.join(root, "sequences", f"{sequence:02d}", "image_2")
    os.makedirs(seq_dir, exist_ok=True)
    split_dir = os.path.join(root, "splits", "odom")
    os.makedirs(split_dir, exist_ok=True)
    poses_dir = os.path.join(root, "poses")
    os.makedirs(poses_dir, exist_ok=True)

    rows = []
    lines = []
    for i in range(n_frames):
        img, _ = scene.render(i, "l", K, width, height)
        Image.fromarray(img).save(os.path.join(seq_dir, f"{i:06d}.png"))
        # cam-to-world: x_w = R_i^T x_c + C_i
        R = scene.camera_rotation(i)
        C = scene.camera_center(i)
        rows.append(np.hstack([R.T, C[:, None]]).reshape(-1))
        lines.append(f"{sequence:02d} {i} l")
    gt_path = os.path.join(poses_dir, f"{sequence:02d}.txt")
    np.savetxt(gt_path, np.array(rows))
    with open(os.path.join(split_dir, f"test_files_{sequence:02d}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root, os.path.join(root, "splits"), gt_path
