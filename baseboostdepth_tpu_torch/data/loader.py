"""Host-side training data loader: threaded decode/resize + prefetch, the
counterpart of `baseboostdepth_tpu/data/loader.py`.

The native C++ batch decoder (native/bbd_loader.cpp: libjpeg + Lanczos3)
decodes and resizes when it builds and the dataset is JPEG; otherwise a
thread pool does it with PIL (which releases the GIL during JPEG decode and
LANCZOS resize). A background thread keeps `prefetch` batches ready. The
host does the minimum: decode, resize to the training resolution, stack
uint8. Flip, color jitter, float conversion and the multi-scale pyramid run
on the device inside the train step (data/augment.py, ops/resize.py), so the
host->device transfer is one uint8 frame stack per batch. Batches are
byte-identical to the JAX loader's for the same seed and the same
`use_native` choice: the same plan, drawn from the same numpy RNG stream,
and the same decoder (the two decoders differ from each other by 1 at some
bytes). At their defaults (`use_native=None`) both loaders choose the same
decoder wherever both native builds succeed.

Per-sample contract (see training/batch.py): frames at offsets beyond the
sample's curriculum window are replicated copies of frame 0.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
from PIL import Image

from baseboostdepth_tpu_torch.data import kitti
from baseboostdepth_tpu_torch.data.curriculum import Stage, sample_f_max
from baseboostdepth_tpu_torch.native import decode_resize_batch, native_available
from baseboostdepth_tpu_torch.training.batch import make_batch, num_frames


def load_resized(path: str, width: int, height: int) -> np.ndarray:
    """Decode + LANCZOS resize -> uint8 [H, W, 3] (reference resize pipeline
    mono_dataset.py:70-74 at scale 0; coarser scales are built on device)."""
    with Image.open(path) as img:
        img = img.convert("RGB").resize((width, height), Image.LANCZOS)
        return np.asarray(img, dtype=np.uint8)


class KittiTrainLoader:
    """Iterable over fixed-shape training batches for one epoch.

    The dataset is conceptually rebuilt each epoch (the reference recreates
    its DataLoader per epoch to advance the curriculum, trainer.py:214-220);
    here that is a new KittiTrainLoader with the epoch's Stage.
    """

    def __init__(
        self,
        index: kitti.KittiRawIndex,
        stage: Stage,
        batch_size: int,
        height: int,
        width: int,
        trimin: bool,
        use_stereo: bool = True,
        classic: bool = False,
        num_workers: int = 8,
        prefetch: int = 2,
        seed: int = 0,
        drop_last: bool = True,
        use_native: Optional[bool] = None,
        process_index: int = 0,
        process_count: int = 1,
        bucket_fs: Optional[Tuple[int, ...]] = None,
        skip_batches: int = 0,
    ):
        """batch_size is the GLOBAL batch size. With process_count > 1 every
        process builds the same shuffled order and per-sample RNG seeds from
        the shared `seed` and loads only its batch_size/process_count slice
        of each global batch, so the realized global batch does not depend
        on the process count.

        bucket_fs: optional ascending frame-budget classes, last == stage.F
        (e.g. (2, 5, 7)). When set, samples are grouped into batches by the
        smallest class covering their curriculum window f_max, so narrow-
        window samples run a cheaper step (fewer pose pairs, warps, frames)
        instead of padding up to the stage budget. Per-sample plans are drawn
        from the SAME rng stream as the unbucketed loader; only batch
        composition changes. Per-class leftover samples at epoch end are
        dropped (a generalization of drop_last).

        skip_batches: fast-forward over the first N batches of the epoch
        without decoding any pixels, consuming the identical RNG stream, so a
        mid-epoch resume sees exactly the batches an uninterrupted run would
        have seen next.

        use_native: decode with the native C++ batch decoder (True) or PIL
        (False); None takes the native one when it builds and the index's
        images are JPEG.
        """
        if batch_size % process_count != 0:
            raise ValueError(f"batch_size {batch_size} does not divide over {process_count} "
                             "processes")
        if process_count > 1:
            # a ragged final batch would give processes misaligned slices
            drop_last = True
        if bucket_fs is not None and (tuple(sorted(bucket_fs)) != tuple(bucket_fs)
                                      or bucket_fs[-1] != stage.F):
            raise ValueError(f"bucket_fs {bucket_fs} must ascend to the stage's F={stage.F}")
        self.bucket_fs = tuple(bucket_fs) if bucket_fs else None
        self.index = index
        self.stage = stage
        self.batch_size = batch_size
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = batch_size // process_count
        self.height = height
        self.width = width
        self.trimin = trimin
        self.use_stereo = use_stereo
        self.classic = classic
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.skip_batches = skip_batches
        # the native decoder is JPEG-only: PNG datasets (--data.png) take PIL
        jpeg = getattr(index, "img_ext", ".jpg") == ".jpg"
        self.use_native = (native_available() and jpeg) if use_native is None else use_native
        self.F = stage.F
        self._K, _ = kitti.intrinsics(width, height)

    def __len__(self) -> int:
        n = len(self.index)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _local_slice(self, order: np.ndarray, bi: int):
        """This process's (sample_indices, rng_seeds) slice of global batch
        bi. Seeds are drawn at global batch size on every process so the
        realized augmentation stream is process-count invariant."""
        base = bi * self.batch_size
        gidxs = order[base : base + self.batch_size]
        seeds = self.rng.integers(0, 2**63, size=self.batch_size)
        lo = self.process_index * self.local_batch
        hi = lo + self.local_batch
        return gidxs[lo:hi], seeds[lo:hi]

    # ---------------------------------------------------------------- plan
    def _plan_sample(self, sample_idx: int, rng: np.random.Generator):
        """Curriculum + augmentation decisions and the frame->path map for
        one sample (no pixel IO)."""
        s = self.index.samples[sample_idx]
        F = self.F
        NF = num_frames(F)

        if self.classic:
            f = 1
        else:
            f = sample_f_max(
                s.baseline,
                self.stage,
                rng,
                exists=lambda o: self.index.exists(s.folder, s.frame_index + o, s.side),
            )
        do_flip = bool(rng.random() > 0.5)

        paths = {F: self.index.image_path(s.folder, s.frame_index, s.side)}
        for o in range(1, f + 1):
            for sign in (1, -1):
                paths[F + sign * o] = self.index.image_path(
                    s.folder, s.frame_index + sign * o, s.side
                )
        if self.use_stereo and (self.classic or f <= 2):
            paths[NF - 1] = self.index.image_path(
                s.folder, s.frame_index, kitti.OTHER_SIDE[s.side]
            )

        stereo_T = np.eye(4, dtype=np.float32)
        baseline_sign = -1 if do_flip else 1
        side_sign = -1 if s.side == "l" else 1
        stereo_T[0, 3] = side_sign * baseline_sign * 0.1

        jit = np.ones((NF, 4), dtype=np.float32)
        jit[:, 3] = 0.0
        if rng.random() > 0.5:
            jit[:, :3] = rng.uniform(0.8, 1.2, size=(NF, 3))
            jit[:, 3] = rng.uniform(-0.1, 0.1, size=NF)
        return paths, f, stereo_T, do_flip, jit

    # ------------------------------------------------------------- decode
    def _decode(self, flat_paths: List[str]) -> List[np.ndarray]:
        """Decode+resize a path list -> uint8 [H, W, 3] images (the native
        batch decoder when use_native, the PIL thread pool otherwise)."""
        if self.use_native:
            decoded, ok = decode_resize_batch(
                flat_paths, self.width, self.height, threads=self.num_workers
            )
            for pth, good in zip(flat_paths, ok):
                if not good:
                    raise FileNotFoundError(pth)
            return list(decoded)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            return list(
                pool.map(lambda p: load_resized(p, self.width, self.height), flat_paths)
            )

    def _assemble(self, plans, F_c: int) -> Dict[str, np.ndarray]:
        """Decode the planned frames and build a fixed-shape batch with
        frame budget F_c (== self.F unbucketed; a smaller class under
        bucket_fs). Plans are slot-keyed at the STAGE budget; slots are
        rebased onto the F_c axis here."""
        F, NF = self.F, num_frames(self.F)
        NF_c = num_frames(F_c)
        B = len(plans)

        flat_paths, owners = [], []
        for b, (paths, f, *_rest) in enumerate(plans):
            for slot, pth in paths.items():
                off = "s" if slot == NF - 1 else slot - F
                owners.append((b, off))
                flat_paths.append(pth)
        decoded = self._decode(flat_paths)

        frames = np.empty((B, NF_c, self.height, self.width, 3), np.uint8)
        center = {}
        for (b, off), img in zip(owners, decoded):
            if off == "s":
                frames[b, NF_c - 1] = img
            else:
                frames[b, off + F_c] = img
                if off == 0:
                    center[b] = img
        for b, (paths, f, *_rest) in enumerate(plans):
            for o in range(-F_c, F_c + 1):
                if abs(o) > f:
                    frames[b, o + F_c] = center[b]
            if (NF - 1) not in paths:  # no stereo frame planned
                frames[b, NF_c - 1] = center[b]

        f_max = np.array([pl[1] for pl in plans], dtype=np.int64)
        stereo_T = np.stack([pl[2] for pl in plans])
        flip = np.array([pl[3] for pl in plans], dtype=bool)
        # jitter was drawn per stage-slot; rebase rows onto the F_c axis
        jit_full = np.stack([pl[4] for pl in plans])  # [B, NF, 4]
        jitter = np.concatenate(
            [jit_full[:, F - F_c : F + F_c + 1], jit_full[:, NF - 1 :]], axis=1
        )
        K = np.broadcast_to(self._K, (B, 4, 4)).copy()
        return make_batch(
            frames, f_max, K, stereo_T, flip, jitter, F_c,
            self.trimin, self.use_stereo, self.classic,
        )

    # ----------------------------------------------------------------- epoch
    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self.rng.permutation(len(self.index))
        nb = len(self)
        skip = self.skip_batches
        if self.bucket_fs is None:
            for bi in range(nb):
                idxs, seeds = self._local_slice(order, bi)
                if bi < skip:  # rng stream consumed, no planning/decoding
                    continue
                plans = [
                    self._plan_sample(int(i), np.random.default_rng(int(sd)))
                    for i, sd in zip(idxs, seeds)
                ]
                yield self._assemble(plans, self.F)
            return

        # bucketed: plans are drawn in the SAME global order/stream, then
        # grouped by frame-budget class; every process sees the same global
        # queues and assembles only its slice of each filled batch
        queues: Dict[int, list] = {fc: [] for fc in self.bucket_fs}
        lo = self.process_index * self.local_batch
        hi = lo + self.local_batch
        emitted = 0  # batches produced so far incl. skipped (plans must be
        # drawn either way: batch boundaries depend on their window classes)
        for bi in range(nb):
            base = bi * self.batch_size
            gidxs = order[base : base + self.batch_size]
            seeds = self.rng.integers(0, 2**63, size=self.batch_size)
            for i, sd in zip(gidxs, seeds):
                plan = self._plan_sample(int(i), np.random.default_rng(int(sd)))
                fc = next(c for c in self.bucket_fs if plan[1] <= c)
                queues[fc].append(plan)
                if len(queues[fc]) == self.batch_size:
                    batch_plans = queues[fc]
                    queues[fc] = []
                    emitted += 1
                    if emitted > skip:
                        yield self._assemble(batch_plans[lo:hi], fc)
        # per-class leftovers are dropped (generalized drop_last)
        left = {fc: len(q) for fc, q in queues.items() if q}
        if left:
            logging.getLogger(__name__).info(
                "bucketed epoch: %d/%d samples dropped as per-class leftovers "
                "(%.2f%%; per class: %s)",
                sum(left.values()), len(self.index),
                100.0 * sum(left.values()) / max(1, len(self.index)),
                left,
            )

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate with background prefetch (the host's decode of the next
        batches overlaps the device's step)."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []

        def producer():
            try:
                for b in self._batches():
                    q.put(b)
            except BaseException as e:  # noqa: BLE001 -- re-raised in the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item


class EvalLoader:
    """Sequential loader for evaluation: center frame only, no augmentation.

    Mirrors the reference's bs=1 eval loaders (trainer.py:125-130,
    evaluate_depth.py:128-139), batched; callers get (images uint8
    [B, H, W, 3], start index, count) with a final ragged batch padded by
    repeating its last image.
    """

    def __init__(self, paths, height: int, width: int, batch_size: int = 16,
                 num_workers: int = 8):
        self.paths = list(paths)
        self.height = height
        self.width = width
        self.batch_size = batch_size
        self.num_workers = num_workers

    def __len__(self):
        return -(-len(self.paths) // self.batch_size)

    def __iter__(self):
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for bi in range(len(self)):
                chunk = self.paths[bi * self.batch_size : (bi + 1) * self.batch_size]
                imgs = list(pool.map(lambda p: load_resized(p, self.width, self.height), chunk))
                count = len(imgs)
                while len(imgs) < self.batch_size:
                    imgs.append(imgs[-1])
                yield np.stack(imgs), bi * self.batch_size, count
