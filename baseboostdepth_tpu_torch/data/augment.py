"""Device-side photometric augmentation (color jitter) and flips, the
counterpart of `baseboostdepth_tpu/data/augment.py`.

The host ships one uint8 frame stack plus a [B, NF, 4] parameter tensor and
the device derives the augmented frames. Formulas follow
torchvision.transforms.functional (blend-with-mean contrast, blend-with-gray
saturation, HSV hue rotation) in the fixed order brightness -> contrast ->
saturation -> hue (reference mono_dataset.py:124-128).
"""

from __future__ import annotations

import numpy as np
import torch

from baseboostdepth_tpu_torch.ops import clip

# ITU-R 601 luma weights (torchvision rgb_to_grayscale).
_LUMA = (0.299, 0.587, 0.114)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB in [0, 1] -> HSV in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.amax(rgb, dim=-1)
    minc = torch.amin(rgb, dim=-1)
    v = maxc
    delta = maxc - minc
    zero = rgb.new_tensor(0.0)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)

    safe = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)[..., None]

    choices = [
        torch.stack([v, t, p], -1),
        torch.stack([q, v, p], -1),
        torch.stack([p, v, t], -1),
        torch.stack([p, q, v], -1),
        torch.stack([t, p, v], -1),
        torch.stack([v, p, q], -1),
    ]
    rgb = torch.zeros_like(choices[0])  # jnp.select's default
    for k in range(5, -1, -1):
        rgb = torch.where(i == k, choices[k], rgb)
    return rgb


def color_jitter(img: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Apply (brightness, contrast, saturation, hue) jitter.

    img [..., H, W, 3] float in [0, 1]; params [..., 4]: multiplicative
    (b, c, s) around 1.0 and hue shift h. (1, 1, 1, 0) is identity.
    """
    params = params.to(img.dtype)
    b = params[..., 0][..., None, None, None]
    c = params[..., 1][..., None, None, None]
    s = params[..., 2][..., None, None, None]
    h = params[..., 3][..., None, None]
    luma = img.new_tensor(_LUMA)

    x = clip(img * b, 0.0, 1.0)
    gray = (x * luma).sum(-1, keepdim=True)
    mean_gray = torch.mean(gray, dim=(-3, -2), keepdim=True)
    x = clip(x * c + mean_gray * (1.0 - c), 0.0, 1.0)
    x = clip(x * s + gray * (1.0 - s), 0.0, 1.0)

    hsv = rgb_to_hsv(x)
    hsv = torch.cat([torch.remainder(hsv[..., :1] + h[..., None], 1.0), hsv[..., 1:]], -1)
    return clip(hsv_to_rgb(hsv), 0.0, 1.0)


def sample_jitter_params(rng: np.random.Generator, batch: int, num_frames: int) -> np.ndarray:
    """Host-side draw of per-(sample, frame) jitter params, identity with
    p=0.5 per sample (reference mono_dataset.py:77,124-128)."""
    p = np.ones((batch, num_frames, 4), dtype=np.float32)
    p[..., 3] = 0.0
    do_aug = rng.random(batch) > 0.5
    bcs = rng.uniform(0.8, 1.2, size=(batch, num_frames, 3)).astype(np.float32)
    hue = rng.uniform(-0.1, 0.1, size=(batch, num_frames)).astype(np.float32)
    p[do_aug, :, :3] = bcs[do_aug]
    p[do_aug, :, 3] = hue[do_aug]
    return p


def apply_flip(frames: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Per-sample horizontal flip: frames [B, ..., H, W, C], flip [B] bool."""
    extra = frames.ndim - 1
    return torch.where(flip.reshape((-1,) + (1,) * extra), frames.flip(-2), frames)
