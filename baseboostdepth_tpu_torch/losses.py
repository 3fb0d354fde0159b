"""Loss assembly, the counterpart of `baseboostdepth_tpu/losses.py`:
min-reprojection with automasking over a fixed candidate-slot axis, and
edge-aware smoothness.

Every sample carries the same slot axis (see training/batch.py):

    slot 0: +f      slot 1: -f        (f = the sample's max frame offset)
    slot 2: +(f-1)  slot 3: -(f-1)
    slot 4: +(f-2)  slot 5: -(f-2)
    slot 6: stereo

with a [B, S] validity mask; invalid candidates take the value _MASKED, so
the per-pixel min over a static tensor reproduces the reference's ragged
per-sample candidate sets (x_min_opt, trainer.py:983-1100).
"""

from __future__ import annotations

from typing import Optional

import torch

from baseboostdepth_tpu_torch.ops import absolute
from baseboostdepth_tpu_torch.ops.ssim import reprojection_loss

# Masked-out candidates take this value; real losses are <= ~1.
_MASKED = 1e4


def slot_losses(
    target: torch.Tensor,
    images: torch.Tensor,
    slot_valid: torch.Tensor,
    use_ssim: bool = True,
) -> torch.Tensor:
    """Photometric loss of each slot image against the shared target.

    target [B, H, W, 3], images [B, S, H, W, 3], slot_valid [B, S] bool ->
    [B, S, H, W], _MASKED where invalid.
    """
    B, S = images.shape[:2]
    tgt = target[:, None].expand(images.shape)
    flat_pred = images.reshape(B * S, *images.shape[2:])
    flat_tgt = tgt.reshape(B * S, *images.shape[2:])
    pe = reprojection_loss(flat_pred, flat_tgt, use_ssim=use_ssim)[..., 0]
    pe = pe.reshape(B, S, *pe.shape[1:])
    return torch.where(slot_valid[:, :, None, None], pe, pe.new_tensor(_MASKED))


def min_reprojection(
    warp_losses: torch.Tensor,
    ident_losses: torch.Tensor,
    noise: torch.Tensor,
    err_losses: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-pixel min over all candidates -> [B, H, W].

    warp_losses / ident_losses [B, S, H, W]; noise [B, 1, H, W] (already
    scaled by 1e-5) breaks warp-vs-identity ties; err_losses [B, S-1, H, W]
    error-pose candidates (decomp). `amin` splits the gradient evenly among
    tied minima, as JAX's min reduction does.
    """
    cands = [warp_losses, ident_losses + noise]
    if err_losses is not None:
        cands.append(err_losses)
    return torch.amin(torch.cat(cands, dim=1), dim=1)


def smooth_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order disparity smoothness -> scalar
    (reference layers.py:203-216). disp [B, h, w, 1], img [B, h, w, 3]."""
    grad_disp_x = absolute(disp[:, :, :-1, :] - disp[:, :, 1:, :])
    grad_disp_y = absolute(disp[:, :-1, :, :] - disp[:, 1:, :, :])

    grad_img_x = torch.mean(torch.abs(img[:, :, :-1, :] - img[:, :, 1:, :]), -1, keepdim=True)
    grad_img_y = torch.mean(torch.abs(img[:, :-1, :, :] - img[:, 1:, :, :]), -1, keepdim=True)

    grad_disp_x = grad_disp_x * torch.exp(-grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-grad_img_y)
    return torch.mean(grad_disp_x) + torch.mean(grad_disp_y)


def normalized_disp(disp: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """disp / (spatial mean + eps); reference trainer.py:560-562."""
    return disp / (torch.mean(disp, dim=(1, 2), keepdim=True) + eps)
