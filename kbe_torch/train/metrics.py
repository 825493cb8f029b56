"""Evaluation metrics. Port of ``kbe_tpu/train/metrics.py``:

  compute_depth_metrics    abs rel, sq rel, RMSE, log RMSE, delta < 1.25^k
  psnr                     with the reference's d = 512 disparity peak and
                           its 20*log10(d^2/sqrt(mse)) form
  compute_inpaint_metrics  PSNR of image and disparity, SSIM distance of both
"""

from __future__ import annotations

from typing import Dict

import torch

from kbe_torch.ops.image_ops import ssim_distance

DEPTH_METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "log_rmse", "a1", "a2",
                      "a3")


def compute_depth_metrics(depth, depth_gt, masks) -> Dict[str, torch.Tensor]:
    """(B, H, W, 1) predicted and true depth and binary masks -> the 7
    metrics, means over all pixels after masking both inputs (a masked-out
    pixel counts through the 1e-7), as the reference computes them."""
    d = depth * masks + 1e-7
    g = depth_gt * masks + 1e-7
    thresh = torch.maximum(g / d, d / g)
    return {
        "abs_rel": torch.mean(torch.abs(g - d) / g),
        "sq_rel": torch.mean((g - d) ** 2 / g),
        "rmse": torch.sqrt(torch.mean((g - d) ** 2)),
        "log_rmse": torch.sqrt(torch.mean(
            (torch.log10(g) - torch.log10(d)) ** 2)),
        "a1": torch.mean((thresh < 1.25).float()),
        "a2": torch.mean((thresh < 1.25 ** 2).float()),
        "a3": torch.mean((thresh < 1.25 ** 3).float()),
    }


def psnr(im1, im2, disp: bool = False) -> torch.Tensor:
    """PSNR; ``disp=True`` takes the reference's d = 512 peak."""
    mse = torch.mean((im1 - im2) ** 2)
    d = 512.0 if disp else 1.0
    return 20.0 * torch.log10(d ** 2 / torch.sqrt(mse))


def compute_inpaint_metrics(image_inpaint, disparity_inpaint, image_gt,
                            disparity_gt) -> Dict[str, torch.Tensor]:
    return {
        "psnr_image": psnr(image_inpaint, image_gt),
        "psnr_disparity": psnr(disparity_inpaint, disparity_gt, disp=True),
        "ssim_image": ssim_distance(image_inpaint, image_gt, 11),
        "ssim_disparity": ssim_distance(disparity_inpaint, disparity_gt, 11),
    }
