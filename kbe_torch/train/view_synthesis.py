"""Training-time novel-view synthesis: per-item camera shifts, visibility
masks and warped renders. Port of ``kbe_tpu/train/view_synthesis.py``;
the batch is looped, as ``render_pointcloud`` loops it, where JAX vmaps.

``zoom`` is a dict of (B,) f32 tensors: 'from_cu', 'from_cv', 'from_cw',
'from_ch', 'to_cu', 'to_cv', 'to_cw', 'to_ch' (the random crop windows of
``kbe_torch.train.data.get_random_zoom``). Images are NHWC.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from kbe_torch.config import CameraConfig
from kbe_torch.ops.filters import validity_mask
from kbe_torch.ops.geometry import (depth_range, depth_to_points,
                                    solve_shift, true_div)
from kbe_torch.ops.splat import render_pointcloud
from kbe_torch.ops.visibility import generate_mask


def batch_full_shift(zoom: Dict[str, torch.Tensor], depth: torch.Tensor,
                     camera: CameraConfig, margin: int = 128) -> torch.Tensor:
    """The full-step (step = 1) camera shift of each item: (B, 3).
    ``depth``: (B, H, W, 1)."""
    h, w = depth.shape[1], depth.shape[2]
    shifts = []
    for b in range(depth.shape[0]):
        dmin, du, dv = depth_range(depth[b, ..., 0], margin)
        fcw, tcw = zoom["from_cw"][b], zoom["to_cw"][b]
        # step = 1: the interpolated window is the 'to' window
        depth_to = dmin * true_div(tcw, torch.maximum(fcw, tcw))
        shifts.append(solve_shift(zoom["to_cu"][b] - w / 2.0,
                                  zoom["to_cv"][b] - h / 2.0, dmin, depth_to,
                                  dmin, du, dv, w, h, camera.focal))
    return torch.stack(shifts)


def _valid_points(disparity, depth, camera: CameraConfig, threshold: float):
    """The pixel-grid cloud (B, H*W, 3), points at depth discontinuities
    zeroed."""
    b, h, w = disparity.shape[0], disparity.shape[1], disparity.shape[2]
    valid = validity_mask(disparity, threshold)
    pts = depth_to_points((depth * valid)[..., 0], camera.focal)
    return pts.reshape(b, h * w, 3)


def masks_a_from_b(image, disparity, depth, zoom, camera: CameraConfig,
                   validity_threshold: float = 0.03):
    """Per-pixel visibility of view A as seen from view B. Returns (masks
    (B, H, W, 1), shift (B, 3))."""
    h, w = image.shape[1], image.shape[2]
    shift = batch_full_shift(zoom, depth, camera)
    pts = _valid_points(disparity, depth, camera, validity_threshold)
    masks = generate_mask(pts, shift, h, w, camera.focal, camera.baseline)
    return masks, shift


def render_view_b(image, disparity, depth, zoom, camera: CameraConfig,
                  context: Optional[torch.Tensor] = None,
                  validity_threshold: float = 0.03):
    """Warp view A to view B by splatting ``image``, ``disparity`` and
    ``context`` (which may be normalised). Differentiable with respect to
    the payload. Returns (render (B, H, W, C), masks (B, H, W, 1), points
    (B, H*W, 3), shift (B, 3))."""
    b, h, w = image.shape[0], image.shape[1], image.shape[2]
    shift = batch_full_shift(zoom, depth, camera)
    pts = _valid_points(disparity, depth, camera, validity_threshold)
    payload = [image.reshape(b, h * w, 3), disparity.reshape(b, h * w, 1)]
    if context is not None:
        payload.append(context.reshape(b, h * w, -1))
    data = torch.cat(payload, dim=-1)
    render, weight = render_pointcloud(pts + shift[:, None, :], data, h, w,
                                       camera.focal, camera.baseline)
    masks = (weight > 0.0).to(torch.float32)
    return render, masks, pts, shift
