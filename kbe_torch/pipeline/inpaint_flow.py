"""The point-cloud inpainting flow around the Inpaint net.

Port of ``kbe_tpu/pipeline/inpaint_flow.py::pointcloud_inpainting`` with a
single inpainting net: render the shifted cloud with a 68-channel payload
(normalized image 3 + disparity 1 + context 64), median-filter the coverage
mask, inpaint, then unproject the result and un-shift it into the cloud's
frame. The splat is ``kbe_torch.ops.splat.render_pointcloud``: the CUDA
kernels on the card, which never drop a point, so the flow is held to the
JAX scatter spec (``splat_method='scatter'``). ``kbe_tpu``'s ``relayout``
works around a TPU layout issue and has no counterpart here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from kbe_torch.config import CameraConfig
from kbe_torch.models.layers import denormalize_sample, normalize_sample
from kbe_torch.ops.filters import median_filter_binary, validity_mask
from kbe_torch.ops.geometry import depth_to_points, disparity_to_depth
from kbe_torch.ops.splat import render_pointcloud


class InpaintModels(NamedTuple):
    """``context``: (image_n, disp_n) -> (B, H, W, 64);
    ``net``: (data68, masks) -> (image_n, disparity_n)."""

    context: Callable
    net: Callable


def pointcloud_inpainting(models: InpaintModels, image: torch.Tensor,
                          disparity: torch.Tensor, shift: torch.Tensor,
                          camera: CameraConfig, focal,
                          validity_threshold: float = 0.03):
    """Inpaint the disocclusions revealed by ``shift``.

    ``image`` (1, H, W, 3) in [0, 1], ``disparity`` (1, H, W, 1), ``shift``
    (3,). Returns a dict of (1, H, W, ...) tensors ``image``,
    ``disparity``, ``depth``, ``existing`` and ``points`` (1, H*W, 3).
    """
    h, w = image.shape[1], image.shape[2]
    depth = disparity_to_depth(disparity, focal, camera.baseline)
    valid = validity_mask(disparity, validity_threshold)
    points = depth_to_points((depth * valid)[..., 0], focal)
    points = points.reshape(1, h * w, 3)

    image_n, img_stats = normalize_sample(image)
    disp_n, disp_stats = normalize_sample(disparity)

    context = models.context(image_n, disp_n)
    payload = torch.cat([image_n, disp_n, context], dim=-1)
    render, weight = render_pointcloud(
        points + shift, payload.reshape(1, h * w, -1), h, w, focal,
        camera.baseline)
    existing = (weight > 0.0).float()
    existing = existing * median_filter_binary(existing, 5)
    render = render * existing

    img_n, dsp_n = models.net(render, existing)
    out_image = torch.clamp(denormalize_sample(img_n, img_stats), 0.0, 1.0)
    out_disparity = torch.clamp(denormalize_sample(dsp_n, disp_stats),
                                min=0.0)

    out_depth = disparity_to_depth(out_disparity, focal, camera.baseline)
    out_valid = validity_mask(out_disparity, validity_threshold)
    out_points = depth_to_points((out_depth * out_valid)[..., 0], focal)
    out_points = out_points.reshape(1, h * w, 3) - shift
    return {
        "image": out_image,
        "disparity": out_disparity,
        "depth": out_depth,
        "existing": existing,
        "points": out_points,
    }
