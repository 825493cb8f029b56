"""The point-cloud inpainting flow around the Inpaint net.

Port of ``kbe_tpu/pipeline/inpaint_flow.py``: render the shifted cloud with
a 68-channel payload (normalized image 3 + disparity 1 + context 64),
median-filter the coverage mask, inpaint, then unproject the result and
un-shift it into the cloud's frame. ``splat_method`` names the renderer as
in the JAX package: ``'scatter'`` is the spec, the plain passes on every
device, as JAX's XLA scatter runs no kernel; ``'banded'`` and ``'routed'``
are entry points that run the same kernels on CUDA tensors, which never
drop a point. All of them compute the same splat.
``kbe_tpu``'s ``relayout_context`` works around a TPU layout issue and has
no counterpart here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from kbe_torch.config import CameraConfig
from kbe_torch.models.layers import denormalize_sample, normalize_sample
from kbe_torch.ops.filters import median_filter_binary, validity_mask
from kbe_torch.ops.geometry import depth_to_points, disparity_to_depth
from kbe_torch.ops.splat import render_pointcloud_plain
from kbe_torch.ops.splat_banded import render_grids_fast_banded
from kbe_torch.ops.splat_routed import render_grids_fast

SPLAT_METHODS = ("scatter", "banded", "routed")


class InpaintModels(NamedTuple):
    """``context``: (image_n, disp_n) -> (B, H, W, 64);
    ``net``: (data68, masks) -> (image_n, disparity_n, existing), where
    ``existing`` is the coverage mask the net reports back: the input mask
    for the grid-net, the propagated mask for the partial-conv net;
    ``depth_net``: an optional second net whose disparity replaces the
    first's (the dual-net mode: color from net 1, disparity from net 2);
    ``context_depth``: that net's own context extractor."""

    context: Callable
    net: Callable
    depth_net: Optional[Callable] = None
    context_depth: Optional[Callable] = None


def flow_cloud(disparity: torch.Tensor, camera: CameraConfig, focal,
               validity_threshold: float):
    """(depth (1, H, W, 1), points (1, H*W, 3)): the cloud of a disparity,
    its invalid pixels at depth 0."""
    h, w = disparity.shape[1], disparity.shape[2]
    depth = disparity_to_depth(disparity, focal, camera.baseline)
    valid = validity_mask(disparity, validity_threshold)
    points = depth_to_points((depth * valid)[..., 0], focal)
    return depth, points.reshape(1, h * w, 3)


def render_payload(points: torch.Tensor, shift: torch.Tensor,
                   image_n: torch.Tensor, disp_n: torch.Tensor,
                   context: torch.Tensor, camera: CameraConfig, focal,
                   splat_method: str):
    """The 68-channel splat: the payload (image_n, disp_n, context) of the
    cloud ``points`` (1, H*W, 3) rendered at ``shift``. ``'scatter'`` is
    ``render_pointcloud_plain``, the spec on every device; ``'banded'`` and
    ``'routed'`` the kernels' entry points. Returns (render (1, H, W, 68),
    weight (1, H, W, 1))."""
    h, w = image_n.shape[1], image_n.shape[2]
    payload = torch.cat([image_n, disp_n, context], dim=-1)
    if splat_method == "scatter":
        return render_pointcloud_plain(
            points + shift, payload.reshape(1, h * w, -1), h, w, focal,
            camera.baseline)
    grids = (render_grids_fast_banded if splat_method == "banded"
             else render_grids_fast)
    return grids((points + shift).reshape(1, h, w, 3),
                 payload.reshape(1, h, w, -1), h, w, focal, camera.baseline)


def coverage(render: torch.Tensor, weight: torch.Tensor):
    """(masked render, existing): the splat's coverage, kept where the
    binary median-5 of it agrees."""
    existing = (weight > 0.0).float()
    existing = existing * median_filter_binary(existing, 5)
    return render * existing, existing


def inpaint_net(net, render: torch.Tensor, existing: torch.Tensor,
                img_stats, disp_stats):
    """The net on the masked render, its outputs denormalised: (image in
    [0, 1], disparity >= 0, the net's ``existing``)."""
    img_n, dsp_n, existing_out = net(render, existing)
    img = torch.clamp(denormalize_sample(img_n, img_stats), 0.0, 1.0)
    dsp = torch.clamp(denormalize_sample(dsp_n, disp_stats), min=0.0)
    return img, dsp, existing_out


def pointcloud_inpainting(models: InpaintModels, image: torch.Tensor,
                          disparity: torch.Tensor, shift: torch.Tensor,
                          camera: CameraConfig, focal,
                          validity_threshold: float = 0.03,
                          splat_method: str = "routed"):
    """Inpaint the disocclusions revealed by ``shift``.

    ``image`` (1, H, W, 3) in [0, 1], ``disparity`` (1, H, W, 1), ``shift``
    (3,). ``splat_method``: ``'scatter'`` (``render_pointcloud_plain``, the
    spec, which launches no kernel), ``'banded'``
    (``render_grids_fast_banded``) or ``'routed'`` (``render_grids_fast``).
    Returns a dict of (1, H, W, ...) tensors ``image``, ``disparity``,
    ``depth``, ``existing`` (the net's mask) and ``points`` (1, H*W, 3).
    The pieces it runs, in order, are this module's ``flow_cloud``,
    ``render_payload``, ``coverage`` and ``inpaint_net``.
    """
    if splat_method not in SPLAT_METHODS:
        raise ValueError(f"splat_method must be one of {SPLAT_METHODS}, got "
                         f"{splat_method!r}")
    _, points = flow_cloud(disparity, camera, focal, validity_threshold)
    image_n, img_stats = normalize_sample(image)
    disp_n, disp_stats = normalize_sample(disparity)

    def render_with(context_fn):
        return coverage(*render_payload(
            points, shift, image_n, disp_n, context_fn(image_n, disp_n),
            camera, focal, splat_method))

    out_image, out_disparity, out_existing = inpaint_net(
        models.net, *render_with(models.context), img_stats, disp_stats)
    if models.depth_net is not None:
        # the dual-net mode renders a second payload with the depth net's
        # own context extractor
        context_depth = (models.context if models.context_depth is None
                         else models.context_depth)
        _, out_disparity, _ = inpaint_net(
            models.depth_net, *render_with(context_depth), img_stats,
            disp_stats)

    out_depth, out_points = flow_cloud(out_disparity, camera, focal,
                                       validity_threshold)
    return {
        "image": out_image,
        "disparity": out_disparity,
        "depth": out_depth,
        "existing": out_existing,
        "points": out_points - shift,
    }


def extend_cloud(cloud_xyz, cloud_data, cloud_valid, inpainted):
    """Append the newly revealed (``existing == 0``) inpainted points.

    ``cloud_xyz`` (1, N, 3), ``cloud_data`` (1, N, 5) = rgb + disparity +
    depth, ``cloud_valid`` (1, N); ``inpainted`` is the result of
    ``pointcloud_inpainting``. Each pass adds exactly H*W slots, masked by
    novelty. Returns the extended (xyz, data, valid)."""
    img = inpainted["image"]
    h, w = img.shape[1], img.shape[2]
    novel = (inpainted["existing"].reshape(1, h * w) == 0.0).float()
    data = torch.cat([img.reshape(1, h * w, 3),
                      inpainted["disparity"].reshape(1, h * w, 1),
                      inpainted["depth"].reshape(1, h * w, 1)], dim=-1)
    return (torch.cat([cloud_xyz, inpainted["points"]], dim=1),
            torch.cat([cloud_data, data], dim=1),
            torch.cat([cloud_valid, novel], dim=1))
