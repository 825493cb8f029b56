"""Auto-zoom: search the start-window shift that maximises render coverage.

Port of ``kbe_tpu/pipeline/autozoom.py``: a ``grid`` x ``grid`` lattice of
candidate (shiftU, shiftV) offsets is scored by the number of covered
pixels after splatting the raw cloud at that shift; out-of-bounds
candidates score -1, and the first of equal best scores wins.

The cloud is laid out once and every candidate's shift travels in the
renderer's pose, so each candidate costs the three splat launches and no
copy of the cloud. The shift is a plain add here, as in the JAX function,
without ``apply_shift``'s perspective rescale.
"""

from __future__ import annotations

import numpy as np
import torch

from kbe_torch.config import CameraConfig, ZoomWindow
from kbe_torch.ops.geometry import solve_shift
from kbe_torch.ops.splat import make_pose, splat


def candidate_shifts(window: ZoomWindow, zoom_factor: float,
                     shift_range: float, anchor, height: int, width: int,
                     camera: CameraConfig, grid: int, device):
    """The lattice of candidates: ``(su, sv, ok, cam_shifts)``.

    ``su``, ``sv`` (grid*grid,) f32 numpy pixel offsets of the window's
    centre; ``ok`` (grid*grid,) numpy bool, false where the end window
    would leave the image; ``cam_shifts`` (grid*grid, 3) f32 tensor on
    ``device``, the camera shift that realises each candidate."""
    crop_w = window.crop_width / zoom_factor
    crop_h = window.crop_height / zoom_factor
    dmin, du, dv = anchor
    depth_to = dmin * (crop_w / window.crop_width)

    shifts = np.linspace(-shift_range, shift_range, grid, dtype=np.float32)
    su, sv = np.meshgrid(shifts, shifts, indexing="xy")
    su, sv = su.reshape(-1), sv.reshape(-1)
    ok = ((window.center_u + su >= crop_w / 2.0)
          & (window.center_u + su <= width - crop_w / 2.0)
          & (window.center_v + sv >= crop_h / 2.0)
          & (window.center_v + sv <= height - crop_h / 2.0))
    cam_shifts = solve_shift(torch.as_tensor(su, device=device),
                             torch.as_tensor(sv, device=device), dmin,
                             depth_to, dmin, du, dv, width, height,
                             camera.focal)
    return su, sv, ok, cam_shifts


def flat_cloud(points: torch.Tensor, image: torch.Tensor):
    """The raw cloud as the splat takes it: contiguous f32 ``(N, 3)``
    points and ``(N, C)`` payload. Every point is valid: the splat reads no
    mask."""
    xyz = points.reshape(-1, 3).float().contiguous()
    payload = image.reshape(-1, image.shape[-1]).float().contiguous()
    return xyz, payload


@torch.inference_mode()
def autozoom(points: torch.Tensor, image: torch.Tensor, window: ZoomWindow,
             zoom_factor: float, shift_range: float, anchor,
             camera: CameraConfig = CameraConfig(),
             grid: int = 16) -> ZoomWindow:
    """Find the best end window for a ``zoom_factor`` move.

    ``points`` (1, H*W, 3) raw cloud and ``image`` (1, H, W, 3), on one
    device; ``window`` the start window; ``shift_range`` the +- search
    extent in pixels; ``anchor`` = (min_depth, min_u, min_v) from
    ``depth_range``. Returns the chosen end ``ZoomWindow``.
    """
    h, w = image.shape[1], image.shape[2]
    dev = points.device
    su, sv, ok, cam_shifts = candidate_shifts(
        window, zoom_factor, shift_range, anchor, h, w, camera, grid, dev)
    xyz, payload = flat_cloud(points, image)
    scores = []
    for i in range(cam_shifts.shape[0]):
        pose = make_pose(cam_shifts[i], camera.focal, camera.baseline)
        _, existing = splat(xyz, payload, None, pose, h, w)
        scores.append((existing > 0.0).float().sum())
    scores = torch.where(torch.as_tensor(ok, device=dev),
                         torch.stack(scores), -1.0)
    # the first of equal maxima, as jnp.argmax (torch.argmax does not
    # promise it on every backend)
    pos = torch.arange(scores.numel(), device=dev)
    best = int(torch.where(scores == scores.max(), pos,
                           scores.numel()).min())

    return ZoomWindow(
        center_u=window.center_u + float(su[best]),
        center_v=window.center_v + float(sv[best]),
        crop_width=int(round(window.crop_width / zoom_factor)),
        crop_height=int(round(window.crop_height / zoom_factor)),
    )
