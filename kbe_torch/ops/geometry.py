"""Camera geometry: unprojection, projection, shift solving, depth ranges.

Port of ``kbe_tpu/ops/geometry.py``. Every function keeps the JAX
evaluation order, since the projected coordinates feed ``floor()`` in the
splat and a contracted or re-associated expression flips corners:

  - ``project_points`` evaluates ``x * f / z + (0.5 * w) - 0.5`` left to
    right, one rounding per op;
  - ``apply_shift`` keeps the ``z / (z + 1e-7)`` pre-scale before the add.

Conventions: images are NHWC float32; depth maps are (B, H, W); point clouds
are stacked (..., 3).
"""

from __future__ import annotations

from typing import Tuple

import torch


def true_div(a, b):
    """``a / b`` with IEEE division on every backend.

    PyTorch divides ``scalar / tensor`` as ``scalar * reciprocal(tensor)``,
    and on CUDA ``tensor / python_scalar`` as a multiply by the scalar's
    reciprocal: both round twice and miss JAX's quotient by an ulp, which
    moves splat corners. A Python number here becomes a 0-d tensor filled on
    the other operand's device first (not copied from the host: on the card
    such a copy waits for the stream)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=torch.float32, device=b.device)
    elif not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=torch.float32, device=a.device)
    return torch.div(a, b)


def pixel_rays(height: int, width: int, focal,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (x/z, y/z) ray directions of a centered pinhole camera."""
    xs = true_div(torch.arange(width, dtype=torch.float32, device=device)
                  - (0.5 * width) + 0.5, focal)
    ys = true_div(torch.arange(height, dtype=torch.float32, device=device)
                  - (0.5 * height) + 0.5, focal)
    return (xs[None, :].expand(height, width),
            ys[:, None].expand(height, width))


def depth_to_points(depth: torch.Tensor, focal) -> torch.Tensor:
    """(..., H, W) depth -> (..., H, W, 3) camera-space points."""
    h, w = depth.shape[-2], depth.shape[-1]
    rx, ry = pixel_rays(h, w, focal, depth.device)
    return torch.stack([depth * rx, depth * ry, depth], dim=-1)


def disparity_to_depth(disparity: torch.Tensor, focal,
                       baseline) -> torch.Tensor:
    """depth = focal * baseline / (disparity + 1e-7)."""
    return true_div(focal * baseline, disparity + 1e-7)


def project_points(xyz: torch.Tensor, height: int, width: int, focal):
    """Pinhole projection; returns ``(u, v, ok)`` with ok = z >= 0.001."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    ok = z >= 0.001
    safe_z = torch.where(ok, z, torch.ones_like(z))
    u = true_div(x * focal, safe_z) + (0.5 * width) - 0.5
    v = true_div(y * focal, safe_z) + (0.5 * height) - 0.5
    return u, v, ok


def splat_error(z: torch.Tensor, focal, baseline) -> torch.Tensor:
    """The z-buffer key 1e6 - focal*baseline/(z + 1e-7) (smaller = closer)."""
    return 1000000.0 - true_div(focal * baseline, z + 1e-7)


def depth_range(depth: torch.Tensor, margin: int = 128):
    """First minimum of the center-cropped depth map and its (u, v) in
    CROPPED coordinates, as the reference's cv2.minMaxLoc call used it.

    ``depth``: (H, W). Returns (min_depth, min_u, min_v) as f32 0-d tensors.
    """
    margin = min(margin, (depth.shape[0] - 1) // 2, (depth.shape[1] - 1) // 2)
    cropped = depth[margin:-margin, margin:-margin] if margin > 0 else depth
    flat = cropped.reshape(-1)
    # the first minimum in row-major order, as jnp.argmin (torch.argmin
    # does not promise the first of equal minima on every backend)
    pos = torch.arange(flat.numel(), device=flat.device)
    idx = torch.where(flat == flat.min(), pos, flat.numel()).min()
    w = cropped.shape[1]
    return (flat[idx], (idx % w).to(torch.float32),
            (idx // w).to(torch.float32))


def solve_shift(shift_u, shift_v, depth_from, depth_to, closest_depth,
                closest_u, closest_v, width: int, height: int,
                focal) -> torch.Tensor:
    """Screen-space shift of the anchor pixel -> metric camera translation
    (3,) f32 (reference process_shift); (T,) shifts or depths give (T, 3)."""
    closest = closest_depth + (depth_to - depth_from)
    to_u = closest_u + shift_u
    to_v = closest_v + shift_v
    from_x = true_div((closest_u - (width / 2.0)) * closest, focal)
    from_y = true_div((closest_v - (height / 2.0)) * closest, focal)
    to_x = true_div((to_u - (width / 2.0)) * closest, focal)
    to_y = true_div((to_v - (height / 2.0)) * closest, focal)
    dz = depth_to - depth_from
    parts = [torch.as_tensor(v, dtype=torch.float32)
             for v in (from_x - to_x, from_y - to_y, dz)]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def apply_shift(xyz: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``xyz * [z/(z+1e-7), z/(z+1e-7), 1] + shift`` (the reference's
    perspective rescale, kept for exactness)."""
    z = xyz[..., 2:3]
    scale = true_div(z, z + 1e-7)
    scaled = torch.cat([xyz[..., 0:2] * scale, z], dim=-1)
    return scaled + shift


def interpolate_window(src, dst, step):
    """Linear interpolation of crop windows at ``step`` in [0, 1]."""
    t_from = 1.0 - step
    t_to = step
    cu = t_from * src.center_u + t_to * dst.center_u
    cv = t_from * src.center_v + t_to * dst.center_v
    cw = t_from * src.crop_width + t_to * dst.crop_width
    ch = t_from * src.crop_height + t_to * dst.crop_height
    return cu, cv, cw, ch
