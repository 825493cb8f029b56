"""Per-point visibility masks of training-time view synthesis. Port of
``kbe_tpu/ops/visibility.py::generate_mask``.

Shift the pixel-grid cloud, z-buffer each point's corner of largest weight,
and mark a point visible iff it wins its pixel: the minimum error, ties to
the smallest point index (two ``scatter_reduce_("amin")`` passes, which
are exact and order-free). The per-point mask, on the image grid, is then
median-5 filtered. JAX computes this in XLA, not in a Pallas kernel, so on
the card it stays plain PyTorch.
"""

from __future__ import annotations

import torch

from kbe_torch.ops.filters import median_filter_binary
from kbe_torch.ops.geometry import project_points, splat_error
from kbe_torch.ops.splat import best_corner_index

_ZFAR = 1000000.0


def _mask_single(xyz, height: int, width: int, focal, baseline):
    u, v, ok = project_points(xyz, height, width, focal)
    err = splat_error(xyz[:, 2], focal, baseline)
    flat = best_corner_index(u, v, height, width, ok)
    n, hw = xyz.shape[0], height * width
    zee = torch.full((hw + 1,), _ZFAR, dtype=torch.float32, device=xyz.device)
    zee.scatter_reduce_(0, flat, err, reduce="amin")
    # a point marks itself only if it reached the buffer's final minimum
    is_min = err <= zee[flat]
    pt = torch.arange(n, device=xyz.device)
    ids = torch.full((hw + 1,), n, dtype=torch.long, device=xyz.device)
    ids.scatter_reduce_(0, torch.where(is_min, flat, hw), pt, reduce="amin")
    return ((ids[flat] == pt) & (flat < hw)).to(torch.float32)


def generate_mask(xyz: torch.Tensor, shift: torch.Tensor, height: int,
                  width: int, focal, baseline) -> torch.Tensor:
    """Visibility mask of the pixel-grid cloud after a camera shift.

    ``xyz``: (B, H*W, 3) unshifted points, one per pixel, row-major;
    ``shift``: (B, 3), added here. Returns the (B, H, W, 1) f32 mask,
    median-5 filtered."""
    shifted = xyz + shift[:, None, :]
    masks = torch.stack([_mask_single(p, height, width, focal, baseline)
                         for p in shifted])
    return median_filter_binary(masks.reshape(-1, height, width, 1), 5)
