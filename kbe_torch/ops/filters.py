"""Spatial filters: the reference's laplacian validity filter and median
filters. Port of ``kbe_tpu/ops/filters.py``; layout is NHWC."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# The reference's asymmetric 3x3 stencil (not a standard Laplacian).
_LAPLACIAN_3X3 = ((0.0, -1.0, -1.0),
                  (-1.0, 4.0, 0.0),
                  (-1.0, 0.0, 0.0))


def laplacian_filter(x: torch.Tensor) -> torch.Tensor:
    """Edge-padded 'laplacian' filter. ``x``: (B, H, W, C) -> same shape.

    The stencil is summed tap by tap in row-major order with plain
    elementwise ops rather than a convolution, so the CPU and the card give
    the same bits (a cuDNN depthwise convolution picks its own order)."""
    h, w = x.shape[1], x.shape[2]
    padded = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                   mode="replicate").permute(0, 2, 3, 1)
    out = None
    for ky, row in enumerate(_LAPLACIAN_3X3):
        for kx, k in enumerate(row):
            if k == 0.0:
                continue
            tap = padded[:, ky:ky + h, kx:kx + w, :] * k
            out = tap if out is None else out + tap
    return out


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    nchw = x.permute(0, 3, 1, 2)
    return F.pad(nchw, (pad, pad, pad, pad), mode="reflect")


def median_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Reflect-padded size x size median filter (middle order statistic).
    ``x``: (B, H, W, C) -> same shape."""
    if size % 2 != 1:
        raise ValueError("median_filter size must be odd")
    pad = size // 2
    b, h, w, c = x.shape
    padded = _reflect_pad(x, pad)
    taps = torch.stack([padded[:, :, dy:dy + h, dx:dx + w]
                        for dy in range(size) for dx in range(size)], dim=-1)
    med = torch.sort(taps, dim=-1).values[..., (size * size - 1) // 2]
    return med.permute(0, 2, 3, 1)


def median_filter_binary(x: torch.Tensor, size: int) -> torch.Tensor:
    """``median_filter`` for inputs that are exactly 0.0 or 1.0: the median
    is the majority vote, a reflect-padded box sum (exact in f32)."""
    if size % 2 != 1:
        raise ValueError("median_filter_binary size must be odd")
    pad = size // 2
    b, h, w, c = x.shape
    padded = _reflect_pad(x, pad)
    rows = torch.zeros((b, c, h, w + 2 * pad), dtype=x.dtype,
                       device=x.device)
    for dy in range(size):
        rows = rows + padded[:, :, dy:dy + h, :]
    total = torch.zeros((b, c, h, w), dtype=x.dtype, device=x.device)
    for dx in range(size):
        total = total + rows[:, :, :, dx:dx + w]
    majority = (size * size) // 2 + 0.5
    return (total > majority).to(x.dtype).permute(0, 2, 3, 1)


def spatial_filter(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The reference's string-typed filter entry point
    (``utils/common.py:394``): 'laplacian', 'median-3' or 'median-5'."""
    if kind == "laplacian":
        return laplacian_filter(x)
    if kind == "median-3":
        return median_filter(x, 3)
    if kind == "median-5":
        return median_filter(x, 5)
    raise ValueError(f"unknown spatial filter {kind!r}")


def validity_mask(disparity: torch.Tensor,
                  threshold: float = 0.03) -> torch.Tensor:
    """``|laplacian(disp / disp.max())| < threshold`` as float.
    ``disparity``: (B, H, W, 1) -> same shape, values in {0.0, 1.0}."""
    peak = torch.amax(disparity, dim=(1, 2, 3), keepdim=True)
    lap = laplacian_filter(disparity / peak)
    return (torch.abs(lap) < threshold).to(disparity.dtype)
