"""Resizing and sub-pixel cropping. Port of ``kbe_tpu/ops/resize.py``.

``resize_bilinear`` reproduces ``jax.image.resize(method='bilinear',
antialias=False)`` rather than ``F.interpolate(align_corners=False)``: the
JAX kernel renormalises the triangle weights of taps that fall outside the
image, where ``F.interpolate`` clamps the sample position. The two agree at
a 2x up- or downscale and differ in rounding at other scales, so the weights
here are computed with JAX's f32 arithmetic: sample position
``(i + 0.5) * f32(in/out) - 0.5``, weights ``max(0, 1 - |s - j|)``
divided by their in-image sum, zero where ``s`` lies outside
``[-0.5, n - 0.5]``. Each output takes two taps, so a gather of two rows
replaces JAX's dense weight-matrix product.

``resize_bilinear_antialias`` is ``jax.image.resize(method='bilinear')``
with its default antialias: on a downsampled axis the triangle is widened
by the downscale, so an output takes many taps, and it applies JAX's dense
weight matrix; an upsampled axis takes the two taps above (there antialias
changes nothing). ``resize_nearest`` is ``jax.image.resize(method=
'nearest')`` as XLA computes it: XLA folds the scale into ``s = f32(m *
f32(1 / n))`` and takes ``floor((i + 0.5) * s)``, which at 378 -> 189
picks rows 0, 2, 4, ... where ``floor((i + 0.5) * m / n)`` picks 1, 3, 5.
"""

from __future__ import annotations

import numpy as np
import torch


def _axis_taps(n_in: int, n_out: int, device):
    """(lo, hi, w_lo, w_hi) for one resized axis, JAX's f32 arithmetic."""
    inv_scale = torch.full((), np.float32(1.0 / (n_out / n_in)),
                           device=device)
    s = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    lo = torch.floor(s)
    hi = lo + 1.0

    def weight(j):
        w = torch.clamp(1.0 - torch.abs(s - j), min=0.0)
        return torch.where((j >= 0) & (j <= n_in - 1), w, torch.zeros_like(w))

    w_lo, w_hi = weight(lo), weight(hi)
    total = w_lo + w_hi
    keep = torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    safe = torch.where(total != 0, total, torch.ones_like(total))
    inside = (s >= -0.5) & (s <= n_in - 0.5)
    w_lo = torch.where(keep & inside, w_lo / safe, torch.zeros_like(w_lo))
    w_hi = torch.where(keep & inside, w_hi / safe, torch.zeros_like(w_hi))
    lo_i = lo.clamp(0, n_in - 1).to(torch.long)
    hi_i = hi.clamp(0, n_in - 1).to(torch.long)
    return lo_i, hi_i, w_lo, w_hi


def _two_taps(x: torch.Tensor, axis: int, lo, hi, w_lo,
              w_hi) -> torch.Tensor:
    """``x[lo] * w_lo + x[hi] * w_hi`` along ``axis``."""
    shape = [1] * x.ndim
    shape[axis] = lo.shape[0]
    a = torch.index_select(x, axis, lo)
    b = torch.index_select(x, axis, hi)
    return a * w_lo.reshape(shape) + b * w_hi.reshape(shape)


def _resize_axis(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    n_in = x.shape[axis]
    if n_in == n_out:
        return x
    return _two_taps(x, axis, *_axis_taps(n_in, n_out, x.device))


def resize_bilinear(image: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """Bilinear resize at half-pixel centers, no antialias.
    ``image``: (..., H, W, C); computes in f32, returns ``image.dtype``."""
    x = image.to(torch.float32)
    x = _resize_axis(x, height, x.ndim - 3)
    x = _resize_axis(x, width, x.ndim - 2)
    return x.to(image.dtype)


def _antialias_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of a downsampled axis, as JAX's
    ``compute_weight_mat`` computes them in f32."""
    inv_scale = torch.full((), np.float32(1.0 / (n_out / n_in)),
                           device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    x = torch.div(torch.abs(sample[None, :] - src[:, None]), kernel_scale)
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    keep = torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(keep, torch.div(weights, torch.where(
        total != 0, total, torch.ones_like(total))), torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_bilinear_antialias(image: torch.Tensor, height: int,
                              width: int) -> torch.Tensor:
    """``jax.image.resize(image, ..., 'bilinear')`` (antialias on).
    ``image``: (..., H, W, C); computes in f32, returns ``image.dtype``."""
    x = image.to(torch.float32)
    for axis, n_out in ((x.ndim - 3, height), (x.ndim - 2, width)):
        n_in = x.shape[axis]
        if n_out < n_in:
            wmat = _antialias_weights(n_in, n_out, x.device)
            x = torch.movedim(torch.tensordot(
                torch.movedim(x, axis, -1), wmat, dims=1), -1, axis)
        else:
            x = _resize_axis(x, n_out, axis)
    return x.to(image.dtype)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    scale = np.float32(n_in) * np.float32(np.float32(1.0) / np.float32(n_out))
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * torch.full((), scale, device=device)
    return torch.floor(pos).to(torch.long).clamp(0, n_in - 1)


def resize_nearest(x: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(x, shape, 'nearest')``: every axis whose size
    differs from ``shape``'s takes the nearest source index."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} for a {x.ndim}-d input")
    for axis, n_out in enumerate(shape):
        if x.shape[axis] != n_out:
            x = torch.index_select(x, axis, _nearest_index(
                x.shape[axis], n_out, x.device))
    return x


def resize_to_max(image: torch.Tensor, max_size: int) -> torch.Tensor:
    """Aspect-preserving resize so the longer side is ``max_size``
    (``min(int(max_size * ratio), max_size)`` as the reference computes)."""
    h, w = image.shape[-3], image.shape[-2]
    ratio = float(w) / float(h)
    new_w = min(int(max_size * ratio), max_size)
    new_h = min(int(max_size / ratio), max_size)
    return resize_bilinear(image, new_h, new_w)


def _interp_axis(image: torch.Tensor, coords: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """Linear interpolation along ``axis`` at ``coords``, borders clamped."""
    n = image.shape[axis]
    i0 = torch.floor(coords)
    frac = coords - i0
    lo = torch.clamp(i0.to(torch.long), 0, n - 1)
    hi = torch.clamp(i0.to(torch.long) + 1, 0, n - 1)
    return _two_taps(image, axis, lo, hi, 1.0 - frac, frac)


def crop_rect_subpix(image: torch.Tensor, patch_width: int,
                     patch_height: int, center_u, center_v) -> torch.Tensor:
    """cv2.getRectSubPix: bilinear patch at ``center - (patch - 1)/2 + i``,
    borders replicated. ``image``: (H, W, C) -> (patch_height, patch_width,
    C). Computes what ``kbe_tpu``'s ``crop_rect_subpix_mm`` computes with
    two banded matrix products."""
    dev = image.device
    xs = (torch.arange(patch_width, dtype=torch.float32, device=dev)
          + center_u - (patch_width - 1) / 2.0)
    ys = (torch.arange(patch_height, dtype=torch.float32, device=dev)
          + center_v - (patch_height - 1) / 2.0)
    out = _interp_axis(image, ys, axis=0)
    return _interp_axis(out, xs, axis=1)
