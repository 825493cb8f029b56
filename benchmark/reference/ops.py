"""The effect's image and geometry operations in plain PyTorch, frozen
copies of the port's ``ops/geometry.py``, ``ops/resize.py``,
``ops/filters.py`` and the plain passes of ``ops/splat.py``, with a fill of
the same function as ``ops/discfill.py::fill_plain`` that marches only
the holes. Nothing is imported from the port.

The arithmetic keeps the port's evaluation order (IEEE quotients through
``true_div``, the splat's projection left to right), so on the CPU the
frames equal the port's plain path bit for bit. The splat's sums run with
PyTorch's deterministic algorithms on: on the card ``index_add_`` then sorts
the entries by pixel and adds each pixel's in ascending entry order, the
CPU's order, instead of with atomics in no fixed order. The bf16 Inpaint
net amplifies a last-bit change of its input into changes of the inpainted
depth, so a reference that summed in no fixed order would part from itself
from run to run.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_ZFAR = 1000000.0


def true_div(a, b):
    """``a / b`` with IEEE division on every backend."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=torch.float32, device=b.device)
    elif not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=torch.float32, device=a.device)
    return torch.div(a, b)


# ------------------------------------------------------------------ geometry

def depth_to_points(depth: torch.Tensor, focal) -> torch.Tensor:
    """(..., H, W) depth -> (..., H, W, 3) camera-space points."""
    h, w = depth.shape[-2], depth.shape[-1]
    dev = depth.device
    xs = true_div(torch.arange(w, dtype=torch.float32, device=dev)
                  - (0.5 * w) + 0.5, focal)
    ys = true_div(torch.arange(h, dtype=torch.float32, device=dev)
                  - (0.5 * h) + 0.5, focal)
    rx = xs[None, :].expand(h, w)
    ry = ys[:, None].expand(h, w)
    return torch.stack([depth * rx, depth * ry, depth], dim=-1)


def disparity_to_depth(disparity, focal, baseline):
    return true_div(focal * baseline, disparity + 1e-7)


def project_points(xyz, height: int, width: int, focal):
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    ok = z >= 0.001
    safe_z = torch.where(ok, z, torch.ones_like(z))
    u = true_div(x * focal, safe_z) + (0.5 * width) - 0.5
    v = true_div(y * focal, safe_z) + (0.5 * height) - 0.5
    return u, v, ok


def depth_range(depth: torch.Tensor, margin: int = 128):
    """First minimum of the center-cropped (H, W) depth and its (u, v) in
    cropped coordinates."""
    margin = min(margin, (depth.shape[0] - 1) // 2, (depth.shape[1] - 1) // 2)
    cropped = depth[margin:-margin, margin:-margin] if margin > 0 else depth
    flat = cropped.reshape(-1)
    pos = torch.arange(flat.numel(), device=flat.device)
    idx = torch.where(flat == flat.min(), pos, flat.numel()).min()
    w = cropped.shape[1]
    return (flat[idx], (idx % w).to(torch.float32),
            (idx // w).to(torch.float32))


def solve_shift(shift_u, shift_v, depth_from, depth_to, closest_depth,
                closest_u, closest_v, width: int, height: int, focal):
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


def interpolate_window(src, dst, step):
    """(center_u, center_v, crop_w, crop_h) at ``step`` in [0, 1]; windows
    are (center_u, center_v, crop_w, crop_h) tuples."""
    t_from, t_to = 1.0 - step, step
    return tuple(t_from * a + t_to * b for a, b in zip(src, dst))


# -------------------------------------------------------------------- resize

def _axis_taps(n_in: int, n_out: int, device):
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
    return (lo.clamp(0, n_in - 1).to(torch.long),
            hi.clamp(0, n_in - 1).to(torch.long), w_lo, w_hi)


def _two_taps(x, axis: int, lo, hi, w_lo, w_hi):
    shape = [1] * x.ndim
    shape[axis] = lo.shape[0]
    a = torch.index_select(x, axis, lo)
    b = torch.index_select(x, axis, hi)
    return a * w_lo.reshape(shape) + b * w_hi.reshape(shape)


def resize_bilinear(image: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """``jax.image.resize(..., 'bilinear', antialias=False)`` of
    (..., H, W, C), in f32; returns ``image.dtype``."""
    x = image.to(torch.float32)
    for axis, n_out in ((x.ndim - 3, height), (x.ndim - 2, width)):
        n_in = x.shape[axis]
        if n_in != n_out:
            x = _two_taps(x, axis, *_axis_taps(n_in, n_out, x.device))
    return x.to(image.dtype)


def resized_shape(height: int, width: int, max_size: int) -> Tuple[int, int]:
    """The (H, W) of ``resize_to_max``: the long side ``max_size``."""
    ratio = float(width) / float(height)
    return (min(int(max_size / ratio), max_size),
            min(int(max_size * ratio), max_size))


def resize_to_max(image: torch.Tensor, max_size: int) -> torch.Tensor:
    return resize_bilinear(image, *resized_shape(image.shape[-3],
                                                 image.shape[-2], max_size))


def _interp_axis(image, coords, axis: int):
    n = image.shape[axis]
    i0 = torch.floor(coords)
    frac = coords - i0
    lo = torch.clamp(i0.to(torch.long), 0, n - 1)
    hi = torch.clamp(i0.to(torch.long) + 1, 0, n - 1)
    return _two_taps(image, axis, lo, hi, 1.0 - frac, frac)


def crop_rect_subpix(image, patch_width: int, patch_height: int, center_u,
                     center_v):
    """cv2.getRectSubPix of (H, W, C): borders replicated."""
    dev = image.device
    xs = (torch.arange(patch_width, dtype=torch.float32, device=dev)
          + center_u - (patch_width - 1) / 2.0)
    ys = (torch.arange(patch_height, dtype=torch.float32, device=dev)
          + center_v - (patch_height - 1) / 2.0)
    return _interp_axis(_interp_axis(image, ys, 0), xs, 1)


# ------------------------------------------------------------------- filters

_LAPLACIAN_3X3 = ((0.0, -1.0, -1.0), (-1.0, 4.0, 0.0), (-1.0, 0.0, 0.0))


def laplacian_filter(x: torch.Tensor) -> torch.Tensor:
    """The reference's asymmetric 3x3 stencil, edge padded, tap by tap in
    row-major order. (B, H, W, C) -> same."""
    h, w = x.shape[1], x.shape[2]
    padded = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                   mode="replicate").permute(0, 2, 3, 1)
    out = None
    for ky, row in enumerate(_LAPLACIAN_3X3):
        for kx, k in enumerate(row):
            if k != 0.0:
                tap = padded[:, ky:ky + h, kx:kx + w, :] * k
                out = tap if out is None else out + tap
    return out


def validity_mask(disparity: torch.Tensor, threshold: float) -> torch.Tensor:
    peak = torch.amax(disparity, dim=(1, 2, 3), keepdim=True)
    lap = laplacian_filter(disparity / peak)
    return (torch.abs(lap) < threshold).to(disparity.dtype)


def median_filter_binary(x: torch.Tensor, size: int) -> torch.Tensor:
    """Reflect-padded size x size median of a 0/1 (B, H, W, C) map: the
    majority of a box sum."""
    pad = size // 2
    b, h, w, c = x.shape
    padded = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                   mode="reflect")
    rows = torch.zeros((b, c, h, w + 2 * pad), dtype=x.dtype,
                       device=x.device)
    for dy in range(size):
        rows = rows + padded[:, :, dy:dy + h, :]
    total = torch.zeros((b, c, h, w), dtype=x.dtype, device=x.device)
    for dx in range(size):
        total = total + rows[:, :, :, dx:dx + w]
    return (total > (size * size) // 2 + 0.5).to(x.dtype).permute(0, 2, 3, 1)


# --------------------------------------------------------------------- splat

def _project(xyz, shift, focal, focal_baseline, height: int, width: int):
    shifted = xyz + shift
    u, v, ok = project_points(shifted, height, width, focal)
    err = 1000000.0 - true_div(focal_baseline * 1.0,
                               shifted[:, 2] + 1e-7)
    return u, v, err, ok


def _corners(u, v):
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    w = torch.stack([(x0 + 1.0 - u) * (y0 + 1.0 - v), (u - x0) * (y0 + 1.0 - v),
                     (x0 + 1.0 - u) * (v - y0), (u - x0) * (v - y0)], dim=-1)
    xi = torch.stack([x0, x0 + 1.0, x0, x0 + 1.0], dim=-1)
    yi = torch.stack([y0, y0, y0 + 1.0, y0 + 1.0], dim=-1)
    return xi, yi, w


def _flat(xi, yi, height: int, width: int, ok):
    inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height) & ok
    flat = yi.clamp(0, height - 1).long() * width \
        + xi.clamp(0, width - 1).long()
    return torch.where(inb, flat, torch.full_like(flat, height * width)), inb


def splat(xyz, payload, shift, focal, focal_baseline, height: int,
          width: int):
    """Z-buffered bilinear forward splat of the valid points ``xyz``
    (N, 3) with ``payload`` (N, C) at ``shift`` (3,): the z key of each
    point goes to its corner of largest weight (NW, NE, SW, SE; ties to the
    first), the z-buffer's holes close over opposing neighbour pairs, then
    every point adds ``w * payload`` and ``w`` to each in-image corner whose
    key it is within 1 of. Returns (render (H, W, C), weight (H, W, 1))."""
    n, c = payload.shape
    hw = height * width
    u, v, err, ok = _project(xyz, shift, focal, focal_baseline, height,
                             width)
    xi, yi, w = _corners(u, v)
    best = torch.zeros_like(u, dtype=torch.long)
    for k in range(1, 4):
        best = torch.where(w[:, k] > torch.gather(w, 1, best[:, None])[:, 0],
                           k, best)
    bflat, _ = _flat(torch.gather(xi, 1, best[:, None])[:, 0],
                     torch.gather(yi, 1, best[:, None])[:, 0], height, width,
                     ok)
    zee = torch.full((hw + 1,), _ZFAR, dtype=torch.float32, device=xyz.device)
    zee.scatter_reduce_(0, bflat, err, reduce="amin")
    zee = _degrid(zee[:-1].reshape(height, width)).reshape(-1)

    flat, inb = _flat(xi, yi, height, width, ok[:, None])
    zn = torch.where(inb, zee[flat.clamp(max=hw - 1)],
                     torch.full_like(w, -float("inf")))
    vis = inb & (err[:, None] <= zn + 1.0)
    weights = torch.where(vis, w, torch.zeros_like(w))
    full = torch.cat([payload, torch.ones((n, 1), dtype=payload.dtype,
                                          device=payload.device)], dim=-1)
    # only the visible entries, in ascending entry order (point, corner)
    entry = torch.nonzero(vis.reshape(-1))[:, 0]
    vals = weights.reshape(-1)[entry, None] * full[entry // 4]
    out = torch.zeros((hw, c + 1), dtype=torch.float32,
                      device=payload.device)
    with _deterministic():
        out.index_add_(0, flat.reshape(-1)[entry], vals)
    render = out[:, :c] / (out[:, c:] + 1e-7)
    return render.reshape(height, width, c), out[:, c:].reshape(height,
                                                                width, 1)


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms on while the block runs."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _degrid(zee: torch.Tensor) -> torch.Tensor:
    h, w = zee.shape
    p = F.pad(zee, (1, 1, 1, 1), value=float("inf"))

    def nb(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    total = torch.zeros_like(zee)
    count = torch.zeros_like(zee)
    for dx, dy in ((1, 0), (0, 1), (1, 1), (1, -1)):
        one, two = nb(dy, dx), nb(-dy, -dx)
        good = (zee >= one + 1.0) & (zee >= two + 1.0)
        total = total + torch.where(good, one + two, torch.zeros_like(zee))
        count = count + torch.where(good, torch.full_like(zee, 2.0),
                                    torch.zeros_like(zee))
    avg = total / torch.clamp(count, min=1.0)
    return torch.where(count > 0.0, torch.minimum(zee, avg), zee)


# ---------------------------------------------------------------------- fill

_DIR_X = (-1, 0, 1, 1, -1, 1, 2, 2, -2, -1, 1, 2, 3, 3, 3, 3)
_DIR_Y = (1, 1, 1, 0, 2, 2, 1, -1, 3, 3, 3, 3, 2, 1, -1, -2)


def _c_round(x: float) -> int:
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


def ray_offsets(steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """(32, steps) x and y offsets of march steps 1..steps: rays 0-15 go
    along the 16 directions, rays 16-31 the opposite way."""
    ox, oy = [], []
    for dx, dy in zip(_DIR_X, _DIR_Y):
        norm = math.sqrt(dx * dx + dy * dy)
        ox.append([_c_round(k * dx / norm) for k in range(1, steps + 1)])
        oy.append([_c_round(k * dy / norm) for k in range(1, steps + 1)])
    ox = ox + [[-v for v in row] for row in ox]
    oy = oy + [[-v for v in row] for row in oy]
    return np.asarray(ox, np.int32), np.asarray(oy, np.int32)


def fill(image: torch.Tensor, depth: torch.Tensor, steps: int,
         roi: Optional[Tuple[int, int, int, int]] = None,
         chunk: int = 8192) -> torch.Tensor:
    """Disocclusion fill of one frame, ``image`` (H, W, C), ``depth``
    (H, W, 1) -> (H, W, C). Each hole pixel (depth <= 0) inside ``roi``
    marches its 32 rays at most ``steps`` pixels to their first event, a
    valid pixel or the image's edge. Of the directions whose two rays both
    end on valid pixels, the first with the strictly smallest distance
    between the two ends wins, and the pixel takes every channel of the
    end with the larger depth. Only the holes march, ``chunk`` at a time."""
    h, w, c = image.shape
    dev = image.device
    valid = depth[..., 0] > 0.0
    y0, y1, x0, x1 = roi if roi is not None else (0, h, 0, w)
    region = torch.zeros_like(valid)
    region[y0:y1, x0:x1] = True
    holes = torch.nonzero(region & ~valid)
    out = image.clone()
    if holes.shape[0] == 0 or steps == 0:
        return out
    ox_np, oy_np = ray_offsets(steps)
    ox = torch.as_tensor(ox_np, device=dev)[:, :, None]
    oy = torch.as_tensor(oy_np, device=dev)[:, :, None]
    kidx = torch.arange(steps, device=dev, dtype=torch.int32)[None, :, None]
    dflat = depth[..., 0].reshape(-1)
    vflat = valid.reshape(-1)
    iflat = image.reshape(-1, c)
    for start in range(0, holes.shape[0], chunk):
        hy = holes[start:start + chunk, 0].to(torch.int32)
        hx = holes[start:start + chunk, 1].to(torch.int32)
        ys = hy[None, None, :] + oy                       # (32, steps, n)
        xs = hx[None, None, :] + ox
        inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        flat = (ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)).long()
        good = vflat[flat] & inside
        event = good | ~inside
        first = torch.where(event, kidx, steps).amin(dim=1)   # (32, n)
        found = first < steps
        at = first.clamp(max=steps - 1).long()[:, None, :]
        usable = found & torch.gather(good, 1, at)[:, 0]
        ey = torch.gather(ys, 1, at)[:, 0]
        ex = torch.gather(xs, 1, at)[:, 0]
        both = usable[:16] & usable[16:]
        ddx = (ex[:16] - ex[16:]).to(torch.float32)
        ddy = (ey[:16] - ey[16:]).to(torch.float32)
        dist = torch.where(both, torch.sqrt(ddx * ddx + ddy * ddy),
                           torch.full_like(ddx, float("inf")))
        best = dist[0]
        bestdir = torch.zeros_like(hy, dtype=torch.long)
        for d in range(1, 16):
            better = dist[d] < best
            best = torch.where(better, dist[d], best)
            bestdir = torch.where(better, d, bestdir)
        pick = bestdir[None]
        t_flat = (torch.gather(ey[:16], 0, pick)[0].long() * w
                  + torch.gather(ex[:16], 0, pick)[0].long())
        f_flat = (torch.gather(ey[16:], 0, pick)[0].long() * w
                  + torch.gather(ex[16:], 0, pick)[0].long())
        do_fill = torch.any(both, dim=0)
        t_flat = t_flat.clamp(0, h * w - 1)
        f_flat = f_flat.clamp(0, h * w - 1)
        src = torch.where(dflat[f_flat] < dflat[t_flat], t_flat, f_flat)
        dst = hy.long() * w + hx.long()
        keep = torch.nonzero(do_fill)[:, 0]
        out.reshape(-1, c)[dst[keep]] = iflat[src[keep]]
    return out
