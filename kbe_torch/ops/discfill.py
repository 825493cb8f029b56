"""Disocclusion filling: plain PyTorch spec + CUDA kernel.

Port of ``kbe_tpu/ops/discfill.py::fill_disocclusion`` (the spec) and of
the TPU kernel that computes it on the main path,
``discfill_pallas.py::_build_gated_flagging_kernel`` /
``::_build_gated_kernel`` (kernel ``discfill`` in ``csrc/discfill.cu``).

For every hole pixel (depth <= 0), march the 32 rays (16 directions, both
ways) to their first event: a valid pixel, or leaving the image. The k-th
pixel of a ray is p + c_round(k * d_hat), the same static offset for every
pixel, so both versions read one offset table. Of the directions whose two
rays end on valid pixels, the first with the strictly smallest f32
endpoint distance wins, and the pixel copies all channels of the endpoint
with the larger depth. ``steps`` bounds the march. The kernel is
bit-identical to the plain version.

``fill_disocclusion_pallas`` is the entry point of the TPU package's other
fill kernels (``discfill_pallas.py::_build_kernel``, ``_build_fused_kernel``):
the same fill under another schedule, so the same ``discfill`` kernel.
``resolve_thin_holes``, the TPU package's XLA pre-pass, has no counterpart:
it only saved march work for the TPU's kernel.

``roi`` = (y0, y1, x0, x1): holes outside it are left untouched; inside it
the result equals the full fill, because the march reads the whole image.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from kbe_torch.ops import _build

# Direction table of the reference kernel (utils/common.py:859-860).
_DIR_X = (-1, 0, 1, 1, -1, 1, 2, 2, -2, -1, 1, 2, 3, 3, 3, 3)
_DIR_Y = (1, 1, 1, 0, 2, 2, 1, -1, 3, 3, 3, 3, 2, 1, -1, -2)

LAUNCHES: collections.Counter = collections.Counter()


def _c_round(x: float) -> int:
    """C round(): half away from zero."""
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


def _offset_tables(steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """(32, steps) x/y offsets of steps 1..steps: rays 0..15 march along
    +d_hat ('to'), rays 16..31 along -d_hat ('from')."""
    ox, oy = [], []
    for dx, dy in zip(_DIR_X, _DIR_Y):
        norm = math.sqrt(dx * dx + dy * dy)
        ox.append([_c_round(k * dx / norm) for k in range(1, steps + 1)])
        oy.append([_c_round(k * dy / norm) for k in range(1, steps + 1)])
    ox = ox + [[-v for v in row] for row in ox]
    oy = oy + [[-v for v in row] for row in oy]
    return np.asarray(ox, np.int32), np.asarray(oy, np.int32)


# ---------------------------------------------------------------- plain spec

def _first_events(valid: torch.Tensor, steps: int):
    """Endpoints (32, H, W) of each ray's first event and whether it is a
    valid pixel (False when the ray leaves the image or runs out)."""
    h, w = valid.shape
    dev = valid.device
    pad = steps + 1
    # 1 = valid, 0 = hole, -1 = outside the image
    vpad = torch.nn.functional.pad(valid.to(torch.int8), (pad, pad, pad, pad),
                                   value=-1).reshape(-1)
    wp = w + 2 * pad
    ox_np, oy_np = _offset_tables(steps)
    ox = torch.as_tensor(ox_np, device=dev)
    oy = torch.as_tensor(oy_np, device=dev)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    base = ((yy + pad) * wp + (xx + pad))[None]           # (1, H, W)
    found = torch.zeros((32, h, w), dtype=torch.bool, device=dev)
    usable = torch.zeros_like(found)
    end_oy = torch.zeros((32, h, w), dtype=torch.int32, device=dev)
    end_ox = torch.zeros_like(end_oy)
    for k in range(steps):
        koy = oy[:, k].view(32, 1, 1)
        kox = ox[:, k].view(32, 1, 1)
        shifted = vpad[base + koy * wp + kox]             # (32, H, W)
        event = (shifted != 0) & ~found
        usable = torch.where(event, shifted == 1, usable)
        end_oy = torch.where(event, koy, end_oy)
        end_ox = torch.where(event, kox, end_ox)
        found = found | event
    usable = usable & found
    return yy[None] + end_oy, xx[None] + end_ox, usable


def fill_plain(image: torch.Tensor, depth: torch.Tensor, steps: int,
               roi: Optional[Tuple[int, int, int, int]] = None
               ) -> torch.Tensor:
    """One frame: ``image`` (H, W, C), ``depth`` (H, W, 1) -> (H, W, C)."""
    h, w, c = image.shape
    valid = depth[..., 0] > 0.0
    ey, ex, ok = _first_events(valid, steps)
    ty, tx, t_ok = ey[:16], ex[:16], ok[:16]
    fy, fx, f_ok = ey[16:], ex[16:], ok[16:]
    both = t_ok & f_ok
    ddx = (tx - fx).to(torch.float32)
    ddy = (ty - fy).to(torch.float32)
    dist = torch.sqrt(ddx * ddx + ddy * ddy)
    dist = torch.where(both, dist, torch.full_like(dist, float("inf")))
    # the first direction with the strictly smallest distance (torch.argmin
    # does not promise the first of equal minima on every backend)
    best = dist[0]
    bestdir = torch.zeros((h, w), dtype=torch.long, device=image.device)
    for d in range(1, 16):
        better = dist[d] < best
        best = torch.where(better, dist[d], best)
        bestdir = torch.where(better, d, bestdir)

    def take(a):
        return torch.gather(a, 0, bestdir[None])[0].long()

    bfy, bfx, bty, btx = take(fy), take(fx), take(ty), take(tx)
    dflat = depth[..., 0].reshape(-1)
    d_from = dflat[(bfy * w + bfx).clamp(0, h * w - 1)]
    d_to = dflat[(bty * w + btx).clamp(0, h * w - 1)]
    use_to = d_from < d_to  # the farther (background) endpoint wins
    fill_y = torch.where(use_to, bty, bfy)
    fill_x = torch.where(use_to, btx, bfx)
    do_fill = (~valid) & torch.any(both, dim=0)
    if roi is not None:
        y0, y1, x0, x1 = roi
        yy = torch.arange(h, device=image.device)[:, None]
        xx = torch.arange(w, device=image.device)[None, :]
        do_fill = do_fill & (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
    flat = (fill_y * w + fill_x).clamp(0, h * w - 1)
    filled = image.reshape(-1, c)[flat]
    return torch.where(do_fill[..., None], filled, image)


# ------------------------------------------------------------- CUDA wrapper

_TABLES_SET = set()  # devices whose __constant__ tables are loaded


def _load_tables(lib, device: torch.device) -> int:
    max_steps = lib.kbe_discfill_max_steps()
    if device not in _TABLES_SET:
        ox, oy = _offset_tables(max_steps)
        ox = np.ascontiguousarray(ox.astype(np.int16))
        oy = np.ascontiguousarray(oy.astype(np.int16))
        with torch.cuda.device(device):
            _build.check(lib.kbe_discfill_set_tables(
                ox.ctypes.data_as(ctypes.c_void_p),
                oy.ctypes.data_as(ctypes.c_void_p)),
                "discfill_set_tables")
        _TABLES_SET.add(device)
    return max_steps


def fill_cuda(image: torch.Tensor, depth: torch.Tensor, steps: int,
              roi: Optional[Tuple[int, int, int, int]] = None
              ) -> torch.Tensor:
    """Kernel ``discfill`` on one frame: ``image`` (H, W, C), ``depth``
    (H, W, 1), contiguous f32 CUDA tensors -> (H, W, C)."""
    for name, t in (("image", image), ("depth", depth)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 CUDA tensor")
    h, w, c = image.shape
    if depth.shape != (h, w, 1) or depth.device != image.device:
        raise ValueError("depth must be (H, W, 1) on the image's device")
    lib = _build.lib("discfill")
    max_steps = _load_tables(lib, image.device)
    if not 0 <= steps <= max_steps:
        raise ValueError(f"steps={steps} outside the kernel's 0..{max_steps}")
    y0, y1, x0, x1 = roi if roi is not None else (0, h, 0, w)
    out = torch.empty_like(image)
    LAUNCHES["discfill"] += 1
    _build.check(lib.kbe_discfill(
        image.data_ptr(), depth.data_ptr(), h, w, c, steps, y0, y1, x0, x1,
        out.data_ptr(), torch.cuda.current_stream(image.device).cuda_stream),
        "discfill")
    return out


def fill_disocclusion(image: torch.Tensor, depth: torch.Tensor,
                      steps: int = 128,
                      roi: Optional[Tuple[int, int, int, int]] = None
                      ) -> torch.Tensor:
    """``image`` (B, H, W, C), ``depth`` (B, H, W, 1) -> (B, H, W, C).
    The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = fill_cuda if image.is_cuda else fill_plain
    return torch.stack([fn(image[b].contiguous(), depth[b].contiguous(),
                           steps, roi) for b in range(image.shape[0])])


def _checked_int(name: str, value, low: int) -> int:
    if isinstance(value, bool) or not isinstance(value, int) or value < low:
        raise ValueError(f"{name} must be an int >= {low}, got {value!r}")
    return value


def fill_disocclusion_pallas(image: torch.Tensor, depth: torch.Tensor,
                             steps: int = 128, phase1_steps: int = 0,
                             roi: Optional[Tuple[int, int, int, int]] = None,
                             phase0_steps: int = 0,
                             phase0_gate: float = 0.0) -> torch.Tensor:
    """The surface of ``kbe_tpu/ops/discfill_pallas.py::
    fill_disocclusion_pallas``: ``image`` (B, H, W, C), ``depth``
    (B, H, W, 1) -> (B, H, W, C).

    The TPU package splits the march into phases to save work on its
    sequential grid: a thin-hole resolver of radius ``phase0_steps`` behind
    a census gate ``phase0_gate``, a short fused march of ``phase1_steps``
    that flags unresolved tiles, and an exact re-march of those tiles; with
    ``phase1_steps <= 0`` it runs the one-phase kernel (``_build_kernel``,
    ``_build_fused_kernel``). It states every schedule to be bit-identical
    to the one-phase march, and so is this function: every setting runs the
    one ``discfill`` kernel, where each hole pixel's thread already stops at
    its ray's first event. The phase arguments are checked for type and
    range and then unused."""
    _checked_int("steps", steps, 0)
    _checked_int("phase1_steps", phase1_steps, 0)
    _checked_int("phase0_steps", phase0_steps, 0)
    if isinstance(phase0_gate, bool) or not isinstance(
            phase0_gate, (int, float)) or not 0.0 <= phase0_gate <= 1.0:
        raise ValueError(f"phase0_gate must be a number in [0, 1], got "
                         f"{phase0_gate!r}")
    if roi is not None:
        y0, y1, x0, x1 = (_checked_int("roi", v, 0) for v in roi)
        if y0 > y1 or x0 > x1:
            raise ValueError(f"roi {roi!r} is not (y0, y1, x0, x1) with "
                             "y0 <= y1 and x0 <= x1")
    return fill_disocclusion(image, depth, steps, roi)
