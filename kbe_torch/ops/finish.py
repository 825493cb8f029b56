"""The frame's finish: uint8 quantise -> sub-pixel crop -> round -> resize
-> round. Plain PyTorch chain + CUDA kernel.

After the fill, a frame (H, W, 4) f32 (rgb, depth) becomes the video's
uint8 (H, W, 3) frame as the reference's uint8 cv2 chain makes it: the rgb
quantised BEFORE the crop, the crop (``resize.crop_rect_subpix``: the
effect's largest window, centred) rounded to uint8 levels, then resized
back to (H, W) (``resize.resize_bilinear``) and rounded. The crop's and
the resize's taps are the same for every pose of a video, so
``finish_taps`` builds the four axes' tables once an effect with the
functions that ``crop_rect_subpix`` and ``resize_bilinear`` take their
taps from (``resize.crop_taps``, ``resize.resize_taps``): the weights are
theirs by construction.

``finish_plain`` is the chain in PyTorch, each step in its span of the
tracer (``frame/quantise``, ``frame/crop``, ``frame/resize``,
``frame/round``). ``finish_cuda`` is kernel ``finish_kernel``
(``csrc/finish.cu``): one launch a frame, bit-equal to the plain chain,
writing into a slot of the video's buffer. ``finish_plan`` sizes the
kernel's shared memory from the tables' indices, once an effect. The
wrapper takes CUDA tensors only and counts its launches in ``LAUNCHES``
(``finish``).
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Tuple

import numpy as np
import torch

from kbe_torch.ops import _build
from kbe_torch.ops.resize import _two_taps, crop_taps, resize_taps
from kbe_torch.utils.logging import span

LAUNCHES: collections.Counter = collections.Counter()

# The kernel's shared memory a block, at most. The effect's crop is never
# larger than its frame (``ZoomSettings.validate``), so the resize only
# enlarges and a 32 x 64 tile needs at most about 55 KB at any frame size.
SMEM_BYTES = 96 * 1024
TILE = (32, 64)  # output rows x columns a block


class FinishTaps(NamedTuple):
    """The four axes' (lo, hi, w_lo, w_hi): the crop's over the frame's
    rows (``crop_y``, patch height entries) and columns, then the resize's
    over the patch's rows (``resize_y``, H entries) and columns."""

    crop_y: Tuple[torch.Tensor, ...]
    crop_x: Tuple[torch.Tensor, ...]
    resize_y: Tuple[torch.Tensor, ...]
    resize_x: Tuple[torch.Tensor, ...]


class FinishPlan(NamedTuple):
    """What the kernel takes: the frame's and the crop's size, the four
    tables as (4, n) int32 (lo, hi, then the bits of w_lo and w_hi), and
    the floats of its two shared-memory buffers for a ``TILE``."""

    height: int
    width: int
    crop_height: int
    crop_width: int
    tables: Tuple[torch.Tensor, ...]
    a_floats: int
    b_floats: int


def finish_taps(height: int, width: int, crop_height: int, crop_width: int,
                center_u, center_v, device) -> FinishTaps:
    """The tables of a frame (height, width) cropped to (crop_height,
    crop_width) around (center_u, center_v) and resized back."""
    return FinishTaps(
        crop_taps(height, crop_height, center_v, device),
        crop_taps(width, crop_width, center_u, device),
        resize_taps(crop_height, height, device),
        resize_taps(crop_width, width, device))


def finish_plain(filled: torch.Tensor, taps: FinishTaps) -> torch.Tensor:
    """The chain on one frame: ``filled`` (H, W, C >= 3) f32 -> (H, W, 3)
    uint8, through ``crop_rect_subpix``'s and ``resize_bilinear``'s
    arithmetic on the given taps."""
    with span("frame/quantise"):
        rgb = torch.floor(torch.clamp(filled[..., 0:3] * 255.0, 0.0, 255.0))
    with span("frame/crop"):
        patch = _two_taps(_two_taps(rgb, 0, *taps.crop_y), 1, *taps.crop_x)
        patch = torch.clamp(torch.round(patch), 0.0, 255.0)
    with span("frame/resize"):
        out = _two_taps(_two_taps(patch, 0, *taps.resize_y), 1,
                        *taps.resize_x)
    with span("frame/round"):
        return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


def _spans(lo: np.ndarray, hi: np.ndarray, n: int, tile: int) -> np.ndarray:
    """[(first, last)] of the entries that each tile of ``tile`` outputs
    reads through a monotone table."""
    first = np.arange(0, n, tile)
    last = np.minimum(first + tile, n) - 1
    return np.stack([lo[first], hi[last]], axis=1)


def _extents(out_taps, in_taps, n: int, tile: int) -> Tuple[int, int]:
    """The most crop entries, and source entries, a tile reads along an
    axis: the resize's table ``out_taps`` into the crop's ``in_taps``."""
    crop = _spans(*out_taps, n, tile)
    lo, hi = in_taps
    return (int((crop[:, 1] - crop[:, 0]).max()) + 1,
            int((hi[crop[:, 1]] - lo[crop[:, 0]]).max()) + 1)


def finish_plan(taps: FinishTaps) -> FinishPlan:
    """The kernel's tables and buffers for ``taps`` (one copy of their
    indices to the host): ``a`` holds a tile's window of quantised pixels,
    then its crop patch; ``b`` the crop's rows over the window's columns,
    then the resized rows. Raises where the tables are not monotone, as the
    kernel's windows need, or where the buffers pass ``SMEM_BYTES`` (a
    resize that shrinks, which the effect never asks for)."""
    idx = {}
    for name, (lo, hi, _, _) in zip(FinishTaps._fields, taps):
        lo, hi = lo.cpu().numpy(), hi.cpu().numpy()
        if (np.diff(lo) < 0).any() or (np.diff(hi) < 0).any() \
                or (hi < lo).any():
            raise ValueError(f"finish: the {name} taps are not monotone")
        idx[name] = (lo, hi)
    height, width = len(idx["resize_y"][0]), len(idx["resize_x"][0])
    ty, tx = TILE
    ecy, esy = _extents(idx["resize_y"], idx["crop_y"], height, ty)
    ecx, esx = _extents(idx["resize_x"], idx["crop_x"], width, tx)
    a = 3 * max(esy * esx, ecy * ecx)
    b = 3 * max(ecy * esx, ty * ecx)
    if 4 * (a + b) > SMEM_BYTES:
        raise ValueError(f"finish: a tile needs {4 * (a + b)} B of shared "
                         f"memory, above {SMEM_BYTES}")
    tables = tuple(
        torch.stack([lo.to(torch.int32), hi.to(torch.int32),
                     w_lo.contiguous().view(torch.int32),
                     w_hi.contiguous().view(torch.int32)]).contiguous()
        for lo, hi, w_lo, w_hi in taps)
    return FinishPlan(height, width, len(idx["crop_y"][0]),
                      len(idx["crop_x"][0]), tables, a, b)


def finish_cuda(filled: torch.Tensor, plan: FinishPlan,
                out: torch.Tensor) -> torch.Tensor:
    """Kernel ``finish`` on one frame: ``filled`` (H, W, 4) contiguous f32
    CUDA -> ``out`` (H, W, 3) contiguous uint8 on its device, which it
    returns."""
    h, w = plan.height, plan.width
    if not filled.is_cuda or filled.dtype != torch.float32 \
            or not filled.is_contiguous():
        raise ValueError("filled must be a contiguous f32 CUDA tensor")
    if filled.shape != (h, w, 4):
        raise ValueError(f"filled is {tuple(filled.shape)}, the plan's "
                         f"frame ({h}, {w}, 4)")
    if out.dtype != torch.uint8 or out.shape != (h, w, 3) \
            or not out.is_contiguous() or out.device != filled.device:
        raise ValueError(f"out must be a contiguous ({h}, {w}, 3) uint8 "
                         "tensor on the frame's device")
    if plan.tables[0].device != filled.device:
        raise ValueError("the plan's tables are on another device")
    if filled.data_ptr() % 16:
        raise ValueError("filled must start on 16 B (one load a pixel)")
    lib = _build.lib("finish")
    cy, cx, ry, rx = plan.tables
    LAUNCHES["finish"] += 1
    _build.check(lib.kbe_finish(
        filled.data_ptr(), h, w, cy.data_ptr(), plan.crop_height,
        cx.data_ptr(), plan.crop_width, ry.data_ptr(), rx.data_ptr(),
        TILE[0], TILE[1], plan.a_floats, plan.b_floats,
        out.data_ptr(),
        torch.cuda.current_stream(filled.device).cuda_stream), "finish")
    return out
