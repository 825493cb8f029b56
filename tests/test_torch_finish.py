"""The frame's finish (``kbe_torch/ops/finish.py``) on the CPU.

The effect builds the crop's and the resize's taps once (``finish_taps``);
run through the plain chain they must give what the per-call
``crop_rect_subpix`` -> ``resize_bilinear`` chain gave, bit for bit, at
the benchmark's shapes and moves. The kernel ``finish`` cannot run here:
its design is emulated in numpy f32 (each product and sum rounded apart,
``rint`` half to even), a ``TILE`` at a time in ``finish_plan``'s two
buffers, and held to the plain chain; ``tests/test_torch_cuda.py``
holds the kernel itself to the plain chain on the card.
"""

import numpy as np
import pytest
import torch

from kbe_torch.config import ZoomSettings
from kbe_torch.ops import finish as F
from kbe_torch.ops.resize import crop_rect_subpix, resize_bilinear
from kbe_torch.pipeline.kenburns import frame_taps

# (height, width, move): 1024^2 in both moves, each other shape of the
# benchmark's mixed photographs, and a small frame
CASES = [(1024, 1024, "3d"), (1024, 1024, "dolly"), (768, 1024, "3d"),
         (1024, 768, "3d"), (680, 1024, "3d"), (576, 1024, "3d"),
         (64, 64, "3d")]


def case_taps(h: int, w: int, move: str, device="cpu"):
    """The taps the effect builds for a frame (h, w) under its default
    move."""
    zoom = (ZoomSettings.default_dolly(w, h) if move == "dolly"
            else ZoomSettings.default_3d(w, h))
    return frame_taps(h, w, zoom, device)


def filled_frames(h: int, w: int, seed: int):
    """A seeded frame (H, W, 4) with values below 0 and above 1, and one
    of a constant colour."""
    g = torch.Generator().manual_seed(seed)
    noisy = torch.rand(h, w, 4, generator=g) * 1.4 - 0.2
    flat = torch.empty(h, w, 4)
    flat[..., :3] = torch.tensor([0.2, 0.61, 0.97])
    flat[..., 3] = 5.0
    return [noisy, flat]


def per_call_chain(filled, h: int, w: int, crop_h: int, crop_w: int):
    """The pose loop's finish as the effect called it before the taps were
    built once: ``crop_rect_subpix`` and ``resize_bilinear`` a frame."""
    rgb = torch.floor(torch.clamp(filled[..., 0:3] * 255.0, 0.0, 255.0))
    patch = crop_rect_subpix(rgb, crop_w, crop_h, w / 2.0, h / 2.0)
    patch = torch.clamp(torch.round(patch), 0.0, 255.0)
    out = resize_bilinear(patch[None], h, w)[0]
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


@pytest.mark.parametrize("h, w, move", CASES)
def test_hoisted_taps_equal_the_per_call_chain(h, w, move):
    taps = case_taps(h, w, move)
    crop_h, crop_w = len(taps.crop_y[0]), len(taps.crop_x[0])
    assert (len(taps.resize_y[0]), len(taps.resize_x[0])) == (h, w)
    for filled in filled_frames(h, w, seed=h + w):
        got = F.finish_plain(filled, taps)
        assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
        assert torch.equal(got, per_call_chain(filled, h, w, crop_h, crop_w))


def _tables(plan):
    """The plan's four tables as numpy (lo, hi, w_lo, w_hi)."""
    out = []
    for t in plan.tables:
        t = t.numpy()
        out.append((t[0].astype(np.int64), t[1].astype(np.int64),
                    t[2].view(np.float32), t[3].view(np.float32)))
    return out


def _two_taps(x, axis: int, lo, hi, w_lo, w_hi, n: int):
    """``x[lo] * w_lo + x[hi] * w_hi`` along ``axis`` in f32, every index
    inside the block's buffer of ``n`` entries on that axis."""
    assert 0 <= lo.min() and hi.max() < n and x.shape[axis] == n
    shape = [1, 1, 1]
    shape[axis] = len(lo)
    a = np.take(x, lo, axis=axis) * w_lo.reshape(shape)
    b = np.take(x, hi, axis=axis) * w_hi.reshape(shape)
    return (a + b).astype(np.float32)


def emulate_kernel(filled: np.ndarray, plan) -> np.ndarray:
    """``finish_kernel``'s tiles in numpy: each block's windows from the
    monotone tables, its five stages in its two buffers (whose sizes the
    plan gives: every stage must fit), and its tile of the frame."""
    cy, cx, ry, rx = _tables(plan)
    h, w = plan.height, plan.width
    ty, tx = F.TILE
    out = np.full((h, w, 3), 7, np.uint8)
    for oy0 in range(0, h, ty):
        for ox0 in range(0, w, tx):
            ny, nx = min(ty, h - oy0), min(tx, w - ox0)
            cr0 = ry[0][oy0]
            ncr = ry[1][oy0 + ny - 1] - cr0 + 1
            cc0 = rx[0][ox0]
            ncc = rx[1][ox0 + nx - 1] - cc0 + 1
            sr0 = cy[0][cr0]
            nsr = cy[1][cr0 + ncr - 1] - sr0 + 1
            sc0 = cx[0][cc0]
            nsc = cx[1][cc0 + ncc - 1] - sc0 + 1
            assert 3 * max(nsr * nsc, ncr * ncc) <= plan.a_floats
            assert 3 * max(ncr * nsc, ny * ncc) <= plan.b_floats
            win = filled[sr0:sr0 + nsr, sc0:sc0 + nsc, :3]
            q = np.floor(np.clip(win * np.float32(255.0), 0.0, 255.0))
            rows = np.arange(cr0, cr0 + ncr)
            crop = _two_taps(q, 0, cy[0][rows] - sr0, cy[1][rows] - sr0,
                             cy[2][rows], cy[3][rows], nsr)
            cols = np.arange(cc0, cc0 + ncc)
            crop = np.clip(np.rint(_two_taps(
                crop, 1, cx[0][cols] - sc0, cx[1][cols] - sc0, cx[2][cols],
                cx[3][cols], nsc)), 0.0, 255.0)
            rows = np.arange(oy0, oy0 + ny)
            res = _two_taps(crop, 0, ry[0][rows] - cr0, ry[1][rows] - cr0,
                            ry[2][rows], ry[3][rows], ncr)
            cols = np.arange(ox0, ox0 + nx)
            res = np.clip(np.rint(_two_taps(
                res, 1, rx[0][cols] - cc0, rx[1][cols] - cc0, rx[2][cols],
                rx[3][cols], ncc)), 0.0, 255.0)
            out[oy0:oy0 + ny, ox0:ox0 + nx] = res.astype(np.uint8)
    return out


@pytest.mark.parametrize("h, w, move", CASES)
def test_kernel_design_emulated_equals_the_plain_chain(h, w, move):
    taps = case_taps(h, w, move)
    plan = F.finish_plan(taps)
    assert 4 * (plan.a_floats + plan.b_floats) <= F.SMEM_BYTES
    for filled in filled_frames(h, w, seed=3 * h + w):
        want = F.finish_plain(filled, taps).numpy()
        assert np.array_equal(emulate_kernel(filled.numpy(), plan), want)


@pytest.mark.parametrize("crop_h, crop_w", [
    (64, 80),    # rows unresized: identity taps
    (37, 58),    # both axes enlarged by odd ratios
    (17, 96)])   # columns unresized, rows enlarged almost four times
def test_emulated_tiles_at_other_crops(crop_h, crop_w):
    h, w = 64, 96
    taps = F.finish_taps(h, w, crop_h, crop_w, w / 2.0 + 0.25,
                         h / 2.0 - 0.5, "cpu")
    plan = F.finish_plan(taps)
    assert 4 * (plan.a_floats + plan.b_floats) <= F.SMEM_BYTES
    for filled in filled_frames(h, w, seed=crop_h):
        want = F.finish_plain(filled, taps).numpy()
        assert np.array_equal(emulate_kernel(filled.numpy(), plan), want)


def test_plan_refuses_what_the_kernel_cannot_take():
    taps = case_taps(64, 64, "3d")
    lo, hi, w_lo, w_hi = taps.crop_x
    flipped = taps._replace(crop_x=(lo.flip(0), hi.flip(0), w_lo, w_hi))
    with pytest.raises(ValueError, match="crop_x taps are not monotone"):
        F.finish_plan(flipped)
    shrink = F.finish_taps(64, 64, 640, 640, 32.0, 32.0, "cpu")
    with pytest.raises(ValueError, match="shared memory"):
        F.finish_plan(shrink)
    plan = F.finish_plan(taps)
    out = torch.empty(64, 64, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        F.finish_cuda(torch.zeros(64, 64, 4), plan, out)
    assert not F.LAUNCHES
