"""kbe_torch's autozoom against kbe_tpu's on the CPU: the same end window on
the same numpy-seeded scene. The score is a count of covered pixels, so the
comparison is exact; the flat scene makes most candidates tie, where the
first of the equal maxima must win on both sides."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kbe_tpu.config import CameraConfig as CameraJ
from kbe_tpu.config import ZoomWindow as WindowJ
from kbe_tpu.ops.geometry import depth_range as depth_range_j
from kbe_tpu.ops.geometry import depth_to_points as points_j
from kbe_tpu.pipeline.autozoom import autozoom as autozoom_j
from kbe_torch.config import CameraConfig, ZoomWindow
from kbe_torch.ops.geometry import depth_range, depth_to_points
from kbe_torch.pipeline import autozoom


def _both(depth, window, zoom_factor, shift_range, grid, margin=4):
    h, w = depth.shape
    image = np.random.default_rng(0).uniform(0, 1, (1, h, w, 3)).astype(
        np.float32)
    cam_j = CameraJ(focal=32.0, baseline=10.0)
    pts_j = points_j(jnp.asarray(depth)[None], cam_j.focal).reshape(1, -1, 3)
    want = autozoom_j(pts_j, jnp.asarray(image), WindowJ(*window),
                      zoom_factor, shift_range,
                      depth_range_j(jnp.asarray(depth), margin=margin),
                      cam_j, grid=grid, batch=4)
    cam = CameraConfig(focal=32.0, baseline=10.0)
    d = torch.as_tensor(depth)
    pts = depth_to_points(d[None], cam.focal).reshape(1, -1, 3)
    got = autozoom(pts, torch.as_tensor(image), ZoomWindow(*window),
                   zoom_factor, shift_range, depth_range(d, margin), cam,
                   grid=grid)
    return got, want


def _same(got, want):
    assert (got.center_u, got.center_v, got.crop_width, got.crop_height) \
        == (want.center_u, want.center_v, want.crop_width, want.crop_height)


@pytest.mark.parametrize("shift_range,grid", [(3.0, 4), (6.0, 5)])
def test_autozoom_picks_the_window_of_jax(shift_range, grid):
    """A far plane with a near box: the candidates' coverage differs."""
    depth = np.full((32, 32), 20.0, np.float32)
    depth[8:20, 8:20] = 10.0
    got, want = _both(depth, (16.0, 16.0, 28, 28), 1.25, shift_range, grid)
    _same(got, want)
    assert got.crop_width == round(28 / 1.25)
    assert 0 <= got.center_u <= 32 and 0 <= got.center_v <= 32


def test_autozoom_ties_take_the_first_candidate():
    """A flat scene under a zoom-in covers the whole frame at every small
    shift, so every in-bounds candidate ties; the first rows and columns of
    the lattice are out of bounds and score -1. The winner is the first
    in-bounds candidate, not the centre and not the last."""
    depth = np.full((32, 40), 20.0, np.float32)
    window = (18.0, 17.0, 36, 30)
    got, want = _both(depth, window, 1.2, 4.0, 6)
    _same(got, want)
    shifts = np.linspace(-4.0, 4.0, 6, dtype=np.float32)
    crop_w, crop_h = 36 / 1.2, 30 / 1.2
    first_u = next(s for s in shifts if crop_w / 2 <= 18.0 + s
                   <= 40 - crop_w / 2)
    first_v = next(s for s in shifts if crop_h / 2 <= 17.0 + s
                   <= 32 - crop_h / 2)
    assert first_u > shifts[0] or first_v > shifts[0]
    assert (got.center_u, got.center_v) == (18.0 + float(first_u),
                                            17.0 + float(first_v))
