"""kbe_torch's geometry, filter, resize and SSIM ops against kbe_tpu's, on
the same numpy-seeded inputs (CPU).

Tolerances: elementwise geometry is exact (same f32 ops in the same order);
the laplacian is summed in another order than XLA's convolution (rtol 1e-6,
and the validity mask, which thresholds it, must agree on all but a handful
of pixels that sit on the threshold); medians, crops and masks are exact;
resizes agree to 1e-5 (XLA contracts the two taps of each output in a
matrix product).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kbe_tpu.ops import filters as F_j
from kbe_tpu.ops import geometry as G_j
from kbe_tpu.ops import resize as R_j
from kbe_tpu.ops.image_ops import ssim as ssim_j
from kbe_tpu.pipeline.kenburns import compute_pose_shift as pose_j
from kbe_torch.config import CameraConfig, ZoomSettings
from kbe_torch.ops import filters as F_t
from kbe_torch.ops import geometry as G_t
from kbe_torch.ops import resize as R_t
from kbe_torch.ops.image_ops import ssim as ssim_t
from kbe_torch.pipeline.kenburns import compute_pose_shift as pose_t

RNG = np.random.default_rng(0)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _n(a):
    return np.asarray(a)


def test_geometry_elementwise_exact():
    depth = RNG.uniform(1, 300, (2, 12, 20)).astype(np.float32)
    np.testing.assert_array_equal(_n(G_t.depth_to_points(_t(depth), 512.0)),
                                  _n(G_j.depth_to_points(depth, 512.0)))
    disp = RNG.uniform(0, 120, (1, 12, 20, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        _n(G_t.disparity_to_depth(_t(disp), 512.0, 120.0)),
        _n(G_j.disparity_to_depth(disp, 512.0, 120.0)))
    xyz = RNG.uniform(-50, 50, (3, 40, 3)).astype(np.float32)
    xyz[..., 2] = RNG.uniform(-1, 100, (3, 40))
    for a, b in zip(G_t.project_points(_t(xyz), 30, 50, 77.0),
                    G_j.project_points(xyz, 30, 50, 77.0)):
        np.testing.assert_array_equal(_n(a), _n(b))
    np.testing.assert_array_equal(
        _n(G_t.splat_error(_t(xyz[..., 2]), 512.0, 120.0)),
        _n(G_j.splat_error(xyz[..., 2], 512.0, 120.0)))
    shift = np.asarray([1.5, -2.25, 7.0], np.float32)
    np.testing.assert_array_equal(_n(G_t.apply_shift(_t(xyz), _t(shift))),
                                  _n(G_j.apply_shift(xyz, shift)))


def test_depth_range_first_minimum():
    depth = RNG.uniform(5, 9, (40, 52)).astype(np.float32)
    depth[20, 30] = depth[25, 14] = 1.0   # equal minima: the first wins
    for margin in (0, 4, 128):
        got = [float(v) for v in G_t.depth_range(_t(depth), margin)]
        want = [float(v) for v in G_j.depth_range(jnp.asarray(depth),
                                                  margin)]
        assert got == want


def test_pose_shift_matches_jax():
    zoom = ZoomSettings.default_3d(96, 64)
    camera = CameraConfig()
    anchor_np = (np.float32(37.25), np.float32(12.0), np.float32(5.0))
    anchor_t = tuple(torch.tensor(v) for v in anchor_np)
    anchor_j = tuple(jnp.asarray(v) for v in anchor_np)
    for s in (0.0, 1.0):   # the bootstrap's python-float steps
        np.testing.assert_array_equal(
            _n(pose_t(s, camera.focal, anchor_t, zoom, camera, 96, 64)),
            _n(pose_j(s, camera.focal, anchor_j, zoom, camera, 96, 64)))
    steps = np.linspace(0.0, 1.0, 9).astype(np.float32)
    focals = np.full(9, camera.focal, np.float32)
    got = _n(pose_t(_t(steps), _t(focals), anchor_t, zoom, camera, 96, 64))
    for i in range(9):    # the frame loop's f32 steps
        want = _n(pose_j(jnp.asarray(steps[i]), jnp.asarray(focals[i]),
                         anchor_j, zoom, camera, 96, 64))
        np.testing.assert_array_equal(got[i], want)


def test_filters_match():
    x = RNG.uniform(0, 2, (2, 17, 23, 3)).astype(np.float32)
    np.testing.assert_allclose(_n(F_t.laplacian_filter(_t(x))),
                               _n(F_j.laplacian_filter(x)), rtol=1e-6,
                               atol=1e-6)
    for size in (3, 5):
        np.testing.assert_array_equal(_n(F_t.median_filter(_t(x), size)),
                                      _n(F_j.median_filter(x, size)))
    b = (RNG.uniform(size=(2, 17, 23, 1)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(_n(F_t.median_filter_binary(_t(b), 5)),
                                  _n(F_j.median_filter_binary(b, 5)))
    np.testing.assert_array_equal(_n(F_t.median_filter_binary(_t(b), 5)),
                                  _n(F_t.median_filter(_t(b), 5)))
    disp = RNG.uniform(0, 1, (1, 30, 40, 1)).astype(np.float32)
    disp = np.cumsum(disp, axis=2).astype(np.float32)
    got = _n(F_t.validity_mask(_t(disp), 0.03))
    want = _n(F_j.validity_mask(disp, 0.03))
    assert (got != want).sum() <= 3 and want.min() == 0 and want.max() == 1


@pytest.mark.parametrize("kind", ["laplacian", "median-3", "median-5"])
def test_spatial_filter_matches(kind):
    """The reference's string-typed entry point, as ``kbe_tpu``'s."""
    x = np.random.default_rng(5).uniform(0, 2, (2, 13, 19, 3)).astype(
        np.float32)
    np.testing.assert_allclose(_n(F_t.spatial_filter(_t(x), kind)),
                               _n(F_j.spatial_filter(x, kind)), rtol=1e-6,
                               atol=1e-6)


def test_spatial_filter_refuses_an_unknown_kind():
    x = np.zeros((1, 4, 4, 1), np.float32)
    for spatial_filter in (F_t.spatial_filter, F_j.spatial_filter):
        with pytest.raises(ValueError, match="unknown spatial filter"):
            spatial_filter(_t(x) if spatial_filter is F_t.spatial_filter
                           else x, "median-7")


@pytest.mark.parametrize("src,dst", [((32, 48), (16, 24)),   # resize_to_max
                                     ((8, 12), (16, 24)),    # upsample2x
                                     ((55, 61), (64, 64)),   # final resize
                                     ((9, 7), (20, 5))])
def test_resize_bilinear_matches_jax_image_resize(src, dst):
    x = RNG.uniform(0, 255, (1,) + src + (3,)).astype(np.float32)
    got = _n(R_t.resize_bilinear(_t(x), *dst))
    want = _n(R_j.resize_bilinear(x, *dst))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_resize_to_max_and_crop():
    x = RNG.uniform(0, 1, (1, 40, 60, 3)).astype(np.float32)
    np.testing.assert_allclose(_n(R_t.resize_to_max(_t(x), 30)),
                               _n(R_j.resize_to_max(x, 30)), atol=1e-6)
    img = np.floor(RNG.uniform(0, 255, (48, 64, 3))).astype(np.float32)
    for cu, cv, pw, ph in ((32.0, 24.0, 57, 43), (30.7, 25.3, 60, 40),
                           (2.0, 3.0, 20, 10)):
        got = _n(R_t.crop_rect_subpix(_t(img), pw, ph, cu, cv))
        want = _n(R_j.crop_rect_subpix_mm(jnp.asarray(img), pw, ph, cu, cv))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(
            got, _n(R_j.crop_rect_subpix(jnp.asarray(img), pw, ph, cu, cv)))


def test_ssim_matches():
    a = RNG.uniform(0, 1, (1, 32, 40, 3)).astype(np.float32)
    b = np.clip(a + RNG.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(ssim_t(_t(a), _t(b))),
                               float(ssim_j(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
