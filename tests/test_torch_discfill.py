"""kbe_torch's disocclusion fill (plain path, CPU) against kbe_tpu's
``fill_disocclusion``: bit-exact, on sparse and dense holes, K=16 and K=128,
holes wider than 16 pixels, and the ROI variant."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kbe_tpu.ops.discfill import _offset_tables as tables_jax
from kbe_tpu.ops.discfill import fill_disocclusion as fill_jax
from kbe_torch.ops import discfill as D
from tests.reference_sim import fill_disocclusion_sim


def _frame(h, w, c, hole_frac, seed, band=0):
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 1, (1, h, w, c)).astype(np.float32)
    depth = rng.uniform(1, 100, (1, h, w, 1)).astype(np.float32)
    depth[rng.uniform(size=(1, h, w, 1)) < hole_frac] = 0.0
    if band:  # a hole wider than the K=16 march
        depth[:, h // 4:h // 4 + 8, w // 3:w // 3 + band] = 0.0
    image[..., -1:] = depth
    return image, depth


def _both(image, depth, steps, roi=None):
    want = np.asarray(fill_jax(jnp.asarray(image), jnp.asarray(depth),
                               steps))
    got = D.fill_disocclusion(torch.as_tensor(image), torch.as_tensor(depth),
                              steps, roi).numpy()
    return got, want


def test_offset_tables_match_jax():
    for steps in (16, 128):
        for a, b in zip(D._offset_tables(steps), tables_jax(steps)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hole_frac,steps,band", [
    (0.05, 16, 0),     # sparse holes
    (0.6, 16, 24),     # dense holes, a band wider than K
    (0.3, 128, 40),    # K=128 reaches across the band
])
def test_fill_bit_exact(hole_frac, steps, band):
    image, depth = _frame(40, 72, 4, hole_frac, seed=int(hole_frac * 100),
                          band=band)
    got, want = _both(image, depth, steps)
    np.testing.assert_array_equal(got, want)
    changed = (got != image).any(-1)
    assert changed.any()
    if band and steps == 16:
        # the band's middle is beyond a 16-step march in every direction
        # that crosses it, and stays as it was wherever the JAX fill left it
        assert (got[depth[..., 0] <= 0] == image[depth[..., 0] <= 0]).any()


def test_fill_roi_inside_equal_outside_untouched():
    image, depth = _frame(48, 64, 4, 0.3, seed=7)
    roi = (5, 40, 9, 50)
    got, want = _both(image, depth, 128, roi)
    y0, y1, x0, x1 = roi
    np.testing.assert_array_equal(got[:, y0:y1, x0:x1],
                                  want[:, y0:y1, x0:x1])
    outside = np.ones(got.shape[:3], bool)
    outside[:, y0:y1, x0:x1] = False
    np.testing.assert_array_equal(got[outside], image[outside])


def test_fill_matches_reference_simulator():
    image, depth = _frame(14, 18, 3, 0.35, seed=11)
    got = D.fill_disocclusion(torch.as_tensor(image), torch.as_tensor(depth),
                              64).numpy()
    want = fill_disocclusion_sim(np.transpose(image[0], (2, 0, 1)),
                                 depth[0, ..., 0])
    np.testing.assert_array_equal(got[0], np.transpose(want, (1, 2, 0)))
