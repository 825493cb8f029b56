"""kbe_torch's image ops against kbe_tpu's on the same numpy-seeded inputs
(CPU). Tolerance: atol 1e-6 (f32 convolutions and sums in another order;
the values are O(1))."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kbe_tpu.ops import image_ops as J
from kbe_torch.ops import image_ops as T

ATOL = 1e-6


def _u(*shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name,args", [
    ("rgb_to_grayscale", ()),
    ("sobel_magnitude", ()),
    ("gaussian_blur_13", (13, 1.5)),
    ("gaussian_blur_7", (7, 1.0)),
    ("total_variation", ()),
    ("gram_matrix", ()),
])
def test_image_op_matches_jax(name, args):
    x = _u(2, 23, 31, 3, seed=len(name))
    fn = name.rsplit("_", 1)[0] if name.startswith("gaussian") else name
    want = getattr(J, fn)(jnp.asarray(x), *args)
    got = getattr(T, fn)(torch.as_tensor(x), *args)
    _close(got, want)


def test_sobel_and_blur_of_a_mask():
    """The adversarial loss runs both on binary (B, H, W, 1) masks, where a
    reflect pad of a narrow image and a threshold decide the result."""
    mask = (_u(1, 17, 9, 1, seed=3) > 0.5).astype(np.float32)
    _close(T.sobel_magnitude(torch.as_tensor(mask)),
           J.sobel_magnitude(jnp.asarray(mask)))
    _close(T.gaussian_blur(torch.as_tensor(mask), 13, 1.5),
           J.gaussian_blur(jnp.asarray(mask), 13, 1.5))


@pytest.mark.parametrize("c", [1, 3])
def test_ssim_distance_matches_jax(c):
    a, b = _u(2, 24, 20, c, seed=5), _u(2, 24, 20, c, seed=6)
    b = 0.7 * a + 0.3 * b
    _close(T.ssim_distance(torch.as_tensor(a), torch.as_tensor(b)),
           J.ssim_distance(jnp.asarray(a), jnp.asarray(b)))
