"""kbe_torch's training-time view synthesis against kbe_tpu's (CPU):
``generate_mask`` and ``masks_a_from_b`` bit-equal (the winner of a pixel is
the minimum-error point, ties to the smallest index, in both), including a
flat cloud where every pixel ties; ``render_view_b`` at atol 2e-4, the
standard the splat is held to (tests/test_torch_splat.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kbe_tpu.config import CameraConfig as CameraJ
from kbe_tpu.ops.visibility import generate_mask as mask_jax
from kbe_tpu.train import view_synthesis as VJ
from kbe_torch.config import CameraConfig
from kbe_torch.ops.visibility import generate_mask
from kbe_torch.train import view_synthesis as VT
from kbe_torch.train.data import synthetic_batches

CAM = (64.0, 30.0)


def _batch(b, h, w, seed):
    batch = next(synthetic_batches(b, h, w, mode="inpainting",
                                   camera=CameraConfig(*CAM), seed=seed))
    return batch


def _jax(batch):
    return {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else jnp.asarray(v))
            for k, v in batch.items()}


def _torch(batch):
    return {k: ({kk: torch.as_tensor(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.as_tensor(v))
            for k, v in batch.items()}


def _points(h, w, depth):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    x = (xs - 0.5 * w + 0.5) / CAM[0] * depth
    y = (ys - 0.5 * h + 0.5) / CAM[0] * depth
    return np.stack([x, y, depth], -1).reshape(1, h * w, 3).astype(
        np.float32)


@pytest.mark.parametrize("case", ["boxes", "flat"])
def test_generate_mask_bit_equal(case):
    h, w = 36, 52
    rng = np.random.default_rng(7)
    if case == "boxes":
        depth = rng.uniform(80, 120, (h, w)).astype(np.float32)
        depth[8:20, 10:30] = 30.0
        shift = np.array([[1.7, -0.9, -4.0]], np.float32)
    else:
        # one depth everywhere, seen from 1.5x as far: about 2.25 points
        # land on each pixel, all with one error, so the index tie-break
        # decides every winner
        depth = np.full((h, w), 50.0, np.float32)
        shift = np.array([[0.0, 0.0, 25.0]], np.float32)
    pts = _points(h, w, depth)
    want = np.asarray(mask_jax(jnp.asarray(pts), jnp.asarray(shift), h, w,
                               *CAM))
    got = generate_mask(torch.as_tensor(pts), torch.as_tensor(shift), h, w,
                        *CAM).numpy()
    assert 0.05 < got.mean() < (1.0 if case == "boxes" else 0.7)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def batch():
    return _batch(2, 40, 56, seed=3)


def test_masks_a_from_b_bit_equal(batch):
    bj, bt = _jax(batch), _torch(batch)
    mj, sj = VJ.masks_a_from_b(bj["image"], bj["disparity"], bj["depth"],
                               bj["zoom"], CameraJ(*CAM))
    mt, st = VT.masks_a_from_b(bt["image"], bt["disparity"], bt["depth"],
                               bt["zoom"], CameraConfig(*CAM))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert 0.0 < float(mt.mean()) < 1.0


def test_render_view_b_matches_jax(batch):
    bj, bt = _jax(batch), _torch(batch)
    ctx = np.random.default_rng(4).normal(
        0, 1, batch["image"].shape[:3] + (5,)).astype(np.float32)
    rj, mj, pj, sj = VJ.render_view_b(bj["image"], bj["disparity"],
                                      bj["depth"], bj["zoom"], CameraJ(*CAM),
                                      context=jnp.asarray(ctx))
    rt, mt, pt, st = VT.render_view_b(bt["image"], bt["disparity"],
                                      bt["depth"], bt["zoom"],
                                      CameraConfig(*CAM),
                                      context=torch.as_tensor(ctx))
    assert rt.shape == (2, 40, 56, 9)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=2e-4)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
