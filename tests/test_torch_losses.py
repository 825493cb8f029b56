"""kbe_torch's training losses and metrics against kbe_tpu's on the same
numpy-seeded inputs (CPU), the inpainting loss with and without VGG16
features (converted weights). Tolerance: rtol 1e-5 (f32 sums in another
order) and, with VGG16 features, rtol 1e-4 (the conv stack's standard,
tests/test_torch_models.py). The SSIM of disparities near 50 subtracts
blurred squares near 2500 (E[x^2] - E[x]^2), which f32 keeps to about 1e-4
of the variance: that metric is held to rtol 1e-3."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kbe_tpu.models.vgg import VGG16Features as VGGJ
from kbe_tpu.train import losses as LJ
from kbe_tpu.train import metrics as MJ
from kbe_torch.models.vgg import VGG16Features
from kbe_torch.train import losses as LT
from kbe_torch.train import metrics as MT
from kbe_torch.utils.convert import load_flax
from tests.test_torch_models import random_params


def _u(*shape, seed=0, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _close(got, want, rtol=1e-5, rtols=None):
    got = {k: float(v) for k, v in got.items()} if isinstance(got, dict) \
        else float(got)
    want = {k: float(v) for k, v in want.items()} if isinstance(want, dict) \
        else float(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            tol = (rtols or {}).get(k, rtol)
            assert got[k] == pytest.approx(want[k], rel=tol, abs=1e-7), k
    else:
        assert got == pytest.approx(want, rel=rtol, abs=1e-7)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


@pytest.fixture(scope="module")
def disp():
    h, w = 30, 38
    d = 20.0 + 40.0 * _u(2, h, w, 1, seed=1)
    d[:, 8:20, 10:25] = 70.0
    t = d + _u(2, h, w, 1, seed=2, lo=-3, hi=3)
    mask = (_u(2, h, w, 1, seed=3) > 0.3).astype(np.float32)
    return d, t, mask


def test_depth_loss_schedule():
    for it in (0, 1, 37, 5000):
        want = LJ.depth_loss_schedule(it)
        got = LT.depth_loss_schedule(it)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("h", [1, 2, 4, 8])
@pytest.mark.parametrize("norm", [True, False])
def test_derivative_scale(disp, h, norm):
    (dj,), (dt,) = _both(disp[0])
    for g, w in zip(LT._derivative_scale(dt, h, norm),
                    LJ._derivative_scale(dj, h, norm)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("mode", ["L1", "rmse", "logrmse"])
def test_loss_ord(disp, mode):
    j, t = _both(*disp)
    _close(LT.compute_loss_ord(*t, mode=mode),
           LJ.compute_loss_ord(*j, mode=mode))


def test_loss_grad_and_masked_grad(disp):
    j, t = _both(*disp)
    _close(LT.compute_loss_grad(*t), LJ.compute_loss_grad(*j))
    _close(LT.compute_masked_grad_loss(t[0], t[2], (1, 2), 0.5),
           LJ.compute_masked_grad_loss(j[0], j[2], (1, 2), 0.5))
    empty = torch.zeros_like(t[2])
    assert float(LT.compute_loss_grad(t[0], t[1], empty)) == 0.0


def test_joint_edge_loss(disp):
    image = _u(2, 30, 38, 3, seed=4)
    image[:, 8:20, 10:25] = 0.9
    j, t = _both(image, disp[0] / 70.0, disp[2])
    _close(LT.joint_edge_loss(*t), LJ.joint_edge_loss(*j))


@pytest.fixture(scope="module")
def vgg():
    x = _u(1, 32, 40, 3, seed=5)
    params = random_params(VGGJ(), x, seed=6)
    port = load_flax(VGG16Features(), params).eval()
    return (lambda a: VGGJ().apply(params, a)), port


@pytest.mark.parametrize("kind", ["vgg", "no_vgg", "kbe_only", "disparity"])
def test_inpainting_loss(vgg, kind):
    c = 1 if kind == "disparity" else 3
    gt = _u(2, 32, 40, c, seed=7)
    out = _u(2, 32, 40, c, seed=8)
    mask = (_u(2, 32, 40, 1, seed=9) > 0.4).astype(np.float32)
    j, t = _both(gt * mask, mask, out, gt)
    cfg_j, cfg_t = LJ.InpaintingLossConfig(), LT.InpaintingLossConfig()
    if kind == "kbe_only":
        cfg_j = LJ.InpaintingLossConfig(kbe_only=True)
        cfg_t = LT.InpaintingLossConfig(kbe_only=True)
    use_vgg = kind != "no_vgg"
    want = LJ.inpainting_loss(vgg[0] if use_vgg else None, *j, cfg_j)
    with torch.no_grad():
        got = LT.inpainting_loss(vgg[1] if use_vgg else None, *t, cfg_t)
    _close(got, want, rtol=1e-4 if use_vgg else 1e-5)
    assert ("prc" in got) == use_vgg


@pytest.mark.parametrize("with_disp", [True, False])
def test_inpainting_loss_adv(disp, with_disp):
    inp = _u(2, 30, 38, 3, seed=10)
    out = _u(2, 30, 38, 3, seed=11)
    out[:, 5:15, 5:15] = 0.2
    mask = np.ones((2, 30, 38, 1), np.float32)
    mask[:, 10:24, 12:30] = 0.0
    arrays = [inp * mask, mask, out]
    if with_disp:
        arrays += [disp[0] / 70.0, disp[1] / 70.0]
    j, t = _both(*arrays)
    _close(LT.inpainting_loss_adv(*t), LJ.inpainting_loss_adv(*j))


def test_loss_weights_are_the_reference_weights():
    assert LT.LOSS_WEIGHTS == LJ.LOSS_WEIGHTS


def test_depth_metrics(disp):
    depth = 512.0 * 74.0 / disp[0]
    gt = 512.0 * 74.0 / disp[1]
    j, t = _both(depth, gt, disp[2])
    _close(MT.compute_depth_metrics(*t), MJ.compute_depth_metrics(*j))


def test_psnr_and_inpaint_metrics(disp):
    img, img_gt = _u(2, 30, 38, 3, seed=12), _u(2, 30, 38, 3, seed=13)
    img = 0.8 * img_gt + 0.2 * img
    j, t = _both(img, disp[0], img_gt, disp[1])
    _close(MT.psnr(t[1], t[3], disp=True), MJ.psnr(j[1], j[3], disp=True))
    _close(MT.compute_inpaint_metrics(*t), MJ.compute_inpaint_metrics(*j),
           rtols={"ssim_disparity": 1e-3})
