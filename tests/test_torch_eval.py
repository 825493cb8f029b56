"""kbe_torch's evaluation modules against kbe_tpu's on the CPU, from the same
Flax trees and batches; JAX runs its XLA spec paths.

- ``generate_view_c`` at 48x64, batch 2 (2N points, C = 4): render and
  coverage weights atol 2e-4, the splat's tolerance against the spec.
- ``InpaintEval`` at 64^2 with full-width nets (with and without partial
  convolutions): ``eval(compute_fid=False)``'s metrics rtol 1e-4, or,
  where the two f32 runs part further, both within 1e-3 of the same
  metrics in float64 on the port's outputs (the disparity's SSIM takes
  blur(x^2) - blur(x)^2 of disparities near 50: on equal arrays the port's
  f32 is 3.5e-4 from float64, JAX's 1.7e-4); both ``get_inpaint`` outputs
  atol 2e-4 of each array's scale, view C against JAX's view C of the
  port's inpainted B (an f32 difference in the inpainted disparity can
  move one of B's points across a z-test or a pixel's edge).
  ``eval_adv``: ``frechet_distance`` is swapped in both packages for one
  that records its statistics (a 2048-d distance takes about half a
  minute of ``sqrtm``), which agree to a relative L2 error of 1e-4 (means)
  and 1e-3 (covariances of two samples).
- ``DepthEval`` with a narrow disparity lattice: ``eval`` over 2 batches
  rtol 1e-4, ``get_depths`` rtol 1e-4 and atol 1e-4 of each array's
  scale, plain and ``eval_pretrained``. The image is 32x1024: the
  refinement takes the estimation at a quarter of the image, which the
  resize to 512 gives at a 1024-pixel long side, the size of the
  reference's eval crops.
- Both evaluators built from the port's state dicts give the bits of the
  same nets built from the Flax trees.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbe_tpu.config import CameraConfig as CameraJ
from kbe_tpu.models import Disparity as DisparityJ
from kbe_tpu.models import Inpaint as InpaintJ
from kbe_tpu.models import PartialInpaint as PartialInpaintJ
from kbe_tpu.models import Refine as RefineJ
from kbe_tpu.models import Semantics as SemanticsJ
from kbe_tpu.models.gridnet import ContextNet as ContextJ
from kbe_tpu.models.inception import InceptionV3Features as InceptionJ
from kbe_tpu.ops.geometry import depth_to_points as depth_to_points_j
from kbe_tpu.ops.geometry import disparity_to_depth as disparity_to_depth_j
from kbe_tpu.train import eval_depth as EDJ
from kbe_tpu.train import eval_inpaint as EIJ
from kbe_tpu.train import fid as FJ
from kbe_torch.config import CameraConfig
from kbe_torch.models import Disparity
from kbe_torch.train import eval_depth as EDT
from kbe_torch.train import eval_inpaint as EIT
from kbe_torch.train import fid as FT
from kbe_torch.train.data import synthetic_batches
from kbe_torch.train.metrics import compute_inpaint_metrics
from kbe_torch.train.trainer_inpaint import to_device
from tests.test_torch_fid import _recording, _rel_l2
from tests.test_torch_models import random_params

CAM = (64.0, 30.0)
ROWS = (8, 12, 16, 32, 32, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The Tier-1 run has six worker processes on the CPU: one thread for
    this file's convolutions keeps them from oversubscribing the cores
    that the other workers' tests run on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unfrozen(tree):
    return flax.core.unfreeze(jax.device_get(tree))


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_generate_view_c_matches_jax():
    b, h, w = 2, 48, 64
    rng = np.random.default_rng(0)
    depth_a = rng.uniform(200, 400, (b, h, w, 1)).astype(np.float32)
    depth_a[:, 12:30, 20:40] = 90.0
    depth_b = rng.uniform(150, 400, (b, h, w, 1)).astype(np.float32)
    image_a = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    image_b = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    mask_b = (rng.uniform(0, 1, (b, h, w, 1)) > 0.3).astype(np.float32)
    shift = np.array([[12.0, -4.0, 6.0], [-9.0, 3.0, -5.0]], np.float32)
    pts_a = np.asarray(depth_to_points_j(jnp.asarray(depth_a[..., 0]),
                                         CAM[0])).reshape(b, -1, 3)
    args = (pts_a, image_a, depth_a, image_b, depth_b, mask_b, shift)
    want_r, want_w = EIJ.generate_view_c(*map(jnp.asarray, args),
                                         CameraJ(*CAM), h, w)
    got_r, got_w = EIT.generate_view_c(*map(_t, args), CameraConfig(*CAM),
                                       h, w)
    assert got_r.shape == (b, h, w, 4) and got_w.shape == (b, h, w, 1)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0,
                               atol=2e-4)
    assert float(got_w.min()) == 0.0 < float(got_w.max())


def _inpaint_params(partial, seed):
    h = w = 64
    zi = np.zeros((1, h, w, 3), np.float32)
    zd = np.zeros((1, h, w, 1), np.float32)
    net = (PartialInpaintJ if partial else InpaintJ)()
    return {"context": _unfrozen(random_params(ContextJ(), zi, zd,
                                               seed=seed)),
            "net": _unfrozen(random_params(
                net, np.zeros((1, h, w, 68), np.float32), zd,
                seed=seed + 1))}


def _inpaint_batches(seed, n=1):
    return list(synthetic_batches(2, 64, 64, mode="inpainting",
                                  camera=CameraConfig(*CAM), seed=seed,
                                  steps=n))


def _evals(params, partial, fid_params=None):
    ej = EIJ.InpaintEval(params, camera=CameraJ(*CAM), partial_conv=partial,
                         fid_params=fid_params)
    et = EIT.InpaintEval(params, camera=CameraConfig(*CAM),
                         partial_conv=partial, fid_params=fid_params,
                         device="cpu")
    return ej, et


@pytest.mark.parametrize("partial", [False, True],
                         ids=["inpaint", "partial_conv"])
def test_inpaint_eval_metrics_match_jax(partial):
    ej, et = _evals(_inpaint_params(partial, 10), partial)
    assert type(et.net).__name__ == ("PartialInpaint" if partial
                                     else "Inpaint")
    batches = _inpaint_batches(11, 2)
    want = ej.eval(batches, compute_fid=False)
    got = et.eval(batches, compute_fid=False)
    assert set(got) == set(want) == {"psnr_image", "psnr_disparity",
                                     "ssim_image", "ssim_disparity"}
    f64 = _metrics_f64(et, batches)
    for k in want:
        if got[k] != pytest.approx(want[k], rel=1e-4):
            assert got[k] == pytest.approx(f64[k], rel=1e-3), k
            assert want[k] == pytest.approx(f64[k], rel=1e-3), k


def _metrics_f64(et, batches):
    """``eval``'s metrics computed in float64 on the port's outputs."""
    acc = {}
    with torch.no_grad():
        for batch in batches:
            b = to_device(batch, "cpu")
            _, out_img, image01, _, out_disp = et._supervised_forward(b)
            m = compute_inpaint_metrics(out_img.double(), out_disp.double(),
                                        image01.double(),
                                        b["disparity"].double())
            for k, v in m.items():
                acc[k] = acc.get(k, 0.0) + float(v) / len(batches)
    return acc


def test_inpaint_eval_outputs_and_fid_statistics_match_jax(monkeypatch):
    tree = _unfrozen(random_params(InceptionJ(), jnp.zeros((1, 75, 75, 3)),
                                   seed=12))
    ej, et = _evals(_inpaint_params(False, 13), False, fid_params=tree)
    batch = _inpaint_batches(14)[0]
    for render_c in (False, True):
        want = ej.get_inpaint(batch, output_render_c=render_c)
        got = et.get_inpaint(batch, output_render_c=render_c)
        assert set(got) == set(want)
        if render_c:
            want.update(_view_c_of(ej, batch, got))
        for k in want:
            assert got[k].shape == want[k].shape, k
            scale = max(1.0, float(np.abs(want[k]).max()))
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=2e-4 * scale, err_msg=k)
    assert got["mask_c"].max() > 0 and got["render_c"].shape[-1] == 4

    calls_j, calls_t = [], []
    monkeypatch.setattr(FJ.FID, "frechet_distance", _recording(calls_j))
    monkeypatch.setattr(FT.FID, "frechet_distance", _recording(calls_t))
    assert ej.eval_adv([batch]) == et.eval_adv([batch]) == 0.0
    (got,), (want,) = calls_t, calls_j
    for i, tol in enumerate((1e-4, 1e-3, 1e-4, 1e-3)):
        assert _rel_l2(got[i], want[i]) <= tol, i


def _view_c_of(ej, batch, got):
    """JAX's view C of the port's inpainted B: B's points come from the
    inpainted disparity, where an f32 difference can move a point across
    a pixel's z-test or its edge, so view C is held on equal inputs."""
    _, _, real, mask_b, pts_a, shift = ej._adv(
        jax.tree_util.tree_map(jnp.asarray, batch))
    h, w = real.shape[1], real.shape[2]
    cam = ej.camera
    depth_b = disparity_to_depth_j(jnp.asarray(got["inpaint_disparity_b"]),
                                   cam.focal, cam.baseline)
    render_c, mask_c = EIJ.generate_view_c(
        pts_a, real, jnp.asarray(batch["depth"]),
        jnp.asarray(got["inpaint_image_b"]), depth_b, mask_b, shift, cam, h,
        w)
    return {"render_c": np.asarray(render_c), "mask_c": np.asarray(mask_c)}


@pytest.fixture(scope="module")
def depth_trees():
    img = jnp.zeros((1, 64, 64, 3))
    return {
        "semantics": _unfrozen(random_params(SemanticsJ(), img, seed=20)),
        "disparity": _unfrozen(random_params(
            DisparityJ(rows=ROWS), img, jnp.zeros((1, 4, 4, 512)), seed=21)),
        "refine": _unfrozen(random_params(
            RefineJ(), img, jnp.zeros((1, 16, 16, 1)), seed=22)),
    }


def _depth_batch(seed):
    r = np.random.default_rng(seed)
    h, w = 32, 1024
    return {"image": r.uniform(-1, 1, (1, h, w, 3)).astype(np.float32),
            "disparity": r.uniform(1, 60, (1, h, w, 1)).astype(np.float32),
            "mask": (r.uniform(0, 1, (1, h, w, 1)) > 0.2).astype(
                np.float32)}


@pytest.mark.parametrize("pretrained", [False, True],
                         ids=["plain", "eval_pretrained"])
def test_depth_eval_matches_jax(depth_trees, pretrained, monkeypatch):
    monkeypatch.setattr(EDJ, "Disparity",
                        functools.partial(DisparityJ, rows=ROWS))
    monkeypatch.setattr(EDT, "Disparity",
                        functools.partial(Disparity, rows=ROWS))
    ej = EDJ.DepthEval(depth_trees, eval_pretrained=pretrained)
    et = EDT.DepthEval(depth_trees, eval_pretrained=pretrained,
                       device="cpu")
    batches = [_depth_batch(23), _depth_batch(24)]
    want, got = ej.eval(batches), et.eval(batches)
    assert len(got) == 7 and set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-7), k
    want, got = ej.get_depths(batches[0]), et.get_depths(batches[0])
    assert set(got) == set(want)
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
    assert got["estimation"].shape == (1, 8, 256, 1)
    assert got["refined"].shape == (1, 32, 1024, 1)


@pytest.mark.parametrize("which", ["inpaint", "depth"])
def test_evals_take_the_ports_state_dicts(depth_trees, which, monkeypatch):
    """An evaluator built from its nets' state dicts (a trainer hands over
    its modules so) gives the same bits as one built from the Flax trees."""
    if which == "inpaint":
        make = lambda p: EIT.InpaintEval(p, camera=CameraConfig(*CAM),
                                         device="cpu")
        trees = _inpaint_params(False, 30)
        nets = ("context", "net")
        batch = _inpaint_batches(31)[0]
        run = lambda e: e.get_inpaint(batch, output_render_c=True)
    else:
        monkeypatch.setattr(EDT, "Disparity",
                            functools.partial(Disparity, rows=ROWS))
        make = lambda p: EDT.DepthEval(p, device="cpu")
        trees = depth_trees
        nets = ("semantics", "disparity", "refine")
        batch = _depth_batch(32)
        run = lambda e: e.get_depths(batch)
    from_trees = make(trees)
    from_dicts = make({k: getattr(from_trees, k).state_dict()
                       for k in nets})
    want, got = run(from_trees), run(from_dicts)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
