"""kbe_torch's inpainting flow and whole effect against kbe_tpu's on the CPU,
with the same numpy-seeded weights (through ``state_dict_from_flax``).

The JAX side runs its XLA specs (``splat_method='scatter'``,
``fill_impl='xla'``) in f32. Tolerances: the flow's outputs to rtol/atol
1e-4 of their scale (nets in f32, splat to 2e-4); the uint8 frames of the
whole effect to a mean SSIM of at least 0.99, the bar of the JAX package's
own end-to-end oracle test (tests/test_oracle_e2e.py).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import torch

from kbe_tpu.config import CameraConfig as CameraJ
from kbe_tpu.config import EffectConfig as EffectJ
from kbe_tpu.config import ZoomSettings as ZoomJ
from kbe_tpu.models import Disparity as DisparityJ
from kbe_tpu.models import Inpaint as InpaintJ
from kbe_tpu.models import Refine as RefineJ
from kbe_tpu.models import Semantics as SemanticsJ
from kbe_tpu.models.gridnet import ContextNet as ContextNetJ
from kbe_tpu.ops.image_ops import ssim
from kbe_tpu.pipeline.inpaint_flow import InpaintModels as ModelsJ
from kbe_tpu.pipeline.inpaint_flow import pointcloud_inpainting as flow_j
from kbe_tpu.pipeline.kenburns import PipelineParams
from kbe_tpu.pipeline.kenburns import build_effect_fn as build_j
from kbe_tpu.train.data import demo_scene_image as demo_j
from kbe_torch.config import CameraConfig, EffectConfig, ZoomSettings
from kbe_torch.data import demo_scene_image
from kbe_torch.models import ContextNet, Inpaint
from kbe_torch.pipeline.inpaint_flow import InpaintModels, \
    pointcloud_inpainting
from kbe_torch.pipeline.kenburns import build_effect_fn, create_models, \
    models_from_flax
from kbe_torch.utils.convert import state_dict_from_flax
from tests.test_torch_models import random_params


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def test_demo_scene_image_matches():
    for seed in (0, 3):
        np.testing.assert_array_equal(demo_scene_image(48, 64, seed),
                                      demo_j(48, 64, seed))


def test_pointcloud_inpainting_matches_jax():
    h, w, rows = 40, 48, (8, 12, 16, 20)
    camera = CameraJ()
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    disp = np.full((1, h, w, 1), 20.0, np.float32)
    disp[:, 10:30, 12:30] = 90.0   # a near box whose shift disoccludes
    disp += rng.uniform(0, 0.5, disp.shape).astype(np.float32)
    shift = np.asarray([6.0, -3.0, 2.0], np.float32)
    image_n = np.zeros((1, h, w, 3), np.float32)
    p_ctx = random_params(ContextNetJ(), image_n, image_n[..., :1], seed=3)
    p_inp = random_params(InpaintJ(rows=rows),
                          np.zeros((1, h, w, 68), np.float32),
                          image_n[..., :1], seed=4)

    models_j = ModelsJ(
        context=partial(ContextNetJ().apply, p_ctx),
        net=lambda d, m: InpaintJ(rows=rows).apply(p_inp, d, m) + (m,))
    want = flow_j(models_j, jnp.asarray(image), jnp.asarray(disp),
                  jnp.asarray(shift), camera, camera.focal,
                  splat_method="scatter")

    ctx = ContextNet()
    ctx.load_state_dict(state_dict_from_flax(p_ctx))
    net = Inpaint(rows=rows)
    net.load_state_dict(state_dict_from_flax(p_inp))
    with torch.no_grad():
        got = pointcloud_inpainting(
            InpaintModels(context=ctx.eval(), net=net.eval()),
            torch.as_tensor(image), torch.as_tensor(disp),
            torch.as_tensor(shift), CameraConfig(), camera.focal)
    existing = np.asarray(want["existing"])
    assert 0 < existing.mean() < 1   # the shift opened holes
    np.testing.assert_array_equal(got["existing"].numpy(), existing)
    for key in ("image", "disparity", "depth", "points"):
        _close(got[key], want[key])


def _pipeline_params(h, w):
    """Full-width Flax trees of every net of the effect, numpy-seeded."""
    z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    return PipelineParams(
        semantics=random_params(SemanticsJ(), z(1, h // 2, w // 2, 3),
                                seed=10),
        disparity=random_params(DisparityJ(), z(1, h // 2, w // 2, 3),
                                z(1, h // 32, w // 32, 512), seed=11),
        refine=random_params(RefineJ(), z(1, h, w, 3),
                             z(1, h // 4, w // 4, 1), seed=12),
        context=random_params(ContextNetJ(), z(1, h, w, 3), z(1, h, w, 1),
                              seed=13),
        inpaint=random_params(InpaintJ(), z(1, h, w, 68), z(1, h, w, 1),
                              seed=14))


def test_effect_frames_match_jax():
    h = w = 64
    steps = 3
    params = _pipeline_params(h, w)
    image = demo_scene_image(h, w)

    effect_j = EffectJ(num_steps=steps, splat_method="scatter",
                       fill_impl="xla")
    fn_j = jax.jit(build_j(h, w, ZoomJ.default_3d(w, h), CameraJ(),
                           effect_j))
    want = np.asarray(fn_j(params, jnp.asarray(image)[None]))

    models = models_from_flax(params, device="cpu")
    fn = build_effect_fn(h, w, ZoomSettings.default_3d(w, h),
                         CameraConfig(), EffectConfig(num_steps=steps),
                         device="cpu")
    got = fn(models, torch.as_tensor(image)[None]).numpy()

    assert got.shape == want.shape == (steps, h, w, 3)
    assert got.dtype == np.uint8
    scores = [float(ssim(jnp.asarray(got[i], jnp.float32)[None] / 255.0,
                         jnp.asarray(want[i], jnp.float32)[None] / 255.0))
              for i in range(steps)]
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"frames vs JAX: mean SSIM {np.mean(scores):.6f}, max diff "
          f"{diff.max()}, pixels differing {np.mean(diff > 0):.4%}")
    assert np.mean(scores) >= 0.99


def test_effect_stats_and_no_inpaint_path():
    """``with_stats`` reports no dropped splats (the port never drops a
    point), and ``inpaint=False`` renders the single depth grid."""
    h = w = 32
    models = create_models(0, device="cpu")
    image = torch.as_tensor(demo_scene_image(h, w))[None]
    zoom = ZoomSettings.default_3d(w, h)
    frames, stats = build_effect_fn(h, w, zoom,
                                    effect=EffectConfig(num_steps=2),
                                    with_stats=True, device="cpu")(models,
                                                                   image)
    assert stats == {"splat_overflow_frames": 0}
    plain = build_effect_fn(h, w, zoom, effect=EffectConfig(
        num_steps=2, inpaint=False), device="cpu")(models, image)
    assert frames.shape == plain.shape == (2, h, w, 3)
    assert plain.dtype == torch.uint8
