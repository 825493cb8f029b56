"""kbe_torch's inpainting flow and whole effect against kbe_tpu's on the CPU,
with the same numpy-seeded weights (through ``state_dict_from_flax``).

The JAX side runs its XLA specs (``splat_method='scatter'``,
``fill_impl='xla'``) in f32. Tolerances: the flow's outputs to rtol/atol
1e-4 of their scale (nets in f32, splat to 2e-4); the uint8 frames of the
whole effect to a mean SSIM of at least 0.99, the bar of the JAX package's
own end-to-end oracle test (tests/test_oracle_e2e.py), and to equality where
it holds (each test's docstring says which).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kbe_tpu.config import CameraConfig as CameraJ
from kbe_tpu.config import EffectConfig as EffectJ
from kbe_tpu.config import ZoomSettings as ZoomJ
from kbe_tpu.models import Disparity as DisparityJ
from kbe_tpu.models import Inpaint as InpaintJ
from kbe_tpu.models import PartialInpaint as PartialInpaintJ
from kbe_tpu.models import Refine as RefineJ
from kbe_tpu.models import RefinePretrained as RefinePretrainedJ
from kbe_tpu.models import Semantics as SemanticsJ
from kbe_tpu.models.gridnet import ContextNet as ContextNetJ
from kbe_tpu.ops.image_ops import ssim
from kbe_tpu.pipeline.inpaint_flow import InpaintModels as ModelsJ
from kbe_tpu.pipeline.inpaint_flow import extend_cloud as extend_j
from kbe_tpu.pipeline.inpaint_flow import pointcloud_inpainting as flow_j
from kbe_tpu.pipeline.kenburns import PipelineParams
from kbe_tpu.pipeline.kenburns import build_effect_fn as build_j
from kbe_tpu.train.data import demo_scene_image as demo_j
from kbe_torch.config import CameraConfig, EffectConfig, ZoomSettings
from kbe_torch.data import demo_scene_image
from kbe_torch.models import ContextNet, Inpaint, PartialInpaint
from kbe_torch.pipeline.inpaint_flow import InpaintModels, extend_cloud, \
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
    net.eval()
    with torch.no_grad():
        got = pointcloud_inpainting(
            InpaintModels(context=ctx.eval(),
                          net=lambda d, m: net(d, m) + (m,)),
            torch.as_tensor(image), torch.as_tensor(disp),
            torch.as_tensor(shift), CameraConfig(), camera.focal)
    existing = np.asarray(want["existing"])
    assert 0 < existing.mean() < 1   # the shift opened holes
    np.testing.assert_array_equal(got["existing"].numpy(), existing)
    for key in ("image", "disparity", "depth", "points"):
        _close(got[key], want[key])


def test_dual_net_flow_and_extend_cloud_match_jax():
    """The dual-net flow with a partial-conv first net: color and
    ``existing`` (the propagated mask) from net 1, disparity from net 2 and
    its own context; then ``extend_cloud`` on the result. Every renderer
    name gives the same result on the CPU."""
    h, w, rows = 32, 40, (8, 12, 16, 20)
    camera = CameraJ()
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
    disp = np.full((1, h, w, 1), 20.0, np.float32)
    disp[:, 8:24, 10:26] = 90.0
    disp += rng.uniform(0, 0.5, disp.shape).astype(np.float32)
    shift = np.asarray([5.0, -3.0, 2.0], np.float32)
    z3, z1 = np.zeros((1, h, w, 3), np.float32), np.zeros((1, h, w, 1),
                                                          np.float32)
    z68 = np.zeros((1, h, w, 68), np.float32)
    p_ctx = random_params(ContextNetJ(), z3, z1, seed=3)
    p_ctx2 = random_params(ContextNetJ(), z3, z1, seed=5)
    p_net = random_params(PartialInpaintJ(rows=rows), z68, z1, seed=4)
    p_net2 = random_params(InpaintJ(rows=rows), z68, z1, seed=6)

    models_j = ModelsJ(
        context=partial(ContextNetJ().apply, p_ctx),
        net=partial(PartialInpaintJ(rows=rows).apply, p_net),
        depth_net=lambda d, m: InpaintJ(rows=rows).apply(p_net2, d, m) + (m,),
        context_depth=partial(ContextNetJ().apply, p_ctx2))
    want = flow_j(models_j, jnp.asarray(image), jnp.asarray(disp),
                  jnp.asarray(shift), camera, camera.focal,
                  splat_method="scatter")

    def port(cls, params, **kw):
        m = cls(**kw)
        m.load_state_dict(state_dict_from_flax(params))
        return m.eval()

    net2 = port(Inpaint, p_net2, rows=rows)
    coverage = []   # the render's mask, as the second net is handed it

    def depth_net(d, m):
        coverage.append(m)
        return net2(d, m) + (m,)

    models = InpaintModels(
        context=port(ContextNet, p_ctx),
        net=port(PartialInpaint, p_net, rows=rows),
        depth_net=depth_net, context_depth=port(ContextNet, p_ctx2))
    t = torch.as_tensor
    got = {}
    with torch.no_grad():
        for method in ("scatter", "banded", "routed"):
            got[method] = pointcloud_inpainting(
                models, t(image), t(disp), t(shift), CameraConfig(),
                camera.focal, splat_method=method)
        with pytest.raises(ValueError, match="splat_method"):
            pointcloud_inpainting(models, t(image), t(disp), t(shift),
                                  CameraConfig(), camera.focal,
                                  splat_method="pallas")
    for method in ("banded", "routed"):
        for key, value in got["scatter"].items():
            assert torch.equal(value, got[method][key]), (method, key)
    got = got["scatter"]
    # the shift opened holes, and the result's mask is not the render's but
    # the one the partial convs propagated
    assert 0 < float(coverage[0].mean()) < 1
    assert not torch.equal(got["existing"], coverage[0])
    np.testing.assert_array_equal(got["existing"].numpy(),
                                  np.asarray(want["existing"]))
    for key in ("image", "disparity", "depth", "points"):
        _close(got[key], want[key])

    n = h * w
    cloud = (rng.normal(0, 1, (1, n, 3)).astype(np.float32),
             rng.uniform(0, 1, (1, n, 5)).astype(np.float32),
             np.ones((1, n), np.float32))
    want_c = extend_j(*(jnp.asarray(a) for a in cloud), want)
    got_c = extend_cloud(*(t(a) for a in cloud), got)
    for g, wnt in zip(got_c, want_c):
        assert g.shape == wnt.shape and g.shape[1] == 2 * n
        _close(g, wnt)
    np.testing.assert_array_equal(got_c[2].numpy(), np.asarray(want_c[2]))


def _pipeline_params(h, w, pretrained_refine=False, partial_inpainting=False,
                     inpaint_depth=False):
    """Full-width Flax trees of every net of the effect, numpy-seeded."""
    z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    refine_j = RefinePretrainedJ() if pretrained_refine else RefineJ()
    inpaint_j = PartialInpaintJ() if partial_inpainting else InpaintJ()
    ctx = (z(1, h, w, 3), z(1, h, w, 1))
    inp = (z(1, h, w, 68), z(1, h, w, 1))
    return PipelineParams(
        semantics=random_params(SemanticsJ(), z(1, h // 2, w // 2, 3),
                                seed=10),
        disparity=random_params(DisparityJ(), z(1, h // 2, w // 2, 3),
                                z(1, h // 32, w // 32, 512), seed=11),
        refine=random_params(refine_j, z(1, h, w, 3),
                             z(1, h // 4, w // 4, 1), seed=12),
        context=random_params(ContextNetJ(), *ctx, seed=13),
        inpaint=random_params(inpaint_j, *inp, seed=14),
        context_depth=(random_params(ContextNetJ(), *ctx, seed=15)
                       if inpaint_depth else None),
        inpaint_depth=(random_params(inpaint_j, *inp, seed=16)
                       if inpaint_depth else None))


def _frames_both(effect_kw, model_kw, steps=3, h=64, w=64):
    """The uint8 frames of the port (CPU, its default entry points) and of
    ``kbe_tpu``'s jitted effect on its XLA specs, f32, same weights; and
    the mean SSIM between them."""
    params = _pipeline_params(h, w, **model_kw)
    image = demo_scene_image(h, w)
    dolly = effect_kw.get("dolly", False)
    flags = {k: v for k, v in model_kw.items() if k != "inpaint_depth"}

    def zoom_of(cls):
        return cls.default_dolly(w, h) if dolly else cls.default_3d(w, h)

    effect_j = EffectJ(num_steps=steps, splat_method="scatter",
                       fill_impl="xla", **effect_kw)
    fn_j = jax.jit(build_j(h, w, zoom_of(ZoomJ), CameraJ(), effect_j,
                           **flags))
    want = np.asarray(fn_j(params, jnp.asarray(image)[None]))

    models = models_from_flax(params, device="cpu", **flags)
    assert (models.inpaint_depth is not None) == model_kw.get(
        "inpaint_depth", False)
    fn = build_effect_fn(h, w, zoom_of(ZoomSettings), CameraConfig(),
                         EffectConfig(num_steps=steps, **effect_kw),
                         device="cpu", **flags)
    got = fn(models, torch.as_tensor(image)[None]).numpy()

    assert got.shape == want.shape == (steps, h, w, 3)
    assert got.dtype == np.uint8
    assert (want[0] != want[-1]).any()
    scores = [float(ssim(jnp.asarray(got[i], jnp.float32)[None] / 255.0,
                         jnp.asarray(want[i], jnp.float32)[None] / 255.0))
              for i in range(steps)]
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"frames vs JAX {effect_kw} {model_kw}: mean SSIM "
          f"{np.mean(scores):.6f}, max diff {diff.max()}, pixels differing "
          f"{np.mean(diff > 0):.4%}")
    return got, want, float(np.mean(scores))


def test_effect_frames_match_jax():
    """The default 3D effect: the port's uint8 frames equal the JAX all-spec
    f32 pipeline's bit for bit at 64^2, 3 steps."""
    got, want, score = _frames_both({}, {})
    assert score >= 0.99
    assert np.array_equal(got, want)


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
