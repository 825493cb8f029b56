"""kbe_torch's inference modes and entry-point knobs on the CPU.

Each mode of the effect (dolly, 2D, pretrained refine, partial-conv
inpainting, dual net) against ``kbe_tpu``'s jitted effect on its XLA specs
(``splat_method='scatter'``, ``fill_impl='xla'``, f32) with the same
numpy-seeded weights through ``state_dict_from_flax``: mean SSIM >= 0.99,
and equality where it holds. Then the knobs that select an entry point:
every ``splat_method``, ``fill_impl`` and fill phase setting gives the
frames of ``'scatter'`` bit for bit on the CPU, where all of them run the
same plain versions, and unknown values raise.
"""

import numpy as np
import pytest
import torch

from kbe_torch.config import EffectConfig, ZoomSettings
from kbe_torch.data import demo_scene_image
from kbe_torch.pipeline.kenburns import (KenBurnsPipeline, build_effect_fn,
                                         create_models, displacement_margin)
from tests.test_torch_pipeline import _frames_both


@pytest.mark.parametrize("name,effect_kw,model_kw,exact", [
    ("dolly", {"dolly": True}, {}, slice(1, None)),
    ("two_d", {"two_d": True}, {}, slice(None)),
    ("pretrained_refine", {}, {"pretrained_refine": True}, slice(None)),
    ("partial_inpainting", {}, {"partial_inpainting": True}, slice(None)),
    ("dual_net", {}, {"inpaint_depth": True}, None),
])
def test_effect_mode_frames_match_jax(name, effect_kw, model_kw, exact):
    """Every other inference mode at 64^2, 3 steps, against ``kbe_tpu``'s
    jitted effect with the same converted weights: mean SSIM >= 0.99, and
    the frames of ``exact`` equal bit for bit.

    Measured where equality does not hold (CPU, f32): dolly's first frame
    differs in 0.6 % of its pixels, by up to 42 of 255. Its pose has no
    shift, so every point projects exactly onto the pixel lattice; XLA's
    compiled ``solve_shift`` returns x = -5.96e-8 there (the port returns
    the exact 0), which moves lattice points across ``floor(u)``. The
    dual-net frames differ by 1 of 255 in 0.005 % of the pixels: two more
    f32 nets whose convolutions sum in another order."""
    got, want, score = _frames_both(effect_kw, model_kw)
    assert score >= 0.99
    if exact is not None:
        assert np.array_equal(got[exact], want[exact])


@pytest.fixture(scope="module")
def scene32():
    h = w = 32
    return (create_models(0, device="cpu"),
            torch.as_tensor(demo_scene_image(h, w))[None],
            ZoomSettings.default_3d(w, h))


def _frames(scene32, **effect_kw):
    models, image, zoom = scene32
    effect = EffectConfig(num_steps=3, **effect_kw)
    return build_effect_fn(32, 32, zoom, effect=effect, device="cpu")(
        models, image)


@pytest.mark.parametrize("effect_kw", [
    {"splat_method": "auto"},
    {"splat_method": "banded"},
    {"splat_method": "routed"},
    {"splat_method": "routed", "splat_fallback": "scatter"},
    {"splat_method": "delta"},
    {"splat_method": "pallas", "max_pallas_margin": 64},
    {"fill_impl": "xla"},
    {"fill_march_phase1": 0},
    {"fill_phase0": 0, "fill_roi": False},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_entry_point_knobs_give_the_scatter_frames(scene32, effect_kw):
    """The posed route (shift added inside the renderer), the routes that
    ``apply_shift`` first, and every fill entry give one set of frames."""
    want = _frames(scene32, splat_method="scatter")
    assert (want[0] != want[-1]).any()
    assert torch.equal(_frames(scene32, **effect_kw), want)


def test_unknown_knobs_and_wide_pallas_moves_raise(scene32):
    with pytest.raises(ValueError, match="splat_method"):
        _frames(scene32, splat_method="mosaic")
    with pytest.raises(ValueError, match="fill_impl"):
        _frames(scene32, fill_impl="triton")
    with pytest.raises(ValueError, match="fallback"):
        _frames(scene32, splat_method="routed", splat_fallback="drop")
    # the windowed renderer keeps the TPU package's refusal of long moves
    zoom = ZoomSettings.default_3d(1024, 1024)
    effect = EffectConfig(splat_method="pallas")
    assert displacement_margin(zoom, None, effect, 1024, 1024) \
        > effect.max_pallas_margin
    with pytest.raises(ValueError, match="max_pallas_margin"):
        build_effect_fn(1024, 1024, zoom, effect=effect, device="cpu")


def test_displacement_margin_and_step_focal_match_jax():
    from kbe_tpu.config import EffectConfig as EffectJ
    from kbe_tpu.config import ZoomSettings as ZoomJ
    from kbe_tpu.pipeline import kenburns as kj
    from kbe_torch.config import CameraConfig
    from kbe_torch.pipeline import kenburns as kt

    for w, h in ((1024, 1024), (640, 360), (64, 64)):
        for kw in ({}, {"dolly": True}, {"inpaint": False}):
            make = "default_dolly" if kw.get("dolly") else "default_3d"
            zoom_t = getattr(ZoomSettings, make)(w, h)
            zoom_j = getattr(ZoomJ, make)(w, h)
            assert kt.displacement_margin(
                zoom_t, CameraConfig(), EffectConfig(**kw), w, h) \
                == kj.displacement_margin(zoom_j, None, EffectJ(**kw), w, h)
            for step in (0.0, 0.3, 1.0):
                assert kt._step_focal(step, zoom_t, CameraConfig(),
                                      bool(kw.get("dolly"))) \
                    == kj._step_focal(step, zoom_j, CameraConfig(),
                                      bool(kw.get("dolly")))


def test_pipeline_modes_and_default_zoom():
    """``KenBurnsPipeline.create`` builds every mode's nets; a dolly
    pipeline picks the dolly windows; a net of the wrong kind is refused."""
    image = demo_scene_image(32, 32)
    pipe = KenBurnsPipeline.create(
        0, effect=EffectConfig(num_steps=2, dolly=True), device="cpu",
        pretrained_refine=True, partial_inpainting=True, inpaint_depth=True)
    assert type(pipe.models.refine).__name__ == "RefinePretrained"
    assert type(pipe.models.inpaint_depth).__name__ == "PartialInpaint"
    frames = pipe(image)
    assert frames.shape == (2, 32, 32, 3) and frames.dtype == np.uint8
    assert (frames[0] != frames[-1]).any()
    plain = create_models(0, device="cpu")
    fn = build_effect_fn(32, 32, ZoomSettings.default_3d(32, 32),
                         effect=EffectConfig(num_steps=2),
                         pretrained_refine=True, device="cpu")
    with pytest.raises(ValueError, match="pretrained_refine"):
        fn(plain, torch.as_tensor(image)[None])
