"""The spec path of kbe_torch's effect: ``splat_method='scatter'`` and
``fill_impl='xla'`` name ``kbe_tpu``'s XLA specs, which run no Pallas
kernel, so the port runs them as its plain versions on every device.

On the CPU every path is plain, so the kernels' entry points are spied on
instead: ``splat._render`` (the dispatch that takes the six splat kernels
for a CUDA tensor) and ``discfill.fill_disocclusion`` (the one that takes
``fill_cuda``). The spec configuration must reach neither, in the frame
loop or in the bootstrap; the production one must reach both. The spec
path's frames equal ``kbe_tpu``'s spec path bit for bit on the same
converted weights.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbe_tpu.config import CameraConfig as CameraJ
from kbe_tpu.config import EffectConfig as EffectJ
from kbe_tpu.config import ZoomSettings as ZoomJ
from kbe_tpu.pipeline.kenburns import build_effect_fn as build_j
from kbe_torch.config import CameraConfig, EffectConfig, ZoomSettings
from kbe_torch.data import demo_scene_image
from kbe_torch.ops import discfill as D
from kbe_torch.ops import splat as S
from kbe_torch.pipeline import inpaint_flow as F
from kbe_torch.pipeline import kenburns as K
from tests.test_torch_pipeline import _pipeline_params

SIZE, STEPS = 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for this file's convolutions: the Tier-1 run's other
    workers use the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPEC = dict(splat_method="scatter", fill_impl="xla")


@pytest.fixture(scope="module")
def scene():
    """(models, image, zoom, the spec configuration's frames)."""
    models = K.create_models(0, device="cpu")
    image = torch.as_tensor(demo_scene_image(SIZE, SIZE))[None]
    zoom = ZoomSettings.default_3d(SIZE, SIZE)
    spec = K.build_effect_fn(SIZE, SIZE, zoom, effect=EffectConfig(
        num_steps=STEPS, **SPEC), device="cpu")(models, image)
    return models, image, zoom, spec


@pytest.fixture
def reached(monkeypatch):
    """A counter of the kernels' entry points reached: ``("splat", C)`` a
    ``_render`` of a C-channel payload, ``"fill"`` a
    ``fill_disocclusion``. A module that holds an entry point under its own
    name is spied on there too."""
    calls = collections.Counter()
    render, fill = S._render, D.fill_disocclusion

    def spy_render(xyz, payload, *args):
        calls["splat", payload.shape[1]] += 1
        return render(xyz, payload, *args)

    def spy_fill(*args, **kwargs):
        calls["fill"] += 1
        return fill(*args, **kwargs)

    monkeypatch.setattr(S, "_render", spy_render)
    for module in (D, K, F):
        if hasattr(module, "fill_disocclusion"):
            monkeypatch.setattr(module, "fill_disocclusion", spy_fill)
    return calls


@pytest.mark.parametrize("splat_method,fill_impl,want", [
    ("scatter", "xla", {}),
    ("auto", "pallas", {("splat", 68): 2, ("splat", 4): STEPS,
                        "fill": STEPS}),
    ("scatter", "pallas", {"fill": STEPS}),
    ("auto", "xla", {("splat", 68): 2, ("splat", 4): STEPS}),
], ids=["spec", "production", "scatter+pallas", "auto+xla"])
def test_spec_configuration_reaches_no_kernel_entry_point(
        scene, reached, splat_method, fill_impl, want):
    """The frame loop's and the bootstrap's renders, and the fills, that
    reach the kernels' dispatch: none for the spec configuration (the
    plain passes and ``fill_plain``), two bootstrap renders at C = 68, a
    render at C = 4 and a fill a frame for the production one, and each
    knob moves only its own part. The frames are equal throughout: on the
    CPU every path is plain."""
    models, image, zoom, spec = scene
    effect = EffectConfig(num_steps=STEPS, splat_method=splat_method,
                          fill_impl=fill_impl)
    frames = K.build_effect_fn(SIZE, SIZE, zoom, effect=effect,
                               device="cpu")(models, image)
    assert dict(reached) == want
    assert torch.equal(frames, spec)


def test_ops_entry_points_keep_the_kernels(reached):
    """``render_pointcloud`` still takes the kernels' dispatch (view C,
    view synthesis and the G loss render through it on the card), and
    ``pointcloud_inpainting`` reaches it for every renderer but
    ``'scatter'``; ``render_pointcloud_plain`` gives its render bit for
    bit."""
    g = torch.Generator().manual_seed(0)
    h = w = 16
    xyz = torch.stack([torch.rand(1, h * w, generator=g) * 20 - 10,
                       torch.rand(1, h * w, generator=g) * 20 - 10,
                       torch.rand(1, h * w, generator=g) * 50 + 50], -1)
    data = torch.rand(1, h * w, 5, generator=g)
    valid = (torch.rand(1, h * w, generator=g) > 0.2).float()
    want = S.render_pointcloud(xyz, data, h, w, 32.0, 10.0, valid=valid)
    assert dict(reached) == {("splat", 5): 1}
    reached.clear()
    got = S.render_pointcloud_plain(xyz, data, h, w, 32.0, 10.0,
                                    valid=valid)
    assert not reached
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    image = torch.rand(1, h, w, 3, generator=g)
    disparity = 20.0 + 60.0 * torch.rand(1, h, w, 1, generator=g)
    flow = F.InpaintModels(
        context=lambda a, b: torch.zeros(1, h, w, 64),
        net=lambda d, m: (d[..., :3], d[..., 3:4], m))
    out = {}
    for method in F.SPLAT_METHODS:
        reached.clear()
        out[method] = F.pointcloud_inpainting(
            flow, image, disparity, torch.tensor([3.0, -2.0, 1.0]),
            CameraConfig(), 32.0, splat_method=method)
        assert dict(reached) == ({} if method == "scatter"
                                 else {("splat", 68): 1})
    for method in ("banded", "routed"):
        for key, value in out[method].items():
            assert torch.equal(value, out["scatter"][key]), (method, key)


def test_spec_frames_equal_jax_spec_frames():
    """The port's spec configuration against ``kbe_tpu``'s jitted spec
    path (the XLA scatter and the XLA fill, f32) on the same converted
    weights, at 32^2, 2 steps: equal uint8 frames, bit for bit."""
    h = w = SIZE
    steps = STEPS
    params = _pipeline_params(h, w)
    image = demo_scene_image(h, w)
    fn_j = jax.jit(build_j(h, w, ZoomJ.default_3d(w, h), CameraJ(),
                           EffectJ(num_steps=steps, **SPEC)))
    want = np.asarray(fn_j(params, jnp.asarray(image)[None]))

    models = K.models_from_flax(params, device="cpu")
    fn = K.build_effect_fn(h, w, ZoomSettings.default_3d(w, h),
                           CameraConfig(),
                           EffectConfig(num_steps=steps, **SPEC),
                           device="cpu")
    got = fn(models, torch.as_tensor(image)[None]).numpy()
    assert got.shape == want.shape == (steps, h, w, 3)
    assert (want[0] != want[-1]).any()
    np.testing.assert_array_equal(got, want)
