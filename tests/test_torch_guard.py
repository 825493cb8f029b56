"""Guards of the kbe_torch port: it loads neither JAX nor kbe_tpu, its entry
points run on CUDA unless asked for the CPU, and its kernel wrappers never
quietly take the plain path."""

import subprocess
import sys

import pytest
import torch

from kbe_torch import EffectConfig, ZoomSettings
from kbe_torch.ops import discfill as D
from kbe_torch.ops import splat as S


def test_port_imports_no_jax_and_no_kbe_tpu():
    code = ("import sys, kbe_torch, kbe_torch.pipeline, kbe_torch.data, "
            "kbe_torch.utils.convert, kbe_torch.ops.image_ops, "
            "kbe_torch.pipeline.autozoom, kbe_torch.pipeline.scene, "
            "kbe_torch.pipeline.video, kbe_torch.ops.splat_routed, "
            "kbe_torch.ops.splat_banded, kbe_torch.ops.legacy, "
            "kbe_torch.models.partial_conv, "
            "kbe_torch.utils.reference_convert, kbe_torch.ops.visibility, "
            "kbe_torch.models.vgg, kbe_torch.models.discriminator, "
            "kbe_torch.models.init, kbe_torch.utils.logging, "
            "kbe_torch.train, kbe_torch.train.data, "
            "kbe_torch.train.losses, kbe_torch.train.metrics, "
            "kbe_torch.train.view_synthesis, kbe_torch.train.checkpoint, "
            "kbe_torch.train.trainer_depth, "
            "kbe_torch.train.trainer_inpaint\n"
            "import cli.kbe_torch, cli.train_torch\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'kbe_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_raises_without_a_gpu(monkeypatch, tmp_path):
    from kbe_torch.pipeline import KenBurnsPipeline, build_effect_fn
    from kbe_torch.train.trainer_inpaint import TrainerInpaint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KenBurnsPipeline.create(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_effect_fn(64, 64, ZoomSettings.default_3d(64, 64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainerInpaint({}, logs_path=str(tmp_path / "runs"))


def test_unsupported_effects_raise():
    """What the port still refuses is what ``kbe_tpu`` refuses: an unknown
    renderer or fill name, a ``'pallas'`` move beyond its margin, and an
    image whose sides are not multiples of 4. No mode that ``kbe_tpu``
    supports raises ``NotImplementedError``."""
    from kbe_torch.pipeline import build_effect_fn

    zoom = ZoomSettings.default_3d(64, 64)
    for effect in (EffectConfig(splat_method="mosaic"),
                   EffectConfig(fill_impl="cuda"),
                   EffectConfig(splat_method="pallas", max_pallas_margin=4)):
        with pytest.raises(ValueError):
            build_effect_fn(64, 64, zoom, effect=effect, device="cpu")
    with pytest.raises(ValueError):
        build_effect_fn(66, 64, zoom, device="cpu")


@pytest.mark.parametrize("effect_kw,model_kw", [
    ({"dolly": True}, {}),
    ({"two_d": True}, {}),
    ({}, {"pretrained_refine": True}),
    ({}, {"partial_inpainting": True}),
    ({}, {"inpaint_depth": True}),
], ids=["dolly", "two_d", "pretrained_refine", "partial_inpainting",
        "inpaint_depth"])
def test_every_inference_mode_runs_on_the_cpu(effect_kw, model_kw):
    """The modes that the first slice of the port refused."""
    from kbe_torch.data import demo_scene_image
    from kbe_torch.pipeline import KenBurnsPipeline

    pipe = KenBurnsPipeline.create(
        0, effect=EffectConfig(num_steps=2, **effect_kw), device="cpu",
        **model_kw)
    frames = pipe(demo_scene_image(32, 32))
    assert frames.shape == (2, 32, 32, 3)
    assert (frames[0] != frames[1]).any()


def test_kernel_wrappers_refuse_cpu_tensors():
    xyz = torch.zeros(8, 3)
    with pytest.raises(ValueError):
        S.front_cuda(xyz, torch.ones(8), torch.zeros(5), 4, 4, 4)
    with pytest.raises(ValueError):
        S.grad_cuda(xyz, None, torch.zeros(5), torch.zeros(4, 4),
                    torch.zeros(16), torch.zeros(16, 4), 4, 4)
    with pytest.raises(ValueError):
        D.fill_cuda(torch.zeros(4, 4, 4), torch.zeros(4, 4, 1), 16)
