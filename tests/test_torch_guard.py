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
            "kbe_torch.utils.convert, kbe_torch.ops.image_ops\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'kbe_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_raises_without_a_gpu(monkeypatch):
    from kbe_torch.pipeline import KenBurnsPipeline, build_effect_fn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KenBurnsPipeline.create(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_effect_fn(64, 64, ZoomSettings.default_3d(64, 64))


def test_unsupported_effects_raise():
    from kbe_torch.pipeline import build_effect_fn

    zoom = ZoomSettings.default_3d(64, 64)
    for effect in (EffectConfig(dolly=True), EffectConfig(two_d=True)):
        with pytest.raises(NotImplementedError):
            build_effect_fn(64, 64, zoom, effect=effect, device="cpu")
    with pytest.raises(NotImplementedError):
        build_effect_fn(64, 64, zoom, pretrained_refine=True, device="cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    xyz = torch.zeros(8, 3)
    with pytest.raises(ValueError):
        S.zee_cuda(xyz, torch.ones(8), torch.zeros(5), 4, 4, 4)
    with pytest.raises(ValueError):
        D.fill_cuda(torch.zeros(4, 4, 4), torch.zeros(4, 4, 1), 16)
