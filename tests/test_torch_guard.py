"""Guards of the kbe_torch port: it loads neither JAX nor kbe_tpu, its entry
points run on CUDA unless asked for the CPU, and its kernel wrappers never
quietly take the plain path."""

import os
import subprocess
import sys

import numpy as np
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
            "kbe_torch.train.trainer_inpaint, kbe_torch.models.inception, "
            "kbe_torch.train.fid, kbe_torch.train.eval_inpaint, "
            "kbe_torch.train.eval_depth, kbe_torch.models.maskrcnn, "
            "kbe_torch.ops.nms, kbe_torch.parallel, "
            "kbe_torch.utils.receptive_field\n"
            "import cli.kbe_torch, cli.train_torch\n"
            "import runpy\n"
            "for ex in ('depth_estimation_torch', 'inpainting_torch'):\n"
            "    runpy.run_path(f'examples/{ex}.py', run_name='ex')\n"
            "for tool in ('make_bench_weights_torch', "
            "'fidelity_report_torch', 'bench_scene_torch', "
            "'profile_frontend_torch', 'profile_frame_torch', "
            "'dtype_sweep_torch'):\n"
            "    runpy.run_path(f'tools/{tool}.py', run_name='tool')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'kbe_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
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
    from kbe_torch.train.eval_depth import DepthEval
    from kbe_torch.train.eval_inpaint import InpaintEval
    from kbe_torch.train.fid import FID, preprocess_images
    from kbe_torch.models.maskrcnn import load_maskrcnn
    from kbe_torch.train.trainer_depth import TrainerDepth

    for make in (lambda: TrainerDepth({}, logs_path=str(tmp_path / "d")),
                 lambda: load_maskrcnn({}),
                 lambda: DepthEval({}), lambda: InpaintEval({}), FID,
                 lambda: preprocess_images(np.zeros((1, 4, 4, 3)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_trained_weights_entry_points_raise_without_a_gpu(monkeypatch,
                                                        tmp_path):
    """The bench-weights recipe and the fidelity report run on the card
    unless asked for the CPU."""
    from tools.fidelity_report_torch import fidelity_report
    from tools.make_bench_weights_torch import make_bench_weights

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_bench_weights(1, 1, 1, str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fidelity_report(32, 2, checkpoint=None)
    assert not os.listdir(tmp_path)


def test_profiler_trace_writes_a_trace(tmp_path):
    """``profiler_trace`` writes its body's trace; ``None`` traces
    nothing."""
    from kbe_torch.utils.logging import profiler_trace

    with profiler_trace(None):
        torch.ones(4).sum()
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_deterministic_training_fixes_the_cublas_workspace(monkeypatch):
    """The training CLI's deterministic mode sets cuBLAS's fixed workspace
    where CUDA has not started, refuses a workspace that is not one, and
    turns ``torch.use_deterministic_algorithms`` on and off."""
    from kbe_torch.device import deterministic_training

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    try:
        deterministic_training()
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    finally:
        deterministic_training(False)
    assert not torch.are_deterministic_algorithms_enabled()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":0:0")
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        deterministic_training()
    assert not torch.are_deterministic_algorithms_enabled()


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
    from kbe_torch.ops import nms as N

    with pytest.raises(ValueError):
        N.keep_cuda(torch.zeros(2, 8, 4), torch.zeros(2, 8), 0.5, "rpn")
