"""The port's layer tools on the CPU, at 32^2 and 2 steps with seeded random
full-width weights: ``tools/bench_scene_torch.py``,
``tools/profile_frontend_torch.py``, ``tools/profile_frame_torch.py``,
``tools/dtype_sweep_torch.py`` and the repaired spec row of
``tools/fidelity_report_torch.py``.

The front-end stages must give ``fn.front_end``'s state bit for bit, and
the frame stages ``fn.render_frames``' frames, or they would time other
work than the pipeline's. On the CPU every path is plain, so the sweep's
``all_f32`` row is the spec's frames. The device columns are null here;
the card fills them (``chip_smoke.py`` (z)).
"""

import pytest
import torch

from kbe_torch.config import EffectConfig
from tools import bench_scene_torch as B
from tools import dtype_sweep_torch as W
from tools import fidelity_report_torch as R
from tools import profile_frame_torch as P
from tools import profile_frontend_torch as T

SIZE, STEPS = 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for this file's convolutions: the Tier-1 run's other
    workers use the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return B.bench_scene(SIZE, STEPS, None, device="cpu")


def _assert_states_equal(got, want):
    for name in got.scene._fields:
        assert torch.equal(getattr(got.scene, name),
                           getattr(want.scene, name)), name
    assert torch.equal(got.cloud_xyz, want.cloud_xyz)
    assert torch.equal(got.poses, want.poses)


def test_bench_scene_says_which_weights(scene):
    """Seeded random weights when there is no checkpoint, the production
    mix, the demo scene and the effect's front-end state."""
    assert scene["checkpoint"] is None
    assert "seeded random" in scene["weights"]
    assert scene["mix"] == B.PRODUCTION == "depth_f32"
    models = scene["models"]
    for net, dtype in ((models.semantics, torch.float32),
                       (models.refine, torch.float32),
                       (models.context, torch.bfloat16),
                       (models.inpaint, torch.bfloat16)):
        assert next(net.parameters()).dtype == dtype
    assert scene["image"].shape == (1, SIZE, SIZE, 3)
    assert scene["state"].poses.shape == (STEPS, 5)
    assert B.timeit(lambda: None, scene["device"], reps=2) >= 0.0


def test_front_end_stages_reproduce_the_front_end(scene):
    """The tool's chain of stages gives ``fn.front_end``'s state bit for
    bit, its rows name every stage in the pipeline's order, and the CPU
    launches no hand-written kernel."""
    report = T.profile_frontend(scene=scene, reps=1)
    _assert_states_equal(report["state"], scene["state"])
    names = [r["stage"] for r in report["stages"]]
    step = ["inputs", "context", "splat68", "median", "inpaint",
            "unproject"]
    assert names == (["resize_to_max", "semantics", "disparity", "refine",
                      "depth_grid"] + [f"step{k}/{s}" for k in (0, 1)
                                       for s in step] + ["prepare_scene"])
    assert all(r["host_ms"] > 0.0 and r["device_ms"] is None
               and r["kernels"] == {} for r in report["stages"])
    assert report["sum_host_ms"] == pytest.approx(
        sum(r["host_ms"] for r in report["stages"]))
    assert report["sum_over_front_end"] == pytest.approx(
        report["sum_host_ms"] / report["front_end_ms"])


def test_front_end_stages_refuse_other_front_ends(scene):
    """Dolly skips the bootstrap: the chain follows the default effect
    only."""
    dolly = dict(scene, effect=EffectConfig(num_steps=STEPS, dolly=True))
    with pytest.raises(ValueError, match="default effect"):
        T.front_end_stages(dolly)


def test_frame_stages_compose_to_render_frames(scene):
    """The frame tool's stages, run over every pose on the outputs of the
    stage before, give ``fn.render_frames``' frames bit for bit; the
    middle pose's fill and dolly's (c2) count their holes in the ROI."""
    report = P.profile_frame(scene=scene, reps=1)
    with torch.inference_mode():
        want = scene["fn"].render_frames(scene["state"])
    assert torch.equal(report["frames"], want)
    assert [r["stage"] for r in report["stages"]] == [
        "splat", "fill", "quantise", "crop", "resize", "round", "stack",
        "wait"]
    assert report["poses"] == STEPS
    for key in ("fill_middle_pose", "fill_dolly_c2"):
        fill = report[key]
        y0, y1, x0, x1 = fill["roi"]
        assert 0 < fill["hole_pixels_in_roi"] <= (y1 - y0) * (x1 - x0)
        assert fill["frame"]["host_ms"] > 0.0
        assert "ray_steps" not in fill["frame"]   # the kernel's counters
    assert report["sum_over_render_frames"] == pytest.approx(
        report["sum_host_ms_a_frame"] / report["render_frames_ms_a_frame"])


def test_dtype_sweep_reads_one_for_all_f32_on_the_cpu():
    """On the CPU every path is plain: ``all_f32`` gives the spec's frames
    (SSIM 1.0, largest difference 0); the bf16 rows read below it."""
    report = W.dtype_sweep(SIZE, STEPS, None, device="cpu",
                           log=lambda *a: None)
    rows = {r["config"]: r for r in report["rows"]}
    assert list(rows) == ["all_bf16", "depth_f32", "all_f32"]
    assert rows["all_f32"]["mean_ssim"] == rows["all_f32"]["min_ssim"] == 1.0
    assert rows["all_f32"]["max_abs_diff_uint8"] == 0
    assert rows["all_f32"]["per_frame_ssim"] == [1.0] * STEPS
    for row in rows.values():
        assert row["front_end_ms"] > 0.0 and row["pose_loop_ms_a_frame"] > 0
    assert rows["all_bf16"]["mean_ssim"] < 1.0
    assert "overflow" not in rows["depth_f32"]


def test_fidelity_report_spec_row_launches_no_kernel():
    """The repaired report runs its spec twice and records that it
    launched no hand-written kernel; on the CPU the two runs are equal
    and the kernels' row with f32 nets reads 1.0."""
    report = R.fidelity_report(SIZE, STEPS, checkpoint=None, device="cpu",
                               log=lambda *a: None)
    assert report["spec_kernel_launches"] == {}
    assert report["spec_runs_equal"] is True
    assert report["spec_runs"]["max_abs_diff_uint8"] == 0.0
    assert report["kernels_f32_path"]["mean_ssim"] == 1.0
    assert "seeded random" in report["scene"]


@pytest.mark.parametrize("call", [
    lambda: B.bench_scene(SIZE, STEPS, None),
    lambda: T.profile_frontend(SIZE, STEPS, None),
    lambda: P.profile_frame(SIZE, STEPS, None),
    lambda: W.dtype_sweep(SIZE, STEPS, None, log=lambda *a: None),
], ids=["bench_scene", "profile_frontend", "profile_frame", "dtype_sweep"])
def test_tools_raise_without_a_gpu(monkeypatch, call):
    """Each tool runs on the card unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
