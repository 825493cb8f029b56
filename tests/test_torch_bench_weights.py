"""The trained-weights path of the port on the CPU: the pipeline checkpoint
(``save_pipeline``, ``load_pipeline_params``, ``find_bench_weights``),
``KenBurnsPipeline.create(checkpoint=...)`` and ``cli/kbe_torch.py
--checkpoint``, ``load_pretrained_params`` on the port's own checkpoints,
the bench-weights recipe (``tools/make_bench_weights_torch.py``) at a tiny
schedule, and the fidelity report (``tools/fidelity_report_torch.py``).

The pipeline checkpoint's nets come from a ``kbe_tpu`` ``PipelineParams``
filled with seeded numpy draws, through ``models_from_flax``, whose frames
``tests/test_torch_pipeline.py`` holds to ``kbe_tpu``'s; here the loaded
nets must equal the in-memory ones entry for entry and render the same
frames bit for bit. The recipe's constants are held to
``tools/make_bench_weights.py``'s, read with ``ast``.
"""

import argparse
import ast
import math
import os
import pickle

import numpy as np
import pytest
import torch

import cli.train_torch as T
from cli import kbe_torch as cli_t
from kbe_torch.config import CameraConfig, EffectConfig, ZoomSettings
from kbe_torch.data import demo_scene_image
from kbe_torch.pipeline.kenburns import (KenBurnsPipeline, build_effect_fn,
                                         models_from_flax)
from kbe_torch.train.checkpoint import (find_bench_weights,
                                        latest_checkpoint,
                                        load_pipeline_params,
                                        load_pretrained_params,
                                        save_checkpoint, save_pipeline)
from kbe_torch.train.trainer_depth import TrainerDepth
from kbe_torch.utils import reference_convert as rc
from tests.test_torch_pipeline import _pipeline_params
from tests.test_torch_reference_convert import _assert_trees_equal, \
    _refine_sd
from tests.test_torch_train_cli import _argv, _narrow_depth
from tools import fidelity_report_torch as F
from tools import make_bench_weights_torch as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for this file's convolutions: the Tier-1 run's other
    workers use the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(flax trees, in-memory models, pipeline checkpoint path)."""
    params = _pipeline_params(64, 64)
    models = models_from_flax(params, device="cpu")
    path = save_pipeline(str(tmp_path_factory.mktemp("pipe")), models, 7)
    return params, models, path


def _frames(models, size=64, steps=3):
    fn = build_effect_fn(size, size, ZoomSettings.default_3d(size, size),
                         effect=EffectConfig(num_steps=steps), device="cpu")
    return fn(models, torch.as_tensor(demo_scene_image(size, size))[None])


def test_pipeline_checkpoint_round_trip(saved):
    """Every state-dict entry of the loaded nets equals the in-memory
    nets', and the 64^2 frames are equal bit for bit."""
    _, models, path = saved
    assert path.endswith("pipeline-7.tar")
    loaded = load_pipeline_params(path, device="cpu")
    assert loaded.context_depth is None and loaded.inpaint_depth is None
    for name, want, got in zip(models._fields, models, loaded):
        if want is None:
            continue
        sd_w, sd_g = want.state_dict(), got.state_dict()
        assert sd_w.keys() == sd_g.keys(), name
        for k in sd_w:
            assert torch.equal(sd_w[k], sd_g[k]), (name, k)
    want = _frames(models)
    assert (want[0] != want[-1]).any()
    assert torch.equal(_frames(loaded), want)


def test_pipeline_checkpoint_places_the_production_mix(saved):
    """The production mix as ``create_models`` places it: f32 depth nets,
    bf16 inpainting nets; the file itself holds f32 whatever it was saved
    from."""
    _, _, path = saved
    mixed = load_pipeline_params(path, device="cpu", dtype=torch.bfloat16,
                                 depth_dtype=torch.float32)
    for name, net in zip(mixed._fields[:5], mixed):
        want = torch.bfloat16 if name in ("context", "inpaint") \
            else torch.float32
        assert {p.dtype for p in net.parameters()} == {want}, name
    again = save_pipeline(os.path.dirname(path) + "_bf16", mixed, 1)
    nets = torch.load(again, weights_only=True)["pipeline"]
    assert {v.dtype for sd in nets.values() for v in sd.values()} \
        == {torch.float32}


def test_pipeline_checkpoint_refuses_what_does_not_fit(saved, tmp_path):
    """A missing or extra net, a shape that differs, a checkpoint of the
    wrong kind and an orbax directory raise."""
    _, _, path = saved
    blob = torch.load(path, weights_only=True)

    def variant(name, change):
        nets = {k: dict(v) for k, v in blob["pipeline"].items()}
        change(nets)
        out = str(tmp_path / f"{name}.tar")
        torch.save({"pipeline": nets, "step": 0}, out)
        return out

    missing = variant("missing", lambda n: n.pop("refine"))
    extra = variant("extra", lambda n: n.update(
        context_depth=n["context"], inpaint_depth=n["inpaint"],
        spare=n["context"]))
    key = "conv1.weight"

    def reshape(n):
        n["context"][key] = n["context"][key][:1]

    with pytest.raises(ValueError, match="missing nets \\['refine'\\]"):
        load_pipeline_params(missing, device="cpu")
    with pytest.raises(ValueError, match="extra nets \\['spare'\\]"):
        load_pipeline_params(extra, device="cpu")
    with pytest.raises(ValueError, match="missing nets \\['context_depth'"):
        load_pipeline_params(path, device="cpu", inpaint_depth=True)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_pipeline_params(variant("shape", reshape), device="cpu")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_pipeline_params(path, device="cpu", pretrained_refine=True)
    trainer_ck = str(tmp_path / "3dkbe-0.tar")
    torch.save({"state": [], "step": 0}, trainer_ck)
    with pytest.raises(ValueError, match="not a pipeline checkpoint"):
        load_pipeline_params(trainer_ck, device="cpu")
    for load in (lambda p: load_pipeline_params(p, device="cpu"),
                 lambda p: load_pretrained_params(p, "disparity")):
        with pytest.raises(NotImplementedError, match="JAX"):
            load(str(tmp_path))


def test_find_bench_weights(tmp_path, monkeypatch):
    """``KBE_BENCH_WEIGHTS`` first ('', '0' and 'none' mean random
    weights), then the highest-step ``pipeline-*.tar`` of
    ``.bench_weights``; ``kbe_tpu``'s orbax directories are not read."""
    bw = tmp_path / ".bench_weights"
    bw.mkdir()
    monkeypatch.delenv("KBE_BENCH_WEIGHTS", raising=False)
    assert find_bench_weights(str(tmp_path)) is None
    (bw / "pipeline-750").mkdir()       # an orbax checkpoint of kbe_tpu
    assert find_bench_weights(str(tmp_path)) is None
    for step in (3, 750, 20):
        (bw / f"pipeline-{step}.tar").write_bytes(b"")
    (bw / "pipeline-9000").mkdir()
    (bw / "other-9000.tar").write_bytes(b"")
    assert find_bench_weights(str(tmp_path)) == str(bw / "pipeline-750.tar")
    for value in ("", "0", "none"):
        monkeypatch.setenv("KBE_BENCH_WEIGHTS", value)
        assert find_bench_weights(str(tmp_path)) is None
    monkeypatch.setenv("KBE_BENCH_WEIGHTS", "/elsewhere/pipeline-1.tar")
    assert find_bench_weights(str(tmp_path)) == "/elsewhere/pipeline-1.tar"
    monkeypatch.delenv("KBE_BENCH_WEIGHTS")
    assert find_bench_weights() == latest_checkpoint(
        os.path.join(REPO, ".bench_weights"), "pipeline")


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cli_renders_a_pipeline_checkpoint(saved, bf16):
    """``run --checkpoint <tar>`` at 32^2 gives the frames of the same
    models in memory, in the precision mix ``--bf16`` picks."""
    params, _, path = saved
    image = (demo_scene_image(32, 32) * 255.0).astype(np.uint8)
    args = cli_t.build_parser().parse_args(
        ["--checkpoint", path, "--steps", "2", "--device", "cpu"]
        + (["--bf16"] if bf16 else []))
    got = cli_t.run(args, image)
    mix = dict(dtype=torch.bfloat16, depth_dtype=torch.float32) if bf16 \
        else {}
    pipe = KenBurnsPipeline(
        camera=CameraConfig(), effect=EffectConfig(num_steps=2),
        models=models_from_flax(params, device="cpu", **mix),
        device=torch.device("cpu"))
    want = pipe(image.astype(np.float32) / 255.0)
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(got, want)


def test_load_pretrained_params_takes_the_ports_checkpoints(tmp_path,
                                                            monkeypatch):
    """A 1-step estimation run of the training CLI writes a checkpoint
    whose disparity net warm-starts a refinement trainer exactly, and the
    CLI's refinement takes it as ``--model-path``; a ``(disparity,
    refine)`` pair gives each net; a reference ``.tar`` still goes through
    ``reference_convert``."""
    _narrow_depth(monkeypatch)
    assert T.main(_argv("estimation", tmp_path / "est", 1)) == 0
    ck = latest_checkpoint(str(tmp_path / "est" / "ck"), "3dkbe")
    saved_net = torch.load(ck, weights_only=True)["state"][0]["net"]
    loaded = load_pretrained_params(ck, "disparity")
    rows = (8, 12, 16, 32, 32, 32)
    trainer = TrainerDepth({"disparity_rows": rows}, device="cpu",
                           logs_path=str(tmp_path / "runs"))
    dstate, rstate = trainer.init_state((32, 1024), "refine",
                                        disparity_params=loaded)
    got = dstate.net.state_dict()
    assert got.keys() == saved_net.keys()
    assert all(torch.equal(got[k], saved_net[k]) for k in got)
    assert T.main(_argv("refinement", tmp_path / "ref", 1, "--model-path",
                        ck)) == 0

    pair = save_checkpoint(str(tmp_path / "pair"), "pair", (dstate, rstate),
                           3)
    for kind, state in (("disparity", dstate), ("refine", rstate)):
        sd = load_pretrained_params(pair, kind)
        want = state.net.state_dict()
        assert sd.keys() == want.keys()
        assert all(torch.equal(sd[k], want[k]) for k in want)

    ref = str(tmp_path / "refine_ref.tar")
    torch.save({"nb_iter": 7, "model_state_dict": {
        k: torch.as_tensor(v) for k, v in _refine_sd().items()}}, ref)
    _assert_trees_equal(load_pretrained_params(ref, "refine"),
                        rc.convert_refine(ref))
    with pytest.raises(ValueError, match="unknown kind"):
        load_pretrained_params(ref, "semantics")


def test_load_pretrained_params_unpickles_only_reference_files(tmp_path):
    """A reference ``.tar`` that the restricted unpickler refuses (numpy
    arrays beside an ``argparse`` namespace, as released files hold) goes on
    to ``reference_convert``; the port's own checkpoints never need the full
    unpickler."""
    ref = str(tmp_path / "refine_ref.tar")
    torch.save({"args": argparse.Namespace(lr=1e-4), "nb_iter": 7,
                "model_state_dict": _refine_sd()}, ref)
    with pytest.raises(pickle.UnpicklingError):
        torch.load(ref, weights_only=True)
    _assert_trees_equal(load_pretrained_params(ref, "refine"),
                        rc.convert_refine(ref))


def _jax_recipe():
    """The constants of ``tools/make_bench_weights.py``'s recipe, read
    with ``ast``: the trainers' hyper-parameter dicts and cameras, each
    stage's (batch, size, mode, seed, camera) and the step defaults."""
    tree = ast.parse(open(os.path.join(REPO, "tools",
                                       "make_bench_weights.py")).read())
    names, calls, steps = {}, {}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if isinstance(target, ast.Tuple) and isinstance(node.value,
                                                            ast.Tuple):
                for t, v in zip(target.elts, node.value.elts):
                    names[t.id] = ast.literal_eval(v)
            elif isinstance(target, ast.Name) and isinstance(
                    node.value, ast.Call) and getattr(
                    node.value.func, "id", None) == "CameraConfig":
                names[target.id] = tuple(ast.literal_eval(a)
                                         for a in node.value.args)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            calls.setdefault(node.func.id, []).append(node)
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == "get" \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value.startswith("KBE_BW_STEPS_"):
            steps[node.args[0].value] = int(node.args[1].value)

    def kw(call, name):
        return next(k.value for k in call.keywords if k.arg == name)

    stages = []
    for call in calls["synthetic_batches"]:
        batch = ast.literal_eval(call.args[0])
        size = (names[call.args[1].id], names[call.args[2].id])
        cam = kw(call, "camera").id
        stages.append((batch, size, ast.literal_eval(kw(call, "mode")),
                       ast.literal_eval(kw(call, "seed")), cam))
    depth = calls["TrainerDepth"][0]
    inpaint = calls["TrainerInpaint"][0]
    return {"depth_hparams": ast.literal_eval(depth.args[0]),
            "inpaint_hparams": ast.literal_eval(inpaint.args[0]),
            "inpaint_camera": kw(inpaint, "camera").id,
            "camera": names["camera"], "stages": stages, "steps": steps}


def test_recipe_constants_are_kbe_tpus():
    from kbe_tpu.train.trainer_inpaint import TRAIN_CAMERA as CAM_J
    from kbe_torch.train.trainer_inpaint import TRAIN_CAMERA

    want = _jax_recipe()
    assert M.DEPTH_HPARAMS == want["depth_hparams"]
    assert M.INPAINT_HPARAMS == want["inpaint_hparams"]
    assert M.DEPTH_CAMERA == want["camera"]
    assert want["inpaint_camera"] == "TRAIN_CAMERA"
    assert (TRAIN_CAMERA.focal, TRAIN_CAMERA.baseline) \
        == (CAM_J.focal, CAM_J.baseline)
    got = [(M.STAGES[s][0], M.SIZES[s], M.STAGES[s][1], M.STAGES[s][2],
            "TRAIN_CAMERA" if s == "inpaint" else "camera")
           for s in ("depth", "refine", "inpaint")]
    assert got == want["stages"]
    assert want["steps"] == {"KBE_BW_STEPS_DEPTH": 300,
                             "KBE_BW_STEPS_REFINE": 150,
                             "KBE_BW_STEPS_INPAINT": 300}
    defaults = M.make_bench_weights.__defaults__[:3]
    assert defaults == (300, 150, 300)


def test_recipe_at_a_tiny_schedule(tmp_path, monkeypatch):
    """One step a stage at the trainer tests' sizes: finite losses, nets
    moved from their seeded start (the saved ``Semantics`` the frozen one
    of the disparity stage), and a checkpoint that loads and renders."""
    from kbe_torch.train.trainer_inpaint import TrainerInpaint

    start = {}

    def spy(cls, take):
        init = cls.init_state

        def init_state(self, *args, **kwargs):
            out = init(self, *args, **kwargs)
            for name, net in take(self, out):
                start[name] = {k: v.clone()
                               for k, v in net.state_dict().items()}
            return out

        monkeypatch.setattr(cls, "init_state", init_state)

    spy(TrainerDepth, lambda t, s: (("semantics", t.semantics),
                                    ("disparity", s[0].net),
                                    ("refine", s[1].net)))
    spy(TrainerInpaint, lambda t, s: (("context", s.context),
                                      ("inpaint", s.net)))
    sizes = {"depth": (16, 128), "refine": (32, 1024), "inpaint": (48, 64)}
    path, report = M.make_bench_weights(1, 1, 1, str(tmp_path), "cpu",
                                        sizes, log=lambda *a: None)
    assert path == str(tmp_path / "pipeline-3.tar")
    for stage in report.values():
        assert stage["steps"] == 1
        assert all(math.isfinite(v) for v in stage["losses"])
    loaded = load_pipeline_params(path, device="cpu")
    for name, net in zip(loaded._fields[:5], loaded):
        sd = net.state_dict()
        moved = [not torch.equal(sd[k], v) for k, v in start[name].items()]
        assert any(moved) == (name != "semantics"), name
    frames = _frames(loaded, size=32, steps=2)
    assert frames.shape == (2, 32, 32, 3)
    assert (frames[0] != frames[1]).any()


def test_fidelity_report_on_the_cpu(saved):
    """The report's fields at 32^2, 3 steps; the production kernels with
    f32 nets give the spec path's frames on the CPU, SSIM 1.0."""
    _, _, path = saved
    report = F.fidelity_report(32, 3, checkpoint=path, device="cpu",
                               log=lambda *a: None)
    for key in ("mean_ssim", "min_ssim", "argmin_ssim_frame",
                "max_abs_diff_uint8", "max_abs_diff_at",
                "mean_abs_diff_uint8", "abs_diff_p999_uint8",
                "pixels_diff_gt32_per_frame", "pixels_diff_gt8_per_frame",
                "per_frame_ssim", "scene", "wall_s", "production_stats"):
        assert key in report, key
    assert "pipeline-7.tar" in report["scene"] and report["device"] == "cpu"
    stats = report["production_stats"]
    assert stats["points"] == 3 * 32 * 32
    assert stats["valid_points"] == sum(stats["valid_points_per_grid"])
    assert stats["valid_share_per_grid"][0] == 1.0
    assert 0 < stats["hole_pixels_a_frame"] <= stats["hole_pixels_max_frame"]
    kern = report["kernels_f32_path"]
    assert kern["mean_ssim"] == kern["min_ssim"] == 1.0
    assert kern["max_abs_diff_uint8"] == 0.0
    frames = np.random.default_rng(0).integers(0, 255, (2, 16, 16, 3))
    same = F.compare(frames.astype(np.uint8), frames.astype(np.uint8))
    assert same["mean_ssim"] == 1.0 and same["per_frame_ssim"] == [1.0, 1.0]
