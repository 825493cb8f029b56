"""The harness: its manifest and files, its refusal to run without a card,
and a whole run on the CPU at a tiny size, sound and with the timed path
broken underneath, with the default nets and with a configuration whose
``models`` names the residual refine, the partial-conv inpainting net and
the dual colour/depth pair. The ``gpu`` test runs a cell on the card."""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, judge, program

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ALL_CELLS = ("kbe3d.square-1024", "dolly.square-1024", "kbe3d.photos-mixed")
ALL_NETS = {"pretrained_refine": True, "partial_inpainting": True,
            "inpaint_depth": True}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_manifest_names_units_and_files(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert [w["name"] for w in manifest["workloads"]] == list(ALL_CELLS)
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    for c in manifest["configs"]:
        assert NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
    for w in manifest["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        cell = harness.load_cell(manifest, w["name"])
        assert cell["mix"]["shapes"] and cell["checks"]["limits"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in manifest["end_to_end"])


def test_each_per_layer_metric_moves_a_metric_its_cells_report(manifest):
    for m in manifest["per_layer"]:
        moved = next(e for e in manifest["end_to_end"]
                     if e["name"] == m["moves"])
        for cell in m.get("workloads", ALL_CELLS):
            assert "workloads" not in moved or cell in moved["workloads"]
    for cell in ALL_CELLS:
        e2e = [m["name"] for m in harness.metrics_of(manifest, cell, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(manifest, cell, True)


def test_every_metric_file_returns_nothing_from_an_empty_record(manifest):
    record = {"window": {"videos": [], "seconds": 0.0}, "setup_s": 1.0,
              "config": {}}
    for m in manifest["per_layer"]:
        assert harness.read_metric(m["name"], record) is None, m["name"]


def test_run_without_a_card_exits_nonzero_and_prints_nothing(tmp_path):
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "kbe3d.square-1024", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def _tiny(manifest, workload, models=None):
    """The cell at 3 poses and 64 px, comparing 2 videos; with ``models``,
    a temporary configuration that names those nets."""
    cell = harness.load_cell(manifest, workload)
    cell["config_data"]["effect"]["num_steps"] = 3
    if models is not None:
        cell["config_data"]["models"] = dict(models)
    cell["mix"] = dict(cell["mix"],
                       shapes=[[64, 64], [48, 64]][:len(cell["mix"]
                                                        ["shapes"])])
    cell["checks"] = dict(cell["checks"], compare=2)
    return cell


@pytest.fixture
def cpu_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("trace,workload,models", [
    (False, "kbe3d.photos-mixed", None), (True, "kbe3d.photos-mixed", None),
    (True, "kbe3d.square-1024", ALL_NETS)],
    ids=["trace0", "trace1", "trace1-all-nets"])
def test_a_run_on_the_cpu_is_correct_and_reports(manifest, trace, workload,
                                                 models, cpu_threads):
    rec = harness.run_cell(_tiny(manifest, workload, models), 2**31 + 5, 1.0,
                           trace, "cpu", time.perf_counter())
    assert rec["correct"] and rec["attempted"] >= 1 and rec["failed"] == 0
    assert rec["compared_videos"] == min(2, rec["attempted"])
    assert rec["numbers"] == {"mean_abs_levels": 0.0, "off8_ppm": 0.0}
    line = harness.result_line(manifest, workload, trace, rec, 1)
    assert list(line)[-1] == "checks"
    want = {"front_end_ms", "pose_loop_ms", "frames_to_host_ms",
            "video_mfu"} if trace else {"frames_per_s", "video_ms.p90",
                                        "setup_s"}
    assert want <= set(line["metrics"])
    if not trace:
        assert "program" not in line
        return
    # the program's record, which the four metrics read: on the CPU no
    # device operation runs, so each of them reads nothing here and is
    # left out of the line; on the card they are reported
    prog = line["program"]
    assert prog is rec["program"] and prog["videos"] == 2
    assert prog["counters"]["bytes_to_host"] > 0
    for name in ("front_end/semantics", "front_end/disparity",
                 "front_end/refine", "front_end/bootstrap", "pose_loop",
                 "to_host"):
        assert prog["spans"][name]["calls"] >= 1, name
    # two bootstrap steps, each one inpainting net, or two in the dual mode
    assert prog["spans"]["bootstrap/inpaint"]["calls"] == (
        4 if models and models["inpaint_depth"] else 2)
    assert not set(program.METRICS) & set(line["metrics"])
    assert rec["program_s"] > 0


def _broken(monkeypatch, alter):
    """Break the frames where the effect produces them, for ``__call__``
    and for the pieces the traced window drives."""
    from kbe_torch.pipeline import kenburns

    real = kenburns.build_effect_fn

    def build(*args, **kwargs):
        fn = real(*args, **kwargs)

        def effect(models, image):
            return alter(fn(models, image))

        effect.front_end = fn.front_end
        effect.render_frames = lambda state: alter(fn.render_frames(state))
        effect.frame_stages = fn.frame_stages
        return effect

    monkeypatch.setattr(kenburns, "build_effect_fn", build)


def _frame_altered(frames):
    out = frames.clone()
    out[1] = 255 - out[1]
    return out


class _Stale:
    """Hands back the previous request's video."""

    def __init__(self):
        self.last = None

    def __call__(self, frames):
        out = frames if self.last is None or \
            self.last.shape != frames.shape else self.last
        self.last = frames
        return out


@pytest.mark.parametrize("fault,trace,models", [
    ("frame_altered", False, None), ("frame_altered", True, None),
    ("stale_video", False, None), ("stale_video", True, None),
    ("frame_altered", False, ALL_NETS), ("frame_altered", True, ALL_NETS)],
    ids=["frame_altered-0", "frame_altered-1", "stale_video-0",
         "stale_video-1", "frame_altered-0-all-nets",
         "frame_altered-1-all-nets"])
def test_a_broken_timed_path_is_not_correct(manifest, monkeypatch, fault,
                                            trace, models, cpu_threads):
    _broken(monkeypatch, _frame_altered if fault == "frame_altered"
            else _Stale())
    cell = _tiny(manifest, "kbe3d.square-1024", models)
    # a stale video shows from the window's first request on: the set-up
    # warms up on a photograph the window never sends
    rec = harness.run_cell(cell, 77, 1.0, trace, "cpu", time.perf_counter())
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    assert not rec["correct"], rec["numbers"]


def test_a_failed_video_is_counted_and_not_correct(manifest, monkeypatch,
                                                   cpu_threads):
    from kbe_torch.pipeline import KenBurnsPipeline

    real = KenBurnsPipeline.__call__
    calls = []

    def flaky(self, image, zoom=None):
        calls.append(1)
        if len(calls) == 3:  # the first two are the set-up's warm-ups
            raise RuntimeError("lost")
        return real(self, image, zoom)

    monkeypatch.setattr(KenBurnsPipeline, "__call__", flaky)
    rec = harness.run_cell(_tiny(manifest, "kbe3d.photos-mixed"), 9, 1.0,
                           False, "cpu", time.perf_counter())
    assert rec["failed"] == 1 and not rec["correct"]
    line = harness.result_line(manifest, "kbe3d.photos-mixed", False, rec, 1)
    assert line["failed"] == 1


def test_sample_is_uniform_and_bounded():
    seen = [0] * 10
    for seed in range(2000):
        s = judge.Sample(3, seed)
        for i in range(10):
            s.offer(i)
        assert len(s.items) == 3 and len(set(s.items)) == 3
        for i in s.items:
            seen[i] += 1
    assert min(seen) > 0.85 * 600 and max(seen) < 1.15 * 600


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "kbe3d.square-1024", "--seed", str(2**31 + 99), "--seconds", "4",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["metrics"]
    if trace:
        assert set(program.METRICS) <= set(line["metrics"])
        assert line["program"]["device_ms"] > 0


@pytest.mark.gpu
def test_the_all_nets_configuration_on_the_card(manifest):
    """``kbe3d.square-1024`` with every net that ``models`` can name, at
    its full size over a short window: correct against the reference, and
    the four program metrics read, ``bootstrap_ms`` above the default
    nets' (both pairs of partial-conv nets)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(manifest, "kbe3d.square-1024")
    cell["config_data"]["models"] = dict(ALL_NETS)
    rec = harness.run_cell(cell, 2**31 + 101, 4.0, True, "cuda:0",
                           time.perf_counter())
    line = harness.result_line(manifest, "kbe3d.square-1024", True, rec, 1)
    assert line["correct"], line["checks"]
    assert set(program.METRICS) <= set(line["metrics"])
    spans = line["program"]["spans"]
    assert spans["bootstrap/inpaint"]["calls"] == 4
    assert line["metrics"]["bootstrap_ms"]["value"] > 100.0
