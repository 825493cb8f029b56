"""The tracer of ``kbe_torch/utils/logging.py`` and the spans and counters
of the effect, on the CPU at 32^2 and 3 steps with seeded random weights.

Off, a span is one shared null context, the profiler sees no ``kbe/``
range and nothing is counted. On, the frames are the same bit for bit,
every span of the effect appears once a call (each frame's once a pose)
inside the span that calls it, and the counts equal what
``kenburns.path_stats`` finds by rendering the poses again.
"""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kbe_torch.config import EffectConfig, ZoomSettings
from kbe_torch.data import demo_scene_image
from kbe_torch.pipeline import KenBurnsPipeline
from kbe_torch.pipeline.kenburns import frames_to_host, path_stats
from kbe_torch.utils import logging as trace

SIZE, STEPS = 32, 3

# span -> the span it runs in (``kbe/`` left off)
PARENTS = {
    "video": None,
    "effect_fn": "video", "upload": "video", "front_end": "video",
    "pose_loop": "video", "to_host": "video",
    **{f"front_end/{s}": "front_end"
       for s in ("resize", "semantics", "disparity", "refine",
                 "depth_grid", "bootstrap", "scene")},
    **{f"bootstrap/{s}": "front_end/bootstrap"
       for s in ("inputs", "context", "splat68", "median", "inpaint",
                 "unproject")},
    **{f"frame/{s}": "pose_loop" for s in ("splat", "count", "fill",
                                            "finish")},
    # the plain finish's steps (the CPU's path; the card's is one kernel)
    **{f"frame/{s}": "frame/finish"
       for s in ("quantise", "crop", "resize", "round")},
    # the partial convs' mask side: the partial-conv nets' only
    "bootstrap/pconv_mask": "bootstrap/inpaint",
}
PARTIAL_ONLY = {"bootstrap/pconv_mask"}
PCONVS = 57  # the partial convs of one ``PartialInpaint`` call


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for this file's convolutions: the Tier-1 run's other
    workers use the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_counts_left():
    trace.reset_counters()
    yield
    trace.reset_counters()


def _kbe_spans(prof):
    """[(name, parent name)] of the ``kbe/`` ranges of a CPU profile, each
    parent the innermost range that holds it (the profiler's raw events:
    the parsed tree of some 40,000 events takes seconds)."""
    ranges = sorted(((e.start_ns(), -e.end_ns(), e.name()[len("kbe/"):])
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("kbe/")))
    out, open_ = [], []
    for start, neg_end, name in ranges:
        while open_ and -open_[-1][1] <= start:
            open_.pop()
        out.append((name, open_[-1][2] if open_ else None))
        open_.append((start, neg_end, name))
    return out


@pytest.fixture(scope="module")
def run():
    """One pipeline's first video with tracing off and its second with
    tracing on, each under ``torch.profiler``, and ``path_stats`` of the
    same effect on the same photograph."""
    pipe = KenBurnsPipeline.create(0, effect=EffectConfig(num_steps=STEPS),
                                   device="cpu")
    image = demo_scene_image(SIZE, SIZE)
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as off:
        frames_off = pipe(image)
    counts_off = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as on, trace.tracing():
        frames_on = pipe(image)
    counts_on = trace.counters()
    trace.reset_counters()
    zoom = ZoomSettings.default_3d(SIZE, SIZE)
    stats = path_stats(pipe.effect_fn(SIZE, SIZE, zoom), pipe.models,
                       torch.as_tensor(image)[None], SIZE, SIZE, zoom,
                       pipe.effect)
    return {"pipe": pipe, "image": image, "frames_off": frames_off,
            "frames_on": frames_on, "spans_off": _kbe_spans(off),
            "spans_on": _kbe_spans(on), "counts_off": counts_off,
            "counts_on": counts_on, "stats": stats}


def test_tracer_off_by_default_and_restored_by_its_block():
    assert not trace.tracing_on()
    assert trace.span("video") is trace.span("frame/fill", step=1)
    with trace.span("video"):
        pass
    trace.count("videos", 1)
    trace.count("hole_pixels", torch.tensor(3))
    assert trace.counters() == {}
    with trace.tracing():
        assert trace.tracing_on()
        with trace.tracing(False):
            assert not trace.tracing_on()
            assert trace.span("video") is trace.span("to_host")
        assert isinstance(trace.span("video"),
                          torch.profiler.record_function)
        trace.count("videos", 2)
        trace.count("hole_pixels", torch.tensor(3))
        trace.count("hole_pixels", torch.tensor(4))
    assert not trace.tracing_on()
    assert trace.counters() == {"videos": 2, "hole_pixels": 7}
    trace.reset_counters()
    assert trace.counters() == {}


def test_tracing_off_records_no_span_and_counts_nothing(run):
    assert run["spans_off"] == []
    assert run["counts_off"] == {}


def test_frames_are_the_same_with_tracing_on_and_off(run):
    assert run["frames_off"].dtype == run["frames_on"].dtype
    assert (run["frames_off"] == run["frames_on"]).all()


def test_every_span_appears_inside_its_parent(run):
    spans = run["spans_on"]
    assert {name for name, _ in spans} == set(PARENTS) - PARTIAL_ONLY
    for name, parent in spans:
        assert parent == PARENTS[name], (name, parent)
    calls = {name: sum(1 for n, _ in spans if n == name)
             for name in set(PARENTS) - PARTIAL_ONLY}
    for name, n in calls.items():
        want = (STEPS if name.startswith("frame/")
                else 2 if name.startswith(("bootstrap/",
                                            "front_end/bootstrap"))
                else 1)
        assert n == want, (name, n)


def test_counts_equal_what_path_stats_finds(run):
    counts, stats = run["counts_on"], run["stats"]
    assert counts["videos"] == 1
    assert counts["valid_points"] == stats["valid_points"] > 0
    assert counts["hole_pixels"] == stats["hole_pixels_a_frame"] * STEPS
    assert counts["hole_pixels"] > 0
    assert counts["bytes_to_host"] == run["frames_on"].nbytes
    assert "effect_builds" not in counts  # the second video of its shape
    assert "finish_kernel_frames" not in counts  # the plain finish here


def test_on_the_cpu_the_frames_come_back_unpinned_with_no_pinned_allocs(run):
    """On the CPU ``__call__`` hands the effect's frames back as they are:
    not page-locked, the array over the tensor's own memory, their bytes in
    ``bytes_to_host`` and no ``pinned_allocs`` counted (the card's copy
    into page-locked blocks is ``tests/test_torch_cuda.py``'s)."""
    out = run["frames_on"]
    assert isinstance(out, np.ndarray) and out.dtype == np.uint8
    assert out.shape == (STEPS, SIZE, SIZE, 3)
    assert not torch.from_numpy(out).is_pinned()
    assert run["counts_on"]["bytes_to_host"] == out.nbytes
    assert "pinned_allocs" not in run["counts_on"]
    frames = torch.arange(24, dtype=torch.uint8).reshape(1, 2, 4, 3)
    with trace.tracing():
        host = frames_to_host(frames)
    assert np.shares_memory(host, frames.numpy())
    assert trace.counters() == {}


def test_dolly_builds_once_has_no_bootstrap_and_profiler_trace_counts(
        run, tmp_path):
    """A new effect (dolly, the same nets) counts one build on its first
    video and none on its second; it runs no bootstrap; its holes are
    counted inside its fill ROI, which is smaller than the frame; and
    ``profiler_trace`` writes the body's counts beside its trace."""
    first_pipe = run["pipe"]
    pipe = KenBurnsPipeline(camera=first_pipe.camera,
                            effect=EffectConfig(num_steps=STEPS, dolly=True),
                            models=first_pipe.models,
                            device=first_pipe.device)
    with trace.profiler_trace(str(tmp_path / "first")):
        pipe(run["image"])
    with trace.profiler_trace(str(tmp_path / "second")):
        frames = pipe(run["image"])
    assert not trace.tracing_on()
    first = json.loads((tmp_path / "first" / "counters.json").read_text())
    second = json.loads((tmp_path / "second" / "counters.json").read_text())
    assert first["effect_builds"] == 1 and second["effect_builds"] == 0
    assert first["videos"] == second["videos"] == 1
    assert second["bytes_to_host"] == frames.nbytes
    zoom = ZoomSettings.default_dolly(SIZE, SIZE)
    stats = path_stats(pipe.effect_fn(SIZE, SIZE, zoom), pipe.models,
                       torch.as_tensor(run["image"])[None], SIZE, SIZE,
                       zoom, pipe.effect)
    assert stats["fill_roi"] != [0, SIZE, 0, SIZE]
    assert second["hole_pixels"] == stats["hole_pixels_a_frame"] * STEPS
    events = json.loads((tmp_path / "second" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"kbe/video", "kbe/front_end", "kbe/frame/fill"} <= names
    assert not any(str(n).startswith(("kbe/bootstrap",
                                      "kbe/front_end/bootstrap"))
                   for n in names)


def test_the_all_nets_effect_nests_the_mask_side_in_its_inpainting(run):
    """The residual refine, the partial-conv nets and the dual colour/depth
    pair: every span of the default effect, and the mask side of each
    partial conv inside ``bootstrap/inpaint``, whose four calls (two steps,
    the colour and the depth net) hold 57 each; the frames are the same
    with tracing on and off."""
    pipe = KenBurnsPipeline.create(0, effect=EffectConfig(num_steps=STEPS),
                                   device="cpu", pretrained_refine=True,
                                   partial_inpainting=True,
                                   inpaint_depth=True)
    frames_off = pipe(run["image"])
    with profile(activities=[ProfilerActivity.CPU]) as on, trace.tracing():
        frames_on = pipe(run["image"])
    counts = trace.counters()
    spans = _kbe_spans(on)
    assert (frames_off == frames_on).all()
    assert {name for name, _ in spans} == set(PARENTS)
    for name, parent in spans:
        assert parent == PARENTS[name], (name, parent)
    calls = collections.Counter(name for name, _ in spans)
    assert calls["bootstrap/inpaint"] == 4
    assert calls["bootstrap/pconv_mask"] == 4 * PCONVS
    assert counts["pconv_calls"] == 4 * PCONVS
