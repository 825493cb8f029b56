"""The program slice (``benchmark/program.py``) and the four metric files
that read its record: a hand-made slice read to the numbers worked by
hand, the slice's choice of requests, the spans that the all-nets path
opens read whole, a slice of a tiny effect on the CPU, the traced run of a
cell with tracing off in its own slices, and on the card, where each
device operation is charged."""

import json
import time

import pytest
import torch

from benchmark import harness, program, traffic
from kbe_torch.utils import logging as trace

# (name, start us, end us), nested as calls nest
SPANS = [
    ("video", 0, 1000),
    ("effect_fn", 0, 5), ("upload", 5, 15),
    ("front_end", 18, 400),
    ("front_end/semantics", 30, 60), ("front_end/disparity", 60, 100),
    ("front_end/refine", 100, 150),
    ("front_end/bootstrap", 150, 300),
    ("bootstrap/splat68", 160, 200), ("bootstrap/inpaint", 200, 280),
    ("front_end/scene", 300, 390),
    ("pose_loop", 400, 800),
    ("frame/splat", 410, 500), ("frame/fill", 500, 700),
    ("to_host", 800, 1000),
]
# (name, start us, end us, the span that launched it); the device runs
# behind the host, so an operation may run after its span has ended
OPS = [
    ("conv", 40, 90, "front_end/semantics"),
    ("conv", 95, 130, "front_end/disparity"),
    ("conv", 130, 200, "front_end/refine"),
    ("splat_sum", 210, 230, "bootstrap/splat68"),
    ("gemm", 230, 330, "bootstrap/inpaint"),
    ("add", 335, 340, "front_end/bootstrap"),
    ("splat_sum", 450, 550, "frame/splat"),
    ("discfill", 600, 650, "frame/fill"),
    ("Memcpy DtoH (Device -> Pageable)", 820, 980, "to_host"),
    ("Memcpy DtoH (Device -> Pinned)", 990, 1000, None),
]


def _read(name, record):
    return harness.read_metric(name, record)


def test_a_hand_made_slice_reads_as_worked_by_hand():
    """Two videos' worth: every number is halved."""
    rec = program.summarise(SPANS, OPS, {"videos": 2,
                                         "bytes_to_host": 3_200_000}, 2)
    record = {"program": rec}
    assert rec["device_ms"] == pytest.approx(0.300)
    assert rec["attributed_share"] == pytest.approx(590 / 600)
    # 382 us less its five spans' 30 + 40 + 50 + 150 + 90
    assert rec["spans"]["front_end"]["host_self_ms"] == pytest.approx(0.011)
    assert rec["spans"]["frame/fill"] == {
        "calls": 0.5, "host_self_ms": 0.1, "device_ms": 0.025,
        "launches": 0.5}
    assert rec["counters"] == {"videos": 1.0, "bytes_to_host": 1_600_000.0}
    # (50 + 35 + 70) us over two videos
    assert _read("depth_nets_ms", record) == pytest.approx(0.0775)
    # (20 + 100 + 5) us over two videos
    assert _read("bootstrap_ms", record) == pytest.approx(0.0625)
    # (100 + 50) us launched in the loop's frames, over two videos
    assert _read("loop_device_ms", record) == pytest.approx(0.075)
    # 1.6 MB in 80 us
    assert _read("to_host_gbps", record) == pytest.approx(20.0)
    assert rec["idle_gaps"][:4] == [
        ["pose_loop", pytest.approx(170e-6)],
        ["front_end", pytest.approx(110e-6)],
        ["frame/fill", pytest.approx(50e-6)],
        ["front_end", pytest.approx(40e-6)]]


def test_the_metrics_read_nothing_where_there_is_nothing_to_read():
    no_bootstrap = [s for s in SPANS if "bootstrap" not in s[0]]
    ops = [o for o in OPS if o[3] is None or "bootstrap" not in o[3]]
    dolly = {"program": program.summarise(no_bootstrap, ops,
                                          {"bytes_to_host": 8}, 1)}
    assert _read("bootstrap_ms", dolly) is None
    assert _read("depth_nets_ms", dolly) == pytest.approx(0.155)
    no_device = {"program": program.summarise(SPANS, [], {"videos": 1}, 1)}
    for record in ({}, {"program": {}}, no_device,
                   {"program": program.summarise([], [], {}, 1)}):
        for name in program.METRICS:
            assert _read(name, record) is None, (name, record)


@pytest.mark.parametrize("shapes,want", [
    ([[1024, 1024]], [(1024, 1024)] * 2),
    ([[1024, 1024], [768, 1024], [1024, 768], [680, 1024], [576, 1024]],
     [(1024, 1024), (768, 1024), (1024, 768), (680, 1024), (576, 1024)])],
    ids=["one-shape", "five-shapes"])
def test_the_slice_reads_each_shape_alike_on_the_same_photographs(shapes,
                                                                 want):
    """The mix's shapes in its order after a warm-up, none twice, and the
    same photographs in every run: the stream of ``SLICE_SEED``."""
    mix = {"shapes": shapes, "loop": "closed", "clients": 1}
    reqs = program.slice_requests(mix)
    assert [(r.height, r.width) for r in reqs[1:]] == want
    assert reqs[0].index == 0
    assert len({r.index for r in reqs}) == len(reqs)
    for r, again in zip(reqs, program.slice_requests(mix)):
        assert r.index == again.index and (r.image == again.image).all()
        assert (r.image == traffic.scene_image(
            r.height, r.width, [program.SLICE_SEED, r.index])).all()


def test_the_metrics_read_every_span_of_the_all_nets_path(cpu_threads):
    """The spans that the residual refine, the partial-conv nets and the
    dual colour/depth pair open on the CPU, each given one device
    operation of 1 us: ``bootstrap_ms`` reads every bootstrap span of
    both pairs, ``depth_nets_ms`` the three depth nets, ``loop_device_ms``
    the loop and its frames."""
    from kbe_torch.config import EffectConfig
    from kbe_torch.pipeline import KenBurnsPipeline

    pipe = KenBurnsPipeline.create(0, effect=EffectConfig(num_steps=2),
                                   device="cpu", pretrained_refine=True,
                                   partial_inpainting=True,
                                   inpaint_depth=True)
    mix = {"shapes": [[64, 64]], "loop": "closed", "clients": 1}
    raw = program.profile_videos(pipe, program.slice_requests(mix), "cpu")
    spans, videos = raw["spans"], raw["videos"]
    ops = [("op", s, s + 1, name) for name, s, _ in spans]
    rec = program.summarise(spans, ops, raw["counters"], videos)
    names = [name for name, _, _ in spans]

    def per_video_ms(wanted):
        return sum(1 for name in names if wanted(name)) / 1e3 / videos

    # two bootstrap steps, each a context net and an inpainting net for
    # the colour and again for the depth
    assert rec["spans"]["bootstrap/inpaint"]["calls"] == 4
    assert rec["spans"]["bootstrap/context"]["calls"] == 4
    assert _read("bootstrap_ms", {"program": rec}) == pytest.approx(
        per_video_ms(lambda n: n == "front_end/bootstrap"
                     or n.startswith("bootstrap/")))
    assert _read("depth_nets_ms", {"program": rec}) == pytest.approx(
        per_video_ms(lambda n: n in ("front_end/semantics",
                                     "front_end/disparity",
                                     "front_end/refine")))
    assert _read("loop_device_ms", {"program": rec}) == pytest.approx(
        per_video_ms(lambda n: n == "pose_loop" or n.startswith("frame/")))


def test_innermost_finds_the_deepest_span_or_none():
    spans = [("a", 0, 10), ("b", 2, 5), ("c", 3, 4), ("d", 6, 9)]
    assert program.innermost(spans, [3.5, 1, 5.5, 7, 11, 4.5]) == [
        2, 0, 0, 3, None, 1]


@pytest.fixture
def cpu_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


def test_a_slice_of_a_tiny_effect_on_the_cpu(cpu_threads):
    """Every span of the effect, the counts a video, no device time and so
    no metric: the CPU runs no device operation."""
    from kbe_torch.config import EffectConfig
    from kbe_torch.pipeline import KenBurnsPipeline

    pipe = KenBurnsPipeline.create(0, effect=EffectConfig(num_steps=2),
                                   device="cpu")
    mix = {"shapes": [[32, 32]], "loop": "closed", "clients": 1}
    stream = traffic.stream(mix, 2**40 + 3)
    rec = program.program_slice(pipe, [next(stream) for _ in range(3)],
                                "cpu")
    assert not trace.tracing_on() and trace.counters() == {}
    assert rec["videos"] == 2 and rec["device_ms"] == 0.0
    assert rec["spans"]["video"]["calls"] == 1.0
    assert rec["spans"]["frame/fill"]["calls"] == 2.0
    assert rec["spans"]["bootstrap/inpaint"]["calls"] == 2.0
    counts = rec["counters"]
    assert counts["videos"] == 1.0 and "effect_builds" not in counts
    assert counts["bytes_to_host"] == 2 * 32 * 32 * 3
    assert counts["valid_points"] > 0 and counts["hole_pixels"] >= 0
    assert all(_read(name, {"program": rec}) is None
               for name in program.METRICS)


def test_a_traced_run_keeps_tracing_off_in_its_own_slices(cpu_threads):
    manifest = harness.load_manifest()
    cell = harness.load_cell(manifest, "kbe3d.square-1024")
    cell["config_data"]["effect"]["num_steps"] = 3
    cell["mix"] = dict(cell["mix"], shapes=[[64, 64]])
    cell["checks"] = dict(cell["checks"], compare=1)
    rec = harness.run_cell(cell, 2**31 + 11, 1.0, True, "cpu",
                           time.perf_counter())
    assert rec["correct"]
    assert "kbe/" not in json.dumps([rec.get("profile"), rec.get("stages")])
    assert trace.counters() == {}


@pytest.mark.gpu
def test_each_operation_is_charged_to_its_span_on_the_card():
    """A slice of ``kbe3d.square-1024``: at least 99 % of the device time
    is charged to a span, the splat kernels only to the splats, the fill
    to ``frame/fill``, the frames' copy to ``to_host``, and nothing is
    built."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.reference.nets import model_flags
    from benchmark.reference.weights import make_weights

    device = torch.device("cuda:0")
    cell = harness.load_cell(harness.load_manifest(), "kbe3d.square-1024")
    config = cell["config_data"]
    pipe = harness.build_pipeline(
        config, make_weights(config["weights_seed"], device,
                             model_flags(config)), device)
    seed = 2**31 + 123
    for req in traffic.warm_ups(cell["mix"], seed):
        pipe(req.image)
    stream = traffic.stream(cell["mix"], seed)
    raw = program.profile_videos(
        pipe, [next(stream) for _ in range(program.PROGRAM_VIDEOS + 1)],
        device)
    ops = raw["ops"]
    total = sum(e - s for _, s, e, _ in ops)
    charged = sum(e - s for _, s, e, where in ops if where is not None)
    assert charged >= 0.99 * total > 0
    where = {}
    for name, _, _, span in ops:
        kind = ("splat" if "splat_" in name else
                "discfill" if "discfill" in name else
                "to_pageable" if name.startswith("Memcpy DtoH") and
                "Pageable" in name else None)
        if kind:
            where.setdefault(kind, set()).add(span)
    assert where["splat"] == {"frame/splat", "bootstrap/splat68"}
    assert where["discfill"] == {"frame/fill"}
    assert where["to_pageable"] == {"to_host"}
    assert raw["counters"]["videos"] == program.PROGRAM_VIDEOS
    assert "effect_builds" not in raw["counters"]
    assert "kernel_builds" not in raw["counters"]
