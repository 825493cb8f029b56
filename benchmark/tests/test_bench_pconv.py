"""The partial convs' two metric files, ``pconv_mask_ms`` and
``pconv_roofline``: a hand-made program record read to the numbers worked
by hand, nothing read from a program without the span or its counters (a
parent that predates them, the default nets, the CPU), and the span and
counters of the partial-conv nets' slice on the CPU read whole; and the
manifest's entries for the partial-conv cell: its configuration, its cell
and the two metrics, named, united and with their files."""

import json
import re
from pathlib import Path

import pytest
import torch

from benchmark import counts, harness, program
from benchmark.pconv_counts import pconv_bytes

# (name, start us, end us), nested as calls nest: two partial convs' mask
# sides inside one inpainting net call
SPANS = [
    ("video", 0, 1000),
    ("front_end", 10, 600),
    ("front_end/bootstrap", 20, 500),
    ("bootstrap/inpaint", 100, 400),
    ("bootstrap/pconv_mask", 150, 160), ("bootstrap/pconv_mask", 300, 320),
    ("to_host", 700, 1000),
]
OPS = [
    ("conv", 120, 150, "bootstrap/inpaint"),
    ("pconv_kernel", 155, 175, "bootstrap/pconv_mask"),
    ("pconv_kernel", 305, 345, "bootstrap/pconv_mask"),
    ("Memcpy DtoH (Device -> Pageable)", 710, 990, "to_host"),
]
# a video: 3,000,000 output values, 400,000 mask pixels in and out
COUNTS = {"videos": 2, "pconv_calls": 4, "pconv_out_elems": 6_000_000,
          "pconv_mask_px": 800_000}


ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELL = "kbe3d-partial-dual.square-1024"
CONFIG = "kbe3d-partial-dual-1024"


def _read(name, record):
    return harness.read_metric(name, record)


def test_the_bytes_by_hand():
    # 10 values: bf16 in, f32 out, 6 B each; 5 mask pixels at 4 B
    assert pconv_bytes(10, 5) == 60 + 20
    assert pconv_bytes(10, 5, "float32") == 80 + 20


def test_a_hand_made_record_reads_as_worked_by_hand():
    """Two videos' worth: every number is halved."""
    rec = program.summarise(SPANS, OPS, COUNTS, 2)
    record = {"program": rec, "config": {"precision": {"inpaint":
                                                       "bfloat16"}}}
    # the kernels' 20 + 40 us over two videos
    assert _read("pconv_mask_ms", record) == pytest.approx(0.030)
    assert rec["spans"]["bootstrap/inpaint"]["device_ms"] == \
        pytest.approx(0.015)
    # a video: 3e6 values at 6 B and 4e5 pixels at 4 B = 19.6 MB
    least = 19.6e6 / 3.35e12
    assert _read("pconv_roofline", record) == pytest.approx(
        100.0 * least / 30e-6)
    assert counts.least_seconds(pconv_bytes(3e6, 4e5)) == \
        pytest.approx(least)
    # an f32 configuration reads its result at 4 B a value
    record["config"]["precision"]["inpaint"] = "float32"
    assert _read("pconv_roofline", record) == pytest.approx(
        100.0 * (25.6e6 / 3.35e12) / 30e-6)
    # both are bootstrap spans: ``bootstrap_ms`` takes the mask side in
    assert _read("bootstrap_ms", record) == pytest.approx(
        (30 + 20 + 40) / 2 / 1e3)


@pytest.mark.parametrize("drop", ["span", "counters", "device_time"])
def test_nothing_is_read_without_the_span_or_its_counters(drop):
    spans = [s for s in SPANS if drop != "span"
             or s[0] != "bootstrap/pconv_mask"]
    ops = [o if drop != "span" or o[3] != "bootstrap/pconv_mask"
           else o[:3] + ("bootstrap/inpaint",) for o in OPS]
    if drop == "device_time":
        ops = []
    tally = ({"videos": 2} if drop == "counters" else COUNTS)
    record = {"program": program.summarise(spans, ops, tally, 2)}
    assert _read("pconv_roofline", record) is None
    assert (_read("pconv_mask_ms", record) is None) == (drop != "counters")


@pytest.fixture
def cpu_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


def test_the_partial_nets_slice_on_the_cpu_carries_the_span(cpu_threads):
    """The dual partial-conv nets at 32^2: each partial conv's mask side a
    span inside ``bootstrap/inpaint``, its counters a video; given one
    device operation of 1 us each, ``pconv_mask_ms`` reads them all."""
    from kbe_torch.config import EffectConfig
    from kbe_torch.models.partial_conv import net_pconv_shapes
    from kbe_torch.pipeline import KenBurnsPipeline

    pipe = KenBurnsPipeline.create(0, effect=EffectConfig(num_steps=2),
                                   device="cpu", partial_inpainting=True,
                                   inpaint_depth=True)
    mix = {"shapes": [[32, 32]], "loop": "closed", "clients": 1}
    raw = program.profile_videos(pipe, program.slice_requests(mix), "cpu")
    spans, videos = raw["spans"], raw["videos"]
    rec = program.summarise(spans, [], raw["counters"], videos)
    calls = 4 * len(net_pconv_shapes(32, 32))
    assert rec["spans"]["bootstrap/pconv_mask"]["calls"] == calls
    assert rec["counters"]["pconv_calls"] == calls
    assert rec["counters"]["pconv_out_elems"] > 0
    # no device operation on the CPU: nothing to read
    assert _read("pconv_mask_ms", {"program": rec}) is None
    assert _read("pconv_roofline", {"program": rec}) is None
    ops = [("op", s, s + 1, name) for name, s, _ in spans]
    rec = program.summarise(spans, ops, raw["counters"], videos)
    assert _read("pconv_mask_ms", {"program": rec}) == pytest.approx(
        calls / 1e3)
    assert 0.0 < _read("pconv_roofline", {"program": rec})


def test_the_manifest_entries_of_the_partial_conv_cell():
    """The configuration, the one-chip cell, the two metrics (names, units,
    ``better``, files) and the cell appended to each metric that lists its
    cells."""
    manifest = harness.load_manifest()
    (config,) = [c for c in manifest["configs"] if c["name"] == CONFIG]
    assert config["reduced"] == []
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == CONFIG and data["source"] == config["source"]
    assert data["models"] == {"partial_inpainting": True,
                              "inpaint_depth": True}
    (work,) = [w for w in manifest["workloads"] if w["name"] == CELL]
    assert (work["config"], work["traffic"], work["chips"]) == \
        (CONFIG, "square-1024", 1)
    assert NAME.match(work["name"]) and NAME.match(work["traffic"])
    assert 0 < len(work["why"]) <= 200
    cell = harness.load_cell(manifest, CELL)
    assert cell["mix"]["shapes"] and cell["checks"]["limits"]
    new = {m["name"]: m for m in manifest["per_layer"]
           if m["name"] in ("pconv_mask_ms", "pconv_roofline")}
    assert [(m["unit"], m["better"], m["layer"]) for m in new.values()] == \
        [("ms", "lower", "front end"), ("%", "higher", "kernels")]
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in new.values():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["source"] == "device_trace" and m["moves"] in e2e
        assert m["workloads"] == [CELL]
        assert (ROOT / "benchmark" / "metrics" /
                f"{m['name']}.py").is_file()
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            assert m["workloads"][-1] == CELL, m["name"]
    names = [m["name"] for m in manifest["end_to_end"]
             + manifest["per_layer"]]
    assert len(names) == len(set(names))
    assert e2e >= {"frames_per_s", "video_ms.p90", "setup_s"}
