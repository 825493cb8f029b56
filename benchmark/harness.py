"""One run of one cell: set-up, the measured window, the traced pieces,
the comparison with the reference, and the metrics by name.

The system under test is ``kbe_torch``'s ``KenBurnsPipeline``: one
photograph in, one video of uint8 frames out on the host. A run:

1. set-up (``setup_s``, from the process's start): imports, the card, the
   nets' weights made on the device from the configuration's
   ``weights_seed`` and loaded into the pipeline's nets, and one warm-up
   video for each shape of the mix, of photographs the window never sends;
2. the window: a closed loop of one client. The next photograph is sent
   when the last video is on the host, for ``--seconds``; the window
   closes when the last video sent has arrived. Each request sends a
   photograph of its own, made by the client between requests with the
   window's clock stopped. With ``--trace 0`` each request is one
   ``KenBurnsPipeline.__call__``; with ``--trace 1`` the loop drives the
   pieces that ``__call__`` is made of (``fn.front_end``,
   ``fn.render_frames``, the copy to the host), each ended by a
   synchronise and timed on the host's clock, then profiles a short slice
   of the same loop on the stream's next requests, and one pass of
   ``fn.frame_stages`` over the stages that the cell's metric files name,
   and last records the program's own spans and counters over a fixed
   slice of photographs, each of the mix's shapes alike (``program.py``);
3. the peak of device memory, read before anything else runs;
4. ``correct``: a sample of the window's videos, drawn from the seed,
   against ``reference/`` on the same photographs and weights, once the
   program's state is freed.

The metrics are read by the files ``metrics/<name>.py``, each a function
``value(record)`` of the run's record, which returns None where it finds
nothing to read; a file that reads a stage of ``fn.frame_stages`` names it
in ``STAGES``, and only those stages are profiled.

The configuration names the nets the pipeline builds in its ``models``
(``reference/nets.py::model_flags``): ``KenBurnsPipeline.create``'s flags,
each false where it is left out. The weights, the reference and the FLOP
count follow the same flags.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from benchmark import judge, program, traffic
from benchmark.reference import effect as ref_effect
from benchmark.reference.nets import model_flags
from benchmark.reference.weights import make_weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
METRICS_DIR = HERE / "metrics"
PROFILED_VIDEOS = 2     # recorded after one warm-up video
FORBIDDEN = ("jax", "jaxlib", "flax", "kbe_tpu")


def load_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(manifest: dict, workload: str) -> dict:
    """The cell's entry, its configuration, mix and checks."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = dict(cells[workload])
    configs = {c["name"]: c for c in manifest["configs"]}
    cell["config_data"] = json.loads(
        (ROOT / configs[cell["config"]]["file"]).read_text())
    cell["mix"] = traffic.load(cell["traffic"])
    cell["checks"] = judge.load_checks(workload)
    cell["per_layer"] = [m["name"] for m in metrics_of(manifest, workload,
                                                       True)]
    return cell


def metrics_of(manifest: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def _metric_module(name: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", METRICS_DIR / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metric(name: str, record: dict) -> Optional[float]:
    value = _metric_module(name).value(record)
    return None if value is None else float(value)


def stages_read(names) -> set:
    """The stages of ``fn.frame_stages`` that the metric files ``names``
    read."""
    return {stage for name in names
            for stage in getattr(_metric_module(name), "STAGES", ())}


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_pipeline(config: dict, weights: dict, device):
    """The port's pipeline as users create it, with the configuration's
    nets in its precisions, loaded with ``weights``."""
    from kbe_torch.config import CameraConfig, EffectConfig
    from kbe_torch.pipeline import KenBurnsPipeline

    dtypes = ref_effect.DTYPES
    pipe = KenBurnsPipeline.create(
        effect=EffectConfig(**config["effect"]),
        camera=CameraConfig(**config["camera"]),
        dtype=dtypes[config["precision"]["inpaint"]],
        depth_dtype=dtypes[config["precision"]["depth"]], device=device,
        **model_flags(config))
    for name, net in zip(pipe.models._fields, pipe.models):
        if net is not None:
            net.load_state_dict(weights[name])
    return pipe


def _effect_fn(pipe, req):
    """The effect ``__call__`` builds for this request (its default move)."""
    from kbe_torch.config import ZoomSettings

    zoom = (ZoomSettings.default_dolly(req.width, req.height)
            if pipe.effect.dolly
            else ZoomSettings.default_3d(req.width, req.height))
    return pipe.effect_fn(req.height, req.width, zoom)


def _pieces(pipe, req, device, spans=None):
    """One request through ``__call__``'s pieces; returns the frames on the
    host and the host seconds of each piece, each ended by a synchronise.
    ``spans`` names each piece for the profiler."""
    fn = _effect_fn(pipe, req)
    times = {}

    def piece(name, work):
        t = time.perf_counter()
        if spans is None:
            out = work()
            _sync(device)
        else:
            with torch.profiler.record_function(f"bench/{name}"):
                out = work()
                _sync(device)
        times[name] = time.perf_counter() - t
        return out

    state = piece("front_end", lambda: fn.front_end(pipe.models, torch.as_tensor(
        np.asarray(req.image, np.float32), device=device)[None]))
    frames = piece("pose_loop", lambda: fn.render_frames(state))
    out = piece("to_host", lambda: frames.cpu().numpy())
    return out, times


def _window(pipe, reqs, seconds: float, device, trace: bool, sample):
    """The closed loop over the stream ``reqs``; returns the window's
    record. Its clock stops while the client makes the next photograph."""
    videos = []
    errors = []
    t_open = time.perf_counter()
    making = 0.0
    while time.perf_counter() - making < t_open + seconds:
        t = time.perf_counter()
        req = next(reqs)
        making += time.perf_counter() - t
        t = time.perf_counter()
        times = None
        try:
            if trace:
                out, times = _pieces(pipe, req, device)
            else:
                out = pipe(req.image)
            ok = True
        except Exception as err:  # a failed video counts as a miss
            out, ok = None, False
            errors.append(f"{type(err).__name__}: {err}")
        done = time.perf_counter()
        videos.append({"index": req.index, "height": req.height,
                       "width": req.width, "ok": ok,
                       "frames": 0 if out is None else int(out.shape[0]),
                       "latency_s": done - t, "pieces_s": times})
        if ok:
            sample.offer((req, out))
    t_close = time.perf_counter()
    return {"seconds": t_close - t_open - making, "videos": videos,
            "errors": errors[:5]}


def _device_events(prof) -> List[tuple]:
    """(name, start us, end us) of the device's operations in a profile,
    without the profiler's own annotations."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("ProfilerStep", "bench/"))]


def _profiled_slice(pipe, reqs, device) -> dict:
    """``PROFILED_VIDEOS`` requests of ``reqs`` through the pieces under
    ``torch.profiler``, after one that warms the profiler up: the device's
    operations and the host spans they ran in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    frames = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        _pieces(pipe, reqs[0], device, spans=True)
        prof.step()
        for req in reqs[1:]:
            out, _ = _pieces(pipe, req, device, spans=True)
            frames += int(out.shape[0])
        prof.step()
    spans = [(e.name[len("bench/"):], e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CPU
             and e.name.startswith("bench/")]
    return {"device_events": _device_events(prof), "spans": spans,
            "frames": frames}


def _over(stage, inputs) -> list:
    """``stage`` over every pose's inputs."""
    return [stage(*a) if isinstance(a, tuple) else stage(a) for a in inputs]


def _stage_pass(pipe, req, device, wanted: set) -> dict:
    """One video's pose loop through ``fn.frame_stages``, a stage at a
    time over every pose, up to the last stage in ``wanted``; each of
    those twice under ``torch.profiler`` (the first pass warms it up): the
    device seconds of its operations."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn = _effect_fn(pipe, req)
    with torch.inference_mode():
        state = fn.front_end(pipe.models, torch.as_tensor(
            np.asarray(req.image, np.float32), device=device)[None])
        poses = [state.poses[i] for i in range(state.poses.shape[0])]
        inputs = [(state, pose) for pose in poses]
        device_s = {}
        for name, stage in fn.frame_stages:
            if not wanted - device_s.keys():
                break
            if name not in wanted:
                inputs = _over(stage, inputs)
                continue
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                for _ in range(2):
                    outs = _over(stage, inputs)
                    _sync(device)
                    prof.step()
            device_s[name] = sum(e - s for _, s, e in
                                 _device_events(prof)) / 1e6
            inputs = outs
        _sync(device)
    return {"height": req.height, "width": req.width,
            "frames": len(poses), "device_s": device_s}


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def _busy_intervals(events, lo: float, hi: float) -> List[tuple]:
    """The union of the device intervals, clipped to [lo, hi]."""
    merged = []
    for _, s, e in sorted(events, key=lambda t: t[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarise_profile(sliced: dict) -> dict:
    """Busy and window seconds, the device's operations by time, launches
    in the pose loop, and the idle gaps named by the host span they fall
    in."""
    spans, events = sliced["spans"], sliced["device_events"]
    if not spans or not events:
        return {}
    lo = min(s for _, s, _ in spans)
    hi = max(e for _, _, e in spans)
    busy = _busy_intervals(events, lo, hi)
    busy_s = sum(e - s for s, e in busy) / 1e6
    totals = collections.Counter()
    for name, s, e in events:
        totals[name[:120]] += (e - s) / 1e6
    loop = [(s, e) for n, s, e in spans if n == "pose_loop"]
    launches = sum(1 for _, s, _ in events
                   if any(a <= s <= b for a, b in loop))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            inside = [n for n, s, e in spans if s <= mid <= e]
            gaps.append((inside[0] if inside else "between", (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": busy_s, "window_s": (hi - lo) / 1e6,
            "loop_launches": launches, "frames": sliced["frames"],
            "device_ops": [[n, t] for n, t in totals.most_common(10)],
            "idle_gaps": [[n, t] for n, t in gaps[:10]]}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run; returns the record the metrics read, with ``correct`` and
    the checks."""
    device = torch.device(device)
    config = cell["config_data"]
    models = model_flags(config)
    checks = cell["checks"]
    parts = {"start_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    pipe = build_pipeline(config, make_weights(config["weights_seed"],
                                               device, models), device)
    parts["pipeline_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for req in traffic.warm_ups(cell["mix"], seed):
        pipe(req.image)
    _sync(device)
    parts["warm_up_s"] = time.perf_counter() - t
    if device.type == "cuda":
        # the peak of the window: the pipeline's nets and what the requests
        # need, not the set-up's weight draw
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    sample = judge.Sample(int(checks["compare"]), seed)
    reqs = traffic.stream(cell["mix"], seed)
    window = _window(pipe, reqs, seconds, device, trace, sample)
    _sync(device)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else None)
    record = {"config": config, "setup_s": setup_s, "setup_parts": parts,
              "window": window,
              "memory_peak_bytes": memory_peak}
    staged = None
    if trace:
        record["profile"] = summarise_profile(_profiled_slice(
            pipe, [next(reqs) for _ in range(PROFILED_VIDEOS + 1)], device))
        wanted = stages_read(cell.get("per_layer", ()))
        if wanted:
            staged = next(reqs)
            record["stages"] = _stage_pass(pipe, staged, device, wanted)
        t = time.perf_counter()
        record["program"] = program.program_slice(
            pipe, program.slice_requests(cell["mix"]), device)
        record["program_s"] = time.perf_counter() - t
    del pipe
    if device.type == "cuda":
        torch.cuda.empty_cache()

    tally = judge.Tally()
    # the same draw again, for the reference's own copy of the nets
    nets = ref_effect.load_nets(
        make_weights(config["weights_seed"], device, models),
        config["precision"], device, models)
    t_ref = time.perf_counter()
    for req, frames in sample.items:
        tally.add(frames, ref_effect.video(nets, req.image, config, device))
    if staged is not None:
        x = torch.as_tensor(staged.image, device=device)[None]
        record["stages"]["valid_points"] = int(
            ref_effect.front_end(nets, x, config).xyz.shape[0])
        record["stages"]["region"] = ref_effect.crop_region(
            staged.height, staged.width, ref_effect.zoom_windows(
                config["zoom"], staged.width, staged.height),
            config["effect"]["fill_roi"])
    record["reference_s"] = time.perf_counter() - t_ref
    numbers = tally.numbers()
    within, shown = judge.verdict(numbers, checks["limits"])
    failed = sum(1 for v in window["videos"] if not v["ok"])
    record.update(compared_videos=tally.videos, numbers=numbers,
                  checks=shown, failed=failed,
                  attempted=len(window["videos"]),
                  correct=bool(within and failed == 0 and tally.videos > 0))
    return record


def result_line(manifest: dict, workload: str, trace: bool, record: dict,
                device_count: int) -> dict:
    """The run's result as the driver reads it."""
    metrics = {}
    for m in metrics_of(manifest, workload, trace):
        value = read_metric(m["name"], record)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = torch.cuda.is_available()
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": device_count,
              "memory_peak_bytes": record["memory_peak_bytes"],
              "power_limit": _power_limit() if cuda else None}
    line = {"correct": record["correct"], "attempted": record["attempted"],
            "failed": record["failed"], "metrics": metrics, "device": device}
    prof = record.get("profile")
    if trace and prof:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
    if trace and "program" in record:
        line["program"] = record["program"]
    line["checks"] = record["checks"]
    return line
