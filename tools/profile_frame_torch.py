"""The port's pose loop by stage, and its fill at the middle pose, on the
bench scene: the counterpart of the frame-body splits of
``tools/profile_map.py``, ``tools/profile_posed.py`` and
``tools/profile_fill.py``.

    python tools/profile_frame_torch.py [--size 1024] [--steps 75]
                                        [--checkpoint find|none|PATH]

**The frame by stage.** ``render_frame`` runs the effect's
``frame_stages`` (``kenburns.build_effect_fn``) in order: ``splat``
(``render_posed``: the six splat kernels), ``fill`` (the depth mask and
``fill_disocclusion_pallas`` in the ROI: the ``discfill`` kernel) and
``finish`` (``ops/finish.py``: the ``finish`` kernel, quantise, crop,
resize and round in one launch, on the card; the plain chain on the CPU).
``render_frames`` writes each frame into the video's buffer; the tool's
loop stacks its frames after its clock stops. For each stage: host ms
a frame in the loop (``loop_split``: the loop run as ``render_frames``
runs it, each stage call timed on the host clock less one clock read
(``clock_read_us``: on a sandboxed host a read can cost tens of µs), no
synchronise between them; the fastest of ``reps`` + 1 runs, in turns with
``render_frames``' own), ending in ``wait``, the final synchronise: the
device work still queued when the host is done. Then,
from the stage run alone over all the poses in a row on the outputs of
the stage before: its host ms a frame alone (the minimum of ``reps`` such
runs, each ended by a synchronise, with no profiler), device ms and
launches a frame (one run under ``torch.profiler``: kernels and copies)
and the hand-written kernels a frame. The in-loop stages sum to the
loop's own time, which is set against ``fn.render_frames``' ms a frame;
the sum alone differs from it by what interleaving the stages costs the
host. The loop's frames equal ``render_frames``' bit for bit
(``tests/test_torch_layer_tools.py``).

**The fill at the middle pose**, as ``profile_fill.py`` splits it: the
hole pixels in the ROI; the hole-free cost (``discfill`` on a depth with
no hole); the real frame; and dolly's frame (c2: one grid, no inpainted
grids, its own ROI), each with host and device ms and the kernel's
device counters of ray steps marched and warp rounds
(``fill_cuda(..., stats=)``).

**TPU rows with no counterpart.** ``kbe_tpu``'s tools also time the
planes build and hole-tile order (``_build_planes``,
``_hole_tile_order``), the gated phase 1 on its own, the census gate of
phase 0 and the CSR routing prepass (``pose_routing``). The port has none
of them: one ``discfill`` kernel marches each hole pixel's rays to their
first event and stops a direction as soon as it cannot win, with no tiles,
planes, phases or gate; and the splat's kernels route each point
themselves, with no routing prepass.

``device`` defaults to ``cuda`` (raises where there is none unless
``device="cpu"``, where the device columns and the counters are null).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from kbe_torch.config import EffectConfig, ZoomSettings  # noqa: E402
from kbe_torch.ops.discfill import fill_cuda, \
    fill_disocclusion_pallas  # noqa: E402
from kbe_torch.pipeline.kenburns import build_effect_fn, \
    fill_roi_of  # noqa: E402
from tools.bench_scene_torch import (bench_scene, card_of, device_profile,
                                     kernel_launches, synchronize, timeit,
                                     total)  # noqa: E402


def _fill_row(render, weight, effect, roi, dev, reps) -> dict:
    """The fill of one frame as the pipeline calls it, and of the same
    render with no hole."""
    depth = (render[..., 3:4] * (weight > 0.0)).contiguous()
    render = render.contiguous()
    y0, y1, x0, x1 = roi or (0, render.shape[0], 0, render.shape[1])

    def fill(d):
        return fill_disocclusion_pallas(
            render[None], d[None], effect.fill_march_steps,
            phase1_steps=effect.fill_march_phase1, roi=roi,
            phase0_steps=effect.fill_phase0,
            phase0_gate=effect.fill_phase0_gate)

    row = {"roi": [y0, y1, x0, x1],
           "hole_pixels_in_roi": int((depth[y0:y1, x0:x1] <= 0.0).sum())}
    for key, d in (("hole_free", torch.ones_like(depth)), ("frame", depth)):
        dev_ms, launches = device_profile(lambda d=d: fill(d), dev)
        row[key] = {"host_ms": timeit(lambda d=d: fill(d), dev, reps),
                    "device_ms": dev_ms, "launches": launches}
    if dev.type == "cuda":
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        fill_cuda(render, depth, effect.fill_march_steps, roi, stats=stats)
        steps, rounds = (int(v) for v in stats.cpu())
        row["frame"].update({"ray_steps": steps, "warp_rounds": rounds})
    return row


def clock_read_s(reads: int = 20000) -> float:
    """The host seconds of one ``time.perf_counter()`` read: an interval
    between two reads holds one read beside what it times."""
    t0 = time.perf_counter()
    for _ in range(reads):
        time.perf_counter()
    return (time.perf_counter() - t0) / (reads + 1)


def loop_split(fn, state, dev, clock_s: float = 0.0):
    """One run of the pose loop as ``render_frames`` runs it, its stages
    timed on the host clock as they come, with no synchronise between
    them: ([host ms of each of ``fn.frame_stages`` and of the final
    synchronise, the device work still queued when the host is done], the
    frames, stacked once the clock has stopped). ``clock_s``, one clock
    read (``clock_read_s``), is taken off each interval."""
    names = len(fn.frame_stages)
    times = [0.0] * (names + 1)
    frames = []
    for i in range(state.poses.shape[0]):
        x = (state, state.poses[i])
        for k, (_, stage) in enumerate(fn.frame_stages):
            t0 = time.perf_counter()
            out = stage(*x)
            times[k] += time.perf_counter() - t0 - clock_s
            x = out if isinstance(out, tuple) else (out,)
        frames.append(x[0])
    t0 = time.perf_counter()
    synchronize(dev)
    times[names] = time.perf_counter() - t0 - clock_s
    return [t * 1e3 for t in times], torch.stack(frames)


def profile_frame(size: int = 1024, steps: int = 75, checkpoint="find",
                  device=None, reps: int = 5, scene=None) -> dict:
    """The pose loop by stage and the fill at the middle pose, as a dict
    (see the module's doc), with ``frames``, the stages' frames; ``scene``:
    a ``bench_scene`` with its front-end state to reuse, else one is
    built."""
    if scene is None:
        scene = bench_scene(size, steps, checkpoint, device=device)
    dev, fn, state = scene["device"], scene["fn"], scene["state"]
    effect, size = scene["effect"], scene["size"]
    if effect.splat_method not in ("auto", "banded") \
            or effect.fill_impl != "pallas":
        raise ValueError("the frame stages follow the production renderer "
                         "and fill")
    n = state.poses.shape[0]
    rows = []
    inputs = [(state, state.poses[i]) for i in range(n)]
    with torch.inference_mode():
        for name, stage in fn.frame_stages:

            def run(stage=stage, inputs=inputs):
                return [stage(*a) for a in inputs]

            alone = timeit(run, dev, reps)
            dev_ms, launches = device_profile(run, dev)
            kernels = kernel_launches(run)
            rows.append({
                "stage": name, "alone_host_ms_a_frame": alone / n,
                "device_ms_a_frame": None if dev_ms is None else dev_ms / n,
                "launches_a_frame": None if dev_ms is None else launches / n,
                "kernels_a_frame": {k: v / n for k, v in kernels.items()}})
            inputs = [o if isinstance(o, tuple) else (o,) for o in run()]

        def loop():
            return fn.render_frames(state)

        # the loop and its split in turns, so that both see the same host
        clock_s = clock_read_s()
        loop()
        synchronize(dev)
        loop_runs, splits = [], []
        for _ in range(reps + 1):
            loop_runs.append(timeit(loop, dev, 1, warmup=False))
            splits.append(loop_split(fn, state, dev, clock_s))
        loop_ms = min(loop_runs) / n
        split_ms, frames = min(splits, key=lambda r: sum(r[0]))
        for row, ms in zip(rows, split_ms):
            row["host_ms_a_frame"] = ms / n
        rows.append({"stage": "wait", "host_ms_a_frame": split_ms[-1] / n})
        loop_dev, loop_launches = device_profile(loop, dev)

        mid = n // 2
        render, weight = fn.frame_stages[0][1](state, state.poses[mid])
        fill = {"pose": mid, **_fill_row(
            render, weight, effect, fill_roi_of(size, size, scene["zoom"],
                                                effect), dev, reps)}
        d_effect = EffectConfig(num_steps=n, dolly=True)
        d_zoom = ZoomSettings.default_dolly(size, size)
        d_fn = build_effect_fn(size, size, d_zoom, scene["camera"], d_effect,
                               device=dev)
        d_state = d_fn.front_end(scene["models"], scene["image"])
        render, weight = d_fn.frame_stages[0][1](d_state, d_state.poses[mid])
        fill_dolly = {"pose": mid, **_fill_row(
            render, weight, d_effect, fill_roi_of(size, size, d_zoom,
                                                  d_effect), dev, reps)}
    host_total = sum(r["host_ms_a_frame"] for r in rows)
    staged = [r for r in rows if r["stage"] != "wait"]
    return {
        "tool": "profile_frame_torch", "size": size, "poses": n,
        **card_of(dev), "weights": scene["weights"], "mix": scene["mix"],
        "reps": reps, "stages": rows,
        "sum_host_ms_a_frame": host_total,
        "render_frames_ms_a_frame": loop_ms,
        "clock_read_us": clock_s * 1e6,
        "sum_over_render_frames": host_total / loop_ms,
        "sum_alone_host_ms_a_frame": sum(r["alone_host_ms_a_frame"]
                                         for r in staged),
        "sum_device_ms_a_frame": total(r["device_ms_a_frame"]
                                       for r in staged),
        "render_frames_device_ms_a_frame": (None if loop_dev is None
                                            else loop_dev / n),
        "sum_launches_a_frame": total(r["launches_a_frame"] for r in staged),
        "render_frames_launches_a_frame": (None if loop_dev is None
                                           else loop_launches / n),
        "fill_middle_pose": fill, "fill_dolly_c2": fill_dolly,
        "frames": frames,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=75)
    ap.add_argument("--checkpoint", default="find",
                    help="'find' (find_bench_weights), 'none' (seeded "
                         "random weights) or a pipeline .tar")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    checkpoint = None if args.checkpoint == "none" else args.checkpoint
    report = profile_frame(args.size, args.steps, checkpoint, reps=args.reps)
    del report["frames"]
    for row in report["stages"]:
        print(json.dumps(row), flush=True)
    print(json.dumps({k: v for k, v in report.items() if k != "stages"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
