#!/usr/bin/env python3
"""Where the time of kbe_torch's effect goes on the card.

    python tools/profile_torch_effect.py [--size 1024] [--steps 75]
                                         [--mode default] [--tree DIR]
                                         [--checkpoint PIPELINE_TAR]

Runs the 3D Ken Burns effect of ``kbe_torch`` (production precision mix:
f32 depth nets, bf16 inpainting nets; seeded random weights, or those of
a pipeline checkpoint such as ``tools/make_bench_weights_torch.py``
writes; the demo scene) once to warm up, then once under ``torch.profiler`` with CPU and
CUDA activities, the front end and the pose loop each under a profiler of
its own. Prints the wall time of the profiled run split into front end
and pose loop (host clock around ``torch.cuda.synchronize``), the kernel
launches of the run and of the loop alone (per frame), the device time of
the top kernels and of every hand-written one (``splat_*``, ``discfill``),
and the device's busy and idle shares (busy = the union of kernel
intervals on the device timeline).
``--mode`` picks one of the inference modes that ``chip_smoke.py`` drives
(dolly, 2d, partial_inpainting, routed+xla, ...), by the same table.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _busy_us(events) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=75)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--mode", default="default",
                    help="'default' or a mode name of chip_smoke.MODES")
    ap.add_argument("--tree", default=None,
                    help="import kbe_torch and chip_smoke from this checkout "
                         "(default: this one), to profile another version")
    ap.add_argument("--checkpoint", default=None,
                    help="a pipeline .tar whose nets to run (default: "
                         "seeded random weights)")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import MODES
    from kbe_torch.config import EffectConfig, ZoomSettings
    from kbe_torch.data import demo_scene_image
    from kbe_torch.pipeline import KenBurnsPipeline

    modes = {"default": ({}, {})}
    modes.update({name: (effect_kw, model_kw)
                  for name, effect_kw, model_kw, _ in MODES})
    if args.mode not in modes:
        ap.error(f"--mode must be one of {sorted(modes)}")
    effect_kw, model_kw = modes[args.mode]

    if not torch.cuda.is_available():
        print("profile_torch_effect: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    size = args.size
    effect = EffectConfig(num_steps=args.steps, **effect_kw)
    pipe = KenBurnsPipeline.create(
        seed=0, effect=effect, dtype=torch.bfloat16,
        depth_dtype=torch.float32, device="cuda", **model_kw,
        **({"checkpoint": args.checkpoint} if args.checkpoint else {}))
    image = torch.as_tensor(demo_scene_image(size, size), device="cuda")[None]
    zoom = (ZoomSettings.default_dolly(size, size) if effect.dolly
            else ZoomSettings.default_3d(size, size))
    fn = pipe.effect_fn(size, size, zoom)
    fn(pipe.models, image)
    torch.cuda.synchronize()

    # the two halves under profilers of their own, so that the pose loop's
    # launches are counted apart
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as front_prof:
        t0 = time.perf_counter()
        state = fn.front_end(pipe.models, image)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    with profile(activities=activities) as loop_prof:
        t2 = time.perf_counter()
        fn.render_frames(state)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    wall_us = ((t1 - t0) + (t3 - t2)) * 1e6
    front, loop = ([e for e in p.events() if e.device_type == DeviceType.CUDA]
                   for p in (front_prof, loop_prof))
    kernels = front + loop
    busy = _busy_us(front) + _busy_us(loop)
    print(f"{smi}; mode {args.mode}; weights "
          f"{args.checkpoint or 'seeded random'}; {size}^2 x {args.steps} "
          "frames; "
          f"profiled run "
          f"{wall_us / 1e3:.3f} ms (front end {(t1 - t0) * 1e3:.3f} ms, "
          f"pose loop {(t3 - t2) * 1e3:.3f} ms); device busy "
          f"{busy / 1e3:.3f} ms = {busy / wall_us:.4f} of the wall time, "
          f"idle {1 - busy / wall_us:.4f}; {len(kernels)} kernel launches, "
          f"{len(loop)} in the pose loop = {len(loop) / args.steps:.2f} a "
          f"frame")
    totals = {}
    for e in kernels:
        name = e.name if len(e.name) <= 70 else e.name[:67] + "..."
        t, n = totals.get(name, (0.0, 0))
        totals[name] = (t + e.time_range.elapsed_us(), n + 1)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for name, (t, n) in ranked[:args.top]:
        print(f"{t / 1e3:10.3f} {t / busy:6.3f} {n:6d}  {name}")
    print("hand-written kernels, device ms over the run (mean us a call):")
    for name, (t, n) in ranked:
        if "splat_" in name or "discfill" in name:
            print(f"{t / 1e3:10.3f} {t / busy:6.3f} {n:6d}  {name} "
                  f"({t / n:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
