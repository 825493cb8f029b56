#!/usr/bin/env python3
"""Where the time of kbe_torch's effect goes on the card.

    python tools/profile_torch_effect.py [--size 1024] [--steps 75]

Runs the 3D Ken Burns effect of ``kbe_torch`` (production precision mix:
f32 depth nets, bf16 inpainting nets; seeded random weights; the demo
scene) once to warm up, then once under ``torch.profiler`` with CPU and
CUDA activities. Prints the wall time of the profiled run split into front
end and pose loop (host clock around ``torch.cuda.synchronize``), the
device time of the top kernels, and the device's busy and idle shares
(busy = the union of kernel intervals on the device timeline).
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
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kbe_torch.config import EffectConfig, ZoomSettings
    from kbe_torch.data import demo_scene_image
    from kbe_torch.pipeline import KenBurnsPipeline

    if not torch.cuda.is_available():
        print("profile_torch_effect: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    size = args.size
    pipe = KenBurnsPipeline.create(
        seed=0, effect=EffectConfig(num_steps=args.steps),
        dtype=torch.bfloat16, depth_dtype=torch.float32, device="cuda")
    image = torch.as_tensor(demo_scene_image(size, size), device="cuda")[None]
    fn = pipe.effect_fn(size, size, ZoomSettings.default_3d(size, size))
    fn(pipe.models, image)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = fn.front_end(pipe.models, image)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn.render_frames(state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    wall_us = (t2 - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us(kernels)
    print(f"{smi}; {size}^2 x {args.steps} frames; profiled run "
          f"{(t2 - t0) * 1e3:.3f} ms (front end {(t1 - t0) * 1e3:.3f} ms, "
          f"pose loop {(t2 - t1) * 1e3:.3f} ms); device busy "
          f"{busy / 1e3:.3f} ms = {busy / wall_us:.4f} of the wall time, "
          f"idle {1 - busy / wall_us:.4f}; {len(kernels)} kernel launches")
    totals = {}
    for e in kernels:
        name = e.name if len(e.name) <= 70 else e.name[:67] + "..."
        t, n = totals.get(name, (0.0, 0))
        totals[name] = (t + e.time_range.elapsed_us(), n + 1)
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for name, (t, n) in sorted(totals.items(), key=lambda kv: -kv[1][0])[
            :args.top]:
        print(f"{t / 1e3:10.3f} {t / busy:6.3f} {n:6d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
