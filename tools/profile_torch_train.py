#!/usr/bin/env python3
"""Where the time of a kbe_torch training step goes on the card.

    python tools/profile_torch_train.py [--height 384] [--width 512]
                                        [--batch 8] [--top 15]

Builds the adversarial trainer of ``cli/train_torch.py --training-mode
inpainting_ref`` (full ContextNet and Inpaint, MPDDiscriminator with
spectral norm and VGG16; seeded random weights; its synthetic data) with
``pretrain_steps=0`` and ``balance_steps=1``, runs a D-only and a G+D
iteration to warm up, then profiles one G+D iteration under
``torch.profiler`` (CPU and CUDA activities). Prints the iteration's wall
time (host clock around ``torch.cuda.synchronize``), its kernel launches,
the device's busy and idle shares (busy = the union of kernel intervals),
the device time of the top kernels, and the share of the splat's
hand-written kernels (``splat_*``: six forward kernels and ``splat_grad``
a batch item) and of the convolutions.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tools.profile_torch_effect import _busy_us  # noqa: E402

# substrings of cuDNN's and cuBLAS's convolution and GEMM kernel names
_CONV = ("conv", "cudnn", "xmma", "gemm", "wgrad", "dgrad", "fprop",
         "winograd", "implicit")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cli import train_torch as cli
    from kbe_torch.train.trainer_inpaint import TRAIN_CAMERA, to_device

    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    size = (args.height, args.width)
    cli.SYNTHETIC_SIZE["inpainting"] = size
    with tempfile.TemporaryDirectory() as logs:
        a = cli.build_parser().parse_args(
            ["--training-mode", "inpainting_ref", "--synthetic",
             "--batch-size", str(args.batch), "--logs-path", logs])
        trainer = cli.make_trainer(a, pretrain_steps=0, balance_steps=1)
        data, _, _ = cli.make_data(a, "inpainting", TRAIN_CAMERA)
        g, d = trainer.init_state(size), trainer.init_disc_state(size)
        for _ in range(2):  # a D-only and a G+D iteration
            g, d, _ = trainer.adversarial_step(
                g, d, to_device(next(data), trainer.device),
                trainer._want_g_update())
            trainer.iter_nb += 1
        batch = to_device(next(data), trainer.device)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.adversarial_step(g, d, batch, True)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        trainer.writer.close()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us(kernels)
    total = sum(e.time_range.elapsed_us() for e in kernels)
    splat = sum(e.time_range.elapsed_us() for e in kernels
                if "splat_" in e.name)
    conv = sum(e.time_range.elapsed_us() for e in kernels
               if "splat_" not in e.name
               and any(k in e.name.lower() for k in _CONV))
    print(f"{smi}; G+D iteration at {size[0]}x{size[1]}, batch "
          f"{args.batch}: {wall_us / 1e3:.3f} ms profiled; device busy "
          f"{busy / 1e3:.3f} ms = {busy / wall_us:.4f} of the wall time, "
          f"idle {1 - busy / wall_us:.4f}; {len(kernels)} kernel launches; "
          f"kernel time {total / 1e3:.3f} ms: the splat's kernels "
          f"{splat / 1e3:.3f} ms = {splat / total:.4f}, convolutions and "
          f"GEMMs {conv / 1e3:.3f} ms = {conv / total:.4f}")
    totals = {}
    for e in kernels:
        name = e.name if len(e.name) <= 70 else e.name[:67] + "..."
        t, n = totals.get(name, (0.0, 0))
        totals[name] = (t + e.time_range.elapsed_us(), n + 1)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for name, (t, n) in ranked[:args.top]:
        print(f"{t / 1e3:10.3f} {t / total:6.3f} {n:6d}  {name}")
    print("the splat's kernels, device ms over the iteration (mean us a "
          "call):")
    for name, (t, n) in ranked:
        if "splat_" in name:
            print(f"{t / 1e3:10.3f} {t / total:6.3f} {n:6d}  {name} "
                  f"({t / n:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
