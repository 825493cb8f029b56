#!/usr/bin/env python3
"""Time the splat accumulation and the fill of a kbe_torch tree on the card.

    python tools/kernel_times.py [--tree DIR] [--sets 5] [--reps 20]

Imports ``kbe_torch`` from ``DIR`` (default: this checkout), so one call
can time two versions of the kernels in turns on one card, for example
this tree and an unpacked parent commit. It uses only the wrappers whose
signatures both versions share: ``zee_cuda``, ``degrid_cuda``,
``accumulate_cuda`` and ``fill_cuda``. The inputs are those of
``chip_smoke.py`` (its ``make_cloud``, the same seeds):
  (a)  C=4, the frame loop's 3-grid 1024^2 cloud at a frame pose;
  (a2) C=4, one grid at dolly's focal;
  (b)  C=68, the bootstrap's one grid;
  (p)  C=4, 65,536 points of a 1024^2 grid on one pixel;
  (c)  the fill of the (a) render, K=128, the default ROI;
  (c2) the fill of the (a2) render, dolly's ROI (open disocclusions).
Prints the card's name and power limit, then one JSON line: the median over
``--sets`` of the mean ms of ``--reps`` launches (CUDA events), and whether
the accumulation was bit-equal over two runs.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=HERE)
    parser.add_argument("--sets", type=int, default=5)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from kbe_torch.config import EffectConfig, ZoomSettings
    from kbe_torch.ops import discfill as D
    from kbe_torch.ops import splat as S
    from kbe_torch.pipeline.kenburns import fill_roi_of

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    def med(fn):
        return statistics.median(cs.timed(fn, args.reps)
                                 for _ in range(args.sets))

    size = cs.SIZE
    shift = torch.tensor([-9.5, 6.25, -30.0])
    xyz, payload, valid = cs.make_cloud(3, 4, seed=1, shift=shift)
    scene = S.prepare_scene(xyz, payload, valid)
    pose = S.make_pose(shift.cuda(), cs.FOCAL, cs.BASELINE)
    xyz1, payload1, valid1 = cs.make_cloud(1, 4, seed=3, shift=shift)
    scene1 = S.prepare_scene(xyz1, payload1, valid1)
    pose1 = S.make_pose(shift.cuda(), cs.FOCAL * 1.21875, cs.BASELINE)
    xyz68, payload68, _ = cs.make_cloud(1, 68, seed=2, shift=shift)
    pts68 = (xyz68.reshape(-1, 3) + shift.cuda()).contiguous()
    zero = S.make_pose(torch.zeros(3, device="cuda"), cs.FOCAL, cs.BASELINE)
    ones = torch.ones(size * size, device="cuda")

    # (p) as chip_smoke.py's pathological_phase builds it
    xyzp, payloadp, validp = cs.make_cloud(1, 4, seed=5,
                                           shift=torch.zeros(3))
    g = torch.Generator().manual_seed(6)
    ptsp = xyzp.reshape(-1, 3).clone()
    pile = torch.randperm(size * size, generator=g)[:65536].cuda()
    z = 300.0 + torch.rand(65536, generator=g).cuda()
    du, dv = (0.1 + 0.8 * torch.rand(2, 65536, generator=g)).cuda()
    ptsp[pile, 0] = (700.0 + du - size / 2 + 0.5) * z / cs.FOCAL
    ptsp[pile, 1] = (400.0 + dv - size / 2 + 0.5) * z / cs.FOCAL
    ptsp[pile, 2] = z

    times, equal = {}, {}
    for name, (x, p, v, q) in (
            ("accumulate_c4", (scene.xyz, scene.payload, scene.valid, pose)),
            ("accumulate_c4_dolly", (scene1.xyz, scene1.payload,
                                     scene1.valid, pose1)),
            ("accumulate_c68", (pts68, payload68.reshape(-1, 68).contiguous(),
                                ones, zero)),
            ("accumulate_c4_pathological", (ptsp.contiguous(),
                                            payloadp.reshape(-1, 4)
                                            .contiguous(),
                                            validp.reshape(-1).contiguous(),
                                            zero))):
        c = p.shape[1]
        deg = S.degrid_cuda(S.zee_cuda(x, v, q, size, size, c), size, size,
                            c)
        times[name] = med(lambda: S.accumulate_cuda(x, v, p, q, deg, size,
                                                    size))
        equal[name] = bool(torch.equal(
            S.accumulate_cuda(x, v, p, q, deg, size, size),
            S.accumulate_cuda(x, v, p, q, deg, size, size)))
    for name, sc, q, zoom, effect in (
            ("fill", scene, pose, ZoomSettings.default_3d(size, size),
             EffectConfig()),
            ("fill_dolly", scene1, pose1,
             ZoomSettings.default_dolly(size, size), EffectConfig(dolly=True))):
        render, existing = S.render_posed(sc, q, size, size)
        depth = (render[..., 3:4] * (existing > 0.0)).contiguous()
        render = render.contiguous()
        roi = fill_roi_of(size, size, zoom, effect)
        times[name] = med(lambda: D.fill_cuda(render, depth, 128, roi))
    print(json.dumps({"tree": tree, "ms": times,
                      "accumulate_run_to_run_equal": equal}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
