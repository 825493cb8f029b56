"""The precision mixes of the effect's nets, against the spec, on the
bench scene: the counterpart of ``tools/dtype_sweep.py``.

    python tools/dtype_sweep_torch.py [size] [n_steps] [--checkpoint ...]

Three rows, as ``kbe_tpu``'s tool has them (``bench_scene_torch.MIXES``):

  - ``all_bf16``: every net in bf16;
  - ``depth_f32``: the production mix, f32 depth nets (Semantics,
    Disparity, Refine: the geometry that places every splat) and bf16
    inpainting nets (ContextNet, Inpaint);
  - ``all_f32``: every net in f32.

Each row runs the production effect (the hand-written kernels on the card)
and holds its uint8 frames against the spec path's: ``splat_method=
'scatter'``, ``fill_impl='xla'``, f32 nets, the plain versions on every
device (``fidelity_report_torch``). It gives mean and min SSIM, the SSIM of
each frame, the largest uint8 difference, and the front-end ms and
pose-loop ms a frame of ``kenburns.path_stats`` (best of 2 runs after a
warm-up). ``kbe_tpu``'s ``overflow`` field has no counterpart: the port's
splat never drops a point. On the CPU every path is plain, so ``all_f32``
reads SSIM 1.0 and a largest difference of 0.

``device`` defaults to ``cuda`` (raises where there is none unless
``device="cpu"``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from kbe_torch.config import EffectConfig  # noqa: E402
from kbe_torch.pipeline.kenburns import build_effect_fn, \
    path_stats  # noqa: E402
from tools.bench_scene_torch import MIXES, bench_scene, card_of, \
    load_models  # noqa: E402
from tools.fidelity_report_torch import frame_ssims  # noqa: E402


def dtype_sweep(size: int = 512, steps: int = 75, checkpoint="find",
                device=None, log=print) -> dict:
    """The sweep as a dict: the scene's fields and ``rows``, one a mix."""
    scene = bench_scene(size, steps, checkpoint, "all_f32", device=device,
                        front=False)
    dev, image, zoom = scene["device"], scene["image"], scene["zoom"]
    spec_fn = build_effect_fn(size, size, zoom, scene["camera"],
                              EffectConfig(num_steps=steps,
                                           splat_method="scatter",
                                           fill_impl="xla"), device=dev)
    spec = spec_fn(scene.pop("models"), image).cpu().numpy()
    rows = []
    for mix in MIXES:
        models = load_models(scene["checkpoint"], dev, mix)
        fn = scene["fn"]
        fn(models, image)   # warm-up: cuDNN plans for this mix
        frames = fn(models, image).cpu().numpy()
        stats = path_stats(fn, models, image, size, size, zoom,
                           scene["effect"])
        del models
        ssims = frame_ssims(frames, spec)
        row = {
            "config": mix, "size": size, "n_steps": steps,
            "mean_ssim": float(np.mean(ssims)),
            "min_ssim": float(np.min(ssims)),
            "per_frame_ssim": [round(s, 6) for s in ssims],
            "max_abs_diff_uint8": int(np.abs(
                frames.astype(np.int32) - spec.astype(np.int32)).max()),
            "front_end_ms": stats["front_end_s"] * 1e3,
            "pose_loop_ms_a_frame": stats["pose_loop_ms_a_frame"],
            "frames_per_s": stats["frames_per_s"],
        }
        log(json.dumps(row))
        rows.append(row)
    return {"tool": "dtype_sweep_torch", "size": size, "n_steps": steps,
            **card_of(dev), "weights": scene["weights"],
            "spec_path": "splat=scatter fill=xla dtype=float32, the plain "
                         "versions", "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("size", type=int, nargs="?", default=512)
    ap.add_argument("n_steps", type=int, nargs="?", default=75)
    ap.add_argument("--checkpoint", default="find",
                    help="'find' (find_bench_weights), 'none' (seeded "
                         "random weights) or a pipeline .tar")
    args = ap.parse_args(argv)
    checkpoint = None if args.checkpoint == "none" else args.checkpoint
    report = dtype_sweep(args.size, args.n_steps, checkpoint,
                         log=lambda line: print(line, flush=True))
    print(json.dumps({k: v for k, v in report.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
