"""Fidelity of the port's production path against its spec path, on one
card. The counterpart of ``tools/fidelity_report.py``.

The same scene goes through three configurations of
``kbe_torch.pipeline.build_effect_fn`` with one set of weights:

  - the production path: the default ``EffectConfig`` (the posed splat and
    the fill inside its ROI, both the hand-written CUDA kernels), bf16
    inpainting nets and f32 depth nets;
  - the spec path: ``splat_method='scatter'``, ``fill_impl='xla'``, f32
    nets. These name ``kbe_tpu``'s XLA specs, and the effect runs them as
    the plain PyTorch versions on every device (``render_pointcloud_plain``
    in the frame loop and the bootstrap, ``fill_plain`` over the whole
    frame): no hand-written kernel, which the report checks
    (``spec_kernel_launches``). On the card the plain accumulate's
    ``index_add_`` adds with atomics in no fixed order, so the spec runs
    twice and ``spec_runs_equal`` says whether its two runs gave equal
    frames (``spec_runs`` holds the second against the first);
  - ``kernels_f32_path``: the production kernels with f32 nets, so that
    its difference from the spec is the kernels' own and the production
    row's beyond it the bf16 nets'.

Each row holds the per-frame SSIM of the uint8 frames against the spec
path's first run (``kbe_torch.ops.image_ops.ssim``), the absolute
differences and where the largest is. The production row adds its
frames/s (best of 2 timed runs of the front end and the pose loop after a
warm-up), the cloud's valid points per grid and the hole pixels a frame
that the fill sees (zero splat weight inside the fill's ROI).

Weights and scene (``tools/bench_scene_torch.py``): the procedural demo
scene, with ``find_bench_weights()``'s checkpoint
(``tools/make_bench_weights_torch.py``) when there is one, else seeded
random weights; ``scene`` says which.

Usage (on the card): python tools/fidelity_report_torch.py [size] [n_steps]
[out.json]; defaults 512, 75 (the full trajectory),
``FIDELITY_torch_r02.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def frame_ssims(frames, spec):
    """The SSIM of each uint8 frame of ``frames`` against ``spec`` (both
    (T, H, W, 3) numpy), on the CPU."""
    import numpy as np
    import torch

    from kbe_torch.ops.image_ops import ssim

    bf = frames.astype(np.float64) / 255.0
    sf = spec.astype(np.float64) / 255.0
    return [float(ssim(torch.as_tensor(bf[i][None], dtype=torch.float32),
                       torch.as_tensor(sf[i][None], dtype=torch.float32)))
            for i in range(frames.shape[0])]


def compare(frames, spec):
    """SSIM and absolute-difference fields of uint8 ``frames`` against
    ``spec`` (both (T, H, W, 3) numpy), as ``tools/fidelity_report.py``
    writes them."""
    import numpy as np

    n = frames.shape[0]
    ssims = frame_ssims(frames, spec)
    diff = np.abs(frames.astype(np.float64) - spec.astype(np.float64))
    arg = np.unravel_index(int(np.argmax(diff)), diff.shape)
    argmin = int(np.argmin(ssims))
    row = {
        "mean_ssim": float(np.mean(ssims)),
        "min_ssim": float(np.min(ssims)),
        "argmin_ssim_frame": argmin,
        "max_abs_diff_uint8": float(np.max(diff)),
        "max_abs_diff_at": {"frame": int(arg[0]), "y": int(arg[1]),
                            "x": int(arg[2]), "channel": int(arg[3])},
        "mean_abs_diff_uint8": float(np.mean(diff)),
        "abs_diff_p999_uint8": float(np.percentile(diff, 99.9)),
        "pixels_diff_gt32_per_frame": float(
            (diff.max(axis=-1) > 32.0).sum() / n),
        "pixels_diff_gt8_per_frame": float(
            (diff.max(axis=-1) > 8.0).sum() / n),
    }
    if n > 8:
        idx = sorted(set(list(range(0, n, max(1, n // 15)))
                         + [argmin, n - 1]))
        row["per_frame_ssim_sampled"] = {int(i): round(ssims[i], 5)
                                         for i in idx}
    else:
        row["per_frame_ssim"] = [round(s, 5) for s in ssims]
    return row


def fidelity_report(size: int = 512, n_steps: int = 75, checkpoint="find",
                    device=None, log=print):
    """The report as a dict. ``checkpoint``: a pipeline ``.tar``, None for
    seeded random weights, or 'find' for ``find_bench_weights()``.
    ``device`` defaults to ``cuda`` (raises where there is none)."""
    from kbe_torch.config import EffectConfig
    from kbe_torch.pipeline.kenburns import build_effect_fn, path_stats
    from tools.bench_scene_torch import bench_scene, card_of, \
        kernel_launches, load_models

    scene = bench_scene(size, n_steps, checkpoint, device=device,
                        front=False)
    dev, image, zoom = scene["device"], scene["image"], scene["zoom"]
    h = w = size

    def run(effect, nets, label):
        fn = build_effect_fn(h, w, zoom, scene["camera"], effect, device=dev)
        t0 = time.perf_counter()
        frames = fn(nets, image).cpu().numpy()
        wall = time.perf_counter() - t0
        log(f"{label}: {wall:.2f} s (the first run: kernels' tables, cuDNN "
            "plans)")
        return fn, frames, wall

    production = scene["effect"]
    spec = EffectConfig(num_steps=n_steps, splat_method="scatter",
                        fill_impl="xla")
    nets_prod = scene.pop("models")
    fn, prod_frames, t_prod = run(production, nets_prod, "production path")
    stats = path_stats(fn, nets_prod, image, h, w, zoom, production)
    del nets_prod
    nets_f32 = load_models(scene["checkpoint"], dev, "all_f32")
    spec_launches = kernel_launches(lambda: run(spec, nets_f32, "spec path"))
    _, spec_frames, t_spec = run(spec, nets_f32, "spec path")
    _, spec_again, _ = run(spec, nets_f32, "spec path again")
    report = {
        "size": size,
        "n_steps": n_steps,
        **card_of(dev),
        "spec_path": "splat=scatter (render_pointcloud_plain) fill=xla "
                     "(fill_plain, the whole frame) dtype=float32: the plain "
                     "PyTorch versions on the device, no hand-written "
                     "kernel; run twice",
        "spec_kernel_launches": spec_launches,
        "spec_runs_equal": bool((spec_frames == spec_again).all()),
        "spec_runs": compare(spec_again, spec_frames),
        "production_path": "splat=auto (render_posed) fill=pallas "
                           "(discfill in the ROI) depth-nets=float32 "
                           "inpaint-nets=bfloat16, the CUDA kernels",
        **compare(prod_frames, spec_frames),
        "production_stats": stats,
        "scene": f"{scene['weights']} + procedural demo scene",
        "wall_s": {"production_path": t_prod, "spec_path": t_spec},
    }
    _, kern_frames, t_kern = run(production, nets_f32, "kernels_f32_path")
    report["kernels_f32_path"] = {
        "config": "splat=auto fill=pallas dtype=float32: the production "
                  "kernels with f32 nets, which isolates the bf16 nets' "
                  "cost from the kernels' fidelity",
        **compare(kern_frames, spec_frames)}
    report["wall_s"]["kernels_f32_path"] = t_kern
    return report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    size = int(argv[0]) if len(argv) > 0 else 512
    n_steps = int(argv[1]) if len(argv) > 1 else 75
    out = argv[2] if len(argv) > 2 else "FIDELITY_torch_r02.json"
    report = fidelity_report(size, n_steps)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
