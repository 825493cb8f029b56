"""Fidelity of the port's production path against its spec path, on one
card. The counterpart of ``tools/fidelity_report.py``.

The same scene goes through three configurations of
``kbe_torch.pipeline.build_effect_fn`` with one set of weights:

  - the production path: the default ``EffectConfig`` (the posed splat and
    the fill inside its ROI, both the hand-written CUDA kernels), bf16
    inpainting nets and f32 depth nets;
  - the spec path: ``splat_method='scatter'``, ``fill_impl='xla'``, f32
    nets (the path the port's CPU tests hold to ``kbe_tpu``'s spec);
  - ``kernels_f32_path``: the production kernels with f32 nets, so that
    its difference from the spec is the kernels' own and the production
    row's beyond it the bf16 nets'.

Each row holds the per-frame SSIM of the uint8 frames against the spec
path's (``kbe_torch.ops.image_ops.ssim``), the absolute differences and
where the largest is. The production row adds its frames/s (best of 2
timed runs of the front end and the pose loop after a warm-up), the
cloud's valid points per grid and the hole pixels a frame that the fill
sees (zero splat weight inside the fill's ROI).

Weights and scene: ``find_bench_weights()``'s checkpoint
(``tools/make_bench_weights_torch.py``) and the procedural demo scene
when there is one; else seeded random weights and a noise image, whose
noisy depth leaves the splat and the fill far more holes. ``scene`` says
which.

Usage (on the card): python tools/fidelity_report_torch.py [size] [n_steps]
[out.json]; defaults 512, 75 (the full trajectory),
``FIDELITY_torch_r01.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def compare(frames, spec):
    """SSIM and absolute-difference fields of uint8 ``frames`` against
    ``spec`` (both (T, H, W, 3) numpy), as ``tools/fidelity_report.py``
    writes them."""
    import numpy as np
    import torch

    from kbe_torch.ops.image_ops import ssim

    n = frames.shape[0]
    bf = frames.astype(np.float64) / 255.0
    sf = spec.astype(np.float64) / 255.0
    ssims = [float(ssim(torch.as_tensor(bf[i][None], dtype=torch.float32),
                        torch.as_tensor(sf[i][None], dtype=torch.float32)))
             for i in range(n)]
    diff = np.abs(bf - sf) * 255.0
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
    import numpy as np
    import torch

    from kbe_torch.config import CameraConfig, EffectConfig, ZoomSettings
    from kbe_torch.data import demo_scene_image
    from kbe_torch.device import card_name, resolve_device
    from kbe_torch.pipeline.kenburns import build_effect_fn, create_models, \
        path_stats
    from kbe_torch.train.checkpoint import find_bench_weights, \
        load_pipeline_params

    dev = resolve_device(device)
    if checkpoint == "find":
        checkpoint = find_bench_weights()
    h = w = size
    zoom = ZoomSettings.default_3d(w, h)
    camera = CameraConfig()
    if checkpoint:
        image_np = demo_scene_image(h, w)
        scene = (f"trained-synthetic weights ({os.path.basename(checkpoint)},"
                 " tools/make_bench_weights_torch.py) + procedural demo scene")
    else:
        image_np = np.random.default_rng(0).uniform(
            0, 1, (h, w, 3)).astype(np.float32)
        scene = ("seeded random weights + noise image (no bench checkpoint; "
                 "noisy depth leaves the splat and the fill more holes)")
    image = torch.as_tensor(image_np, device=dev)[None]

    def models(dtype, depth_dtype=None):
        if checkpoint:
            return load_pipeline_params(checkpoint, dev, dtype, depth_dtype)
        return create_models(0, dev, dtype, depth_dtype)

    def run(effect, nets, label):
        fn = build_effect_fn(h, w, zoom, camera, effect, device=dev)
        t0 = time.perf_counter()
        frames = fn(nets, image).cpu().numpy()
        wall = time.perf_counter() - t0
        log(f"{label}: {wall:.2f} s (the first run: kernels' tables, cuDNN "
            "plans)")
        return fn, frames, wall

    production = EffectConfig(num_steps=n_steps)
    spec = EffectConfig(num_steps=n_steps, splat_method="scatter",
                        fill_impl="xla")
    nets_prod = models(torch.bfloat16, torch.float32)
    fn, prod_frames, t_prod = run(production, nets_prod, "production path")
    stats = path_stats(fn, nets_prod, image, h, w, zoom, production)
    del nets_prod
    nets_f32 = models(torch.float32)
    _, spec_frames, t_spec = run(spec, nets_f32, "spec path")
    report = {
        "size": size,
        "n_steps": n_steps,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "nvidia_smi": card_name() if dev.type == "cuda" else None,
        "spec_path": "splat=scatter fill=xla dtype=float32",
        "production_path": "splat=auto (render_posed) fill=pallas "
                           "(discfill in the ROI) depth-nets=float32 "
                           "inpaint-nets=bfloat16, the CUDA kernels",
        **compare(prod_frames, spec_frames),
        "production_stats": stats,
        "scene": scene,
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
    out = argv[2] if len(argv) > 2 else "FIDELITY_torch_r01.json"
    report = fidelity_report(size, n_steps)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
