"""3D Ken Burns effect CLI of the PyTorch/CUDA port.

The flags of ``cli/kbe.py`` (themselves those of the reference ``kbe.py``:
--in/--out, --dolly, --write-frames, --2d, --pretrained-refine,
--pretrained-estim, --partial-conv, --inpaint-depth, model paths, the 8
crop-window parameters with aspect-ratio completion and in-bounds
validation) plus ``--device`` (default ``cuda``).

Usage:
  python cli/kbe_torch.py --in images/input.jpg --out out_dir [--dolly] ...

``run(args, image)`` holds everything between reading the image and writing
the video; ``main`` does the file I/O around it.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="3D Ken Burns effect (PyTorch + CUDA)")
    p.add_argument("--in", dest="input", default="images/doublestrike.jpg")
    p.add_argument("--out", dest="output", default="images/kbe")
    p.add_argument("--dolly", action="store_true")
    p.add_argument("--write-frames", action="store_true")
    p.add_argument("--2d", dest="two_d", action="store_true")
    p.add_argument("--pretrained-refine", action="store_true")
    p.add_argument("--pretrained-estim", action="store_true")
    p.add_argument("--partial-conv", action="store_true")
    p.add_argument("--inpaint-depth", default=None,
                   help="path to a depth-inpainting checkpoint "
                        "(enables the dual-net mode)")
    p.add_argument("--inpaint-path", default=None)
    p.add_argument("--refine-path", default=None)
    p.add_argument("--estim-path", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="orbax pipeline checkpoint directory (not readable "
                        "without JAX: refused)")
    for flag in ("startU", "startV", "startW", "startH",
                 "endU", "endV", "endW", "endH"):
        p.add_argument(f"--{flag}", type=float, default=None)
    p.add_argument("--steps", type=int, default=75)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--bf16", action="store_true",
                   help="production precision policy: bf16 inpaint stack, "
                        "f32 depth path; default is f32 end-to-end")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "PyTorch versions")
    return p


def resolve_windows(args, width: int, height: int):
    """Aspect-ratio completion + defaults (kbe.py:117-140)."""
    from kbe_torch.config import ZoomSettings, ZoomWindow

    su, sv, sw, sh = args.startU, args.startV, args.startW, args.startH
    eu, ev, ew, eh = args.endU, args.endV, args.endW, args.endH

    if eh is not None and ew is None:
        ew = int(width * eh / height)
    if ew is not None and eh is None:
        eh = int(height * ew / width)
    if sh is not None and sw is None:
        sw = int(width * sh / height)
    if sw is not None and sh is None:
        sh = int(height * sw / width)

    if None in (su, sv, sw, sh, eu, ev, ew, eh):
        if args.dolly:
            print("Using default dolly crop windows.")
            return ZoomSettings.default_dolly(width, height)
        print("Using default 3D KBE crop windows.")
        return ZoomSettings.default_3d(width, height)

    zoom = ZoomSettings(
        src=ZoomWindow(su, sv, int(sw), int(sh)),
        dst=ZoomWindow(eu, ev, int(ew), int(eh)),
    )
    zoom.validate(width, height)
    return zoom


def run(args, image: np.ndarray) -> np.ndarray:
    """``image``: (H, W, 3) uint8 as ``cv2.imread`` gives it (BGR) ->
    (steps, H', W', 3) uint8 frames, H' and W' cropped to multiples of 4.
    Everything between reading the image and writing the video."""
    import torch

    from kbe_torch.config import EffectConfig
    from kbe_torch.pipeline import KenBurnsPipeline

    if args.checkpoint:
        raise NotImplementedError(
            "--checkpoint names an orbax checkpoint directory, and reading "
            "one needs a reader that does not import JAX, which kbe_torch "
            "does not have; convert with cli/kbe.py's stack, or pass the "
            "reference .tar files (--estim-path, --refine-path, "
            "--inpaint-path)")
    if args.pretrained_estim:
        image = image[:, :, ::-1]  # BGR -> RGB

    # crop to multiple-of-4 dims (kbe.py:108-114)
    h, w = image.shape[:2]
    image = image[:h - h % 4, :w - w % 4]
    h, w = image.shape[:2]

    zoom = resolve_windows(args, w, h)
    effect = EffectConfig(num_steps=args.steps, fps=args.fps,
                          dolly=args.dolly, two_d=args.two_d)
    pipe = KenBurnsPipeline.create(
        0, effect=effect, pretrained_refine=args.pretrained_refine,
        partial_inpainting=args.partial_conv,
        inpaint_depth=args.inpaint_depth is not None,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        depth_dtype=torch.float32 if args.bf16 else None,
        device=args.device)

    if any((args.inpaint_path, args.refine_path, args.estim_path)):
        from kbe_torch.utils.reference_convert import load_torch_pipeline

        load_torch_pipeline(
            pipe.models, estim=args.estim_path, refine=args.refine_path,
            inpaint=args.inpaint_path, inpaint_depth=args.inpaint_depth)
    else:
        print("WARNING: no checkpoint given — running with random weights.")

    return pipe(np.ascontiguousarray(image).astype(np.float32) / 255.0, zoom)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import cv2

    from kbe_torch.pipeline.video import write_frames, write_video

    image = cv2.imread(args.input, cv2.IMREAD_COLOR)
    if image is None:
        print(f"cannot read {args.input}", file=sys.stderr)
        return 1
    frames = run(args, image)

    os.makedirs(args.output, exist_ok=True)
    if args.write_frames:
        write_frames(frames, args.output,
                     bgr_input=not args.pretrained_estim)
    out = write_video(frames, os.path.join(args.output, "3d_kbe.mp4"),
                      fps=args.fps, bgr_input=not args.pretrained_estim)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
