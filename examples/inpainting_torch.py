"""Inpainting analysis on the PyTorch/CUDA port: the flow of
``examples/inpainting.py`` through ``kbe_torch``'s ``InpaintEval``. Runs
the inpainting nets over a dataset (or synthetic RGBD scenes), prints PSNR
and SSIM (and the FID with ``--fid``), and saves a panel: the view, the
masked view and the inpainted one, or with ``--view-c`` the view A, the
inpainted view B and the halfway view C.

The nets are fresh, from a seed, unless ``--checkpoint`` names a
checkpoint of ``cli/train_torch.py``'s inpainting modes.

Usage:
  python examples/inpainting_torch.py \\
      [--dataset name:path:focal:baseline] [--checkpoint file.tar] \\
      [--out runs/inpaint_eval.png] [--view-c] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np

SIZE = (192, 256)


def _fresh_nets(seed: int = 0):
    """Port state dicts of a fresh ContextNet and Inpaint, drawn as Flax
    inits from ``seed``."""
    import torch

    from kbe_torch.models import ContextNet, Inpaint
    from kbe_torch.models.init import flax_default_init

    nets = {"context": ContextNet(), "net": Inpaint()}
    for i, net in enumerate(nets.values()):
        flax_default_init(net, torch.Generator().manual_seed(seed + i))
    return {k: net.state_dict() for k, net in nets.items()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", action="append", default=[])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", default="runs/inpaint_eval.png")
    p.add_argument("--view-c", action="store_true")
    p.add_argument("--batches", type=int, default=2)
    p.add_argument("--fid", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from kbe_torch.pipeline.video import write_image
    from kbe_torch.train.data import synthetic_batches
    from kbe_torch.train.eval_inpaint import InpaintEval
    from kbe_torch.train.trainer_inpaint import TRAIN_CAMERA

    h, w = SIZE
    params = _fresh_nets()
    if args.checkpoint:
        from kbe_torch.train.checkpoint import load_checkpoint

        states, _ = load_checkpoint(args.checkpoint)  # G, then D if any
        params = {k: states[0][k] for k in ("context", "net")}

    ev = InpaintEval(params, camera=TRAIN_CAMERA, device=args.device)

    if args.dataset:
        from cli.train_torch import parse_dataset
        from kbe_torch.train.data import KBEDataset

        ds = KBEDataset([parse_dataset(d) for d in args.dataset],
                        mode="inpainting")
        _, val_idx = ds.split()
        batches = list(ds.batches(val_idx, 1, shuffle=False, epochs=1))
    else:
        print("No dataset — using synthetic RGBD scenes.")
        batches = list(synthetic_batches(1, h, w, mode="inpainting",
                                         camera=TRAIN_CAMERA,
                                         steps=args.batches))

    metrics = ev.eval(iter(batches), compute_fid=args.fid)
    print("Inpaint metrics:", {k: round(float(v), 4)
                               for k, v in metrics.items()})

    views = ev.get_inpaint(batches[0], output_render_c=args.view_c)
    if args.view_c:
        panel = np.concatenate([
            views["image_a"][0],
            views["inpaint_image_b"][0],
            np.clip(views["render_c"][0, ..., :3], 0, 1)], axis=1)
    else:
        panel = np.concatenate([
            views["image"][0],
            views["image"][0] * views["masks"][0],
            views["inpaint_image"][0]], axis=1)
    write_image(args.out, (np.clip(panel, 0, 1) * 255).astype(np.uint8))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
